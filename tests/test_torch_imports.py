"""The port imports torch, never JAX, and nothing of the JAX package.

Checked in a fresh interpreter (this test process has JAX loaded already):
every module of the port, and ``chip_smoke.py``, is imported, then none of
the forbidden modules may be in ``sys.modules``.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import importlib, pkgutil, sys
import vqa_transfer_externaldata_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
banned = ("jax", "jaxlib", "flax", "optax", "orbax",
          "vqa_transfer_externaldata_tpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), "modules")
assert len(names) >= 30, names
assert not bad, bad
assert "torch" in sys.modules
"""

SMOKE = """
import sys
import chip_smoke
banned = ("jax", "jaxlib", "flax", "optax", "orbax",
          "vqa_transfer_externaldata_tpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
assert not bad, bad
assert callable(chip_smoke.main)
print("ok")
"""


def _fresh(script: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


NEW_MODULE = """
import importlib, sys
importlib.import_module("vqa_transfer_externaldata_torch.{name}")
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "h5py", "nltk",
          "vqa_transfer_externaldata_tpu") + {extra}
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("name,extra", [
    ("data.vqa_v2", ("torch",)), ("data.visualgenome", ("torch",)),
    ("cli.preprocess", ("torch",)), ("utils.vocab", ("torch",)),
    ("data.datasets", ("torch",)), ("data.features", ("torch",)),
    ("cli.train", ()), ("cli.eval", ())])
def test_real_data_modules_import_no_jax_h5py_or_nltk(name, extra):
    """The real-data modules import neither JAX nor the optional h5py and
    nltk (imported only where an hdf5 file or WordNet is used); the
    preprocessing modules need no torch either."""
    assert "ok" in _fresh(NEW_MODULE.format(name=name, extra=repr(extra)))


@pytest.mark.parametrize("name,extra", [
    ("ops.resnet", ("PIL",)), ("models.end2end", ("PIL",)),
    ("data.ingest", ("PIL", "torch")), ("cli.extract", ("PIL", "torch")),
    ("cli.predict", ("PIL",)), ("serving", ("PIL",))])
def test_raw_image_modules_import_no_jax_pil_or_h5py(name, extra):
    """The raw-image modules import neither JAX nor PIL and h5py (PIL only
    where a file is decoded, h5py where an hdf5 store is written); the
    JPEG ingest and the extraction CLI need no torch at import either."""
    assert "ok" in _fresh(NEW_MODULE.format(name=name, extra=repr(extra)))


@pytest.mark.parametrize("name", ["tools.trace_summary", "tools.profile_step",
                                  "utils.tracing"])
def test_profiling_tools_import_no_jax(name):
    """The trace reader, the profiling tool and the profiler window import
    no JAX, h5py or nltk."""
    assert "ok" in _fresh(NEW_MODULE.format(name=name, extra="()"))


@pytest.mark.parametrize("name", ["parallel.mesh", "parallel.trainer"])
def test_multi_device_modules_import_no_jax(name):
    """The mesh and the trainer that runs on it import no JAX, h5py or
    nltk."""
    assert "ok" in _fresh(NEW_MODULE.format(name=name, extra="()"))


@pytest.mark.parametrize("name,extra", [
    ("utils.fidelity", ("torch",)), ("ops.gru", ()), ("models.zoo", ()),
    ("models.vqa_attention", ()), ("ops.attention_resident", ())])
def test_fidelity_and_float32_modules_import_no_jax(name, extra):
    """The float64 oracle imports neither JAX nor torch (it runs on the
    card's machine, which has no JAX); the TF1 GRU, the fidelity assembly
    and the float32 kernels' wrappers import no JAX, h5py or nltk."""
    assert "ok" in _fresh(NEW_MODULE.format(name=name, extra=repr(extra)))


WORKER = """
import sys
sys.path.insert(0, "tests")
import {name}
banned = ("jax", "jaxlib", "flax", "optax", "orbax",
          "vqa_transfer_externaldata_tpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("name", ["test_torch_distributed_resident",
                                  "test_torch_distributed_cli",
                                  "test_torch_distributed_tp"])
def test_multi_rank_workers_import_no_jax(name):
    """Each multi-rank test file is also its ranks' worker: imported as
    the ranks import it, it loads no JAX (its JAX imports sit inside the
    test functions)."""
    assert "ok" in _fresh(WORKER.format(name=name))


def test_port_imports_no_jax():
    assert "modules" in _fresh(SCRIPT)


def test_chip_smoke_imports_no_jax():
    assert "ok" in _fresh(SMOKE)


@pytest.mark.parametrize("name", ["ops.kernels", "ops.gru", "ops.attention",
                                  "ops.attention_resident",
                                  "parallel.trainer", "models.vlmap",
                                  "parallel.evaler", "cli.eval",
                                  "utils.checkpoint", "utils.metrics",
                                  "tools.probe_mxu_rows",
                                  "tools.probe_bwd_ceiling",
                                  "tools.trace_summary",
                                  "tools.profile_step", "utils.tracing"])
def test_importing_kernel_modules_builds_nothing(name):
    """Kernels are built on first launch only: importing the modules (as
    every CPU test does) must not look for nvcc or write a library."""
    import importlib

    from vqa_transfer_externaldata_torch.ops import kernels

    importlib.import_module(f"vqa_transfer_externaldata_torch.{name}")
    assert kernels.load.cache_info().currsize == 0


def test_md_fault_check_imports_no_jax():
    """The fault check of chip_smoke's phase 24 imports no JAX either."""
    assert "ok" in _fresh(WORKER.replace('sys.path.insert(0, "tests")\n', "")
                          .format(name="md_fault_check"))
