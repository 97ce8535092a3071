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


@pytest.mark.parametrize("name", ["data.native", "data.grain_loader",
                                  "data.ingest", "data.features"])
def test_input_modules_import_no_jax_grain_or_pil(name):
    """The native IO bindings and the grain pipeline import neither JAX,
    grain, PIL nor torch: grain is imported where a pipeline is built,
    PIL where a file is decoded."""
    assert "ok" in _fresh(NEW_MODULE.format(
        name=name, extra=repr(("grain", "PIL", "torch"))))


BUILDS_NOTHING = """
import importlib
for name in ("data.native", "data.ingest", "data.features",
             "data.grain_loader", "cli.predict", "cli.train"):
    importlib.import_module("vqa_transfer_externaldata_torch." + name)
from vqa_transfer_externaldata_torch.data import native
assert native._loaded == {}, native._loaded
print("ok")
"""


def test_importing_input_modules_builds_nothing():
    """The native libraries are built at first use only: importing the
    modules that use them loads and compiles nothing."""
    assert "ok" in _fresh(BUILDS_NOTHING)


def _imported_modules(path):
    """Every module a Python file imports: its import statements and the
    constant names it passes to ``importlib.import_module``,
    ``__import__`` or ``importlib.util.find_spec``."""
    import ast

    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            func = node.func
            name = getattr(func, "attr", getattr(func, "id", ""))
            if name in ("import_module", "__import__", "find_spec"):
                yield node.args[0].value


def test_port_sources_name_no_jax_module():
    """No Python file of the port, ``chip_smoke.py`` or
    ``md_fault_check.py`` imports or looks up JAX, its libraries or the
    JAX package, on any path, also those a fresh import does not take
    (functions that import where they run)."""
    banned = ("jax", "jaxlib", "flax", "optax", "orbax",
              "vqa_transfer_externaldata_tpu")
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "md_fault_check.py")]
    for root, _, names in os.walk(os.path.join(
            REPO, "vqa_transfer_externaldata_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    bad = sorted((os.path.relpath(f, REPO), m) for f in files
                 for m in _imported_modules(f)
                 if m.split(".")[0] in banned)
    assert not bad, bad


GRAIN_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None  # the card's machine: grain without JAX
import numpy as np
from vqa_transfer_externaldata_torch.data.datasets import ArrayDataset
from vqa_transfer_externaldata_torch.data.grain_loader import (
    GrainTrainIterator)
ds = ArrayDataset({"answer_id": np.arange(10, dtype=np.int32),
                   "q_ids": np.arange(30, dtype=np.int32).reshape(10, 3)})
it = GrainTrainIterator(ds, batch_size=4, seed=0)
a, b = next(it), next(it)
assert a["q_ids"].shape == (4, 3) and b["answer_id"].shape == (4,)
assert not set(a["answer_id"].tolist()) & set(b["answer_id"].tolist())
assert it.get_state() == {"next_index": 2}, it.get_state()
banned = ("jax", "jaxlib", "flax", "optax", "vqa_transfer_externaldata_tpu")
bad = sorted(m for m, mod in sys.modules.items()
             if m.split(".")[0] in banned and mod is not None)
assert not bad, bad
assert "grain" in sys.modules
print("ok")
"""


def test_grain_pipeline_runs_with_jax_blocked():
    """grain 0.2.15 imports JAX's tree utilities where JAX is installed
    (``grain/_src/core/tree_lib.py``) and falls back to dm-tree where it
    is not: with JAX blocked the port's iterator draws its batches, so
    JAX is grain's optional import, never the port's. (grain also loads a
    few pure-Python modules of orbax's checkpoint package; they need no
    JAX.)"""
    assert "ok" in _fresh(GRAIN_WITHOUT_JAX)
