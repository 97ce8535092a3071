"""``chip_smoke.py`` phase 24(b)'s limits (MD_TOL_LOSS, MD_GRAD_COS) and
phase 32's float32 ones (MD_TOL_LOSS_F32, MD_GRAD_COS_F32) tell a wrong
multi-device run from a sound one: ``md_fault_check.py --device cpu`` runs
the phase's two-rank comparisons at tiny widths in float32 on gloo ranks,
sound and with each planted fault (``md_fault_check.FAULTS``), and every
sound run must pass both sets of limits while every fault fails them.
"""

import json
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_ranks as torch_ranks  # noqa: E402

sys.path.insert(0, torch_ranks.REPO)
import md_fault_check  # noqa: E402


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("md_fault_check")
    out, log = tmp / "readings.json", str(tmp / "run.log")
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "md_fault_check.py", "--device", "cpu",
             "--out", str(out)], cwd=torch_ranks.REPO,
            env=torch_ranks.rank_env(), stdout=fh, stderr=subprocess.STDOUT)
        torch_ranks.wait_all([proc], [log], timeout=400)
    with open(out) as fh:
        return json.load(fh)


@pytest.mark.parametrize("case", ["replicated", "sharded", "tp"])
def test_sound_runs_pass_the_limits(readings, case):
    assert readings[f"sound_{case}"]["passes"], readings[f"sound_{case}"]


@pytest.mark.parametrize("fault", sorted(md_fault_check.FAULTS))
def test_planted_faults_fail_the_limits(readings, fault):
    assert not readings[fault]["passes"], readings[fault]


@pytest.mark.parametrize("case", ["replicated", "sharded", "tp"])
def test_sound_runs_pass_the_float32_limits(readings, case):
    assert readings[f"sound_{case}"]["passes_float32"], \
        readings[f"sound_{case}"]


@pytest.mark.parametrize("fault", sorted(md_fault_check.FAULTS))
def test_planted_faults_fail_the_float32_limits(readings, fault):
    assert not readings[fault]["passes_float32"], readings[fault]
