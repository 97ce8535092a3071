"""The launch plan and route of the float32 GRU's persistent kernels
(``csrc/gru_seq_f32.cuh``: K1f's recurrence and K3f's chain), chosen in one
place, ``ops/kernels.py::gru_f32_plan`` / ``gru_f32_route``, from the
shapes and the occupancy alone; the C side (``persist_grid``) derives the
same grid. Pure arithmetic on shapes and a reading of the sources: it runs
here on the CPU; the card tests (``tests/test_torch_kernels_cuda.py``, ``-k
f32``) hold the launches to it."""

import re

import numpy as np
import pytest

from vqa_transfer_externaldata_torch.ops import gru, kernels

UNITS, ROWS = kernels.GRU_F32_UNITS, kernels.GRU_F32_ROWS
HEADER = (kernels.CSRC / "gru_seq_f32.cuh").read_text()


def _tile(name: str) -> dict:
    """The tiling ``name`` (FwdTile, BwdTile) as gru_seq_f32.cuh declares
    it: TR rows x TU units of sums a thread, KC columns a stage, S stages,
    and the threads a block that follow from them."""
    m = re.search(rf"using {name} = Tile<(\d+), (\d+), (\d+), (\d+)>;",
                  HEADER)
    assert m, name
    tr, tu, kc, s = map(int, m.groups())
    return {"TR": tr, "TU": tu, "KC": kc, "S": s,
            "RG": ROWS // tr, "UG": UNITS // tu,
            "threads": (ROWS // tr) * (UNITS // tu)}


TILES = {False: _tile("FwdTile"), True: _tile("BwdTile")}


def _c_smem(H: int, backward: bool) -> int:
    """The block's dynamic shared memory as the header lays it out from its
    tile: U_h's slice (48 columns of H, or 16 rows of 3H, rounded up to a
    stage, 4 floats of pad a row) and S stages of 64 rows x (KC + 4)
    floats."""
    t = TILES[backward]
    depth = kernels.round_up(3 * H if backward else H, t["KC"])
    cols = UNITS if backward else 3 * UNITS
    return 4 * (cols * (depth + 4) + t["S"] * ROWS * (t["KC"] + 4))


def _fits(B: int, H: int, sms: int, per_sm: int, backward: bool) -> bool:
    """Whether a persistent launch exists: the block's shared memory within
    a block's and a row of ceil(H / 16) unit tiles resident at once."""
    jt = -(-H // UNITS)
    return (_c_smem(H, backward) <= kernels.SMEM_OPTIN
            and per_sm * sms // jt >= 1)


def _thread_coverage(backward: bool) -> np.ndarray:
    """How often the threads of a block take each (row, unit) sum of its
    64-row x 16-unit b-tile: thread (ty, tx) = (tid / UG, tid % UG) takes
    rows ty + RG i and units tx + UG e."""
    t = TILES[backward]
    seen = np.zeros((ROWS, UNITS), np.int64)
    for tid in range(t["threads"]):
        ty, tx = divmod(tid, t["UG"])
        for i in range(t["TR"]):
            for e in range(t["TU"]):
                seen[ty + t["RG"] * i, tx + t["UG"] * e] += 1
    return seen


def _coverage(plan: dict, B: int, H: int) -> np.ndarray:
    """How often the kernel's blocks take each (row, unit) in a step: block
    (jx, by) owns units 16 jx.. and walks b-tiles by, by + grid_y, ... of
    64 rows; rows past B and units past H are masked."""
    nj, gy, gz = plan["grid"]
    assert gz == 1
    seen = np.zeros((B, H), np.int64)
    for jx in range(nj):
        for by in range(gy):
            for bt in range(by, plan["b_tiles"], gy):
                seen[bt * ROWS:(bt + 1) * ROWS,
                     jx * UNITS:(jx + 1) * UNITS] += 1
    return seen


@pytest.mark.parametrize("backward", [False, True])
def test_the_header_tiles_are_the_plan_constants(backward):
    """The tiling the C side compiles (FwdTile, BwdTile) has the threads,
    stage columns and stages that ops/kernels.py plans with, and each
    thread's sums cover a 64-row x 16-unit b-tile exactly once."""
    t = TILES[backward]
    if backward:
        want = (kernels.GRU_F32_BWD_THREADS, kernels.GRU_F32_BWD_CHUNK,
                kernels.GRU_F32_BWD_STAGES)
    else:
        want = (kernels.GRU_F32_FWD_THREADS, kernels.GRU_F32_FWD_CHUNK,
                kernels.GRU_F32_FWD_STAGES)
    assert (t["threads"], t["KC"], t["S"]) == want
    assert t["RG"] * t["TR"] == ROWS and t["UG"] * t["TU"] == UNITS
    assert t["KC"] % 8 == 0 and t["S"] >= 2
    assert (_thread_coverage(backward) == 1).all()


@pytest.mark.parametrize("B", [1, 17, 63, 64, 65, 256, 300, 512])
@pytest.mark.parametrize("H", [1, 6, 15, 16, 17, 100, 101, 512, 600, 917,
                               1013, 1014, 1024, 1025, 1200])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("backward", [False, True])
def test_gru_f32_plan_takes_every_sum_once(B, H, sms, per_sm, backward):
    """Where a persistent launch fits, its grid is resident at once (at
    most sms x per_sm blocks), its unit tiles span H, its shared memory
    stays within a block's, and every (row, unit) of a step is taken by
    exactly one block (whose threads take each of its sums once:
    test_the_header_tiles_are_the_plan_constants); elsewhere the route
    takes the step form and the plan raises."""
    route = kernels.gru_f32_route(B, H, sms, per_sm, backward)
    if not _fits(B, H, sms, per_sm, backward):
        assert route == "step"
        with pytest.raises(ValueError, match="gru_f32_plan"):
            kernels.gru_f32_plan(B, H, sms, per_sm, backward)
        return
    assert route == "persistent"
    plan = kernels.gru_f32_plan(B, H, sms, per_sm, backward)
    nj, gy, gz = plan["grid"]
    assert nj == -(-H // UNITS) and gz == 1
    assert plan["b_tiles"] == -(-B // ROWS) and plan["rows"] == ROWS
    assert 1 <= gy <= plan["b_tiles"]
    assert nj * gy <= sms * per_sm
    assert plan["smem_bytes"] == _c_smem(H, backward) <= kernels.SMEM_OPTIN
    assert plan["threads"] == TILES[backward]["threads"]
    assert plan["launches"] == (4 if backward else 1)
    assert (_coverage(plan, B, H) == 1).all()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("per_sm", [0, 1, 2])
def test_gru_f32_route_is_step_exactly_where_nothing_fits(backward, sms,
                                                          per_sm):
    """Every H of 1..1200 at B of 1, 64 and 512: the route takes the step
    form exactly where the block's shared memory exceeds SMEM_OPTIN or a
    row of unit tiles cannot be resident, whatever B; the shared memory
    grows with H."""
    last = 0
    for H in range(1, 1201):
        smem = kernels.gru_f32_smem(H, backward)
        assert smem == _c_smem(H, backward) and smem >= last
        last = smem
        for B in (1, 64, 512):
            want = ("persistent" if _fits(B, H, sms, per_sm, backward)
                    else "step")
            assert kernels.gru_f32_route(B, H, sms, per_sm, backward) == want


def test_gru_f32_plan_at_the_training_shape():
    """B=256, H=512 on an H100 (132 SMs, one block an SM): 32 unit tiles x
    4 rows of blocks, one b-tile a block, for K1f (1 launch) and K3f's
    chain (4 launches a call); the widest persistent widths are 1024
    forward and 1013 for the chain, and at B=1024 the 4 rows of blocks
    walk 16 b-tiles."""
    k1 = kernels.gru_f32_plan(256, 512, 132, 1)
    k3 = kernels.gru_f32_plan(256, 512, 132, 1, backward=True)
    assert k1["grid"] == k3["grid"] == [32, 4, 1]
    assert (k1["launches"], k3["launches"]) == (1, 4)
    assert (k1["threads"], k3["threads"]) == (256, 128)
    assert kernels.gru_f32_plan(1024, 512, 132, 1)["b_tiles"] == 16
    assert kernels.gru_f32_plan(1024, 512, 132, 1)["grid"] == [32, 4, 1]
    for H, backward in ((1024, False), (1013, True)):
        assert kernels.gru_f32_route(256, H, 132, 1, backward) == "persistent"
        assert kernels.gru_f32_route(256, H + 1, 132, 1, backward) == "step"


@pytest.mark.parametrize("B,H,sms,per_sm", [
    (0, 512, 132, 1), (4, 0, 132, 1), (4, 512, 0, 1), (4, 512, 132, -1),
    (-1, 16, 1, 1)])
@pytest.mark.parametrize("backward", [False, True])
def test_gru_f32_plan_refuses_bad_arguments(B, H, sms, per_sm, backward):
    """Bad shapes raise in the route and the plan alike, and a width
    below 1 in the shared-memory formula."""
    with pytest.raises(ValueError, match="gru_f32_route"):
        kernels.gru_f32_route(B, H, sms, per_sm, backward)
    with pytest.raises(ValueError, match="gru_f32_route"):
        kernels.gru_f32_plan(B, H, sms, per_sm, backward)
    with pytest.raises(ValueError, match="gru_f32_smem"):
        kernels.gru_f32_smem(0, backward)


def test_the_launcher_refuses_an_unknown_form():
    """The private launcher's form is "persistent", "step" or None (the
    route's choice); another raises before any library is loaded."""
    for name in ("gru_fwd_f32", "gru_bwd_f32"):
        assert gru._f32_form(name, "step", 1, 1, None) == name + "_step"
        assert gru._f32_form(name, "persistent", 1, 1, None) == name
        with pytest.raises(ValueError, match="form"):
            gru._f32_form(name, "wide", 1, 1, None)


@pytest.mark.parametrize("name", ["gru_fwd_f32", "gru_bwd_f32"])
def test_k1f_and_k3f_include_the_shared_gate_math(name):
    """K1f's and K3f's sources include the persistent kernels'
    header and, through it, gru_step_f32.cuh, which holds the gate math
    (gates, cell, cell_bwd) and the step form; both forms run that math,
    K6f and K7f too. Each library exports its persistent entry, its step
    form and its launch query."""
    names = [p.name for p in kernels.sources(name)]
    assert names[:2] == [f"{name}.cu", "gru_seq_f32.cuh"]
    assert "gru_step_f32.cuh" in names and "fp32_ring.cuh" in names
    step = (kernels.CSRC / "gru_step_f32.cuh").read_text()
    for fn in ("Gates gates(", "float cell(", "Cotangents cell_bwd("):
        assert step.count(fn) == 1, fn
    assert "gru_f32::gates(" in HEADER and "gru_f32::cell(" in HEADER
    assert "gru_f32::cell_bwd(" in HEADER
    assert "cudaLaunchCooperativeKernel" in HEADER and "grid.sync()" in HEADER
    assert "Cotangents c = cell_bwd(" in step and "cell(q, hp, live)" in step
    text = (kernels.CSRC / f"{name}.cu").read_text()
    for entry in (name, f"{name}_step", f"{name}_config"):
        assert re.search(rf"^int {entry}\(", text, re.MULTILINE), entry
    for other in ("bigru_fwd_f32", "bigru_bwd_f32"):
        assert "gru_step_f32.cuh" in [p.name for p in kernels.sources(other)]
