"""The launch plan and route of the float32 GRU's persistent kernels
(``csrc/gru_seq_f32.cuh``: K1f's recurrence and K3f's chain, and K6f's and
K7f's, which run them on both chains of a bidirectional GRU), chosen in
one place, ``ops/kernels.py::gru_f32_plan`` / ``gru_f32_route``, from the
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
    """The tiling ``name`` (FwdTile, BwdTile, FwdPairTile) as
    gru_seq_f32.cuh declares it: TR rows x TU units of sums a thread, KC
    columns a stage, S stages, BR rows a b-tile (64 unless given), and the
    threads a block that follow from them."""
    m = re.search(rf"using {name} = Tile<(\d+), (\d+), (\d+), (\d+)"
                  rf"(?:, (\d+))?>;", HEADER)
    assert m, name
    tr, tu, kc, s = map(int, m.groups()[:4])
    br = int(m.group(5) or ROWS)
    return {"TR": tr, "TU": tu, "KC": kc, "S": s, "BR": br,
            "RG": br // tr, "UG": UNITS // tu,
            "threads": (br // tr) * (UNITS // tu)}


TILES = {False: _tile("FwdTile"), True: _tile("BwdTile")}
PAIR = _tile("FwdPairTile")  # K6f's 128-row b-tiles


def _c_smem(H: int, backward: bool, tile: dict = None) -> int:
    """The block's dynamic shared memory as the header lays it out from its
    tile (``tile``, else FwdTile or BwdTile): U_h's slice (48 columns of
    H, or 16 rows of 3H, rounded up to a stage, 4 floats of pad a row) and
    S stages of BR rows x (KC + 4) floats."""
    t = tile or TILES[backward]
    depth = kernels.round_up(3 * H if backward else H, t["KC"])
    cols = UNITS if backward else 3 * UNITS
    return 4 * (cols * (depth + 4) + t["S"] * t["BR"] * (t["KC"] + 4))


def _fits(B: int, H: int, sms: int, per_sm: int, backward: bool,
          chains: int = 1) -> bool:
    """Whether a persistent launch of ``chains`` chains exists: the block's
    shared memory within a block's and a row of ceil(H / 16) unit tiles of
    each of the chains resident at once."""
    jt = -(-H // UNITS)
    return (_c_smem(H, backward) <= kernels.SMEM_OPTIN
            and per_sm * sms // (chains * jt) >= 1)


def _thread_coverage(backward: bool, tile: dict = None) -> np.ndarray:
    """How often the threads of a block take each (row, unit) sum of its
    BR-row x 16-unit b-tile: thread (ty, tx) = (tid / UG, tid % UG) takes
    rows ty + RG i and units tx + UG e."""
    t = tile or TILES[backward]
    seen = np.zeros((t["BR"], UNITS), np.int64)
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
    return _chain_coverage(plan, B, H, 1)[0]


def _chain_coverage(plan: dict, B: int, H: int,
                    directions: int) -> np.ndarray:
    """How often the launches of a call take each (direction, row, unit) in
    a step: with grid z = directions, one launch whose block (jx, by, d)
    owns direction d's units 16 jx.. and walks its b-tiles by, by +
    grid_y, ... (of plan["rows"] rows); with z = 1, one such launch a
    direction (the C side's persist_launch puts the chain in c[0] and
    c[1])."""
    nj, gy, gz = plan["grid"]
    rows = plan["rows"]
    seen = np.zeros((directions, B, H), np.int64)
    for launch in range(directions // gz):
        for d in range(gz):
            chain = launch if gz == 1 else d
            for jx in range(nj):
                for by in range(gy):
                    for bt in range(by, plan["b_tiles"], gy):
                        seen[chain, bt * rows:(bt + 1) * rows,
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


def test_the_k6f_pair_tile_is_the_plan_constants():
    """K6f's 128-row tiling (FwdPairTile) keeps FwdTile's threads, stage
    columns and stages, takes GRU_F32_PAIR_ROWS rows (8 rows x one unit's
    3 gates a thread), each thread's sums cover its 128-row x 16-unit
    b-tile exactly once, and its shared memory is gru_f32_smem's at those
    rows at every width."""
    t = TILES[False]
    assert (PAIR["threads"], PAIR["KC"], PAIR["S"], PAIR["TU"]) == (
        t["threads"], t["KC"], t["S"], t["TU"])
    assert PAIR["BR"] == kernels.GRU_F32_PAIR_ROWS == 2 * ROWS
    assert PAIR["TR"] == 2 * t["TR"]
    assert (_thread_coverage(False, PAIR) == 1).all()
    for H in range(1, 1201):
        assert kernels.gru_f32_smem(H, False, 128) == _c_smem(H, False, PAIR)
    assert kernels.gru_f32_smem(832, False, 128) <= kernels.SMEM_OPTIN
    assert kernels.gru_f32_smem(833, False, 128) > kernels.SMEM_OPTIN


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


@pytest.mark.parametrize("B", [1, 17, 63, 64, 65, 256, 300, 512])
@pytest.mark.parametrize("H", [1, 6, 15, 16, 17, 100, 101, 512, 600, 917,
                               1013, 1014, 1024, 1025, 1200])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("per_sm_pair", [0, 1])
@pytest.mark.parametrize("backward", [False, True])
def test_bigru_f32_plan_takes_every_sum_once(B, H, sms, per_sm, per_sm_pair,
                                             backward):
    """K6f and K7f's chains (directions 2): where a persistent launch of
    both chains fits, one launch on a grid 2 deep; where only one chain's
    row of unit tiles fits, one launch a chain on a grid 1 deep; K6f on
    128-row b-tiles (``per_sm_pair`` of their blocks resident per SM)
    exactly where their block fits with the same grid depth and a block's
    walk over them is no longer than over twice as many 64-row b-tiles;
    every grid resident at once (at most sms x blocks per SM), its shared
    memory within a block's, and every (direction, row, unit) of a step
    taken by exactly one block of one launch; the launches a call (K6f 1
    or 2, K7f 4 or 5) follow. Elsewhere the route takes the step form and
    the plan raises."""
    route = kernels.gru_f32_route(B, H, sms, per_sm, backward, 2)
    if not _fits(B, H, sms, per_sm, backward):
        assert route == "step"
        with pytest.raises(ValueError, match="gru_f32_plan"):
            kernels.gru_f32_plan(B, H, sms, per_sm, backward, 2, per_sm_pair)
        return
    assert route == "persistent"
    plan = kernels.gru_f32_plan(B, H, sms, per_sm, backward, 2, per_sm_pair)
    nj, gy, gz = plan["grid"]
    assert gz == (2 if _fits(B, H, sms, per_sm, backward, 2) else 1)
    jt = -(-H // UNITS)
    walk = -(-(-(-B // ROWS)) // min(-(-B // ROWS), per_sm * sms // (gz * jt)))
    pair_resident = per_sm_pair * sms // (gz * jt)
    pair = (not backward and pair_resident >= 1
            and _c_smem(H, False, PAIR) <= kernels.SMEM_OPTIN
            and 2 * -(-(-(-B // 128)) // min(-(-B // 128), pair_resident))
            <= walk)
    tile = PAIR if pair else TILES[backward]
    assert plan["rows"] == tile["BR"] == (128 if pair else ROWS)
    assert nj == jt and 1 <= gy <= plan["b_tiles"]
    assert plan["b_tiles"] == -(-B // plan["rows"])
    assert nj * gy * gz <= sms * (per_sm_pair if pair else per_sm)
    assert plan["smem_bytes"] == _c_smem(H, backward, tile)
    assert plan["smem_bytes"] <= kernels.SMEM_OPTIN
    assert plan["threads"] == tile["threads"]
    chain_launches = 2 // gz
    assert plan["launches"] == (3 + chain_launches if backward
                                else chain_launches)
    assert (_chain_coverage(plan, B, H, 2) == 1).all()
    # One chain a launch takes the same grid as K1f / K3f's.
    one = kernels.gru_f32_plan(B, H, sms, per_sm, backward)
    if gz == 1:
        assert plan["grid"] == one["grid"]


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


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("per_sm", [0, 1, 2])
def test_bigru_f32_route_takes_both_chains_then_one_then_the_step_form(
        backward, sms, per_sm):
    """Every H of 1..1200 at B of 1, 64 and 512 with two directions: the
    plan takes both chains in one launch exactly where a row of both
    chains' unit tiles is resident at once, else one launch a chain exactly
    where one chain's is, else the route takes the step form; each form
    only where the one before it does not fit, whatever B."""
    seen = set()
    for H in range(1, 1201):
        for B in (1, 64, 512):
            route = kernels.gru_f32_route(B, H, sms, per_sm, backward, 2)
            if _fits(B, H, sms, per_sm, backward, 2):
                want = 2
            elif _fits(B, H, sms, per_sm, backward, 1):
                want = 1
            else:
                assert route == "step"
                seen.add(0)
                continue
            assert route == "persistent"
            assert kernels.gru_f32_plan(B, H, sms, per_sm, backward,
                                        2)["grid"][2] == want
            seen.add(want)
    if per_sm == 0:
        assert seen == {0}
    elif sms == 132:  # a full H100: shared memory ends before residency
        assert seen == {0, 2}
    elif sms == 16:
        assert seen == {0, 1, 2}


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


def test_bigru_f32_plan_at_the_training_shape():
    """Stage 1's shape, B=256, H=512 on an H100 (132 SMs, one block an SM)
    with two directions: 32 unit tiles x 2 rows of blocks x 2 chains, each
    block walking 2 of the 4 b-tiles a step; K6f 1 launch and K7f 4 a call.
    A row of both chains fits up to 66 unit tiles (H = 1056), past the
    widths whose shared memory K1f's and K3f's kernels take (1024 forward,
    1013 backward), so on an H100 the route goes from both chains a launch
    to the step form; on 48 SMs at H = 512 one chain's 32 unit tiles fit
    and both do not: one launch a chain (K6f 2, K7f 5). K6f takes 128-row
    b-tiles (one a block a step) where it would walk two of 64 rows and
    their block fits (up to 832 units)."""
    k6 = kernels.gru_f32_plan(256, 512, 132, 1, False, 2, 1)
    k7 = kernels.gru_f32_plan(256, 512, 132, 1, True, 2, 1)
    assert k6["grid"] == k7["grid"] == [32, 2, 2]
    assert (k6["rows"], k6["b_tiles"], k7["rows"], k7["b_tiles"]) == (
        128, 2, 64, 4)
    assert (k6["launches"], k7["launches"]) == (1, 4)
    assert (k6["threads"], k7["threads"]) == (256, 128)
    # Without the 128-row tiling's blocks, and where a block walks one
    # 64-row b-tile a step (B = 128), K6f keeps 64-row b-tiles.
    assert kernels.gru_f32_plan(256, 512, 132, 1, False, 2)["rows"] == 64
    assert kernels.gru_f32_plan(128, 512, 132, 1, False, 2, 1)["rows"] == 64
    # Past 832 units the 128-row block's shared memory does not fit.
    assert kernels.gru_f32_plan(256, 832, 132, 1, False, 2, 1)["rows"] == 128
    assert kernels.gru_f32_plan(256, 833, 132, 1, False, 2, 1)["rows"] == 64
    for H, backward in ((1024, False), (1013, True)):
        assert kernels.gru_f32_plan(256, H, 132, 1, backward,
                                    2)["grid"][2] == 2
        assert kernels.gru_f32_route(256, H + 1, 132, 1, backward,
                                     2) == "step"
    # On 64 SMs at H = 512: one chain's 32 unit tiles fit, both do not.
    k6 = kernels.gru_f32_plan(256, 512, 48, 1, False, 2)
    k7 = kernels.gru_f32_plan(256, 512, 48, 1, True, 2)
    assert k6["grid"] == k7["grid"] == [32, 1, 1]
    assert kernels.gru_f32_plan(256, 512, 48, 1, False, 2, 1)["grid"] == [
        32, 1, 1]
    assert (k6["launches"], k7["launches"]) == (2, 5)


@pytest.mark.parametrize("directions", [1, 2])
@pytest.mark.parametrize("backward", [False, True])
def test_gru_f32_launches_follow_the_route(directions, backward):
    """On an H100 (132 SMs, one block an SM) at B=256 and T = 1, 2 and 26:
    the persistent form's launches at H = 512 (K1f and K6f 1, K3f and K7f
    4, at any T), the step form's past the widest persistent width, at
    2400 too (T forward; backward T + 4: the lists, gh, T carries, dU_h
    and db_hn, one chain or two); T = 0 raises."""
    at = (132, 1, backward, directions)
    widest = 1013 if backward else 1024
    for T in (1, 2, 26):
        assert kernels.gru_f32_launches(T, 256, 512, *at) == (
            kernels.gru_f32_plan(256, 512, *at)["launches"]) == (
            4 if backward else 1)
        assert kernels.gru_f32_launches(T, 256, widest, *at) == (
            4 if backward else 1)
        for H in (widest + 1, 2400):
            assert kernels.gru_f32_route(256, H, *at) == "step"
            assert kernels.gru_f32_launches(T, 256, H, *at) == (
                T + 4 if backward else T)
    assert kernels.GRU_F32_STEP_BWD_LAUNCHES == 4
    with pytest.raises(ValueError):
        kernels.gru_f32_launches(0, 256, 512, *at)


@pytest.mark.parametrize("directions", [0, 3])
@pytest.mark.parametrize("backward", [False, True])
def test_gru_f32_plan_refuses_other_directions(directions, backward):
    """One chain (K1f, K3f) or two (K6f, K7f): any other count raises in
    the route and the plan."""
    with pytest.raises(ValueError, match="gru_f32_route"):
        kernels.gru_f32_route(256, 512, 132, 1, backward, directions)
    with pytest.raises(ValueError, match="gru_f32_route"):
        kernels.gru_f32_plan(256, 512, 132, 1, backward, directions)


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
    """The private launcher's form is "persistent", "step", for K6f and K7f
    also "per_chain" (the persistent kernels, one launch a chain), for K6f
    "persistent64" (both chains a launch on 64-row b-tiles), or None (the
    route's choice); another raises before any library is loaded."""
    for name in ("gru_fwd_f32", "gru_bwd_f32", "bigru_fwd_f32",
                 "bigru_bwd_f32"):
        assert gru._f32_form(name, "step", 1, 1, None) == name + "_step"
        assert gru._f32_form(name, "persistent", 1, 1, None) == name
        with pytest.raises(ValueError, match="form"):
            gru._f32_form(name, "wide", 1, 1, None)
        if name.startswith("bigru"):
            assert gru._f32_form(name, "per_chain", 1, 1, None) == name
        else:
            with pytest.raises(ValueError, match="form"):
                gru._f32_form(name, "per_chain", 1, 1, None)
        if name == "bigru_fwd_f32":
            assert gru._f32_form(name, "persistent64", 1, 1, None) == name
        else:
            with pytest.raises(ValueError, match="form"):
                gru._f32_form(name, "persistent64", 1, 1, None)
    assert set(gru._F32_KINDS) == {n for n in gru._F32_ARGS
                                   if not n.endswith("_step")}


@pytest.mark.parametrize("name", ["gru_fwd_f32", "gru_bwd_f32"])
def test_k1f_and_k3f_include_the_shared_gate_math(name):
    """K1f's and K3f's sources include the persistent kernels'
    header and, through it, gru_step_f32.cuh, which holds the gate math
    (gates, cell, cell_bwd) and the forward step form; the BPTT's step
    form (gru_bptt_f32.cuh) runs cell_bwd in its carry's epilogue; both
    forms run that math, K6f and K7f too. Each library exports its
    persistent entry, its step form and its launch query."""
    names = [p.name for p in kernels.sources(name)]
    assert names[:2] == [f"{name}.cu", "gru_seq_f32.cuh"]
    assert "gru_step_f32.cuh" in names and "fp32_ring.cuh" in names
    step = (kernels.CSRC / "gru_step_f32.cuh").read_text()
    for fn in ("Gates gates(", "float cell(", "Cotangents cell_bwd("):
        assert step.count(fn) == 1, fn
    assert "gru_f32::gates(" in HEADER and "gru_f32::cell(" in HEADER
    assert "gru_f32::cell_bwd(" in HEADER
    assert "cudaLaunchCooperativeKernel" in HEADER and "grid.sync()" in HEADER
    bptt = (kernels.CSRC / "gru_bptt_f32.cuh").read_text()
    assert "gru_f32::cell_bwd(q, hp, d, true)" in bptt
    assert "cell(q, hp, live)" in step and "cell_bwd(q" not in step
    text = (kernels.CSRC / f"{name}.cu").read_text()
    for entry in (name, f"{name}_step", f"{name}_config"):
        assert re.search(rf"^int {entry}\(", text, re.MULTILINE), entry
    for other in ("bigru_fwd_f32", "bigru_bwd_f32"):
        assert "gru_step_f32.cuh" in [p.name for p in kernels.sources(other)]


@pytest.mark.parametrize("name", ["bigru_fwd_f32", "bigru_bwd_f32"])
def test_k6f_and_k7f_run_the_persistent_kernels_of_k1f_and_k3f(name):
    """K6f's and K7f's sources include the persistent kernels' header
    (gru_seq_f32.cuh: K1f's recurrence and K3f's gh, chain and their
    launch helpers, with the chain on blockIdx.z) and, through it, the
    ring and the step form's gate math; each library exports its
    persistent entry, its step form and its launch query, and asks the
    helpers for two chains."""
    names = [p.name for p in kernels.sources(name)]
    twin = [p.name for p in kernels.sources(name.replace("bigru_", "gru_"))]
    assert names[0] == f"{name}.cu" and names[1:] == twin[1:]
    assert names[1] == "gru_seq_f32.cuh" and "fp32_ring.cuh" in names
    text = (kernels.CSRC / f"{name}.cu").read_text()
    for entry in (name, f"{name}_step", f"{name}_config"):
        assert re.search(rf"^int {entry}\(", text, re.MULTILINE), entry
    kernel = ("gru_f32_seq_kernel" if "fwd" in name
              else "gru_f32_bptt_kernel")
    assert f"gru_seq_f32::{kernel}" in text
    assert "persist_launch<" in text and "persist_config<" in text
    assert "blockIdx.z == 0 ? a.c[0] : a.c[1]" in HEADER
    if "bwd" in name:
        assert "gh_launch(" in text and "duh_launch(" in text
        assert "dbhn_launch(" in text


# The float32 BPTT's step form (csrc/gru_bptt_f32.cuh): its lists launch,
# mirrored here round by round as the C kernel ranks its rows, and the
# carry launch's tiling.
BPTT = (kernels.CSRC / "gru_bptt_f32.cuh").read_text()


def _bptt_const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", BPTT)
    assert m, name
    return int(eval(m.group(1), {}, {k: _bptt_const(k) for k in re.findall(
        r"[A-Z][A-Z_]*", m.group(1))}))


def _c_lists(lens: np.ndarray, T: int) -> dict:
    """gru_f32_lists_kernel's writes, block t as the C side computes them:
    the sums over clamped lengths, then ranks in rounds of LIST_THREADS
    rows, warp ballots counted before each warp's lane."""
    threads = _bptt_const("LIST_THREADS")
    B = len(lens)
    rows = np.full((T, B), -1)
    steps = np.full(max(T - 1, 1) * B, -1)
    cnt, m = np.zeros(T, int), 0
    clamp = np.maximum(lens, 0)
    for t in range(T):
        p, n, n0 = np.minimum(clamp, t).sum(), (clamp > t).sum(), (
            clamp > 0).sum()
        cnt[t] = n
        if t == T - 1:
            m = np.minimum(clamp, T).sum() - n0
        live_before = dead_before = 0
        for b0 in range(0, B, threads):
            chunk = np.arange(b0, min(b0 + threads, B))
            live = lens[chunk] > t
            ranks = np.cumsum(live) - live  # live rows of the round before b
            for k, b in enumerate(chunk):
                if live[k]:
                    j = live_before + ranks[k]
                    rows[t, j] = b
                    if t >= 1:
                        steps[p - n0 + j] = (t - 1) * B + b
                else:
                    rows[t, n + dead_before + k - ranks[k]] = b
            live_before += live.sum()
            dead_before += len(chunk) - live.sum()
    return {"rows": rows, "cnt": cnt, "rowsteps": steps[:m], "m": m}


@pytest.mark.parametrize("T", [1, 2, 5, 26])
@pytest.mark.parametrize("B", [1, 2, 63, 256, 300, 513])
@pytest.mark.parametrize("kind", ["uniform", "all", "one", "wild"])
def test_gru_f32_step_lists_take_every_live_row_step_once(T, B, kind):
    """The step form's lists (``kernels.gru_f32_step_lists``, the C
    kernel's rounds mirrored in ``_c_lists``) on lengths from a seeded
    generator: step t's rows are a permutation of the batch, its live rows
    (t < lens[b]) first in ascending b, then its dead ones; the packed
    list takes every live row-step whose h_prev is not zero exactly once
    and no other, in ascending order, for either chain (forward: b live at
    step t >= 1, h_prev hseq[t - 1]; reverse: b live at step t + 1, so at
    t too, h_prev hseq[t + 1]); the buffer's size is the C side's."""
    rng = np.random.default_rng(T * 1000 + B)
    lens = {"uniform": rng.integers(1, T + 1, B),
            "all": np.full(B, T),
            "one": np.where(np.arange(B) == B // 2, T, 1),
            "wild": rng.integers(-2, T + 3, B)}[kind]
    got = kernels.gru_f32_step_lists(lens, T)
    c = _c_lists(lens, T)
    for key in ("rows", "cnt", "rowsteps", "m"):
        assert np.array_equal(got[key], c[key]), key
    live = np.arange(T)[:, None] < lens[None, :]
    for t in range(T):
        n = got["cnt"][t]
        assert n == live[t].sum()
        assert sorted(got["rows"][t]) == list(range(B))
        assert list(got["rows"][t][:n]) == list(np.flatnonzero(live[t]))
        assert list(got["rows"][t][n:]) == list(np.flatnonzero(~live[t]))
    forward = [(t - 1) * B + b for t in range(1, T) for b in range(B)
               if live[t, b]]
    reverse = [t * B + b for t in range(T - 1) for b in range(B)
               if live[t, b] and live[t + 1, b]]
    assert list(got["rowsteps"]) == forward == reverse
    assert got["m"] == len(forward) == got["cnt"][1:].sum()
    assert kernels.gru_f32_lists_ints(T, B) == (
        T * B + T + max(T - 1, 1) * B + 1)
    assert "static_cast<long long>(T > 1 ? T - 1 : 1) * B;" in BPTT


def test_the_bptt_header_is_the_carry_plan():
    """The carry's tiling in gru_bptt_f32.cuh is the plan's constants: 128
    threads of 4 unit lanes, passes of 32 row groups x 8 rows, 32-k
    stages, 2 of a whole pass, rows padded to 36 floats, the units a thread
    that its instances take, its shared memory formula (two blocks an SM)
    and the ring's stages at each pass height."""
    assert _bptt_const("THREADS") == kernels.GRU_F32_CARRY_THREADS
    assert _bptt_const("UL") == kernels.GRU_F32_CARRY_LANES
    assert _bptt_const("RB") == kernels.GRU_F32_CARRY_PASS
    assert _bptt_const("TR") * _bptt_const("RG") == _bptt_const("RB")
    assert _bptt_const("KC") == kernels.GRU_F32_CARRY_CHUNK
    assert _bptt_const("S") == kernels.GRU_F32_CARRY_STAGES
    assert _bptt_const("P") == kernels.GRU_F32_CARRY_CHUNK + 4
    cases = [int(x) for x in re.findall(r"case (\d+):\s+return f\(",
                                        BPTT)]
    assert tuple(cases) == kernels.GRU_F32_CARRY_UNITS
    assert _bptt_const("MAX_TU") == max(kernels.GRU_F32_CARRY_UNITS)
    assert "__launch_bounds__(THREADS, 2)" in BPTT
    assert "const int trn = V16 ? (nr + RG - 1) / RG : TR;" in BPTT
    assert [kernels.gru_f32_carry_pass(n) for n in (1, 32, 33, 256)] == [
        (32, 1), (32, 1), (32, 2), (32, 8)]
    assert "RING = S * (RB + UL * MAX_TU) * P;" in BPTT
    assert "return RB * 8 + RING * 4;" in BPTT
    smem = kernels.gru_f32_carry_smem()
    assert smem % 16 == 0
    assert 2 * (smem + kernels.F32_RING_BLOCK_RESERVED) <= (
        kernels.F32_RING_SMEM_PER_SM)
    assert "return RING / ((rows + UL * MAX_TU) * P);" in BPTT
    assert [kernels.gru_f32_carry_stages(32 * r) for r in range(1, 9)] == [
        10, 6, 4, 3, 3, 2, 2, 2]
    ring = _bptt_const("RING")
    for rows in range(1, 257):  # the stages fit in the ring, 2 at least
        n = kernels.gru_f32_carry_stages(rows)
        assert n >= _bptt_const("S")
        assert n * (rows + 20) * _bptt_const("P") <= ring
    with pytest.raises(ValueError, match="rows"):
        kernels.gru_f32_carry_stages(257)
    with pytest.raises(ValueError, match="rows"):
        kernels.gru_f32_carry_pass(0)


@pytest.mark.parametrize("B", [1, 8, 63, 256, 300])
@pytest.mark.parametrize("H", [1, 6, 100, 101, 512, 1100, 2400, 4000])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("directions", [1, 2])
def test_gru_f32_carry_plan_takes_every_live_sum_once(B, H, sms,
                                                      directions):
    """Each carry launch takes every (chain, live row, unit) of its step
    exactly once, at every live count n of the step: block (jx, 0, d) owns
    units 4 TU jx .. of chain d; its passes of 256 list positions give
    thread (ty, tx) the rows ty + 32 i (i below the pass's rows a thread,
    the fewest that cover it) and the units tx + 4 e; units past H and
    positions past n are masked; every pass's staged rows have their
    stages. TU is the plan's pick of the instances, the one whose busiest
    SM takes the least time (the narrower on a tie)."""
    plan = kernels.gru_f32_carry_plan(B, H, sms, directions)
    tu, lanes = plan["units"], kernels.GRU_F32_CARRY_LANES
    assert tu in kernels.GRU_F32_CARRY_UNITS
    assert plan["grid"] == [-(-H // (lanes * tu)), 1, directions]
    assert plan["smem_bytes"] == kernels.gru_f32_carry_smem()
    assert plan["threads"] == kernels.GRU_F32_CARRY_THREADS

    def cost(u):
        blocks = directions * -(-H // (lanes * u))
        return -(-blocks // sms) * u

    best = min(cost(u) for u in kernels.GRU_F32_CARRY_UNITS)
    assert cost(tu) == best and all(
        u > tu for u in kernels.GRU_F32_CARRY_UNITS
        if cost(u) == best and u != tu)
    groups = plan["threads"] // lanes
    for n in sorted({0, 1, min(B, groups), min(B, groups + 1), min(B, 129),
                     B}):
        seen = np.zeros((n, H), np.int64)
        for jx in range(plan["grid"][0]):
            for p0 in range(0, n, kernels.GRU_F32_CARRY_PASS):
                nr = min(kernels.GRU_F32_CARRY_PASS, n - p0)
                rg, trn = kernels.gru_f32_carry_pass(nr)
                assert rg == groups and trn * rg >= nr > (trn - 1) * rg
                assert trn * rg in plan["stages"]
                for tid in range(plan["threads"]):
                    ty, tx = divmod(tid, lanes)
                    for i in range(trn):
                        j = p0 + ty + rg * i
                        if j >= n:
                            continue
                        for e in range(tu):
                            u = jx * lanes * tu + tx + lanes * e
                            if u < H:
                                seen[j, u] += 1
        assert (seen == 1).all(), (n, H)
    assert kernels.gru_f32_carry_plan(256, 2400, 132, 2)["grid"] == [
        120, 1, 2]
    with pytest.raises(ValueError, match="gru_f32_carry_plan"):
        kernels.gru_f32_carry_plan(B, H, sms, 3)
