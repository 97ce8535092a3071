"""The launch plan of the persistent GRU forward kernel
(``csrc/gru_fwd_step.cuh``: K1 with one direction, K6 with two), chosen in
one place, ``ops/kernels.py::gru_fwd_plan``, from which the wrappers take
the batch rows a block; the C side derives the grid and the launches from
them. Pure arithmetic on shapes: it runs here on the CPU; the card tests
(``tests/test_torch_kernels_cuda.py``) hold the C side to it."""

import numpy as np
import pytest

from vqa_transfer_externaldata_torch.ops import kernels

SMS = 132  # an H100 SXM's streaming multiprocessors
# Blocks resident per SM by batch rows a block, as the C side reports them
# on an H100 at H = 512 (two 16-row blocks, one 64-row block), one of each
# (H = 848), and one 16-row block where no 64-row block fits (H > 848).
H100_512 = {16: 2, 64: 1}
NARROW = {16: 1, 64: 1}
WIDE = {16: 1, 64: 0}


def _coverage(plan: dict, B: int, H: int, directions: int) -> np.ndarray:
    """How often the kernel's blocks write each (direction, row, unit) of
    [directions, B, H] in a step: launch l of block (jx, by, z) takes
    direction l * grid_z + z, owns units 16 jx.. and walks b-tiles by,
    by + grid_y, ... of ``rows`` rows, dropping rows past B."""
    units, rows = kernels.GRU_FWD_UNITS, plan["rows"]
    nj, gy, gz = plan["grid"]
    seen = np.zeros((directions, B, H), np.int64)
    for launch in range(plan["launches"]):
        for z in range(gz):
            d = launch * gz + z
            for jx in range(nj):
                for by in range(gy):
                    for bt in range(by, plan["b_tiles"], gy):
                        seen[d, bt * rows:(bt + 1) * rows,
                             jx * units:(jx + 1) * units] += 1
    return seen


@pytest.mark.parametrize("B", [1, 16, 17, 33, 64, 65, 128, 129, 256, 257,
                               1000, 1024])
@pytest.mark.parametrize("H", [16, 64, 512, 848])
@pytest.mark.parametrize("per_sm", [NARROW, H100_512, WIDE],
                         ids=["narrow", "h100", "wide"])
@pytest.mark.parametrize("directions", [1, 2])
def test_gru_fwd_plan_covers_every_tile_once(B, H, per_sm, directions):
    """Across the b-tile loop every (direction, row, unit) of the state is
    one block's exactly once a step; each launch's grid is resident at once
    (at most sms x per_sm[rows] blocks) with its j-tiles spanning H; b-tiles
    past one wave are walked, never refused; every launch together takes
    every direction once."""
    plan = kernels.gru_fwd_plan(B, H, SMS, per_sm, directions)
    nj, gy, gz = plan["grid"]
    assert plan["rows"] in kernels.GRU_FWD_ROWS
    assert per_sm[plan["rows"]] >= 1
    assert nj * kernels.GRU_FWD_UNITS == H
    assert plan["b_tiles"] == -(-B // plan["rows"])
    assert 1 <= gy <= plan["b_tiles"]
    assert gz * plan["launches"] == directions
    assert nj * gy * gz <= SMS * per_sm[plan["rows"]]
    assert (_coverage(plan, B, H, directions) == 1).all()


def test_gru_fwd_plan_at_the_main_shapes():
    """Training and evaluation at B=256, H=512: 32 j-tiles x 4 b-tiles of
    64 rows, 128 blocks on 132 SMs (one an SM). Serving at B=64 gets 128
    blocks of 16 rows, not the 32 that 64-row tiles would give; a single
    request (B=1) and `cli.predict`'s batch of 8 one row of 32; B=128 still
    takes 16 rows (256 blocks, two an SM); B=1024 walks 16 b-tiles on 4
    rows of blocks."""
    train = kernels.gru_fwd_plan(256, 512, SMS, H100_512)
    assert (train["rows"], train["grid"]) == (64, [32, 4, 1])
    serve = kernels.gru_fwd_plan(64, 512, SMS, H100_512)
    assert (serve["rows"], serve["grid"]) == (16, [32, 4, 1])
    assert serve["grid"][0] * serve["grid"][1] == 128 > 32
    for B in (1, 8):
        small = kernels.gru_fwd_plan(B, 512, SMS, H100_512)
        assert (small["rows"], small["grid"]) == (16, [32, 1, 1])
    mid = kernels.gru_fwd_plan(128, 512, SMS, H100_512)
    assert (mid["rows"], mid["grid"]) == (16, [32, 8, 1])
    big = kernels.gru_fwd_plan(1024, 512, SMS, H100_512)
    assert big["grid"] == [32, 4, 1] and big["b_tiles"] == 16
    for plan in (train, serve, small, mid, big):
        assert plan["launches"] == 1


@pytest.mark.parametrize("per_sm", [NARROW, H100_512],
                         ids=["narrow", "h100"])
def test_gru_fwd_plan_takes_fewer_rows_while_the_card_has_room(per_sm):
    """Over batches, the plan takes 16 rows a block while every 16-row
    b-tile is resident at once, and 64 rows past that: a block never reads
    more rows of h_prev a step while the smaller tile still fits."""
    for B in range(1, 1100, 7):
        plan = kernels.gru_fwd_plan(B, 512, SMS, per_sm)
        all_resident = 32 * -(-B // 16) <= SMS * per_sm[16]
        assert plan["rows"] == (16 if all_resident else 64)


@pytest.mark.parametrize("H", [864, 1024, 1568])
def test_gru_fwd_plan_past_the_64_row_tile(H):
    """Where a 64-row block's shared memory does not fit (H > 848) but a
    16-row one does (up to H = 1568), every batch takes 16-row b-tiles,
    walking them where they are more than one wave."""
    for B in (1, 64, 256, 1024):
        plan = kernels.gru_fwd_plan(B, H, SMS, WIDE)
        rows_resident = SMS // (H // 16)
        assert plan["rows"] == 16
        assert plan["grid"] == [H // 16, min(-(-B // 16), rows_resident), 1]
        assert (_coverage(plan, B, H, 1) == 1).all()


@pytest.mark.parametrize("B,H,sms,per_sm", [(0, 512, SMS, H100_512),
                                            (4, 24, SMS, H100_512),
                                            (4, 0, SMS, H100_512),
                                            (4, 512, 0, H100_512),
                                            (4, 512, SMS, {16: 0, 64: 0}),
                                            (4, 512, 16, NARROW),
                                            (4, 1584, SMS, {16: 0, 64: 0})])
@pytest.mark.parametrize("directions", [1, 2])
def test_gru_fwd_plan_refuses_what_the_kernel_does_not_take(B, H, sms,
                                                            per_sm,
                                                            directions):
    """Bad shapes raise, and so does a card on which no tiling has a row of
    one direction's j-tiles (H / 16 blocks) resident at once, as at
    H = 1584, where not even a 16-row block's shared memory fits: with two
    directions as with one."""
    with pytest.raises(ValueError, match="gru_fwd_plan"):
        kernels.gru_fwd_plan(B, H, sms, per_sm, directions)


@pytest.mark.parametrize("directions", [0, 3])
def test_gru_fwd_plan_takes_one_or_two_directions(directions):
    with pytest.raises(ValueError, match="directions"):
        kernels.gru_fwd_plan(4, 512, SMS, H100_512, directions)


def test_bigru_fwd_plan_at_the_stage1_shapes():
    """K6 at the stage-1 shape (B=256, H=512): both chains' 32 j-tiles x 2
    rows of 64-row blocks, 128 blocks on 132 SMs (one an SM), each walking
    2 of the 4 b-tiles a step, in one launch. At B=64 every 16-row b-tile
    of both directions is resident at once ([32, 4, 2], two blocks an SM);
    B=1024 walks 8 b-tiles a block."""
    stage1 = kernels.gru_fwd_plan(256, 512, SMS, H100_512, 2)
    assert stage1 == {"rows": 64, "b_tiles": 4, "grid": [32, 2, 2],
                      "launches": 1}
    b64 = kernels.gru_fwd_plan(64, 512, SMS, H100_512, 2)
    assert (b64["rows"], b64["grid"], b64["launches"]) == (16, [32, 4, 2], 1)
    big = kernels.gru_fwd_plan(1024, 512, SMS, H100_512, 2)
    assert big["grid"] == [32, 2, 2] and big["b_tiles"] == 16


@pytest.mark.parametrize("per_sm", [NARROW, H100_512],
                         ids=["narrow", "h100"])
def test_bigru_fwd_plan_counts_both_directions_for_16_rows(per_sm):
    """With two directions the 16-row rule counts every b-tile of both:
    16 rows while 2 x 32 j-tiles x every 16-row b-tile fit at once, 64
    past that."""
    for B in range(1, 1100, 7):
        plan = kernels.gru_fwd_plan(B, 512, SMS, per_sm, 2)
        all_resident = 2 * 32 * -(-B // 16) <= SMS * per_sm[16]
        assert plan["rows"] == (16 if all_resident else 64)
        assert plan["launches"] == 1 and plan["grid"][2] == 2


@pytest.mark.parametrize("H", [1072, 1248, 1408, 1568])
@pytest.mark.parametrize("B", [1, 64, 256, 1024])
def test_bigru_fwd_plan_launches_once_a_chain_at_wide_widths(B, H):
    """Past H = 1056 both directions' H / 16 j-tiles of 16-row blocks
    (one an SM) do not fit on 132 SMs, but one direction's do: the plan
    takes one direction a launch (grid z 1) and 2 launches of the same
    kernel, rather than refusing a width the one-direction kernel takes;
    each launch's grid is resident at once."""
    plan = kernels.gru_fwd_plan(B, H, SMS, WIDE, 2)
    jt = H // 16
    assert 2 * jt > SMS >= jt
    assert plan["launches"] == 2 and plan["rows"] == 16
    assert plan["grid"] == [jt, min(-(-B // 16), SMS // jt), 1]
    assert plan["grid"] == kernels.gru_fwd_plan(B, H, SMS, WIDE)["grid"]
    assert (_coverage(plan, B, H, 2) == 1).all()


@pytest.mark.parametrize("H", [864, 1024, 1056])
def test_bigru_fwd_plan_keeps_one_launch_while_both_directions_fit(H):
    """Up to H = 1056 (2 x 66 j-tiles on 132 SMs) both chains stay in one
    launch, even where that leaves one row of blocks walking every b-tile
    of the batch."""
    for B in (1, 64, 256, 1024):
        plan = kernels.gru_fwd_plan(B, H, SMS, WIDE, 2)
        jt = H // 16
        assert plan["launches"] == 1
        assert plan["grid"] == [jt, min(-(-B // 16), SMS // (2 * jt)), 2]
        assert (_coverage(plan, B, H, 2) == 1).all()


def test_gru_fwd_is_one_persistent_launch_on_mma_sync():
    """K1's and K6's libraries hold the persistent kernel of
    gru_fwd_step.cuh and the mma.sync primitives it shares with K3/K7;
    the header launches only that kernel, cooperatively (seq_run), and
    has one instance of it; the per-step kernel and WMMA are gone, and
    neither C interface launches a kernel of its own."""
    for name in ("gru_fwd", "bigru_fwd"):
        assert [p.name for p in kernels.sources(name)] == [
            f"{name}.cu", "gru_fwd_step.cuh", "mma_sync.cuh", "elem16.cuh"]
        text = (kernels.CSRC / f"{name}.cu").read_text()
        assert "seq_run<" in text and "seq_config<" in text
        assert "cudaLaunch" not in text and text.count("<<<") == 0
        assert "gru_step_kernel" not in text and "wmma" not in text
        assert "template" not in text
    header = (kernels.CSRC / "gru_fwd_step.cuh").read_text()
    assert header.count("cudaLaunchCooperativeKernel(") == 1
    assert header.count("__global__") == 1 and "<<<" not in header
    assert "gru_step_kernel" not in header and "wmma" not in header
    assert "mma.h" not in header
    # One template parameter, the element type (bf16 in K1/K6, float16 in
    # K1h): each library instantiates the kernel once.
    assert "template <class E>\n__global__" in header
    assert not any("gru_step_kernel" in p.read_text()
                   for p in kernels.CSRC.iterdir())


# Widths off 16 that K1/K6 now take, padded by the wrappers (ops/gru.py's
# gru_pad): 8, 24, 40, 100 and 600 units run at 16, 32, 48, 112 and 608.
PADDED = [kernels.round_up(H, kernels.GRU_FWD_PAD) for H in (8, 24, 40, 100,
                                                              600)]


@pytest.mark.parametrize("H", PADDED)
@pytest.mark.parametrize("B", [1, 17, 64, 256, 1024])
@pytest.mark.parametrize("directions", [1, 2])
def test_gru_fwd_plan_at_the_padded_widths(H, B, directions):
    """At the padded widths the persistent kernel plans (the route takes
    it) and its blocks take every (direction, row, unit) of the padded
    state once a step."""
    assert kernels.gru_fwd_route(B, H, SMS, H100_512, directions) == (
        "persistent")
    plan = kernels.gru_fwd_plan(B, H, SMS, H100_512, directions)
    assert plan["grid"][0] * kernels.GRU_FWD_UNITS == H
    assert (_coverage(plan, B, H, directions) == 1).all()


def _step_coverage(plan: dict, B: int, H: int) -> tuple:
    """How often the step form's forward (csrc/gru_wide_step.cuh) takes
    each (direction, row, unit) in a step for its cell, and each (direction,
    b-tile, unit tile, k) of its product: block (x, by, d) is half x % 2
    of cluster (x // 2, by, d), which owns units 40 (x // 2).. and rows
    256 by.. of direction d; the half takes k in [half split_k, (half + 1)
    split_k) of gh's sum and the cell of rows 256 by + 128 half.., dropping
    rows past B, units and k past H."""
    nx, gy, gz = plan["grid"]
    split = plan["cluster"][0]
    units, tall = kernels.GRU_STEP_UNITS, kernels.GRU_STEP_TALL
    rows = tall // split
    cell = np.zeros((gz, B, H), np.int64)
    ks = np.zeros((gz, gy, nx // split, H), np.int64)
    for d in range(gz):
        for x in range(nx):
            jx, half = divmod(x, split)
            for by in range(gy):
                r0 = by * tall + half * rows
                cell[d, r0:r0 + rows, jx * units:(jx + 1) * units] += 1
                ks[d, by, jx, half * plan["split_k"]:
                   (half + 1) * plan["split_k"]] += 1
    return cell, ks


@pytest.mark.parametrize("H", [16, 608, 1024, 1584, 2400])
@pytest.mark.parametrize("B", [1, 63, 128, 129, 256, 300])
@pytest.mark.parametrize("directions", [1, 2])
def test_gru_step_plan_forward_covers_every_tile_once(H, B, directions):
    """The step form's forward (csrc/gru_wide_step.cuh): every step's grid
    takes every (direction, row, unit) once for the cell and every k of
    each tile's product once over the cluster's two halves, in clusters of
    two along x, T launches a call; past the persistent kernel's shared
    memory (H = 1584, 2400) it is the route, as past
    kernels.GRU_FWD_STEP_ABOVE."""
    plan = kernels.gru_step_plan(26, B, H, False, directions)
    assert plan["launches"] == 26
    assert plan["grid"][2] == directions
    assert plan["cluster"] == [kernels.GRU_STEP_SPLIT, 1, 1]
    assert plan["grid"][0] % kernels.GRU_STEP_SPLIT == 0
    assert plan["split_k"] % 64 == 0 and 2 * plan["split_k"] >= H
    cell, ks = _step_coverage(plan, B, H)
    assert (cell == 1).all()
    assert (ks == 1).all()
    if H > kernels.GRU_FWD_STEP_ABOVE:
        assert kernels.gru_fwd_route(B, H, SMS, H100_512, directions) == (
            "step")
    if H > 1568:  # not even a 16-row block's U_h slice fits
        assert kernels.gru_fwd_route(B, H, SMS, {16: 0, 64: 0},
                                     directions) == "step"


@pytest.mark.parametrize("bad", [dict(H=24), dict(T=0), dict(B=0),
                                 dict(directions=3)])
def test_gru_step_plan_refuses_what_the_step_form_does_not_take(bad):
    kw = {**dict(T=4, B=4, H=32, directions=1), **bad}
    with pytest.raises(ValueError, match="gru_step_plan"):
        kernels.gru_step_plan(kw["T"], kw["B"], kw["H"], False,
                              kw["directions"])
