"""The launch plan of K1's persistent kernel (``csrc/gru_fwd.cu``), chosen
in one place, ``ops/kernels.py::gru_fwd_plan``, from which the wrapper takes
the batch rows a block; the C side derives the grid from them. Pure
arithmetic on shapes: it runs here on the CPU; the card tests
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


def _coverage(plan: dict, B: int, H: int) -> np.ndarray:
    """How often the kernel's blocks write each (row, unit) of [B, H] in a
    step: block (jx, by) owns units 16 jx.. and walks b-tiles by,
    by + grid_y, ... of ``rows`` rows, dropping rows past B."""
    units, rows = kernels.GRU_FWD_UNITS, plan["rows"]
    nj, gy = plan["grid"]
    seen = np.zeros((B, H), np.int64)
    for jx in range(nj):
        for by in range(gy):
            for bt in range(by, plan["b_tiles"], gy):
                seen[bt * rows:(bt + 1) * rows, jx * units:(jx + 1) * units] \
                    += 1
    return seen


@pytest.mark.parametrize("B", [1, 16, 17, 33, 64, 65, 128, 129, 256, 257,
                               1000, 1024])
@pytest.mark.parametrize("H", [16, 64, 512, 848])
@pytest.mark.parametrize("per_sm", [NARROW, H100_512, WIDE],
                         ids=["narrow", "h100", "wide"])
def test_gru_fwd_plan_covers_every_tile_once(B, H, per_sm):
    """Across the b-tile loop every (row, unit) of the state is one block's
    exactly once a step; the grid is resident at once (at most sms x
    per_sm[rows] blocks) with its j-tiles spanning H; b-tiles past one wave
    are walked, never refused."""
    plan = kernels.gru_fwd_plan(B, H, SMS, per_sm)
    nj, gy = plan["grid"]
    assert plan["rows"] in kernels.GRU_FWD_ROWS
    assert per_sm[plan["rows"]] >= 1
    assert nj * kernels.GRU_FWD_UNITS == H
    assert plan["b_tiles"] == -(-B // plan["rows"])
    assert 1 <= gy <= plan["b_tiles"]
    assert nj * gy <= SMS * per_sm[plan["rows"]]
    assert (_coverage(plan, B, H) == 1).all()


def test_gru_fwd_plan_at_the_main_shapes():
    """Training and evaluation at B=256, H=512: 32 j-tiles x 4 b-tiles of
    64 rows, 128 blocks on 132 SMs (one an SM). Serving at B=64 gets 128
    blocks of 16 rows, not the 32 that 64-row tiles would give; a single
    request (B=1) and `cli.predict`'s batch of 8 one row of 32; B=128 still
    takes 16 rows (256 blocks, two an SM); B=1024 walks 16 b-tiles on 4
    rows of blocks."""
    train = kernels.gru_fwd_plan(256, 512, SMS, H100_512)
    assert (train["rows"], train["grid"]) == (64, [32, 4])
    serve = kernels.gru_fwd_plan(64, 512, SMS, H100_512)
    assert (serve["rows"], serve["grid"]) == (16, [32, 4])
    assert serve["grid"][0] * serve["grid"][1] == 128 > 32
    for B in (1, 8):
        small = kernels.gru_fwd_plan(B, 512, SMS, H100_512)
        assert (small["rows"], small["grid"]) == (16, [32, 1])
    mid = kernels.gru_fwd_plan(128, 512, SMS, H100_512)
    assert (mid["rows"], mid["grid"]) == (16, [32, 8])
    big = kernels.gru_fwd_plan(1024, 512, SMS, H100_512)
    assert big["grid"] == [32, 4] and big["b_tiles"] == 16


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
        assert plan["grid"] == [H // 16, min(-(-B // 16), rows_resident)]
        assert (_coverage(plan, B, H) == 1).all()


@pytest.mark.parametrize("B,H,sms,per_sm", [(0, 512, SMS, H100_512),
                                            (4, 24, SMS, H100_512),
                                            (4, 0, SMS, H100_512),
                                            (4, 512, 0, H100_512),
                                            (4, 512, SMS, {16: 0, 64: 0}),
                                            (4, 512, 16, NARROW),
                                            (4, 1584, SMS, {16: 0, 64: 0})])
def test_gru_fwd_plan_refuses_what_the_kernel_does_not_take(B, H, sms,
                                                            per_sm):
    """Bad shapes raise, and so does a card on which no tiling has a row of
    j-tiles (H / 16 blocks) resident at once, as at H = 1584, where not
    even a 16-row block's shared memory fits."""
    with pytest.raises(ValueError, match="gru_fwd_plan"):
        kernels.gru_fwd_plan(B, H, sms, per_sm)


def test_gru_fwd_is_one_persistent_launch_on_mma_sync():
    """K1's library holds its kernel, the shared cell of gru_fwd_step.cuh
    and the mma.sync primitives it shares with K3; it launches only the
    persistent kernel, cooperatively, never the per-step kernel (which
    stays in the header for K6), and has one instance of it."""
    assert [p.name for p in kernels.sources("gru_fwd")] == [
        "gru_fwd.cu", "gru_fwd_step.cuh", "mma_sync.cuh"]
    text = (kernels.CSRC / "gru_fwd.cu").read_text()
    assert "cudaLaunchCooperativeKernel" in text
    assert "gru_step_kernel" not in text and "wmma" not in text
    assert text.count("<<<") == 0
    assert "template" not in text
