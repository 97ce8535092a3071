"""The launch plan of the persistent BPTT step kernel that K3 (one
direction) and K7 (two) share (``csrc/gru_bwd_step.cuh``), chosen in one
place, ``ops/kernels.py::gru_bwd_plan``, from which both wrappers take the
rows of blocks; the C side derives the grid from them. Pure arithmetic on
shapes: it runs here on the CPU; the card tests
(``tests/test_torch_kernels_cuda.py``) hold the launches to it."""

import numpy as np
import pytest

from vqa_transfer_externaldata_torch.ops import kernels


def _c_formula(B: int, H: int, sms: int, per_sm: int) -> list:
    """The one-direction grid of the C side's former plan: H / 16 j-tiles
    by as many rows of blocks as fit on the card, at most one per 64-row
    b-tile."""
    nj = H // 16
    rows_fit = per_sm * sms // nj
    ntiles = (B + 63) // 64
    return [nj, ntiles if ntiles < rows_fit else rows_fit, 1]


def _coverage(plan: dict, B: int, H: int) -> np.ndarray:
    """How often the kernel's blocks take each (direction, row, unit) in a
    step: block (jx, by, d) owns units 16 jx.. of direction d and walks
    b-tiles by, by + grid_y, ... of 64 rows, dropping rows past B."""
    units, rows = kernels.GRU_BWD_UNITS, kernels.GRU_BWD_ROWS
    nj, gy, nd = plan["grid"]
    seen = np.zeros((nd, B, H), np.int64)
    for d in range(nd):
        for jx in range(nj):
            for by in range(gy):
                for bt in range(by, plan["b_tiles"], gy):
                    seen[d, bt * rows:(bt + 1) * rows,
                         jx * units:(jx + 1) * units] += 1
    return seen


@pytest.mark.parametrize("B", [1, 17, 64, 65, 256, 1024, 4096])
@pytest.mark.parametrize("H", [64, 128, 512, 576])
@pytest.mark.parametrize("directions", [1, 2])
@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("sms", [114, 132])
def test_gru_bwd_plan_covers_every_tile_once(B, H, directions, per_sm, sms):
    """The grid is resident at once (at most sms x per_sm blocks), its
    j-tiles span H for each direction, every 64-row b-tile of each
    direction is walked exactly once a step, and with one direction the
    grid is the C side's former formula."""
    plan = kernels.gru_bwd_plan(B, H, sms, per_sm, directions)
    nj, gy, nd = plan["grid"]
    assert nj * kernels.GRU_BWD_UNITS == H and nd == directions
    assert plan["b_tiles"] == -(-B // kernels.GRU_BWD_ROWS)
    assert 1 <= gy <= plan["b_tiles"]
    assert nj * gy * nd <= sms * per_sm
    assert (_coverage(plan, B, H) == 1).all()
    if directions == 1:
        assert plan["grid"] == _c_formula(B, H, sms, per_sm)


def test_gru_bwd_plan_at_the_training_shapes():
    """B=256, H=512 on an H100 (132 SMs, one block an SM): K3 runs 32
    j-tiles x 4 rows (one b-tile a block), K7 32 x 2 x 2, 128 blocks
    either way, each of K7's walking 2 of the 4 b-tiles a step; at
    B=1024 both walk 16 b-tiles on the same rows."""
    k3 = kernels.gru_bwd_plan(256, 512, 132, 1)
    k7 = kernels.gru_bwd_plan(256, 512, 132, 1, 2)
    assert k3["grid"] == [32, 4, 1] and k7["grid"] == [32, 2, 2]
    assert k3["b_tiles"] == k7["b_tiles"] == 4
    big3 = kernels.gru_bwd_plan(1024, 512, 132, 1)
    big7 = kernels.gru_bwd_plan(1024, 512, 132, 1, 2)
    assert big3["grid"] == [32, 4, 1] and big7["grid"] == [32, 2, 2]
    assert big3["b_tiles"] == big7["b_tiles"] == 16


@pytest.mark.parametrize("directions", [1, 2])
@pytest.mark.parametrize("H", [64, 512, 576])
@pytest.mark.parametrize("per_sm", [1, 2])
def test_gru_bwd_plan_raises_where_the_j_tiles_cannot_be_resident(
        directions, H, per_sm):
    """The plan raises exactly where directions x H / 16 blocks exceed
    per_sm x sms: one SM short of a row of every direction's j-tiles
    raises, a whole row fits."""
    need = directions * H // 16
    fit = -(-need // per_sm)  # the fewest SMs that hold one row
    plan = kernels.gru_bwd_plan(256, H, fit, per_sm, directions)
    assert plan["grid"][1] == 1
    with pytest.raises(ValueError, match="gru_bwd_plan.*resident"):
        kernels.gru_bwd_plan(256, H, fit - 1, per_sm, directions)


@pytest.mark.parametrize("B,H,sms,per_sm,directions", [
    (0, 512, 132, 1, 1), (4, 96, 132, 1, 1), (4, 0, 132, 1, 1),
    (4, 512, 0, 1, 1), (4, 512, 132, -1, 1), (4, 512, 132, 1, 3),
    (4, 512, 132, 1, 0), (4, 640, 132, 0, 2)])
def test_gru_bwd_plan_refuses_what_the_kernel_does_not_take(
        B, H, sms, per_sm, directions):
    """Bad shapes raise, and so does a width whose blocks do not fit on an
    SM at all (no block resident: H = 640 on an H100)."""
    with pytest.raises(ValueError, match="gru_bwd_plan"):
        kernels.gru_bwd_plan(B, H, sms, per_sm, directions)


def test_k3_and_k7_share_one_persistent_body():
    """K3's and K7's libraries hold the same BPTT kernels, from
    gru_bwd_step.cuh, on the mma.sync primitives of mma_sync.cuh; neither
    entry launches a kernel of its own or walks the timesteps, and the
    per-step kernel and the WMMA dU_h GEMM are gone."""
    for name in ("gru_bwd", "bigru_bwd"):
        assert [p.name for p in kernels.sources(name)] == [
            f"{name}.cu", "gru_bwd_step.cuh", "mma_sync.cuh", "elem16.cuh"]
        text = (kernels.CSRC / f"{name}.cu").read_text()
        assert "<<<" not in text and "__global__" not in text
        assert "for (int k" not in text
        assert "bptt_run<" in text
    step = (kernels.CSRC / "gru_bwd_step.cuh").read_text()
    assert "cudaLaunchCooperativeKernel" in step
    assert step.count("__global__") == 3  # step, dU_h GEMM, db_hn sum
    for gone in ("gru_bwd_step_kernel", "gru_duh_kernel", "wmma",
                 "BwdStep", "DuhGemm", "step_smem_bytes"):
        assert gone not in step, gone


# Widths off 64 that K3/K7 now take, padded by the wrappers (ops/gru.py's
# gru_pad): 8, 24 and 40 units run at 64, 100 at 128, 600 at 640 and
# Skip-Thought's 2400 at 2432.
def _padded(H: int) -> int:
    return kernels.round_up(H, kernels.GRU_BWD_PAD)


@pytest.mark.parametrize("H", [8, 24, 40, 100])
@pytest.mark.parametrize("B", [1, 17, 256, 1024])
@pytest.mark.parametrize("directions", [1, 2])
def test_gru_bwd_plan_at_the_padded_widths(H, B, directions):
    """At the padded widths within the persistent kernel's shared memory
    the route takes it, and every 64-row b-tile of each direction is
    walked once a step."""
    Hp = _padded(H)
    assert kernels.gru_bwd_route(B, Hp, 132, 1, directions) == "persistent"
    plan = kernels.gru_bwd_plan(B, Hp, 132, 1, directions)
    assert (_coverage(plan, B, Hp) == 1).all()


@pytest.mark.parametrize("H", [600, 640, 1024, 2400])
@pytest.mark.parametrize("B", [1, 65, 256])
@pytest.mark.parametrize("directions", [1, 2])
def test_gru_step_plan_backward_past_the_persistent_kernel(H, B, directions):
    """Past H = 576 no persistent step block fits (0 blocks an SM): the
    route takes the step form, whose every step's grid takes each
    (direction, row, unit) once, 2T + 2 launches a call, where the
    persistent plan raises."""
    Hp = _padded(H)
    assert kernels.gru_bwd_route(B, Hp, 132, 0, directions) == "step"
    with pytest.raises(ValueError, match="gru_bwd_plan"):
        kernels.gru_bwd_plan(B, Hp, 132, 0, directions)
    plan = kernels.gru_step_plan(26, B, Hp, True, directions)
    assert plan["launches"] == 2 * 26 + 2
    nj, gy, gz = plan["grid"]
    assert (nj * kernels.GRU_STEP_UNITS, gz) == (Hp, directions)
    assert gy * kernels.GRU_STEP_ROWS >= B > (gy - 1) * kernels.GRU_STEP_ROWS
    with pytest.raises(ValueError, match="gru_step_plan"):
        kernels.gru_step_plan(26, B, Hp - 16, True, directions)


def test_the_step_form_reuses_k3s_dwh_and_dbhn_kernels():
    """The step form's libraries build csrc/gru_wide_step.cuh on K3's
    header: its BPTT ends in gru_bwd_step.cuh's dU_h GEMM and db_hn sum,
    which it launches, and holds no persistent launch of its own."""
    for name in ("gru_fwd_wide", "gru_bwd_wide"):
        assert [p.name for p in kernels.sources(name)] == [
            f"{name}.cu", "gru_wide_step.cuh", "gru_bwd_step.cuh",
            "mma_sync.cuh", "elem16.cuh"]
        f16 = [p.name for p in kernels.sources(f"{name}_f16")]
        assert f16 == [f"{name}_f16.cu", f"{name}.cu", "gru_wide_step.cuh",
                       "gru_bwd_step.cuh", "mma_sync.cuh", "elem16.cuh"]
    step = (kernels.CSRC / "gru_wide_step.cuh").read_text()
    assert "gru_duh_pipe_kernel<E><<<" in step and "gru_dbhn_kernel<<<" in step
    assert "cudaLaunchCooperativeKernel" not in step
    assert step.count("__global__") == 4  # forward, copy, dgx, carry
