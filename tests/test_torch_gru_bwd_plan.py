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


def _carry_coverage(plan: dict, B: int, H: int) -> tuple:
    """How often a carry launch of the step form takes each (direction,
    b-tile, unit tile, gate) for its product and each (direction, row,
    unit) for its gate backward: block (jx, by, z) of a cluster of three
    along z is gate g = z % 3 of direction z // 3, on units 128 jx.. and
    rows 128 by..; its gate backward takes the tile's 16-row groups q with
    q % 3 == g, dropping rows past B and units past H."""
    nj, gy, gz = plan["grid"]
    rows, units = kernels.GRU_STEP_ROWS, kernels.GRU_STEP_CARRY_UNITS
    nd = gz // kernels.GRU_STEP_CLUSTER
    product = np.zeros((nd, gy, nj, kernels.GRU_STEP_CLUSTER), np.int64)
    cell = np.zeros((nd, B, H), np.int64)
    for z in range(gz):
        d, g = divmod(z, kernels.GRU_STEP_CLUSTER)
        for jx in range(nj):
            for by in range(gy):
                product[d, by, jx, g] += 1
                for q in range(g, rows // 16, kernels.GRU_STEP_CLUSTER):
                    r0 = by * rows + 16 * q
                    cell[d, r0:r0 + 16, jx * units:(jx + 1) * units] += 1
    return product, cell


def _gh_coverage(plan: dict, M: int, H: int) -> np.ndarray:
    """How often the step form's gh GEMM writes each (direction, saved
    state, gate, unit) of [(T - 1) B, 3H]: block (jx, by, d) takes the r,
    z and n columns of units 40 jx.. for saved states 256 by.."""
    nj, gy, nd = plan["gh_grid"]
    units, tall = kernels.GRU_STEP_UNITS, kernels.GRU_STEP_TALL
    seen = np.zeros((nd, M, 3, H), np.int64)
    for d in range(nd):
        for jx in range(nj):
            for by in range(gy):
                seen[d, by * tall:(by + 1) * tall, :,
                     jx * units:(jx + 1) * units] += 1
    return seen


@pytest.mark.parametrize("H", [600, 640, 1024, 2400])
@pytest.mark.parametrize("B", [1, 65, 256])
@pytest.mark.parametrize("directions", [1, 2])
def test_gru_step_plan_backward_past_the_persistent_kernel(H, B, directions):
    """Past H = 576 no persistent step block fits (0 blocks an SM): the
    route takes the step form, where the persistent plan raises. Its plan:
    every carry launch takes each (direction, b-tile, unit tile, gate)
    once for the product and each (direction, row, unit) once for the
    gate backward, in clusters of three along z; the gh GEMM covers
    [(T - 1) B, 3H] once; a partial of db_hn a carry block; the copies of
    h and G Hq = H rounded up to 256 wide; T + 3 + directions launches a
    call (the copy, the gh GEMM, T carries, dU_h a direction, db_hn). The
    step form takes H padded to 16 (600 to 608, not 640)."""
    Hp = kernels.round_up(H, kernels.GRU_BWD_PAD)
    assert kernels.gru_bwd_route(B, Hp, 132, 0, directions) == "step"
    with pytest.raises(ValueError, match="gru_bwd_plan"):
        kernels.gru_bwd_plan(B, Hp, 132, 0, directions)
    Hs = kernels.round_up(H, kernels.GRU_STEP_PAD)
    T = 3
    plan = kernels.gru_step_plan(T, B, Hs, True, directions)
    assert plan["launches"] == T + 3 + directions
    assert kernels.gru_step_plan(26, B, Hs, True, directions)["launches"] \
        == 26 + 3 + directions
    assert plan["cluster"] == [1, 1, kernels.GRU_STEP_CLUSTER]
    assert plan["grid"][2] == kernels.GRU_STEP_CLUSTER * directions
    assert plan["partials"] == kernels.GRU_STEP_CLUSTER * plan["grid"][1]
    assert plan["Hq"] % 256 == 0 and Hs <= plan["Hq"] < Hs + 256
    assert plan["grid"][0] * kernels.GRU_STEP_CARRY_UNITS <= plan["Hq"]
    product, cell = _carry_coverage(plan, B, Hs)
    assert (product == 1).all() and (cell == 1).all()
    assert (_gh_coverage(plan, (T - 1) * B, Hs) == 1).all()
    with pytest.raises(ValueError, match="gru_step_plan"):
        kernels.gru_step_plan(T, B, Hs - 8, True, directions)


def test_the_step_form_reuses_k3s_dwh_and_dbhn_kernels():
    """The step form's libraries build csrc/gru_wide_step.cuh on K3's
    header and K5's: its BPTT ends in attention_dwv.cuh's wgmma dW_v
    product (dU_h is that product over the saved states) and
    gru_bwd_step.cuh's db_hn sum, which it launches unchanged, and holds no
    persistent launch and no K3 dU_h GEMM of its own; its own kernels are
    the forward step, the copy, the gh GEMM and the carry."""
    for name in ("gru_fwd_wide", "gru_bwd_wide"):
        src = [p.name for p in kernels.sources(name)]
        assert src[:2] == [f"{name}.cu", "gru_wide_step.cuh"]
        for dep in ("attention_dwv.cuh", "score_gemm.cuh", "gru_bwd_step.cuh",
                    "mma_sync.cuh", "elem16.cuh"):
            assert dep in src, dep
        f16 = [p.name for p in kernels.sources(f"{name}_f16")]
        assert f16 == [f"{name}_f16.cu"] + src
    step = (kernels.CSRC / "gru_wide_step.cuh").read_text()
    assert "attn_dwv::launch_dwv(" in step and "gru_dbhn_kernel<<<" in step
    assert "gru_duh_pipe_kernel" not in step
    assert "cudaLaunchCooperativeKernel" not in step
    assert step.count("__global__") == 4  # forward, copy, gh, carry
    for kernel in ("gru_wide_fwd_kernel", "gru_wide_round_kernel",
                   "gru_wide_gh_kernel", "gru_wide_carry_kernel"):
        assert kernel in step, kernel
