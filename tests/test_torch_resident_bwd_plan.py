"""The launch plan of the rows stage that K5's per-question pass and the
probe P2 share (``csrc/attention_rows.cuh``), computed in one place,
``ops/kernels.py::rows_plan``: one block a question, its shared memory and
the second pass's groups of threads. Pure arithmetic on shapes: it runs
here on the CPU; the card tests (``tests/test_torch_kernels_cuda.py``) hold
the C side to it."""

import itertools

import numpy as np
import pytest

from vqa_transfer_externaldata_torch.ops import kernels

SMEM_OPTIN = 232448  # the dynamic shared memory a block of an H100 may take

# (B, n_valid, G, C, H): the main path and its families (196 of 200 cells,
# C=2048, H=512 at G=1, 2, 8), P2 (all 200 cells), serving and small
# batches, ragged cell counts, narrow and wide units (H=384 leaves threads
# of a block idle, H > 2048 takes two passes).
SWEEP = list(itertools.product(
    (1, 17, 256, 1024), (1, 7, 13, 196, 200), (1, 2, 8), (128, 2048),
    (128, 384, 512, 2304)))


def _second_pass(plan: dict, n_valid: int, H: int) -> np.ndarray:
    """How many threads of a block take each (cell, unit) in the second
    pass, as the kernel assigns them: thread t is cell lane t % P of the
    group t // P, which takes ROWS_UNITS units of each pass and the cells
    t % P, t % P + P, ...; groups past the units of a pass stay idle."""
    P = plan["cell_lanes"]
    groups = min(H // kernels.ROWS_UNITS, kernels.ROWS_THREADS)
    width = groups * kernels.ROWS_UNITS
    taken = np.zeros((n_valid, H), np.int64)
    for t in range(plan["threads"]):
        cl, lu = t % P, t // P
        if lu >= groups:
            continue
        for p in range(plan["unit_passes"]):
            u0 = p * width + lu * kernels.ROWS_UNITS
            taken[cl::P, u0:u0 + kernels.ROWS_UNITS] += 1
    return taken


@pytest.mark.parametrize("B,n_valid,G,C,H", SWEEP)
def test_rows_plan_covers_every_cell_once(B, n_valid, G, C, H):
    plan = kernels.rows_plan(B, n_valid, G, C, H)
    assert plan["grid"] == [B]  # one block a question
    assert plan["threads"] == kernels.ROWS_THREADS == 256
    assert plan["smem_bytes"] == 2 * G * C + 4 * (G + 1) * n_valid
    assert plan["smem_bytes"] <= SMEM_OPTIN
    # The second pass: every unit of every valid cell once. The threads
    # that share units are neighbours of one warp (a power of two at most
    # 32), so their sums over the cells meet in a fixed xor tree.
    P = plan["cell_lanes"]
    assert P & (P - 1) == 0 and 32 % P == 0
    assert (_second_pass(plan, n_valid, H) == 1).all()
    lanes = min(H // 8, 256)
    assert P * lanes <= 256 < 2 * P * lanes
    assert plan["unit_passes"] * lanes * 8 >= H > (
        plan["unit_passes"] - 1) * lanes * 8


@pytest.mark.parametrize("B", [1, 17, 64, 128, 132, 256, 1024])
def test_rows_plan_at_the_main_shapes(B):
    """196 valid cells at C=2048, H=512: one block a question at every
    batch, four cell lanes of 64 groups of 8 units, one pass."""
    for G in (1, 2, 8):
        plan = kernels.rows_plan(B, 196, G, 2048, 512)
        assert plan["grid"] == [B], (G, plan)
        assert plan["cell_lanes"] == 4 and plan["unit_passes"] == 1


@pytest.mark.parametrize("G", [1, 2, 8])
def test_rows_plan_fits_shared_memory_at_c2048(G):
    """At C=2048 the G bf16 cotangent rows lead K5's shared memory (32 KB
    at G=8), and the per-cell arrays follow: within the card's opt-in
    limit, and under the 48 KB default at every G up to 8."""
    plan = kernels.rows_plan(256, 196, G, 2048, 512)
    assert plan["smem_bytes"] == 2 * G * 2048 + 4 * (G + 1) * 196
    assert plan["smem_bytes"] <= 48 * 1024 <= SMEM_OPTIN


@pytest.mark.parametrize("G,C,Np", [(8, 2048, 2000), (8, 128, 6000),
                                    (1, 99968, 200), (8, 13056, 200)])
def test_rows_plan_takes_every_shape_the_one_block_design_took(G, C, Np):
    """The earlier rows kernel needed G * C * 2 + (G + 1) * Np * 4 bytes of
    shared memory for a question; wherever that fitted, the plan fits too
    (it counts the valid cells, at most Np): the wrapper's limit is never
    tightened."""
    assert G * C * 2 + (G + 1) * Np * 4 <= SMEM_OPTIN
    for n_valid in (Np, Np - 4):
        plan = kernels.rows_plan(256, n_valid, G, C, 512)
        assert plan["smem_bytes"] <= G * C * 2 + (G + 1) * Np * 4


def test_rows_plan_refuses_shapes_the_kernel_does_not_take():
    for B, n_valid, G, C, H in [(0, 196, 1, 2048, 512),
                                (256, 0, 1, 2048, 512),
                                (256, 196, 0, 2048, 512),
                                (256, 196, 9, 2048, 512),
                                (256, 196, 1, 2040, 512),
                                (256, 196, 1, 2048, 520),
                                (256, 196, 1, 0, 512)]:
        with pytest.raises(ValueError, match="rows_plan needs"):
            kernels.rows_plan(B, n_valid, G, C, H)
    # Per-cell arrays past a block's shared memory.
    with pytest.raises(ValueError, match="shared memory"):
        kernels.rows_plan(4, 6000, 8, 2048, 512)


def test_rows_stage_is_one_header_of_k5_and_p2():
    """K5 and P2 include the one rows stage, so the build hash of both
    libraries covers it; both launch its loader and dot (cell_dots)."""
    for name in ("attention_resident_bwd", "probe_bwd_ceiling"):
        assert [p.name for p in kernels.sources(name)] == [
            f"{name}.cu", "attention_dwv.cuh", "attention_rows.cuh",
            "score_gemm.cuh", "store_rows.cuh", "elem16.cuh"]
        text = (kernels.CSRC / f"{name}.cu").read_text()
        assert "attn_rows::cell_dots<" in text
    assert "attention_rows.cuh" not in [
        p.name for p in kernels.sources("attention_bwd")]
