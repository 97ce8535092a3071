"""The launch plan of K8's dz stage (``csrc/attention_bwd.cu``: the
recomputed score GEMM on ``score_gemm.cuh``'s mainloop over 128-cell tiles
of all B*N cells, its epilogue's (tile, slot) partials of dqh and dws, and
the fold that sums them per question), computed in one place,
``ops/kernels.py::dz_plan``. Pure arithmetic on shapes: it runs here on the
CPU; the card tests (``tests/test_torch_kernels_cuda.py``) hold the C side
to it."""

import functools
import itertools

import numpy as np
import pytest

from vqa_transfer_externaldata_torch.ops import kernels

SMEM_OPTIN = 232448  # the dynamic shared memory a block of an H100 may take
TILE = 128

# (B, N, C, H): one question up to past the SM count, one cell a question
# up to past a tile, the cell counts on both sides of a tile (127, 128,
# 129), the main path's 196; one and sixteen channel tiles; 128-unit tiles
# (128, 384) and 256-unit tiles (512, 2304).
SWEEP = list(itertools.product(
    (1, 3, 17, 256, 1024), (1, 7, 13, 49, 127, 128, 129, 196, 300),
    (128, 2048), (128, 384, 512, 2304)))


@functools.lru_cache(maxsize=None)
def _walk(B: int, N: int) -> tuple:
    """The partials that the dz epilogue writes, as each column's thread
    walks its tile: rows in order from question b0 = row0 // N, a partial
    of slot b - b0 at each question boundary and at the tile's end. Returns
    (tile, slot, question, first cell, end cell) for each."""
    cells = B * N
    out = []
    for tile in range(-(-cells // TILE)):
        row0 = tile * TILE
        rows = min(TILE, cells - row0)
        b0 = row0 // N
        b, nxt, start = b0, (b0 + 1) * N - row0, 0
        while nxt < rows:
            out.append((tile, b - b0, b, row0 + start, row0 + nxt))
            b, start, nxt = b + 1, nxt, nxt + N
        out.append((tile, b - b0, b, row0 + start, row0 + rows))
    return tuple(out)


def _fold(B: int, N: int) -> list:
    """The (tile, slot) partials that the fold sums for each question, in
    its order: the question's tiles, first to last, tile t's first
    question being t * 128 // N."""
    return [[(t, b - t * TILE // N)
             for t in range(b * N // TILE, (b * N + N - 1) // TILE + 1)]
            for b in range(B)]


@pytest.mark.parametrize("B,N,C,H", SWEEP)
def test_dz_plan_covers_every_cell_once(B, N, C, H):
    plan = kernels.dz_plan(B, N, C, H)
    bn = 256 if H % 256 == 0 else 128
    tiles = -(-(B * N) // TILE)
    assert plan["tile"] == [TILE, bn]
    assert plan["stages"] == (4 if bn == 256 else 5)
    assert plan["grid"] == [H // bn, tiles]
    assert plan["partials"] == [tiles, plan["slots"], H]
    walk = _walk(B, N)
    # Every (question, cell) lies in exactly one (tile, slot) partial.
    seen = np.zeros(B * N, np.int64)
    for tile, slot, b, lo, hi in walk:
        assert lo < hi and lo // TILE == tile == (hi - 1) // TILE
        assert lo // N == b == (hi - 1) // N
        assert 0 <= slot < plan["slots"]  # never past the plan's slots
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert len({(t, s) for t, s, *_ in walk}) == len(walk)
    # The fold reads, for each question, exactly the partials the walk
    # wrote for it, each once, in tile order.
    written = {}
    for tile, slot, b, *_ in walk:
        written.setdefault(b, []).append((tile, slot))
    for b, reads in enumerate(_fold(B, N)):
        assert reads == written[b]
        assert all(t0 < t1 for (t0, _), (t1, _) in zip(reads, reads[1:]))
    # Shared memory: the ring and a tile row's norm within a block's
    # opt-in limit, the epilogue's staging inside the ring.
    ring = plan["stages"] * 2 * 64 * (TILE + bn)
    assert plan["smem_bytes"] == 1024 + ring + 4 * TILE
    assert 48 * 1024 < plan["smem_bytes"] <= SMEM_OPTIN
    assert plan["epilogue_bytes"] == 4 * (TILE * (bn + 8) + 2 * TILE)
    assert plan["epilogue_bytes"] <= ring


@pytest.mark.parametrize("B,N", [(1, 1), (3, 13), (2, 127), (2, 129),
                                 (3, 300), (17, 196), (1024, 7), (5, 1)])
def test_dz_partials_fold_to_each_questions_sums(B, N):
    """Through the plan's [tiles, slots, H] buffers, the fold gives each
    question the sum of its cells' values (integers, so exact in any
    order)."""
    H = 8
    plan = kernels.dz_plan(B, N, 128, 128)
    vals = np.random.default_rng(B * 1000 + N).integers(
        -50, 50, (B * N, H)).astype(np.float64)
    part = np.full(plan["partials"][:2] + [H], np.nan)
    for tile, slot, _, lo, hi in _walk(B, N):
        part[tile, slot] = vals[lo:hi].sum(0)
    got = np.stack([sum(part[t, s] for t, s in reads)
                    for reads in _fold(B, N)])
    np.testing.assert_array_equal(got, vals.reshape(B, N, H).sum(1))


@pytest.mark.parametrize("B", [1, 64, 256, 1024])
def test_dz_plan_at_the_main_shapes(B):
    """196 cells at C=2048, H=512: 128 x 256 tiles, 4 stages (192 KB of
    ring, 132 KB of it the epilogue's), two unit tiles side by side, and
    two slots: a tile spans at most two questions."""
    plan = kernels.dz_plan(B, 196, 2048, 512)
    assert plan["tile"] == [128, 256] and plan["stages"] == 4
    assert plan["grid"] == [2, -(-B * 196 // 128)]
    assert plan["slots"] == min(B, 2)
    assert plan["smem_bytes"] == 198144
    assert plan["epilogue_bytes"] == 136192


def test_dz_plan_slots_follow_the_cells_a_question_has():
    """ceil(127 / N) + 1 slots, at most B: 128 at N=1, 20 at N=7, 2 from
    N=64 on."""
    for N, slots in [(1, 128), (2, 65), (7, 20), (13, 11), (49, 4),
                     (63, 4), (64, 3), (127, 2), (128, 2), (196, 2)]:
        assert kernels.dz_plan(1024, N, 128, 128)["slots"] == slots
        assert kernels.dz_plan(3, N, 128, 128)["slots"] == min(3, slots)


def test_dz_plan_refuses_shapes_the_kernel_does_not_take():
    for B, N, C, H in [(0, 196, 2048, 512), (256, 0, 2048, 512),
                       (256, 196, 2040, 512), (256, 196, 2048, 520),
                       (256, 196, 0, 512), (256, 196, 2048, 64)]:
        with pytest.raises(ValueError, match="dz_plan needs"):
            kernels.dz_plan(B, N, C, H)


def test_dz_stage_runs_on_the_score_mainloop():
    """K8's dz stage is score_gemm.cuh's wgmma mainloop with its dense row
    source (no WMMA left), so the build hash of K8's library covers the
    mainloop; the entry counts the launches that the wrapper's constant
    names."""
    assert [p.name for p in kernels.sources("attention_bwd")] == [
        "attention_bwd.cu", "attention_dwv.cuh", "score_gemm.cuh",
        "store_rows.cuh", "elem16.cuh"]
    text = (kernels.CSRC / "attention_bwd.cu").read_text()
    assert "mma.h" not in text and "wmma" not in text
    assert "score_gemm::mainloop<E, BN>" in text
    assert "score_gemm::DenseRows<E>{" in text
    assert "struct DenseRows" in (kernels.CSRC / "score_gemm.cuh").read_text()
    assert text.count("++*launched") == kernels.ATTENTION_BWD_LAUNCHES == 4
