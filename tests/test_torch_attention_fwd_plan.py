"""The launch plan of K2's score launch (``csrc/attention_fwd.cu``: the score
tile of ``csrc/score_tile.cuh`` on ``score_gemm.cuh``'s mainloop, 128-cell
tiles over all B*N cells, the unit tiles of a cell tile side by side, one
partial score a cell and unit tile, summed in order by the wsum launch),
computed in one place, ``ops/kernels.py::score_plan``, on which K8's
``dz_plan`` builds. Pure arithmetic on shapes and a read of the sources: it
runs here on the CPU; the card tests (``tests/test_torch_kernels_cuda.py``)
hold the C side to it."""

import itertools

import numpy as np
import pytest

from vqa_transfer_externaldata_torch.ops import kernels

SMEM_OPTIN = 232448  # the dynamic shared memory a block of an H100 may take
TILE = 128

# (B, N, C, H): one question, the Predictor's default batch, a ragged batch,
# the serving and the training batch; one cell a question, the cell counts
# on both sides of a tile (127, 128, 129) and the main path's 196; one
# 64-channel chunk, a half-filled last chunk (96) and the main width;
# 128-unit tiles (128, 384) and 256-unit tiles (512, 2304).
SWEEP = list(itertools.product(
    (1, 8, 17, 64, 256), (1, 9, 127, 128, 129, 196), (64, 96, 2048),
    (128, 384, 512, 2304)))


def _blocks(plan: dict) -> list:
    """(unit tile, cell tile) of each block in launch order: blockIdx.x
    runs fastest."""
    gx, gy = plan["grid"]
    return [(x, y) for y in range(gy) for x in range(gx)]


@pytest.mark.parametrize("B,N,C,H", SWEEP)
def test_score_plan_covers_every_cell_and_unit_once(B, N, C, H):
    plan = kernels.score_plan(B, N, C, H)
    bn = 256 if H % 256 == 0 else 128
    cells = B * N
    assert plan["tile"] == [TILE, bn]
    assert plan["stages"] == (4 if bn == 256 else 5)
    assert plan["n_part"] == H // bn == plan["grid"][0]
    # Every (cell, unit) lies in exactly one block's tile: each (unit tile,
    # cell tile) pair is one block, and the tiles cover the cells and the
    # units once each.
    blocks = _blocks(plan)
    assert len(set(blocks)) == len(blocks)
    cell_seen = np.zeros(cells, np.int64)
    for y in range(plan["grid"][1]):
        lo, hi = y * TILE, min((y + 1) * TILE, cells)
        assert lo < hi  # no cell tile is empty
        cell_seen[lo:hi] += 1
    unit_seen = np.zeros(H, np.int64)
    for x in range(plan["grid"][0]):
        unit_seen[x * bn:(x + 1) * bn] += 1
    assert (cell_seen == 1).all() and (unit_seen == 1).all()
    # The unit tiles of one cell tile come side by side in launch order, so
    # they read its rows from L2 together.
    order = [y for _, y in _blocks(plan)]
    assert order == sorted(order)
    assert all(order.count(y) == plan["n_part"] for y in set(order))
    # Shared memory: the ring (64-channel chunks of the 128 rows and of
    # W_v^T's bn rows, 2 B a value), 1024 B to align it and a tile row's
    # norm, within a block's opt-in limit.
    ring = plan["stages"] * 2 * 64 * (TILE + bn)
    assert plan["smem_bytes"] == 1024 + ring + 4 * TILE
    assert 48 * 1024 < plan["smem_bytes"] <= SMEM_OPTIN


@pytest.mark.parametrize("H", [128, 384, 512, 2304])
def test_partial_scores_sum_to_each_cells_score(H):
    """Each block writes h . ws over its unit tile as one partial a cell;
    summed over the plan's n_part slices, unit tile by unit tile, they give
    each cell's whole score (integers, so exact in any order)."""
    B, N = 3, 129
    plan = kernels.score_plan(B, N, 64, H)
    bn = plan["tile"][1]
    rng = np.random.default_rng(H)
    h = rng.integers(0, 20, (B * N, H)).astype(np.float64)
    ws = rng.integers(-5, 5, H).astype(np.float64)
    part = np.full((plan["n_part"], B * N), np.nan)
    for x, y in _blocks(plan):
        lo, hi = y * TILE, min((y + 1) * TILE, B * N)
        part[x, lo:hi] = h[lo:hi, x * bn:(x + 1) * bn] @ ws[x * bn:
                                                            (x + 1) * bn]
    np.testing.assert_array_equal(part.sum(0), h @ ws)


@pytest.mark.parametrize("B", [8, 64, 256])
def test_score_plan_at_the_main_shapes(B):
    """196 cells at C=2048, H=512: 128 x 256 tiles, 4 stages (192 KB of
    ring), two unit tiles side by side, two partial scores a cell. At the
    Predictor's default batch (8) that is 26 blocks; at 64, 196; at 256,
    784."""
    plan = kernels.score_plan(B, 196, 2048, 512)
    assert plan == {"tile": [128, 256], "stages": 4, "smem_bytes": 198144,
                    "grid": [2, -(-B * 196 // 128)], "n_part": 2}
    assert {8: 26, 64: 196, 256: 784}[B] == 2 * plan["grid"][1]


def test_score_plan_refuses_shapes_the_kernel_does_not_take():
    for B, N, C, H in [(0, 196, 2048, 512), (256, 0, 2048, 512),
                       (256, 196, 2040, 512), (256, 196, 2048, 520),
                       (256, 196, 0, 512), (256, 196, 16, 512),
                       (256, 196, 2048, 64), (256, 196, 2048, 0)]:
        with pytest.raises(ValueError, match="score_plan needs"):
            kernels.score_plan(B, N, C, H)


@pytest.mark.parametrize("B,N,C,H", [(1, 1, 128, 128), (17, 129, 2048, 384),
                                     (256, 196, 2048, 512),
                                     (64, 7, 256, 2304)])
def test_dz_plan_builds_on_score_plan(B, N, C, H):
    """K8's dz stage runs the same mainloop and tiles: its tile, stages,
    shared memory and grid are score_plan's."""
    score, dz = kernels.score_plan(B, N, C, H), kernels.dz_plan(B, N, C, H)
    for key in ("tile", "stages", "smem_bytes", "grid"):
        assert dz[key] == score[key], key


def test_k2_runs_the_score_tile_on_the_mainloop():
    """K2's score launch is score_tile.cuh's kernel on score_gemm.cuh's
    mainloop with the dense row source (no WMMA left), so the build hash of
    K2's library covers both headers; the entry counts its two launches.
    K4 runs the same template over its store rows (CellRows), and the
    epilogue rounds z * r and + qh as two operations."""
    assert [p.name for p in kernels.sources("attention_fwd")] == [
        "attention_fwd.cu", "score_gemm.cuh", "score_tile.cuh",
        "store_rows.cuh", "elem16.cuh"]
    text = (kernels.CSRC / "attention_fwd.cu").read_text()
    assert '#include "score_tile.cuh"' in text
    assert '#include "score_gemm.cuh"' in text
    assert "score_gemm::DenseRows<E>{" in text
    assert "score_tile::launch<E>(" in text
    assert "mma.h" not in text and "wmma" not in text.lower()
    assert text.count("++*launched") == 2
    k4 = (kernels.CSRC / "attention_resident_fwd.cu").read_text()
    assert "score_tile::launch<T, E>(" in k4 and "CellRows<T>{" in k4
    assert "__global__" not in k4.split("attn_res_wsum_kernel")[0]
    tile = (kernels.CSRC / "score_tile.cuh").read_text()
    assert "score_gemm::mainloop<T, BN>(rows," in tile
    assert "__fadd_rn(__fmul_rn(z[0], r), qv.x)" in tile
