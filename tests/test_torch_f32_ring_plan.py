"""The launch plan of the float32 attention products' tile loop
(``csrc/fp32_ring.cuh``: K4f's and K2f's score launch, K8f's dz launch and
K5f's and K8f's dW_v launch), computed in one place,
``ops/kernels.py::f32_ring_plan``: the copy widths from the rows' pitch and
base address, the stages and the block's shared memory. Pure arithmetic on
shapes, mirrored from the C side's copy loops: it runs here on the CPU; the
card tests (``tests/test_torch_kernels_cuda.py``) hold the kernels to it and
the C entries refuse a plan that disagrees with their own layout."""

import itertools

import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_torch.ops import (
    attention, attention_resident as ar, kernels)

TILE, BK, THREADS = 128, 16, 256
SM_SMEM = 233472  # an H100 SM's shared memory
WIDTHS = (16, 8, 4, 0)


def _a_granules(elem: int, kmajor: bool, width: int) -> list:
    """The A copies of one chunk as the C side's issue loop makes them:
    copy g of ng takes elements (row, k) of the chunk's [TILE][BK] cells x
    channels (K-major) or [BK][TILE] cells x channels (MN-major)."""
    epg = width // elem if width else 1
    if kmajor:
        gpr = BK // epg
        return [[(g // gpr, (g % gpr) * epg + j) for j in range(epg)]
                for g in range(TILE * gpr)]
    gpr = TILE // epg
    return [[((g % gpr) * epg + j, g // gpr) for j in range(epg)]
            for g in range(BK * gpr)]


def _bswz(n: int) -> int:
    """fp32_ring.cuh's bswz: column n's place in a k row of B."""
    return ((((n >> 2) ^ ((n >> 5) & 1))) << 2) | (n & 3)


@pytest.mark.parametrize("elem,kmajor,width", [
    (e, k, w) for e, k, w in itertools.product((4, 2, 1), (True, False),
                                               WIDTHS)
    if w == 0 or w >= e])
def test_a_copies_take_every_element_of_a_chunk_once(elem, kmajor, width):
    """Each (cell, channel) of a chunk is copied by exactly one copy, a
    copy's elements are contiguous in the row it reads (so one cp.async of
    ``width`` bytes, aligned where the row pitch and the chunk start are),
    and the copies split over the threads in whole rounds or one partial
    round (the C loop's ``g >= NG`` stop)."""
    copies = _a_granules(elem, kmajor, width)
    seen = np.zeros((TILE, BK), np.int64)  # (m, k)
    for elems in copies:
        for m, k in elems:
            seen[m, k] += 1
        contig = [k for _, k in elems] if kmajor else [m for m, _ in elems]
        assert contig == list(range(contig[0], contig[0] + len(elems)))
        assert len({k for _, k in elems} if not kmajor
                   else {m for m, _ in elems}) == 1
        if width:
            assert contig[0] * elem % width == 0
    assert (seen == 1).all()
    ng = len(copies)
    assert ng % THREADS == 0 or ng < THREADS


@pytest.mark.parametrize("width", (16, 8, 4))
def test_b_copies_and_reads(width):
    """B [k][n] f32: every column of a k row lands once, a copy's columns
    stay side by side after the swizzle (one 16-byte group), and the 8
    threads of a quarter warp reading their float4 groups 2tx and 2tx + 1
    touch 8 distinct 4-bank groups: no bank conflict."""
    epg = width // 4
    pos = [_bswz(n) for n in range(TILE)]
    assert sorted(pos) == list(range(TILE))
    for g in range(TILE // epg):
        cols = [_bswz(g * epg + j) for j in range(epg)]
        assert cols == list(range(cols[0], cols[0] + epg))
        assert cols[0] // 4 == cols[-1] // 4
    for txs in (range(0, 8), range(8, 16)):  # a quarter warp: one ty
        for half in (0, 1):
            groups = [2 * tx + ((tx >> 2) & 1 if half == 0
                                else 1 - ((tx >> 2) & 1)) for tx in txs]
            assert len({grp % 8 for grp in groups}) == 8
    # The swizzled groups hold the thread's own columns: tx*8 .. tx*8+7.
    for tx in range(16):
        sw = (tx >> 2) & 1
        lo, hi = (2 * tx + sw) * 4, (2 * tx + 1 - sw) * 4
        assert [pos.index(lo + j) for j in range(4)] == [tx * 8 + j
                                                         for j in range(4)]
        assert [pos.index(hi + j) for j in range(4)] == [tx * 8 + 4 + j
                                                         for j in range(4)]


@pytest.mark.parametrize("pitch,address", list(itertools.product(
    (1, 2, 4, 6, 8, 12, 16, 20, 24, 32, 50, 100, 200, 300, 600, 4096),
    (0, 2, 4, 8, 12, 16, 256 + 4))))
def test_copy_width_is_the_widest_the_alignment_allows(pitch, address):
    w = kernels.f32_copy_width(pitch, address)
    assert w in WIDTHS
    if w:
        assert pitch % w == 0 and address % w == 0
    wider = [x for x in (16, 8, 4) if w == 0 or x > w]
    for x in wider:
        assert pitch % x or address % x


# The widths of the 16-bit kernels' width sweep (C of 16, 48, 100, 300; H
# of 8, 100, 600) and the ones that take the narrower copies (C of 25 and
# 50, H of 6 and 101): the width each row type gets.
WIDTH_CASES = [
    (4, 16, 16), (4, 25, 4), (4, 48, 16), (4, 50, 8), (4, 100, 16),
    (4, 300, 16), (4, 2048, 16),
    (2, 16, 16), (2, 25, 0), (2, 48, 16), (2, 50, 4), (2, 100, 8),
    (2, 300, 8), (2, 2048, 16),
    (1, 16, 16), (1, 25, 0), (1, 48, 16), (1, 50, 0), (1, 100, 4),
    (1, 300, 4), (1, 2048, 16)]


@pytest.mark.parametrize("elem,C,want", WIDTH_CASES)
@pytest.mark.parametrize("kmajor", [True, False])
def test_plan_widths_from_the_shapes(elem, C, want, kmajor):
    for H, wb in ((8, 16), (100, 16), (600, 16), (6, 8), (101, 4),
                  (512, 16)):
        plan = kernels.f32_ring_plan(elem, kmajor, C * elem, 0, H * 4, 0)
        assert (plan["a_width"], plan["b_width"]) == (want, wb)
        assert (plan["chunk"], plan["stages"]) == (BK, 4)


@pytest.mark.parametrize("elem,kmajor", list(itertools.product(
    (4, 2, 1), (True, False))))
@pytest.mark.parametrize("wb", [16, 8, 4])
def test_plan_shared_memory(elem, kmajor, wb):
    """The block's bytes are the C side's Layout: the A ring in the rows'
    type, the B ring, the widened A's two slots unless A is f32 MN-major,
    and the row pointers; two blocks fit on an SM."""
    plan = kernels.f32_ring_plan(elem, kmajor, 2048 * elem, 0, wb * 25, 0)
    assert plan["b_width"] == wb
    widened = not (elem == 4 and not kmajor)
    assert plan["a_widened"] == widened
    want = (4 * TILE * BK * elem + 4 * BK * TILE * 4
            + (2 * BK * (TILE + 4) * 4 if widened else 0)
            + 8 * (TILE if kmajor else 4 * BK))
    assert plan["smem_bytes"] == want
    assert plan["smem_bytes"] % 16 == 0
    assert 2 * (plan["smem_bytes"] + 1024) <= SM_SMEM
    # B's rows through an index (the GRU's dU_h, MN-major only): a slot of
    # B's row pointers a stage beside A's.
    if kmajor:
        with pytest.raises(ValueError, match="index"):
            kernels.f32_ring_plan(elem, kmajor, 2048 * elem, 0, wb * 25, 0,
                                  b_listed=True)
    else:
        listed = kernels.f32_ring_plan(elem, kmajor, 2048 * elem, 0,
                                       wb * 25, 0, b_listed=True)
        assert listed["smem_bytes"] == want + 8 * 4 * BK
        assert 2 * (listed["smem_bytes"] + 1024) <= SM_SMEM


def test_plan_refuses_a_misaligned_b_and_other_elements():
    with pytest.raises(ValueError, match="f32-aligned"):
        kernels.f32_ring_plan(4, True, 4096, 0, 2050, 0)
    with pytest.raises(ValueError, match="f32-aligned"):
        kernels.f32_ring_plan(4, True, 4096, 0, 2048, 2)
    with pytest.raises(ValueError, match="f32, f16 or int8"):
        kernels.f32_ring_plan(8, True, 4096, 0, 2048, 0)


@pytest.mark.parametrize("dtype,C,H", [
    (torch.float32, 2048, 512), (torch.float16, 2048, 512),
    (torch.int8, 2048, 512), (torch.float16, 300, 100),
    (torch.int8, 100, 600), (torch.float32, 25, 101)])
def test_wrappers_plan_their_launches(dtype, C, H):
    """K4f's score and K5f's dW_v launches plan the store's rows (K-major,
    then MN-major) against W_v and dz * r; K2f's score and K8f's dz and
    dW_v launches plan v's rows, K8f's dW_v against dz * r. A store or grid
    that starts off a 16-byte boundary gets the narrower copy its address
    allows."""
    es = torch.empty(0, dtype=dtype).element_size()
    store = torch.zeros(3, 8, C, dtype=dtype)
    wv = torch.zeros(C, H)
    dzr = torch.zeros(24, H)
    k4, k5 = ar.f32_score_plan(store, wv), ar.f32_dwv_plan(store, dzr)
    want_a = kernels.f32_copy_width(C * es, store.data_ptr())
    assert k4 == kernels.f32_ring_plan(es, True, C * es, store.data_ptr(),
                                       H * 4, wv.data_ptr())
    assert k5 == kernels.f32_ring_plan(es, False, C * es, store.data_ptr(),
                                       H * 4, dzr.data_ptr())
    assert k4["a_width"] == k5["a_width"] == want_a
    v = torch.zeros(2 * 8 * C + 1)[1:].view(2, 8, C)
    assert v.data_ptr() % 8 == 4
    k2 = attention.f32_score_plan(v, wv)
    k8 = attention.f32_dwv_plan(v, dzr)
    assert k2["a_width"] == k8["a_width"] == 4
    assert not k8["a_widened"] and k2["a_widened"]
    assert k8["smem_bytes"] == kernels.f32_ring_plan(
        4, False, C * 4, v.data_ptr(), H * 4, dzr.data_ptr())["smem_bytes"]


def test_the_c_side_states_the_same_layout():
    """The constants the plan mirrors are fp32_ring.cuh's."""
    src = (kernels.CSRC / "fp32_ring.cuh").read_text()
    for line in ("constexpr int TILE = 128;", "constexpr int BK = 16;",
                 "constexpr int STAGES = 4;",
                 "constexpr int WPITCH = TILE + 4;",
                 "kBP + (BLISTED ? 8 * STAGES * BK : 0)"):
        assert line in src
    assert kernels.F32_RING_CHUNK == BK and kernels.F32_RING_STAGES == 4
    assert kernels.F32_RING_WIDE_PITCH == TILE + 4
