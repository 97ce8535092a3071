"""Port parity: the H100 probes P1 (``tools/probe_mxu_rows``) and P2
(``tools/probe_bwd_ceiling``) of the port against the TPU probes' Pallas
bodies.

The TPU probes in the repository's ``tools/`` hard-wire the TPU's grid spec
and have no interpret switch, so each Pallas body's math is written here in
``jax.numpy`` as the body states it (``jnp.dot`` / ``dot_general`` of bf16
operands with ``preferred_element_type=float32``) and the port's plain
versions are held against it at small sizes: rtol 1e-5 and atol 1e-5, f32
sums of the same exact bf16 products in another order. The kernels
themselves run only on the card (``tests/test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_torch.tools import (
    probe_bwd_ceiling as p2, probe_mxu_rows as p1)

torch.set_num_threads(2)  # xdist runs several workers on the same cores

M, Np, C, H = 5, 24, 64, 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _bf16(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(ml_dtypes.bfloat16)


def _t(a):
    """A bf16 numpy array as a torch bf16 tensor (same bits)."""
    return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
        torch.bfloat16)


@pytest.mark.parametrize("q", [1, 2, 3, 4])
def test_probe_mxu_rows_plain_matches_the_pallas_body(q):
    rng = np.random.default_rng(q)
    store, wv = _bf16(rng, M, Np, C), _bf16(rng, C, H, scale=0.02)
    rows = rng.integers(0, M, size=12).astype(np.int32)

    # make_call.kernel: per group, the q rows concatenated, one dot.
    want = np.stack([np.asarray(jnp.dot(
        jnp.concatenate([jnp.asarray(store[rows[i * q + j]])
                         for j in range(q)], axis=0),
        jnp.asarray(wv), preferred_element_type=jnp.float32))
        for i in range(12 // q)])
    got = p1.probe_mxu_rows_reference(_t(store), torch.from_numpy(rows),
                                      _t(wv), q)
    assert tuple(got.shape) == want.shape == (12 // q, q * Np, H)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_probe_bwd_ceiling_plain_matches_the_pallas_body():
    rng = np.random.default_rng(7)
    B = 6
    store, h, g = _bf16(rng, M, Np, C), _bf16(rng, B, Np, H), _bf16(rng, B, C)
    rows = rng.integers(0, M, size=B).astype(np.int32)

    # make_call.kernel: dwv accumulated over the questions, dal per one.
    f32 = jnp.float32
    dwv = jnp.zeros((C, H), f32)
    dal = []
    for b in range(B):
        v = jnp.asarray(store[rows[b]])
        dz = jnp.asarray(h[b]).astype(f32) * 0.5
        dal.append(jax.lax.dot_general(
            jnp.asarray(g[b])[None], v, (((1,), (1,)), ((), ())),
            preferred_element_type=f32)[0])
        dwv = dwv + jax.lax.dot_general(
            v, dz.astype(v.dtype), (((0,), (0,)), ((), ())),
            preferred_element_type=f32)
    got_dwv, got_dal = p2.probe_bwd_ceiling_reference(
        _t(store), torch.from_numpy(rows), _t(h), _t(g))
    np.testing.assert_allclose(got_dwv.numpy(), np.asarray(dwv), **TOL)
    np.testing.assert_allclose(got_dal.numpy(), np.stack(dal), **TOL)


def test_probe_wrappers_refuse_cpu_tensors_and_runs_need_a_card(monkeypatch):
    rng = np.random.default_rng(0)
    store, wv = _t(_bf16(rng, M, Np, C)), _t(_bf16(rng, C, 128))
    rows = torch.zeros(4, dtype=torch.int32)
    h, g = _t(_bf16(rng, 4, Np, 128)), _t(_bf16(rng, 4, C))
    before = (p1.probe_mxu_rows.launches, p2.probe_bwd_ceiling.launches)
    with pytest.raises(ValueError, match="CUDA"):
        p1.probe_mxu_rows(store, rows, wv, 2)
    with pytest.raises(ValueError, match="CUDA"):
        p2.probe_bwd_ceiling(store, rows, h, g)
    assert (p1.probe_mxu_rows.launches,
            p2.probe_bwd_ceiling.launches) == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for probe in (p1, p2):
        with pytest.raises(RuntimeError, match="CUDA card"):
            probe.main([])


def test_probe_shapes_are_the_tpu_probes():
    """The sizes of tools/probe_mxu_rows.py and tools/probe_bwd_ceiling.py,
    and the operation counts their cost estimates state."""
    assert (p1.M, p1.Np, p1.C, p1.H, p1.B, p1.ITERS) == (64, 200, 2048, 512,
                                                        252, 96)
    assert all(p1.B % q == 0 for q in p1.QS) and p1.QS == (1, 2, 3, 4)
    assert (p2.M, p2.Np, p2.C, p2.H, p2.B, p2.ITERS) == (64, 200, 2048, 512,
                                                        256, 96)
    assert p1.FLOPS == 2 * 252 * 200 * 2048 * 512  # 105.7 GFLOP
    assert p2.FLOPS == 2 * 256 * 200 * 2048 * 513  # 107.6 GFLOP


@pytest.mark.parametrize("q,tiles", [(1, 2), (2, 4), (3, 5), (4, 7)])
def test_probe_mxu_rows_tile_accounting(q, tiles):
    """P1's groups of q questions of 200 rows in 128-row tiles, the last
    tile of a group padded with zero rows: the tiles a group takes and the
    share of the rows computed that are useful (what ``run()`` reports)."""
    assert p1.TILE_ROWS == 128
    got_tiles, useful = p1.tile_accounting(q)
    assert got_tiles == tiles
    assert useful == pytest.approx(q * 200 / (tiles * 128))
    assert (tiles - 1) * 128 < q * 200 <= tiles * 128


def test_score_mainloop_is_one_header_of_k4_and_p1():
    """K4's score kernel and P1 include the one wgmma mainloop, so the build
    hash of both libraries covers it (and the int8 widening it calls); K4
    also includes the score tile around it that it shares with K2."""
    from vqa_transfer_externaldata_torch.ops import kernels

    for name, tile in (("attention_resident_fwd", ["score_tile.cuh"]),
                       ("probe_mxu_rows", [])):
        assert [p.name for p in kernels.sources(name)] == [
            f"{name}.cu", "score_gemm.cuh", *tile, "store_rows.cuh",
            "elem16.cuh"]
