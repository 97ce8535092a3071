"""Port parity: ops/attention_resident.py against the JAX package's
``spatial_attention_resident``, whose forward and backward are the Pallas
kernels B3 and B4 in interpret mode on the CPU.

float32 store: the forward to 1e-5 and the grads (dqh, dwv, dws) to 1e-5
(the same math in f32, sums over 2048-free tiny widths in another order).
Np > n_valid (padded cells) and rows that repeat an image are covered.
``pad_store_rows`` and ``prenormalize_store`` must be bit-equal to JAX's.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.ops import attention_resident as jar
from vqa_transfer_externaldata_torch.ops import attention_resident as tar

torch.set_num_threads(2)  # xdist runs several workers on the same cores

M, N, C, H, B = 6, 13, 24, 16, 8  # Np = 16 > n_valid = 13
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    grid = np.abs(rng.normal(size=(M, N, C))).astype(np.float32)
    grid *= np.exp2(rng.uniform(-2, 2, size=(M, N, 1))).astype(np.float32)
    store = jar.pad_store_rows(grid)
    rows = rng.integers(0, M, size=B).astype(np.int32)
    rows[1] = rows[0]  # two questions about one image
    qh = rng.normal(size=(B, H)).astype(np.float32) * 0.5
    wv = rng.normal(size=(C, H)).astype(np.float32) * 0.3
    ws = rng.normal(size=(H,)).astype(np.float32) * 0.3
    g = rng.normal(size=(B, C)).astype(np.float32)
    ga = rng.normal(size=(B, N)).astype(np.float32)
    return store, rows, qh, wv, ws, g, ga


@pytest.mark.parametrize("normalize", [True, False])
def test_forward_and_grads_match_jax(normalize):
    store, rows, qh, wv, ws, g, ga = _inputs()

    def f(qh, wv, ws):
        return jar.spatial_attention_resident(
            jnp.asarray(store), jnp.asarray(rows), qh, wv, ws, n_valid=N,
            normalize=normalize, interpret=True)

    (va_j, al_j), vjp = jax.vjp(f, jnp.asarray(qh), jnp.asarray(wv),
                                jnp.asarray(ws))
    want = vjp((jnp.asarray(g), jnp.asarray(ga)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (qh, wv, ws)]
    va, al = tar.spatial_attention_resident(
        torch.from_numpy(store), torch.from_numpy(rows), *ins, n_valid=N,
        normalize=normalize)
    assert al.shape == (B, N)
    np.testing.assert_allclose(va.detach().numpy(), np.asarray(va_j), **TOL)
    np.testing.assert_allclose(al.detach().numpy(), np.asarray(al_j), **TOL)
    (va * torch.from_numpy(g)).sum().add(
        (al * torch.from_numpy(ga)).sum()).backward()
    for name, t, w in zip(("dqh", "dwv", "dws"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def test_unused_alpha_gives_the_same_grads_as_a_zero_cotangent():
    """A loss that ignores alpha (the model's) matches JAX's zero ga."""
    store, rows, qh, wv, ws, g, _ = _inputs(1)

    def f(qh, wv, ws):
        return jar.spatial_attention_resident(
            jnp.asarray(store), jnp.asarray(rows), qh, wv, ws, n_valid=N,
            normalize=True, interpret=True)[0]

    _, vjp = jax.vjp(f, jnp.asarray(qh), jnp.asarray(wv), jnp.asarray(ws))
    want = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(a).requires_grad_() for a in (qh, wv, ws)]
    va, _ = tar.spatial_attention_resident(
        torch.from_numpy(store), torch.from_numpy(rows), *ins, n_valid=N,
        normalize=True)
    va.backward(torch.from_numpy(g))
    for name, t, w in zip(("dqh", "dwv", "dws"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def test_no_grad_forward_saves_nothing_and_store_gets_no_grad():
    store, rows, qh, wv, ws, _, _ = _inputs(2)
    st = torch.from_numpy(store).requires_grad_()
    with torch.no_grad():
        va, _ = tar.spatial_attention_resident(
            st, torch.from_numpy(rows), torch.from_numpy(qh),
            torch.from_numpy(wv), torch.from_numpy(ws), n_valid=N)
    assert va.grad_fn is None
    w = torch.from_numpy(wv).requires_grad_()
    va, _ = tar.spatial_attention_resident(
        st, torch.from_numpy(rows), torch.from_numpy(qh), w,
        torch.from_numpy(ws), n_valid=N)
    va.sum().backward()
    assert st.grad is None and w.grad is not None


def test_evaluation_saves_no_h_with_trainable_params(monkeypatch):
    """Under no_grad the forward saves no h ([B, Np, H], 52 MB a batch at
    full width) even though the parameters require gradients, as in the
    resident evaluator: the Function's needs_input_grad follows the inputs'
    requires_grad, not the grad mode, so the op decides from the grad mode
    before it applies the Function."""
    store, rows, qh, wv, ws, _, _ = _inputs(3)
    seen = []
    plain = tar.attention_resident_fwd_reference
    monkeypatch.setattr(tar, "attention_resident_fwd_reference",
                        lambda *a, **kw: seen.append(kw["save_h"])
                        or plain(*a, **kw))
    params = [torch.from_numpy(x).requires_grad_() for x in (qh, wv, ws)]
    args = (torch.from_numpy(store), torch.from_numpy(rows), *params)
    with torch.no_grad():
        tar.spatial_attention_resident(*args, n_valid=N)
    tar.spatial_attention_resident(*args, n_valid=N)
    assert seen == [False, True]


def test_pad_and_prenormalize_are_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    grid = (rng.normal(size=(5, N, C)) * 3).astype(np.float16)
    np.testing.assert_array_equal(tar.pad_store_rows(grid),
                                  jar.pad_store_rows(grid))
    for out_np, out_t in ((None, None), (ml_dtypes.bfloat16, torch.bfloat16),
                          (np.float32, torch.float32)):
        # A small chunk so that the chunked pass runs more than once.
        want, scale = jar.prenormalize_store(grid, out_dtype=out_np,
                                             chunk_bytes=2 * N * C * 4)
        got, tscale = tar.prenormalize_store(grid, out_dtype=out_t,
                                             chunk_bytes=2 * N * C * 4)
        assert scale == tscale == 1.0
        assert tuple(got.shape) == want.shape == (5, 16, C)
        bits = np.uint16 if want.itemsize == 2 else np.uint32
        tbits = torch.int16 if want.itemsize == 2 else torch.int32
        np.testing.assert_array_equal(
            got.view(tbits).numpy().view(bits), want.view(bits))
    assert grid.dtype == np.float16  # the source is left as it was


def test_kernel_wrappers_refuse_cpu_tensors():
    store, rows, qh, wv, ws, g, _ = _inputs()
    before = (tar.attention_resident_fwd.launches,
              tar.attention_resident_bwd.launches)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA"):
        tar.attention_resident_fwd(t(store), t(rows), t(qh), t(wv), t(ws),
                                   n_valid=N, normalize=False)
    with pytest.raises(ValueError, match="CUDA"):
        tar.attention_resident_bwd(t(store), t(rows), t(qh), t(ws),
                                   t(qh), t(g), t(qh), n_valid=N,
                                   normalize=False)
    assert (tar.attention_resident_fwd.launches,
            tar.attention_resident_bwd.launches) == before
