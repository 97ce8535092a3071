"""Port parity: the differentiable gathered attention of ops/attention.py
against the JAX package's ``spatial_attention`` (custom VJP) and its fused
backward B6, which run their Pallas kernels in interpret mode on the CPU.

float32 throughout: the cotangents agree to 1e-4 (rtol and atol, JAX's own
bound between its two backwards in ``tests/test_attention.py``: the same
math with sums in another order). The loss drives both outputs, v_att and
alpha.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.ops import attention as ja
from vqa_transfer_externaldata_torch.ops import attention as ta

torch.set_num_threads(2)  # xdist runs several workers on the same cores

B, N, C, H = 3, 20, 32, 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(B, N, C)).astype(np.float32)
    qh = rng.normal(size=(B, H)).astype(np.float32)
    wv = (rng.normal(size=(C, H)) * 0.3).astype(np.float32)
    ws = rng.normal(size=(H,)).astype(np.float32)
    return v, qh, wv, ws


def _jax_grads(arrays, **kw):
    def loss(v, qh, wv, ws):
        v_att, alpha = ja.spatial_attention(v, qh, wv, ws, use_pallas=False,
                                            interpret=True, **kw)
        return jnp.sum(v_att ** 2) + jnp.sum(alpha ** 3)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in arrays))]


def _torch_grads(arrays, **kw):
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    v_att, alpha = ta.spatial_attention(*ins, **kw)
    (v_att.square().sum() + alpha.pow(3).sum()).backward()
    return [None if t.grad is None else t.grad.numpy() for t in ins]


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("bwd_kernel", [True, False])
def test_parameter_grads_match_jax(normalize, bwd_kernel):
    """dqh, dW_v and dws of the op against jax.grad of JAX's op with the
    same backward choice: K8's plain version (bwd_kernel) against B6
    interpreted, the explicit math against JAX's; the grid gets none."""
    arrays = _inputs(1)
    want = _jax_grads(arrays, normalize=normalize, bwd_kernel=bwd_kernel,
                      feature_grad=False)
    got = _torch_grads(arrays, normalize=normalize, bwd_kernel=bwd_kernel,
                       feature_grad=False)
    assert got[0] is None and not want[0].any()
    for name, a, b in zip(("dqh", "dwv", "dws"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_feature_grad_matches_jax(normalize):
    """With feature_grad the explicit backward also gives dv (through the
    fused normalization), as JAX's does."""
    arrays = _inputs(2)
    want = _jax_grads(arrays, normalize=normalize, feature_grad=True)
    got = _torch_grads(arrays, normalize=normalize, feature_grad=True)
    for name, a, b in zip(("dv", "dqh", "dwv", "dws"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_bwd_reference_matches_jax_pallas_bwd(normalize):
    """K8's plain version against the Pallas body B6 (interpreted), both fed
    the same score cotangent ds and per-cell norm r."""
    v, qh, wv, ws = _inputs(3)
    rng = np.random.default_rng(4)
    ds = rng.normal(size=(B, N)).astype(np.float32)
    r = (1.0 / np.sqrt((v ** 2).sum(-1) + 1e-12)).astype(np.float32)
    want = ja._attention_pallas_bwd(
        *(jnp.asarray(a) for a in (v, qh, wv, ws, ds, r)), interpret=True,
        normalize=normalize)
    got = ta.attention_bwd_reference(
        *(torch.from_numpy(a) for a in (v, qh, wv, ws, ds, r)), normalize)
    for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("bwd_kernel,feature_grad,kernel_path", [
    (True, False, True), (False, False, False), (True, True, False)])
def test_backward_path_selection(monkeypatch, bwd_kernel, feature_grad,
                                 kernel_path):
    """The op takes K8 (on the CPU its plain version) only with bwd_kernel
    and without feature_grad; otherwise the explicit math."""
    calls = []
    plain = ta.attention_bwd_reference
    monkeypatch.setattr(ta, "attention_bwd_reference",
                        lambda *a: calls.append(1) or plain(*a))
    _torch_grads(_inputs(5), normalize=True, bwd_kernel=bwd_kernel,
                 feature_grad=feature_grad)
    assert bool(calls) == kernel_path


def test_forward_saves_the_norm_it_used():
    """The forward's plain version returns the per-cell norm r it scaled
    by (ones without normalize), which the backward reuses."""
    v, qh, wv, ws = (torch.from_numpy(a) for a in _inputs(6))
    _, _, r = ta.attention_fwd_reference(v, qh, wv, ws, True)
    torch.testing.assert_close(r, torch.rsqrt(v.square().sum(-1) + 1e-12))
    _, _, ones = ta.attention_fwd_reference(v, qh, wv, ws, False)
    assert torch.equal(ones, torch.ones(B, N))
