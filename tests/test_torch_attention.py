"""Port parity: ops/attention.py against the JAX package, whose
``spatial_attention(use_pallas=True)`` runs the Pallas kernel B5 in
interpret mode on the CPU.

float32 cases use 1e-5: the same math in f32 with sums in another order
(the Pallas kernel streams cells in chunks of 128 with an online softmax,
the plain version takes one softmax over all cells). The bf16 case uses
1e-2: the kernel rounds p*r to bf16 against a running maximum, the plain
version against the global one, so single weights may round one bf16 ulp
(2^-8) apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.ops import attention as ja
from vqa_transfer_externaldata_torch.ops import attention as ta

torch.set_num_threads(2)  # xdist runs several workers on the same cores

F32 = dict(rtol=1e-5, atol=1e-5)
B, C, H = 3, 16, 8


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    v = np.abs(rng.normal(size=(B, n, C))).astype(np.float32)
    qh = rng.normal(size=(B, H)).astype(np.float32)
    wv = (rng.normal(size=(C, H)) * 0.5).astype(np.float32)
    ws = rng.normal(size=(H,)).astype(np.float32)
    return v, qh, wv, ws


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n", [9, 196])
@pytest.mark.parametrize("normalize", [True, False])
def test_spatial_attention_matches_jax_pallas(n, normalize):
    v, qh, wv, ws = _inputs(n)
    jv, ja_ = ja.spatial_attention(jnp.asarray(v), jnp.asarray(qh),
                                   jnp.asarray(wv), jnp.asarray(ws),
                                   normalize=normalize, use_pallas=True)
    tv, talpha = ta.spatial_attention(*_torch(v, qh, wv, ws),
                                      normalize=normalize)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32)
    np.testing.assert_allclose(talpha.numpy(), np.asarray(ja_), **F32)
    np.testing.assert_allclose(talpha.sum(1).numpy(), 1.0, rtol=1e-5)


def test_spatial_attention_bf16_matches_jax_pallas():
    v, qh, wv, ws = _inputs(196, seed=1)
    jv, jalpha = ja.spatial_attention(
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(qh, jnp.bfloat16),
        jnp.asarray(wv), jnp.asarray(ws), normalize=True, use_pallas=True)
    tv, talpha = ta.spatial_attention(
        torch.from_numpy(v).to(torch.bfloat16),
        torch.from_numpy(qh).to(torch.bfloat16),
        *_torch(wv, ws), normalize=True)
    assert tv.dtype == torch.float32 and talpha.dtype == torch.float32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(talpha.numpy(), np.asarray(jalpha),
                               rtol=1e-2, atol=1e-4)


@pytest.mark.parametrize("oracle", ["spatial_attention_reference",
                                    "_reference_postscaled"])
def test_oracles_match_jax(oracle):
    v, qh, wv, ws = _inputs(9, seed=2)
    jv, jalpha = getattr(ja, oracle)(*(jnp.asarray(a)
                                       for a in (v, qh, wv, ws)))
    tv, talpha = getattr(ta, oracle)(*_torch(v, qh, wv, ws))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32)
    np.testing.assert_allclose(talpha.numpy(), np.asarray(jalpha), **F32)


def test_kernel_plain_version_equals_postscaled_oracle_in_f32():
    """In f32 the kernel's rounding points are no-ops, so its plain version
    is the scale-after-matmul oracle."""
    v, qh, wv, ws = _inputs(9, seed=3)
    a = ta.attention_fwd_reference(*_torch(v, qh, wv, ws), True)
    b = ta._reference_postscaled(*_torch(v, qh, wv, ws))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_attention_fwd_wrapper_refuses_cpu_tensors():
    v, qh, wv, ws = _torch(*_inputs(9))
    before = ta.attention_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        ta.attention_fwd(v.to(torch.bfloat16), qh, wv.to(torch.bfloat16), ws,
                         normalize=True)
    ta.spatial_attention(v, qh, wv, ws, normalize=True)  # plain version
    assert ta.attention_fwd.launches == before
