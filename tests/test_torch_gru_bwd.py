"""Port parity: the GRU backward (ops/gru.py ``gru_fused`` through its
autograd Function, on the CPU through ``gru_bwd_reference``) against
``jax.vjp`` of the JAX package's ``gru_fused``, whose backward is the
Pallas BPTT kernel B2 in interpret mode.

float32: tolerance 1e-5 (the same BPTT in f32 with sums in another order,
over at most 7 steps). The bf16 case holds the plain version to the
kernel's rounding points (h_prev and the gate cotangents rounded to bf16
ahead of their products): 1e-4, the f32 sums of up to 7 * 5 bf16 products
in another order, where a last-bit difference can flip one rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.ops import gru as jg
from vqa_transfer_externaldata_torch.ops import gru as tg

torch.set_num_threads(2)  # xdist runs several workers on the same cores

T, B, H = 7, 5, 8
LENS = np.array([7, 1, 4, 0, 3], np.int32)  # the longest, 1, an empty row


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, B, 3 * H)).astype(np.float32),
            rng.normal(size=(H, 3 * H)).astype(np.float32) * 0.4,
            rng.normal(size=(H,)).astype(np.float32) * 0.2,
            rng.normal(size=(B, H)).astype(np.float32))


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_fused_grads_match_jax_vjp(reverse):
    gx, uh, bhn, ghT = _inputs(0)
    lens = jnp.asarray(LENS)

    def f(gx, uh, bhn):
        return jg.gru_fused(gx, lens, uh, bhn, reverse=reverse,
                            interpret=True)

    hT_j, vjp = jax.vjp(f, jnp.asarray(gx), jnp.asarray(uh), jnp.asarray(bhn))
    want = vjp(jnp.asarray(ghT))
    ins = [torch.from_numpy(a).requires_grad_() for a in (gx, uh, bhn)]
    hT = tg.gru_fused(ins[0], torch.from_numpy(LENS), ins[1], ins[2],
                      reverse=reverse)
    hT.backward(torch.from_numpy(ghT))
    np.testing.assert_allclose(hT.detach().numpy(), np.asarray(hT_j),
                               rtol=1e-5, atol=1e-5)
    for name, t, w in zip(("dgx", "duh", "dbhn"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_bwd_reference_bf16_matches_pallas_kernel(reverse):
    """bf16 U_h: the plain version rounds where the Pallas kernel does."""
    gx, uh, bhn, ghT = _inputs(1)
    uh16 = jnp.asarray(uh).astype(jnp.bfloat16)
    _, hseq = jg._gru_pallas_fwd_call(jnp.asarray(gx), jnp.asarray(LENS),
                                      uh16, jnp.asarray(bhn),
                                      interpret=True, reverse=reverse)
    want = jg._gru_pallas_bwd_call(jnp.asarray(gx), hseq, jnp.asarray(LENS),
                                   uh16, jnp.asarray(bhn), jnp.asarray(ghT),
                                   interpret=True, reverse=reverse)
    got = tg.gru_bwd_reference(
        torch.from_numpy(gx), torch.from_numpy(np.array(hseq)),
        torch.from_numpy(LENS), torch.from_numpy(uh).to(torch.bfloat16),
        torch.from_numpy(bhn), torch.from_numpy(ghT), reverse=reverse)
    for name, t, w in zip(("dgx", "duh", "dbhn"), got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w, np.float32),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_encoder_is_differentiable_in_all_its_params():
    """GRUEncoder.forward backpropagates through the fused recurrence into
    wx, b (autograd matmuls) and uh, bhn (the BPTT)."""
    enc = tg.GRUEncoder(6, H, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    x = torch.randn(T, B, 6, generator=torch.Generator().manual_seed(1))
    mask = (torch.arange(T)[None, :] < torch.from_numpy(LENS)[:, None])
    enc(x, mask.float()).square().sum().backward()
    for name, p in enc.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name


def test_gru_bwd_wrapper_refuses_cpu_tensors():
    """The K3 wrapper launches on CUDA tensors or raises; on the CPU the
    Function takes the plain version and no launch is counted."""
    z = torch.zeros
    before = tg.gru_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        tg.gru_bwd(z(2, 3, 3 * 64), z(2, 3, 64), torch.ones(3, dtype=torch.int32),
                   z(64, 3 * 64, dtype=torch.bfloat16), z(64), z(3, 64))
    gx = torch.zeros(2, 3, 3 * H, requires_grad=True)
    tg.gru_fused(gx, torch.ones(3, dtype=torch.int32), torch.zeros(H, 3 * H),
                 torch.zeros(H)).sum().backward()
    assert gx.grad.shape == gx.shape
    assert tg.gru_bwd.launches == before
