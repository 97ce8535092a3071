"""Port parity: the bidirectional GRU of ops/gru.py. ``bigru_fused``
through its autograd Function (on the CPU the plain versions
``bigru_reference`` / ``bigru_bwd_reference``) against ``jax.vjp`` of the
JAX package's ``bigru_fused``, whose forward and backward are the Pallas
kernels B7/B8 in interpret mode; and ``BiGRUEncoder`` against two
per-direction ``GRUEncoder`` calls on the same bridged weights, and against
the JAX encoder fused and unfused.

Tolerances, those of tests/test_gru.py for the fused path: float32
outputs 1e-5 (the same recurrence with sums in another order, at most 7
steps) and gradients 1e-4 (the BPTT carries those differences back through
7 steps and the projection). bfloat16 2e-3: the state is rounded to bf16
ahead of each hidden matmul in both frameworks, and where the f32 states
differ in their last bit a rounding can flip, moving a product by one bf16
ulp (2^-8 of it) that later steps carry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.ops import gru as jg
from vqa_transfer_externaldata_torch.ops import gru as tg
from vqa_transfer_externaldata_torch.ops import kernels
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
T, B, D, H = 7, 5, 6, 8
LENS = np.array([7, 1, 4, 0, 3], np.int32)  # the longest, 1, an empty row


def _fused_inputs(seed):
    rng = np.random.default_rng(seed)
    gx = [rng.normal(size=(T, B, 3 * H)).astype(np.float32) for _ in "fb"]
    uh = [rng.normal(size=(H, 3 * H)).astype(np.float32) * 0.4
          for _ in "fb"]
    bhn = [rng.normal(size=(H,)).astype(np.float32) * 0.2 for _ in "fb"]
    ghT = [rng.normal(size=(B, H)).astype(np.float32) for _ in "fb"]
    return gx, uh, bhn, ghT


def test_bigru_fused_grads_match_jax_vjp():
    gx, uh, bhn, ghT = _fused_inputs(0)
    lens = jnp.asarray(LENS)

    def f(gxf, gxb, uhf, uhb, bhnf, bhnb):
        return jg.bigru_fused(gxf, gxb, lens, uhf, uhb, bhnf, bhnb,
                              interpret=True)

    args = (gx[0], gx[1], uh[0], uh[1], bhn[0], bhn[1])
    (hf_j, hb_j), vjp = jax.vjp(f, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(ghT[0]), jnp.asarray(ghT[1])))
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    hf, hb = tg.bigru_fused(ins[0], ins[1], torch.from_numpy(LENS), *ins[2:])
    torch.autograd.backward([hf, hb], [torch.from_numpy(g) for g in ghT])
    np.testing.assert_allclose(hf.detach().numpy(), np.asarray(hf_j), **F32)
    np.testing.assert_allclose(hb.detach().numpy(), np.asarray(hb_j), **F32)
    names = ("dgxf", "dgxb", "duhf", "duhb", "dbhnf", "dbhnb")
    for name, t, w in zip(names, ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD,
                                   err_msg=name)


def test_bigru_reference_hseq_matches_jax_kernel():
    """Both chains' full state sequences (K7's residuals) against the
    Pallas B7 kernel's."""
    gx, uh, bhn, _ = _fused_inputs(1)
    want = jg._bigru_pallas_fwd_call(
        *map(jnp.asarray, (gx[0], gx[1], LENS, uh[0], uh[1], bhn[0],
                           bhn[1])), interpret=True)
    got = tg.bigru_reference(
        *map(torch.from_numpy, (gx[0], gx[1], LENS, uh[0], uh[1], bhn[0],
                                bhn[1])))
    for name, a, w in zip(("hTf", "hTb", "hseqf", "hseqb"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **F32,
                                   err_msg=name)


def _encoder_inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    mask = (np.arange(T)[None, :] < LENS[:, None]).astype(np.float32)
    tree = {d: {"wx": rng.normal(size=(D, 3 * H)).astype(np.float32) * 0.4,
                "uh": rng.normal(size=(H, 3 * H)).astype(np.float32) * 0.4,
                "b": rng.normal(size=(3 * H,)).astype(np.float32) * 0.2,
                "bhn": rng.normal(size=(H,)).astype(np.float32) * 0.2}
            for d in ("fwd", "bwd")}
    return x, mask, tree


def _port_encoder(tree, dtype=torch.float32):
    enc = tg.BiGRUEncoder(D, H, dtype=dtype)
    enc.load_state_dict(params_from_flax(tree))
    return enc


class _TwoEncoders(torch.nn.Module):
    """The unfused composition: a GRUEncoder per direction (K1/K3 on
    CUDA), its outputs concatenated."""

    def __init__(self):
        super().__init__()
        self.fwd = tg.GRUEncoder(D, H, dtype=torch.float32)
        self.bwd = tg.GRUEncoder(D, H, dtype=torch.float32, reverse=True)

    def forward(self, x, mask):
        return torch.cat([self.fwd(x, mask), self.bwd(x, mask)], dim=-1)


def _unfused_encoder(tree):
    enc = _TwoEncoders()
    enc.load_state_dict(params_from_flax(tree))
    return enc


def _loss_and_grads(enc, x, mask, g):
    xt = torch.from_numpy(x).requires_grad_()
    out = enc(xt, torch.from_numpy(mask))
    (out.float() * torch.from_numpy(g)).sum().backward()
    grads = {k: p.grad.clone() for k, p in enc.named_parameters()}
    grads["x"] = xt.grad
    return out.detach(), grads


def test_fused_encoder_matches_unfused_on_the_same_weights():
    x, mask, tree = _encoder_inputs(2)
    g = np.random.default_rng(3).normal(size=(B, 2 * H)).astype(np.float32)
    out_f, gr_f = _loss_and_grads(_port_encoder(tree), x, mask, g)
    out_u, gr_u = _loss_and_grads(_unfused_encoder(tree), x, mask, g)
    np.testing.assert_allclose(out_f.numpy(), out_u.numpy(), **F32)
    assert set(gr_f) == set(gr_u)
    for k in gr_u:
        np.testing.assert_allclose(gr_f[k].numpy(), gr_u[k].numpy(), **GRAD,
                                   err_msg=k)


@pytest.mark.parametrize("fuse", [False, True])
def test_encoder_matches_jax_bigru(fuse):
    """Outputs and every gradient against the JAX BiGRUEncoder (time
    major), fused through B7/B8 or unfused through B1/B2: the port's one
    path gives both."""
    x, mask, tree = _encoder_inputs(4)
    g = np.random.default_rng(5).normal(size=(B, 2 * H)).astype(np.float32)
    jenc = jg.BiGRUEncoder(H, dtype=jnp.float32, time_major=True,
                           fuse_directions=fuse)

    def f(p, x):
        return jnp.sum(jenc.apply({"params": p}, x, jnp.asarray(mask))
                       * jnp.asarray(g))

    want_out = jenc.apply({"params": tree}, jnp.asarray(x), jnp.asarray(mask))
    gp, gx = jax.grad(f, argnums=(0, 1))(tree, jnp.asarray(x))
    want = params_from_flax(jax.device_get(gp))
    out, grads = _loss_and_grads(_port_encoder(tree), x, mask, g)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **F32)
    np.testing.assert_allclose(grads.pop("x").numpy(), np.asarray(gx), **GRAD)
    assert set(grads) == set(want)
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(), **GRAD,
                                   err_msg=k)


def test_fused_encoder_bf16_matches_jax():
    """bf16 compute: both frameworks round x, W_x and U_h to bf16 and the
    state ahead of each hidden matmul."""
    x, mask, tree = _encoder_inputs(6)
    jenc = jg.BiGRUEncoder(H, dtype=jnp.bfloat16, time_major=True,
                           fuse_directions=True)
    want = jenc.apply({"params": tree}, jnp.asarray(x), jnp.asarray(mask))
    enc = _port_encoder(tree, dtype=torch.bfloat16)
    with torch.no_grad():
        got = enc(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("fuse", [False, True])
def test_junk_past_a_rows_length_changes_nothing(fuse):
    """Both directions mask t < len, in the BiGRUEncoder and in the
    per-direction composition it replaces: junk in a row's padded tail
    leaves its output and the gradients of its valid steps as they
    were."""
    x, mask, tree = _encoder_inputs(7)
    g = np.random.default_rng(8).normal(size=(B, 2 * H)).astype(np.float32)
    x2 = x.copy()
    for b, n in enumerate(LENS):
        x2[n:, b] = 77.0
    enc = _port_encoder(tree) if fuse else _unfused_encoder(tree)
    out1, g1 = _loss_and_grads(enc, x, mask, g)
    enc.zero_grad()
    out2, g2 = _loss_and_grads(enc, x2, mask, g)
    np.testing.assert_allclose(out2.numpy(), out1.numpy(), rtol=1e-6,
                               atol=1e-6)
    valid = torch.from_numpy(mask.T[:, :, None] > 0)
    np.testing.assert_allclose((g2["x"] * valid).numpy(),
                               (g1["x"] * valid).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert g2["x"][~valid.expand_as(g2["x"])].abs().max().item() == 0.0
    for k in ("fwd.uh", "bwd.uh", "fwd.bhn", "bwd.bhn"):
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_bigru_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise; the CPU path
    goes through bigru_fused's plain versions, never through them."""
    gx, uh, bhn, ghT = _fused_inputs(9)
    t = [torch.from_numpy(a) for a in (gx[0], gx[1], uh[0], uh[1], bhn[0],
                                       bhn[1])]
    lens = torch.from_numpy(LENS)
    before = tg.bigru_fwd.launches, tg.bigru_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        tg.bigru_fwd(t[0], t[1], lens, t[2].bfloat16(), t[3].bfloat16(),
                     t[4], t[5])
    with pytest.raises(ValueError, match="CUDA"):
        tg.bigru_bwd(t[0], t[1], t[0][..., :H], t[1][..., :H], lens,
                     t[2].bfloat16(), t[3].bfloat16(), t[4], t[5],
                     *map(torch.from_numpy, ghT))
    hf, hb = tg.bigru_fused(t[0], t[1], lens, *t[2:])
    assert hf.shape == hb.shape == (B, H)
    assert (tg.bigru_fwd.launches, tg.bigru_bwd.launches) == before


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """A kernel library's name changes when a csrc header that its source
    includes changes, so an edited shared step kernel is rebuilt; the
    libraries of K1/K6 and K3/K7 name their shared headers, and K1, K6 and
    K3 the mma.sync primitives they share; the per-step kernel and WMMA
    are gone from K1/K6's header."""
    assert [p.name for p in kernels.sources("bigru_fwd")] == [
        "bigru_fwd.cu", "gru_fwd_step.cuh", "mma_sync.cuh", "elem16.cuh"]
    header = (kernels.CSRC / "gru_fwd_step.cuh").read_text()
    assert "gru_step_kernel" not in header and "wmma" not in header
    assert [p.name for p in kernels.sources("gru_bwd")] == [
        "gru_bwd.cu", "gru_bwd_step.cuh", "mma_sync.cuh", "elem16.cuh"]
    (tmp_path / "k.cu").write_text('#include "step.cuh"\nint f();\n')
    (tmp_path / "step.cuh").write_text("// v1\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels.library_path("k")
    assert before == kernels.library_path("k")
    (tmp_path / "step.cuh").write_text("// v2\n")
    assert kernels.library_path("k") != before
