"""Every width the Pallas bodies take, on the CPU: the padding functions
that the port's 16-bit kernel wrappers wrap around their kernels (H to 16
for K1/K6 and to 64 for K3/K7, C to 32 for K2/K4 and to 128 for K5/K8, the
attention's H to 128, a resident store's channels to 128 at upload),
wrapped here around each kernel's plain version; the route between the
GRU's persistent kernels and its step form
(``kernels.gru_fwd_route`` / ``gru_bwd_route``) on given occupancy
numbers; the port's encoders and attention ops at odd widths against the
JAX package's, whose B1-B8 run in interpret mode in bf16; and the slice as
a whole: ``tools/oov_claim.py``'s TINY config in bf16, the first stage-2
step's loss and gradients against JAX's.

Tolerances. Padding adds exact zeros, so in exact arithmetic the padded
plain version equals the unpadded one. In float32 on the CPU it does not
bit for bit: MKL's sgemm sums the contracted axis in blocks whose sizes
follow the shapes, so the same products of a width-H and a width-Hp sum
are added in another order (with MKL on an AVX-512 CPU, 16 of 40 such
products differ in the last bit), and a last-bit difference can flip a
later 16-bit rounding. What padding must keep exact is checked bit for bit: the
padded units and channels of every output are exactly 0, and slicing a
padded input back gives the input. The real outputs are held to the limits
the kernels are held to against these same plain versions (PERF.md §2,
float16's scaled by its step, 1/8): h 2e-3 absolute, K3's outputs 2^-8 of
their largest value, K2's alpha 1e-5, v_att 2^-10 and r 1e-6 of their
largest value, K8's and K5's outputs 2^-9 (K5's dqh and dW_v G times
that), K4's saved h 2^-7.

Against JAX in bf16 both sides round at the same places, with f32 sums in
another order, so a last-bit difference can move a bf16 rounding by one
step (2^-8 of a value) and what follows carries it: h to 4e-3 absolute
(|h| < 1), the GRU's gradients and the attention's v_att and alpha to
2^-7 of their largest value (two bf16 steps). The attention's gradients
sum terms of both signs over cells, units and glimpses, so the largest
value can be far below the terms and a flip near a ReLU boundary moves
one entry by more than 2^-7 of it (up to 2^-5 read at H = 600, G = 2):
they are held to cosine 0.9999 against JAX's (0.99997 the least read),
which a misplaced unit or channel would take far below.
The first training step of the whole model: the loss to 1e-2 absolute and
every gradient to cosine 0.999, the limits chip_smoke.py holds the card's
first step to against the plain path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.models.vqa_attention import (
    VQAAttentionModel as JaxModel, vqa_loss as jax_vqa_loss)
from vqa_transfer_externaldata_tpu.ops import attention as ja
from vqa_transfer_externaldata_tpu.ops import attention_resident as jar
from vqa_transfer_externaldata_tpu.ops import gru as jg
from vqa_transfer_externaldata_torch.models import vqa_attention as tmodel
from vqa_transfer_externaldata_torch.ops import attention as ta
from vqa_transfer_externaldata_torch.ops import attention_resident as tar
from vqa_transfer_externaldata_torch.ops import gru as tg
from vqa_transfer_externaldata_torch.ops import kernels
from vqa_transfer_externaldata_torch.tools import oov_claim
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

WIDTH_H = (8, 24, 40, 100, 600)
WIDTH_C = (16, 48, 100, 300)
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}
TOL_H = 2e-3
TOL_K3 = 2.0 ** -8
TOL_ALPHA = 1e-5
TOL_VATT = 2.0 ** -10
TOL_R = 1e-6
TOL_K5 = 2.0 ** -9
TOL_K4_H = 2.0 ** -7
JAX_TOL_H = 4e-3
JAX_TOL_REL = 2.0 ** -7
JAX_GRAD_COS = 0.9999
LOSS_ABS, GRAD_COS = 1e-2, 0.999
SMS = 132  # an H100 SXM's streaming multiprocessors


def _step(dtype):
    """float16's limits are bf16's with its step: 1/8."""
    return 1.0 if dtype == torch.bfloat16 else 0.125


def _cos(got, want):
    """The cosine of two arrays taken as vectors."""
    a = np.asarray(got, np.float64).ravel()
    b = np.asarray(want, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _rel(got, want, what=""):
    """The largest error of ``got`` relative to ``want``'s largest
    |value|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- the padding functions around the plain versions --------------------------


def _gru_inputs(T, B, H, dtype, seed=0):
    rng = np.random.default_rng(seed)
    gx = torch.from_numpy(rng.normal(size=(T, B, 3 * H)).astype(np.float32))
    lens = torch.from_numpy(rng.integers(0, T + 1, size=B).astype(np.int32))
    lens[0], lens[1] = T, 1
    uh = torch.from_numpy((rng.normal(size=(H, 3 * H)) * H ** -0.5).astype(
        np.float32)).to(dtype)
    bhn = torch.from_numpy((rng.normal(size=H) * 0.1).astype(np.float32))
    ghT = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32))
    return gx, lens, uh, bhn, ghT


def _gates(x):
    """[..., 3Hp] -> [..., 3, Hp]."""
    return x.reshape(*x.shape[:-1], 3, -1)


@pytest.mark.parametrize("H", WIDTH_H)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("pad", [kernels.GRU_FWD_PAD, kernels.GRU_BWD_PAD])
def test_gru_padding_around_the_plain_versions(H, dt, pad):
    """gru_pad, then K1's and K3's plain versions at Hp, then
    gru_unpad_fwd / gru_unpad_bwd, against the plain versions at H: the
    padded units stay exactly 0 in hseq, dgx, dU_h and db_hn, and the real
    outputs agree within K1's and K3's limits."""
    dtype = DTYPES[dt]
    T, B = 6, 9
    Hp = kernels.round_up(H, pad)
    gx, lens, uh, bhn, ghT = _gru_inputs(T, B, H, dtype)
    p = tg.gru_pad(Hp, gx, uh, bhn, None, ghT)
    assert p[1].shape == (Hp, 3 * Hp) and p[1].dtype == dtype
    assert torch.equal(tg._unpad_gates(p[0], H), gx)
    assert torch.equal(tg._unpad_gates(p[1][:H], H), uh)
    for reverse in (False, True):
        hT, hseq = tg.gru_reference(gx, lens, uh, bhn, reverse=reverse)
        pT, pseq = tg.gru_reference(p[0], lens, p[1], p[2], reverse=reverse)
        assert not pseq[..., H:].any() and not pT[:, H:].any()
        gT, gseq = tg.gru_unpad_fwd(H, pT, pseq)
        assert gseq.shape == hseq.shape and gseq.is_contiguous()
        assert (gseq - hseq).abs().max().item() <= TOL_H * _step(dtype)
        assert (gT - hT).abs().max().item() <= TOL_H * _step(dtype)
        want = tg.gru_bwd_reference(gx, hseq, lens, uh, bhn, ghT,
                                    reverse=reverse)
        pp = tg.gru_pad(Hp, gx, uh, bhn, hseq, ghT)
        dgx, duh, dbhn = tg.gru_bwd_reference(pp[0], pp[3], lens, pp[1],
                                              pp[2], pp[4], reverse=reverse)
        assert not _gates(dgx)[..., H:].any()
        assert not duh[H:].any() and not _gates(duh)[..., H:].any()
        assert not dbhn[H:].any()
        got = tg.gru_unpad_bwd(H, dgx, duh, dbhn)
        for name, a, b in zip(("dgx", "duh", "dbhn"), got, want):
            assert _rel(a, b, name) <= TOL_K3 * _step(dtype), name


@pytest.mark.parametrize("H", WIDTH_H)
@pytest.mark.parametrize("dt", DTYPES)
def test_bigru_padding_around_the_plain_versions(H, dt):
    """K6's and K7's plain versions around gru_pad at H's multiples of 16
    and 64: each direction equals its padded K1/K3 plain call bit for bit
    (the chains are independent) and the unpadded one within the limits."""
    dtype = DTYPES[dt]
    T, B = 5, 7
    f = _gru_inputs(T, B, H, dtype, 1)
    b = _gru_inputs(T, B, H, dtype, 2)
    lens = f[1]
    Hf = kernels.round_up(H, kernels.GRU_FWD_PAD)
    pf, pb = tg.gru_pad(Hf, *f[:1], *f[2:4]), tg.gru_pad(Hf, *b[:1], *b[2:4])
    got = tg.bigru_reference(pf[0], pb[0], lens, pf[1], pb[1], pf[2], pb[2])
    one = tg.gru_reference(pb[0], lens, pb[1], pb[2], reverse=True)
    assert torch.equal(got[1], one[0]) and torch.equal(got[3], one[1])
    want = tg.bigru_reference(f[0], b[0], lens, f[2], b[2], f[3], b[3])
    hTf, hseqf = tg.gru_unpad_fwd(H, got[0], got[2])
    hTb, hseqb = tg.gru_unpad_fwd(H, got[1], got[3])
    for a, w in zip((hTf, hTb, hseqf, hseqb), want):
        assert (a - w).abs().max().item() <= TOL_H * _step(dtype)
    Hb = kernels.round_up(H, kernels.GRU_BWD_PAD)
    qf = tg.gru_pad(Hb, f[0], f[2], f[3], want[2], f[4])
    qb = tg.gru_pad(Hb, b[0], b[2], b[3], want[3], b[4])
    grads = tg.bigru_bwd_reference(qf[0], qb[0], qf[3], qb[3], lens, qf[1],
                                   qb[1], qf[2], qb[2], qf[4], qb[4])
    wgrads = tg.bigru_bwd_reference(f[0], b[0], want[2], want[3], lens, f[2],
                                    b[2], f[3], b[3], f[4], b[4])
    unf = tg.gru_unpad_bwd(H, grads[0], grads[2], grads[4])
    unb = tg.gru_unpad_bwd(H, grads[1], grads[3], grads[5])
    for i, (name, w) in enumerate(zip(("dgxf", "dgxb", "duhf", "duhb",
                                       "dbhnf", "dbhnb"), wgrads)):
        a = (unf, unb)[i % 2][i // 2]
        assert _rel(a, w, name) <= TOL_K3 * _step(dtype), name


def _grid_inputs(B, N, C, H, dtype, seed=3):
    rng = np.random.default_rng(seed)
    v = np.abs(rng.normal(size=(B, N, C))).astype(np.float32)
    v *= np.exp2(rng.uniform(-2, 2, size=(B, N, 1))).astype(np.float32)
    qh = (rng.normal(size=(B, H)) * 0.5).astype(np.float32)
    wv = (rng.normal(size=(C, H)) * (6.0 / (C + H)) ** 0.5).astype(
        np.float32)
    ws = (rng.normal(size=H) * 0.3).astype(np.float32)
    ds = rng.normal(size=(B, N)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (v, qh, wv, ws, ds)]
    t[0], t[2] = t[0].to(dtype), t[2].to(dtype)
    t[3] = t[3].to(dtype).float()
    return t


@pytest.mark.parametrize("C", WIDTH_C)
@pytest.mark.parametrize("H", WIDTH_H)
@pytest.mark.parametrize("dt", DTYPES)
def test_gathered_attention_padding_around_the_plain_versions(C, H, dt):
    """attention_pad to K2's multiples (C to 32, H to 128) around K2's
    plain version and to K8's (both to 128) around K8's, then
    attention_unpad, against the plain versions at (C, H), normalize on
    and off: v_att's padded channels, dqh's and dws's padded units and
    dW_v's padded rows and columns exactly 0; the real outputs within K2's
    and K8's limits."""
    dtype = DTYPES[dt]
    B, N = 3, 11
    v, qh, wv, ws, ds = _grid_inputs(B, N, C, H, dtype)
    Hp = kernels.round_up(H, kernels.ATTENTION_UNITS)
    Cf = kernels.round_up(C, kernels.ATTENTION_FWD_CHANNELS)
    Cb = kernels.round_up(C, kernels.ATTENTION_BWD_CHANNELS)
    for normalize in (True, False):
        rv, ra, rr = ta.attention_fwd_reference(v, qh, wv, ws, normalize)
        padded = ta.attention_pad(Cf, Hp, v, qh, wv, ws)
        assert torch.equal(padded[0][..., :C], v)
        va, al, r = ta.attention_fwd_reference(*padded, normalize)
        assert not va[:, C:].any()
        va, = ta.attention_unpad(C, H, va)
        assert va.shape == rv.shape
        assert _rel(va, rv) <= TOL_VATT
        assert (al - ra).abs().max().item() <= TOL_ALPHA
        assert _rel(r, rr) <= TOL_R
        want = ta.attention_bwd_reference(v, qh, wv, ws, ds, rr, normalize)
        padded = ta.attention_pad(Cb, Hp, v, qh, wv, ws)
        dqh, dwv, dws = ta.attention_bwd_reference(*padded, ds, rr,
                                                   normalize)
        assert not dqh[:, H:].any() and not dws[H:].any()
        assert not dwv[C:].any() and not dwv[:, H:].any()
        got = ta.attention_unpad(C, H, dqh, dwv, dws)
        for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
            assert _rel(a, b, name) <= TOL_K5 * _step(dtype), name


def _store_inputs(M, n_valid, C, H, B, rows_type, dtype, seed=5):
    rng = np.random.default_rng(seed)
    grid = np.abs(rng.normal(size=(M, n_valid, C))).astype(np.float32)
    grid *= np.exp2(rng.uniform(-2, 2, size=(M, n_valid, 1))).astype(
        np.float32)
    if rows_type == "int8":
        g32 = grid / np.sqrt(np.sum(grid ** 2, -1, keepdims=True) + 1e-12)
        codes, _ = tar.quantize_store(g32)
        store = torch.from_numpy(tar.pad_store_rows(codes))
    else:
        store = torch.from_numpy(tar.pad_store_rows(grid)).to(dtype)
    rows = torch.from_numpy(rng.integers(0, M, size=B).astype(np.int32))
    qh = torch.from_numpy((rng.normal(size=(B, H)) * 0.5).astype(np.float32))
    wv = torch.from_numpy((rng.normal(size=(C, H)) * (6.0 / (C + H)) ** 0.5)
                          .astype(np.float32)).to(dtype)
    return store, rows, qh, wv, rng


@pytest.mark.parametrize("C", WIDTH_C)
@pytest.mark.parametrize("H", WIDTH_H)
@pytest.mark.parametrize("rows_type", ["bf16", "f16", "int8"])
def test_resident_padding_around_the_plain_versions(C, H, rows_type):
    """resident_pad_store (the batch's rows gathered and zero-padded) and
    resident_pad_weights to K4's multiples around K4's plain version and to
    K5's around K5's, then the slices back, at G = 1 and 2, against the
    plain versions on the unpadded store: the saved h's padded units,
    v_att's padded channels and the padded outputs of K5 exactly 0; the
    real ones within K4's and K5's limits."""
    dtype = torch.float16 if rows_type == "f16" else torch.bfloat16
    M, nv, B = 4, 13, 6
    store, rows, qh, wv, rng = _store_inputs(M, nv, C, H, B, rows_type,
                                             dtype)
    Hp = kernels.round_up(H, kernels.ATTENTION_UNITS)
    for G in (1, 2):
        ws = torch.from_numpy((rng.normal(size=(H, G)) * 0.3).astype(
            np.float32))
        ws = (ws if G > 1 else ws[:, 0].contiguous()).to(dtype).float()
        for normalize in ((False,) if rows_type == "int8" else (True,
                                                                  False)):
            kw = dict(n_valid=nv, normalize=normalize)
            rv, ra, rh = tar.attention_resident_fwd_reference(
                store, rows, qh, wv, ws, save_h=True, **kw)
            Cf = kernels.round_up(C, kernels.ATTENTION_FWD_CHANNELS)
            s, r = tar.resident_pad_store(Cf, store, rows)
            assert s.shape[2] == Cf and torch.equal(s[..., :C],
                                                    store[rows.long()]
                                                    if Cf != C else store)
            w, wsp, q = tar.resident_pad_weights(Cf, Hp, wv, ws, qh)
            va, al, h = tar.attention_resident_fwd_reference(
                s, r, q, w, wsp, save_h=True, **kw)
            assert not h[..., H:].any()
            assert not va.reshape(B, G, Cf)[..., C:].any()
            va = tar.glimpse_channels(va, G, C)
            for k in range(G):
                sl = slice(k * C, (k + 1) * C)
                assert _rel(va[:, sl], rv[:, sl]) <= TOL_VATT
            assert (al - ra).abs().max().item() <= TOL_ALPHA
            assert _rel(h[..., :H].float(), rh.float()) <= (
                TOL_K4_H * _step(dtype))
            g = torch.from_numpy(rng.normal(size=(B, G * C)).astype(
                np.float32))
            sga = torch.from_numpy(rng.normal(size=ra.shape).astype(
                np.float32))
            want = tar.attention_resident_bwd_reference(
                store, rows, rh, ws, ra, g, sga, **kw)
            Cb = kernels.round_up(C, kernels.ATTENTION_BWD_CHANNELS)
            s, r = tar.resident_pad_store(Cb, store, rows)
            _, wsp, _ = tar.resident_pad_weights(Cb, Hp, wv, ws)
            hp = torch.nn.functional.pad(rh, (0, Hp - H))
            dqh, dwv, dws = tar.attention_resident_bwd_reference(
                s, r, hp, wsp, ra, tar.glimpse_channels(g, G, Cb), sga, **kw)
            assert not dqh[:, H:].any() and not dws[H:].any()
            assert not dwv[C:].any() and not dwv[:, H:].any()
            got = (dqh[:, :H], dwv[:C, :H], dws[:H])
            for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
                tol = TOL_K5 * _step(dtype) * (G if name != "dws" else 1)
                assert _rel(a, b, name) <= tol, name


@pytest.mark.parametrize("C", WIDTH_C)
@pytest.mark.parametrize("quantize", ["", "int8"])
def test_store_channels_padded_once_at_upload(C, quantize):
    """prenormalize_store and pad_store_rows with ``channels``: the store
    the Trainer uploads for the 16-bit kernels has C padded to 128 with
    zero channels, the real channels (and an int8 store's scale) bit for
    bit those of the unpadded store; the op on it equals the op on the
    unpadded store within K4's limits, its v_att [B, C] and dW_v [C, H]."""
    rng = np.random.default_rng(6)
    grid = np.abs(rng.normal(size=(5, 9, C))).astype(np.float32)
    flat, s0 = tar.prenormalize_store(grid, torch.bfloat16, quantize)
    wide, s1 = tar.prenormalize_store(grid, torch.bfloat16, quantize,
                                      channels=kernels.STORE_CHANNELS)
    Cp = kernels.round_up(C, kernels.STORE_CHANNELS)
    assert s0 == s1 and wide.shape == flat.shape[:2] + (Cp,)
    assert torch.equal(wide[..., :C], flat) and not wide[..., C:].any()
    raw = tar.pad_store_rows(grid, channels=kernels.STORE_CHANNELS)
    assert raw.shape == (5, 16, Cp) and np.array_equal(raw[:, :9, :C], grid)
    assert not raw[:, :, C:].any() and not raw[:, 9:].any()
    B, H = 6, 24
    rows = torch.from_numpy(rng.integers(0, 5, size=B).astype(np.int32))
    qh = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32))
    wv = torch.from_numpy((rng.normal(size=(C, H)) * 0.2).astype(np.float32))
    ws = torch.from_numpy((rng.normal(size=H) * 0.3).astype(np.float32))
    out = []
    for store, scale in ((flat, s0), (wide, s1)):
        ins = [t.clone().requires_grad_() for t in (qh, wv, ws)]
        va, al = tar.spatial_attention_resident(
            store, rows, ins[0].bfloat16(), ins[1], ins[2], n_valid=9,
            store_scale=scale)
        va.square().sum().backward()
        out.append((va.detach(), al.detach()) + tuple(t.grad for t in ins))
    for name, a, b in zip(("v_att", "alpha", "dqh", "dwv", "dws"), *out):
        assert _rel(a, b, name) <= TOL_K4_H, name
    assert out[1][0].shape == (B, C) and out[1][3].shape == (C, H)


def test_store_channel_multiple_follows_the_kernels():
    """Only a CUDA store in bf16 or float16 (K4/K5, K4h/K5h) is padded at
    upload; the CPU and float32 stores (K4f/K5f take any C) are not."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for dt in (torch.bfloat16, torch.float16):
        assert kernels.store_channel_multiple(cuda, dt) == 128
        assert kernels.store_channel_multiple(cpu, dt) == 1
    assert kernels.store_channel_multiple(cuda, torch.float32) == 1


# -- the route between the persistent kernels and the step form ---------------


def _fwd_smem(H, rows):
    """gru_fwd_step.cuh's seq_smem_bytes: U_h's slice [H][56], the b-tile
    of h_prev [rows][H+8] (E, 2 bytes, each aligned to 128) and two gx
    slices [rows][48] f32."""
    a128 = lambda x: -(-x // 128) * 128  # noqa: E731
    return a128(H * 56 * 2) + a128(rows * (H + 8) * 2) + 2 * rows * 48 * 4


def _bwd_smem(H):
    """gru_bwd_step.cuh's bptt_smem_bytes: Uc [H][56] and Ur [16][3H+8] of
    E, the 3-stage ring of [64][72 + 200] E and Rs [64][16] f32."""
    a128 = lambda x: -(-x // 128) * 128  # noqa: E731
    return (a128(H * 56 * 2) + a128(16 * (3 * H + 8) * 2)
            + 3 * 64 * 272 * 2 + 64 * 16 * 4)


def _fwd_per_sm(H):
    """One block an SM of each tiling whose shared memory fits in a
    block's (an H100's SMEM_OPTIN), 0 otherwise: the occupancy the C side
    reports where a block's memory, not its registers, decides."""
    return {r: int(_fwd_smem(H, r) <= kernels.SMEM_OPTIN)
            for r in kernels.GRU_FWD_ROWS}


@pytest.mark.parametrize("H,form", [(512, "persistent"),
                                    (576, "persistent"), (640, "step"),
                                    (1024, "step"), (2432, "step")])
@pytest.mark.parametrize("directions", [1, 2])
def test_bwd_route_by_shape(H, form, directions):
    """The BPTT takes the persistent step kernel up to H = 576 on an H100
    (U_h's slices and the ring within a block's shared memory, a row of
    every direction's j-tiles resident) and the step form past it (2432:
    Skip-Thought's 2400 units padded to 64)."""
    per_sm = int(_bwd_smem(H) <= kernels.SMEM_OPTIN)
    assert kernels.gru_bwd_route(256, H, SMS, per_sm, directions) == form
    if form == "persistent":
        kernels.gru_bwd_plan(256, H, SMS, per_sm, directions)
    else:
        with pytest.raises(ValueError, match="resident"):
            kernels.gru_bwd_plan(256, H, SMS, per_sm, directions)


@pytest.mark.parametrize("H,form", [(512, "persistent"),
                                    (832, "persistent"), (848, "step"),
                                    (1024, "step"),
                                    (1568, "step"), (1584, "step"),
                                    (2400, "step")])
@pytest.mark.parametrize("directions", [1, 2])
def test_fwd_route_by_shape(H, form, directions):
    """The forward takes the persistent kernel up to
    kernels.GRU_FWD_STEP_ABOVE (832 units, phase 30's crossover) where a
    block's U_h slice fits and its j-tiles can be resident, and the step
    form past it, though the persistent kernel still plans up to H = 1568
    (both directions past H = 1056 as two launches; past 1568 no tiling
    fits and its plan raises); where a block fits but its j-tiles cannot
    be resident on the card (a card of fewer SMs than j-tiles) the step
    form too."""
    per_sm = _fwd_per_sm(H)
    assert kernels.gru_fwd_route(256, H, SMS, per_sm, directions) == form
    if H <= 1568:
        kernels.gru_fwd_plan(256, H, SMS, per_sm, directions)
    else:
        with pytest.raises(ValueError, match="resident"):
            kernels.gru_fwd_plan(256, H, SMS, per_sm, directions)
    if form == "persistent":
        few = H // kernels.GRU_FWD_UNITS - 1
        assert kernels.gru_fwd_route(256, H, few, per_sm, directions) == (
            "step")


@pytest.mark.parametrize("B", [1, 64, 256, 1024])
@pytest.mark.parametrize("directions", [1, 2])
def test_fwd_route_crossover(B, directions):
    """The crossover is a width, the same at every batch: the persistent
    K1/K6 at kernels.GRU_FWD_STEP_ABOVE, the step form one padded width
    (16 units) past it, where both forms run."""
    at = kernels.GRU_FWD_STEP_ABOVE
    assert at % kernels.GRU_FWD_PAD == 0
    for H, form in ((at, "persistent"), (at + kernels.GRU_FWD_PAD, "step")):
        per_sm = _fwd_per_sm(H)
        kernels.gru_fwd_plan(B, H, SMS, per_sm, directions)
        assert kernels.gru_fwd_route(B, H, SMS, per_sm, directions) == form


@pytest.mark.parametrize("H", WIDTH_H + (1024, 2400))
def test_route_of_the_padded_widths(H):
    """Every width H >= 1 has a route after padding: forward at H rounded
    to 16, backward to 64; 600 pads to 608 (persistent forward) and 640
    (step-form BPTT)."""
    Hf = kernels.round_up(H, kernels.GRU_FWD_PAD)
    Hb = kernels.round_up(H, kernels.GRU_BWD_PAD)
    fwd = kernels.gru_fwd_route(64, Hf, SMS, _fwd_per_sm(Hf))
    bwd = kernels.gru_bwd_route(64, Hb, SMS,
                                int(_bwd_smem(Hb) <= kernels.SMEM_OPTIN))
    assert fwd == ("persistent" if Hf <= kernels.GRU_FWD_STEP_ABOVE
                   else "step")
    assert bwd == ("persistent" if Hb <= 576 else "step")


@pytest.mark.parametrize("bad", [dict(H=24), dict(H=0), dict(B=0),
                                 dict(sms=0), dict(directions=3)])
def test_routes_refuse_unpadded_or_bad_shapes(bad):
    """The routes take padded widths only (the wrappers pad first)."""
    kw = {**dict(B=4, H=64, sms=SMS, directions=1), **bad}
    with pytest.raises(ValueError, match="gru_fwd_route"):
        kernels.gru_fwd_route(kw["B"], kw["H"], kw["sms"], {16: 1, 64: 1},
                              kw["directions"])
    with pytest.raises(ValueError, match="gru_bwd_route"):
        kernels.gru_bwd_route(kw["B"], kw["H"], kw["sms"], 1,
                              kw["directions"])


# -- the port's ops at odd widths against JAX's, in bf16 ----------------------


@pytest.fixture
def padded_plain(monkeypatch):
    """The plain versions that the port's ops call on the CPU, wrapped in
    the padding their CUDA wrappers put around the kernels (H to 16 and 64,
    the attention's C to 32 and 128 and H to 128), so the ops at odd widths
    run through the padding functions."""
    gref, gbwd = tg.gru_reference, tg.gru_bwd_reference
    afwd, abwd = ta.attention_fwd_reference, ta.attention_bwd_reference
    rfwd = tar.attention_resident_fwd_reference
    rbwd = tar.attention_resident_bwd_reference
    up = kernels.round_up

    def gru_fwd(gx, lens, uh, bhn, *, reverse=False):
        H = uh.shape[0]
        p = tg.gru_pad(up(H, kernels.GRU_FWD_PAD), gx, uh, bhn)
        return tg.gru_unpad_fwd(H, *gref(p[0], lens, p[1], p[2],
                                         reverse=reverse))

    def gru_bwd(gx, hseq, lens, uh, bhn, ghT, *, reverse=False):
        H = uh.shape[0]
        p = tg.gru_pad(up(H, kernels.GRU_BWD_PAD), gx, uh, bhn, hseq, ghT)
        return tg.gru_unpad_bwd(H, *gbwd(p[0], p[3], lens, p[1], p[2], p[4],
                                         reverse=reverse))

    def att_fwd(v, qh, wv, ws, normalize):
        C, H = wv.shape
        p = ta.attention_pad(up(C, kernels.ATTENTION_FWD_CHANNELS),
                             up(H, kernels.ATTENTION_UNITS), v, qh, wv, ws)
        va, al, r = afwd(*p, normalize)
        return ta.attention_unpad(C, H, va) + (al, r)

    def att_bwd(v, qh, wv, ws, ds, r, normalize):
        C, H = wv.shape
        p = ta.attention_pad(up(C, kernels.ATTENTION_BWD_CHANNELS),
                             up(H, kernels.ATTENTION_UNITS), v, qh, wv, ws)
        return ta.attention_unpad(C, H, *abwd(*p, ds, r, normalize))

    def res_fwd(store, rows, qh, wv, ws, *, save_h=False, **kw):
        C, H = wv.shape
        G = 1 if ws.dim() == 1 else ws.shape[1]
        Cp = up(C, kernels.ATTENTION_FWD_CHANNELS)
        s, r = tar.resident_pad_store(Cp, store, rows)
        w, wsp, q = tar.resident_pad_weights(
            Cp, up(H, kernels.ATTENTION_UNITS), wv, ws, qh)
        va, al, h = rfwd(s, r, q, w, wsp, save_h=save_h, **kw)
        return (tar.glimpse_channels(va, G, C), al,
                None if h is None else h[..., :H].contiguous())

    def res_bwd(store, rows, h, ws, alpha, g, sga, **kw):
        C, H = store.shape[2], h.shape[-1]
        G = 1 if ws.dim() == 1 else ws.shape[1]
        Cp, Hp = (up(C, kernels.ATTENTION_BWD_CHANNELS),
                  up(H, kernels.ATTENTION_UNITS))
        s, r = tar.resident_pad_store(Cp, store, rows)
        _, wsp, _ = tar.resident_pad_weights(Cp, Hp, None, ws)
        dqh, dwv, dws = rbwd(s, r, torch.nn.functional.pad(h, (0, Hp - H)),
                             wsp, alpha, tar.glimpse_channels(g, G, Cp),
                             sga, **kw)
        return dqh[:, :H], dwv[:C, :H], dws[:H]

    for mod, name, fn in ((tg, "gru_reference", gru_fwd),
                          (tg, "gru_bwd_reference", gru_bwd),
                          (ta, "attention_fwd_reference", att_fwd),
                          (ta, "attention_bwd_reference", att_bwd),
                          (tar, "attention_resident_fwd_reference", res_fwd),
                          (tar, "attention_resident_bwd_reference",
                           res_bwd)):
        monkeypatch.setattr(mod, name, fn)


@pytest.mark.parametrize("H", WIDTH_H)
@pytest.mark.parametrize("bidirectional", [False, True])
def test_gru_encoders_at_odd_widths_match_jax(H, bidirectional,
                                              padded_plain):
    """GRUEncoder (reverse too) and BiGRUEncoder in bf16 at H off 16 and 64
    against JAX's, whose recurrences and BPTTs are B1/B2 (and B7/B8 fused
    for both directions) interpreted: the final states, then every
    parameter's gradient and x's."""
    T, B, D = 6, 5, 12
    rng = np.random.default_rng(H)
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    lens = np.array([6, 1, 4, 0, 3])
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)

    def enc_params():
        return {"wx": rng.normal(size=(D, 3 * H)).astype(np.float32) * 0.4,
                "uh": (rng.normal(size=(H, 3 * H)) * H ** -0.5).astype(
                    np.float32),
                "b": rng.normal(size=(3 * H,)).astype(np.float32) * 0.2,
                "bhn": rng.normal(size=(H,)).astype(np.float32) * 0.2}

    if bidirectional:
        params = {"fwd": enc_params(), "bwd": enc_params()}
        jm = jg.BiGRUEncoder(H, jnp.bfloat16, time_major=True,
                             fuse_directions=True)
        port = tg.BiGRUEncoder(D, H, dtype=torch.bfloat16)
        sd = {f"{d}.{k}": torch.from_numpy(v) for d in params
              for k, v in params[d].items()}
        cases = [(jm, port, sd)]
    else:
        params = enc_params()
        sd = {k: torch.from_numpy(v) for k, v in params.items()}
        cases = [(jg.GRUEncoder(H, jnp.bfloat16, time_major=True,
                                reverse=rev),
                  tg.GRUEncoder(D, H, dtype=torch.bfloat16, reverse=rev), sd)
                 for rev in (False, True)]
    out_w = rng.normal(size=(B, 2 * H if bidirectional else H)).astype(
        np.float32)
    for jm, port, sd in cases:
        def loss(p, xx):
            return jnp.sum(jm.apply({"params": p}, xx, jnp.asarray(mask))
                           .astype(jnp.float32) * out_w)

        want = jm.apply({"params": params}, jnp.asarray(x),
                        jnp.asarray(mask))
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
        port.load_state_dict(sd)
        xt = torch.from_numpy(x).requires_grad_()
        got = port(xt, torch.from_numpy(mask))
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert np.abs(got.float().detach().numpy()
                      - np.asarray(want, np.float32)).max() <= JAX_TOL_H
        (got.float() * torch.from_numpy(out_w)).sum().backward()
        assert _rel(xt.grad, gx, "x") <= JAX_TOL_REL
        flat = (gp if not bidirectional else
                {f"{d}.{k}": v for d in gp for k, v in gp[d].items()})
        for k, p in port.named_parameters():
            assert _rel(p.grad, flat[k], k) <= JAX_TOL_REL, k


ATT_WIDTHS = [(16, 8), (48, 24), (100, 40), (300, 100), (100, 600)]


@pytest.mark.parametrize("C,H", ATT_WIDTHS)
@pytest.mark.parametrize("normalize", [True, False])
def test_gathered_attention_at_odd_widths_matches_jax(C, H, normalize,
                                                      padded_plain):
    """spatial_attention in bf16 at (C, H) off 32 and 128 against JAX's,
    whose forward is B5 and whose backward (``bwd_kernel``) is B6, both
    interpreted; the port's runs K2's and K8's plain versions through the
    wrappers' padding: v_att, alpha, and the gradients of qh, W_v and
    ws."""
    B, N = 3, 11
    rng = np.random.default_rng(C + H)
    v = np.abs(rng.normal(size=(B, N, C))).astype(np.float32)
    v = v.astype(jnp.bfloat16).astype(np.float32)
    qh = (rng.normal(size=(B, H)) * 0.5).astype(np.float32)
    wv = (rng.normal(size=(C, H)) * (6.0 / (C + H)) ** 0.5).astype(
        np.float32)
    ws = (rng.normal(size=H) * 0.3).astype(np.float32)
    g = rng.normal(size=(B, C)).astype(np.float32)
    ga = rng.normal(size=(B, N)).astype(np.float32)
    vj = jnp.asarray(v).astype(jnp.bfloat16)

    def f(qh, wv, ws):
        return ja.spatial_attention(vj, qh, wv, ws, normalize=normalize,
                                    bwd_kernel=True, feature_grad=False,
                                    interpret=True)

    fwd, vjp = jax.vjp(f, *map(jnp.asarray, (qh, wv, ws)))
    grads = vjp((jnp.asarray(g), jnp.asarray(ga)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (qh, wv, ws)]
    va, al = ta.spatial_attention(torch.from_numpy(v).bfloat16(), *ins,
                                  normalize=normalize, feature_grad=False)
    (va * torch.from_numpy(g)).sum().add(
        (al * torch.from_numpy(ga)).sum()).backward()
    got = [va.detach(), al.detach()] + [t.grad for t in ins]
    want = [np.asarray(a, np.float32) for a in (*fwd, *grads)]
    for name, a, b in zip(("v_att", "alpha"), got, want):
        assert _rel(a, b, name) <= JAX_TOL_REL, (name, _rel(a, b))
    for name, a, b in zip(("dqh", "dwv", "dws"), got[2:], want[2:]):
        assert _rel(a, b, name) < 1 and _cos(a, b) >= JAX_GRAD_COS, (
            name, _cos(a, b))


@pytest.mark.parametrize("C,H", ATT_WIDTHS)
@pytest.mark.parametrize("glimpses", [1, 2])
@pytest.mark.parametrize("channel_padded", [False, True])
def test_resident_attention_at_odd_widths_matches_jax(C, H, glimpses,
                                                      channel_padded,
                                                      padded_plain):
    """spatial_attention_resident in bf16 at (C, H) off 32 and 128 against
    JAX's (B3/B4 interpreted) at 1 and 2 glimpses, normalize on, on the
    store as JAX holds it and on the store with its channels padded to 128
    as the Trainer uploads it for the card: v_att, alpha and the gradients
    of qh, W_v and ws."""
    M, nv, B = 4, 13, 8
    rng = np.random.default_rng(C * H + glimpses)
    grid = np.abs(rng.normal(size=(M, nv, C))).astype(np.float32)
    store = jar.pad_store_rows(grid.astype(jnp.bfloat16))
    rows = rng.integers(0, M, size=B).astype(np.int32)
    qh = (rng.normal(size=(B, H)) * 0.5).astype(np.float32)
    wv = (rng.normal(size=(C, H)) * (6.0 / (C + H)) ** 0.5).astype(
        np.float32)
    shape = (H,) if glimpses == 1 else (H, glimpses)
    ws = (rng.normal(size=shape) * 0.3).astype(np.float32)
    g = rng.normal(size=(B, glimpses * C)).astype(np.float32)
    ga = rng.normal(size=(B, nv) + shape[1:]).astype(np.float32)
    kw = dict(n_valid=nv, normalize=True)

    def f(qh, wv, ws):
        return jar.spatial_attention_resident(
            jnp.asarray(store), jnp.asarray(rows), qh, wv, ws,
            interpret=True, **kw)

    fwd, vjp = jax.vjp(f, *map(jnp.asarray, (qh, wv, ws)))
    grads = vjp((jnp.asarray(g), jnp.asarray(ga)))
    tstore = torch.from_numpy(store.astype(np.float32)).bfloat16()
    if channel_padded:
        tstore = torch.nn.functional.pad(
            tstore, (0, kernels.round_up(C, kernels.STORE_CHANNELS) - C))
    ins = [torch.from_numpy(a).requires_grad_() for a in (qh, wv, ws)]
    va, al = tar.spatial_attention_resident(tstore, torch.from_numpy(rows),
                                            *ins, **kw)
    (va * torch.from_numpy(g)).sum().add(
        (al * torch.from_numpy(ga)).sum()).backward()
    got = [va.detach(), al.detach()] + [t.grad for t in ins]
    want = [np.asarray(a, np.float32) for a in (*fwd, *grads)]
    for name, a, b in zip(("v_att", "alpha"), got, want):
        assert _rel(a, b, name) <= JAX_TOL_REL, (name, _rel(a, b))
    for name, a, b in zip(("dqh", "dwv", "dws"), got[2:], want[2:]):
        assert _rel(a, b, name) < 1 and _cos(a, b) >= JAX_GRAD_COS, (
            name, _cos(a, b))


# -- the slice as a whole: oov_claim.TINY in bf16 ------------------------------


@pytest.mark.parametrize("resident", [False, True])
def test_tiny_config_first_step_matches_jax_in_bf16(resident, padded_plain):
    """tools/oov_claim.py's TINY model (the JAX tests' tiny config: GRU 16,
    attention 16, 32 channels, 4 x 4 grid) in ``model.dtype bfloat16``,
    dropout off so that both sides draw no mask: the first stage-2 step's
    loss and every parameter's gradient against jax.value_and_grad of
    JAX's model on the same parameters and batch, on gathered features (B5
    forward, JAX's explicit backward; the port's K2 and K8 through their
    padding) and on the resident store (B3/B4; the port's K4/K5 on the
    store padded to 128 channels, as the Trainer uploads it)."""
    t = oov_claim.TINY
    V, A = t["data.vocab_size"], t["data.num_answers"]
    C, Tq = t["data.feature_dim"], t["data.max_question_len"]
    N = t["data.grid_h"] * t["data.grid_w"]
    dims = {k: t[f"model.{k}"] for k in ("word_dim", "rnn_dim",
                                         "fusion_dim", "att_hidden",
                                         "answer_dim")}
    B = 16
    rng = np.random.default_rng(11)
    mod = JaxModel(vocab_size=V, num_answers=A, dtype=jnp.bfloat16,
                   dropout=0.0, n_cells=N, **dims)
    feats = np.abs(rng.normal(size=(B, N, C))).astype(np.float32)
    q = rng.integers(4, V, size=(B, Tq)).astype(np.int32)
    for i in range(B):
        q[i, rng.integers(1, Tq + 1):] = 0
    labels = rng.integers(2, A, size=B).astype(np.int32)
    tree = jax.device_get(mod.init(jax.random.PRNGKey(0),
                                   jnp.asarray(feats), jnp.asarray(q),
                                   train=False)["params"])
    if resident:
        store = tar.pad_store_rows(feats.astype(jnp.bfloat16))
        rows = np.arange(B, dtype=np.int32)
        jfeat = (jnp.asarray(store), jnp.asarray(rows))
        tstore = torch.from_numpy(store.astype(np.float32)).bfloat16()
        tstore = torch.nn.functional.pad(
            tstore, (0, kernels.round_up(C, kernels.STORE_CHANNELS) - C))
        tfeat = (tstore, torch.from_numpy(rows))
    else:
        jfeat = jnp.asarray(feats)
        tfeat = torch.from_numpy(feats)
    batch = {"answer_id": jnp.asarray(labels)}

    def jloss(params):
        out = mod.apply({"params": params}, jfeat, jnp.asarray(q),
                        train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_vqa_loss(out, batch)[0]

    jl, jgrads = jax.value_and_grad(jloss)(tree)
    want = params_from_flax(jax.device_get(jgrads))
    model = tmodel.VQAAttentionModel(V, A, feature_dim=C,
                                     dtype=torch.bfloat16, dropout=0.0,
                                     n_cells=N, **dims)
    model.load_state_dict(params_from_flax(tree))
    out = model(tfeat, torch.from_numpy(q), train=True)
    loss = tmodel.vqa_loss(out, {"answer_id": torch.from_numpy(labels)})[0]
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_ABS
    for name, p in model.named_parameters():
        a, b = p.grad.flatten(), want[name].flatten()
        assert torch.isfinite(a).all(), name
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        assert cos >= GRAD_COS, (name, cos)
