"""Spatial attention over the image feature grid, single glimpse:

    h      = relu(v @ Wv + qh)          # [B, N, H], qh = q @ Wq + bq
    score  = h @ w_s                    # [B, N]
    alpha  = softmax_N(score)           # [B, N]
    v_att  = sum_N alpha * v            # [B, C]

With ``normalize`` the per-cell L2 norm of ``v`` is fused in by scaling
after the matmul: h = relu((v @ Wv) * r + qh), v_att = sum (alpha r) v,
r = rsqrt(|v|^2 + 1e-12).

:func:`spatial_attention` is the entry point, differentiable: on CUDA
tensors its forward launches the hand-written kernel ``csrc/attention_fwd.cu``
(K2, wrapper :func:`attention_fwd`) and its backward
``csrc/attention_bwd.cu`` (K8, wrapper :func:`attention_bwd`), or the
explicit backward :func:`attention_bwd_math`; on CPU tensors the plain
versions :func:`attention_fwd_reference` and :func:`attention_bwd_reference`.
The wrappers dispatch on v's dtype: bf16 takes K2/K8, float16 their
float16 instances ``csrc/attention_fwd_f16.cu`` (K2h,
:func:`attention_fwd_f16`) and ``csrc/attention_bwd_f16.cu`` (K8h,
:func:`attention_bwd_f16`), the same bodies with float16 in place of bf16,
float32 the float32 kernels ``csrc/attention_fwd_f32.cu`` (K2f,
:func:`attention_fwd_f32`) and ``csrc/attention_bwd_f32.cu`` (K8f,
:func:`attention_bwd_f32`), plain FFMA with f32 sums. The 16-bit wrappers
take any C and H, as the Pallas bodies do: :func:`attention_pad` zero-pads
C to 32 (K2) or 128 (K8) and H to 128, :func:`attention_unpad` slices the
outputs back; at a C off the multiple that is one copy of v a call.
:func:`spatial_attention_reference` and :func:`_reference_postscaled` are
the JAX package's oracles, in PyTorch. :func:`spatial_attention_multi` is
the G-glimpse variant on a gathered grid, plain PyTorch differentiated by
autograd (the JAX package computes it in XLA, with no Pallas kernel).

Products of ``dt`` (bf16 or float16) values are taken as float32 matmuls
of upcast operands: the upcast copies are exact, so this is a ``dt`` matmul
with float32 accumulation, as ``preferred_element_type=float32`` is in
JAX.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from vqa_transfer_externaldata_torch.ops import kernels



def spatial_attention_reference(
    v: torch.Tensor,  # [B, N, C] grid features
    qh: torch.Tensor,  # [B, H] projected question
    wv: torch.Tensor,  # [C, H]
    w_score: torch.Tensor,  # [H]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain oracle (no fused normalization): (v_att [B, C] f32,
    alpha [B, N] f32)."""
    dt = v.dtype
    vf = v.float()
    h = vf @ wv.to(dt).float()
    h = torch.relu(h + qh[:, None, :].float())
    score = h.to(dt).float() @ w_score.to(dt).float()
    alpha = torch.softmax(score, dim=1)
    v_att = torch.einsum("bn,bnc->bc", alpha.to(dt).float(), vf)
    return v_att, alpha


def _reference_postscaled(
    v: torch.Tensor,  # [B, N, C] raw grid features
    qh: torch.Tensor,  # [B, H]
    wv: torch.Tensor,  # [C, H]
    w_score: torch.Tensor,  # [H]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized-attention oracle that scales after the matmul:
    h = (v @ Wv) * r and v_att = sum (alpha r) v."""
    dt = v.dtype
    vf = v.float()
    r = torch.rsqrt(torch.sum(vf * vf, dim=-1) + 1e-12)
    h = vf @ wv.to(dt).float()
    h = torch.relu(h * r[:, :, None] + qh[:, None, :].float())
    score = h.to(dt).float() @ w_score.to(dt).float()
    alpha = torch.softmax(score, dim=1)
    v_att = torch.einsum("bn,bnc->bc", (alpha * r).to(dt).float(), vf)
    return v_att, alpha


def spatial_attention_multi(
    v: torch.Tensor,  # [B, N, C] grid features (normalized by the caller)
    qh: torch.Tensor,  # [B, H] projected question
    wv: torch.Tensor,  # [C, H]
    w_score: torch.Tensor,  # [H, G]: one score vector per glimpse
) -> Tuple[torch.Tensor, torch.Tensor]:
    """G independent softmaxes over the grid sharing h = relu(v @ Wv + qh):
    (v_att [B, G*C] f32, concatenated in glimpse order, alpha [B, N, G]
    f32), differentiable in all four. ``wv`` and ``w_score`` are rounded
    to ``v.dtype``; products of ``v.dtype`` values are summed in f32, as
    ``preferred_element_type=float32`` is in the JAX package."""
    dt = v.dtype
    vf = v.float()
    h = torch.relu(vf @ wv.to(dt).float() + qh[:, None, :].float())
    score = h.to(dt).float() @ w_score.to(dt).float()  # [B, N, G]
    alpha = torch.softmax(score, dim=1)
    v_att = torch.einsum("bng,bnc->bgc", alpha.to(dt).float(), vf)
    return v_att.reshape(v.shape[0], -1), alpha


def attention_fwd_reference(v: torch.Tensor, qh: torch.Tensor,
                            wv: torch.Tensor, ws: torch.Tensor,
                            normalize: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of kernel K2, in the kernel's rounding:
    v [B, N, C] (dt), qh [B, H] f32, wv [C, H] (dt), ws [H] f32
    -> (v_att [B, C] f32, alpha [B, N] f32, r [B, N] f32, the per-cell
    norm: ones unless ``normalize``). h stays f32 for the score, squares
    and the weights p * r are rounded to dt."""
    vf = v.float()
    z = vf @ wv.float()
    if normalize:
        r = torch.rsqrt((v * v).float().sum(-1) + 1e-12)
    else:
        r = torch.ones(v.shape[:2], dtype=torch.float32, device=v.device)
    h = torch.relu(z * r[:, :, None] + qh[:, None, :])
    s = h @ ws
    p = torch.exp(s - s.amax(dim=1, keepdim=True))
    d = p.sum(dim=1, keepdim=True)
    w = (p * r).to(v.dtype).float()
    v_att = torch.einsum("bn,bnc->bc", w, vf) / d
    return v_att, p / d, r


def attention_bwd_reference(v: torch.Tensor, qh: torch.Tensor,
                            wv: torch.Tensor, ws: torch.Tensor,
                            ds: torch.Tensor, r: torch.Tensor,
                            normalize: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of kernel K8 (the Pallas backward body without
    its padding): v [B, N, C] (dt), qh [B, H] f32, wv [C, H] (dt), ws [H]
    f32, the score cotangent ds [B, N] f32 and the forward's per-cell norm
    r [B, N] f32 (read only when ``normalize``) -> (dqh [B, H], dwv [C, H],
    dws [H]), all f32. z is recomputed from v; dz * r is rounded to dt
    ahead of the dW_v product."""
    vf = v.float()
    z = vf @ wv.float()
    if normalize:
        z = z * r[:, :, None]
    z = z + qh[:, None, :]
    dz = torch.where(z > 0, ds[:, :, None] * ws, torch.zeros_like(z))
    dws = torch.einsum("bn,bnh->h", ds, torch.relu(z))
    dqh = dz.sum(1)
    dzr = dz * r[:, :, None] if normalize else dz
    dwv = torch.einsum("bnc,bnh->ch", vf, dzr.to(v.dtype).float())
    return dqh, dwv, dws


def attention_bwd_math(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                       ws: torch.Tensor, alpha: torch.Tensor,
                       vatt: torch.Tensor, g: torch.Tensor, ga: torch.Tensor,
                       *, normalize: bool, feature_grad: bool
                       ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
    """The explicit backward of the JAX package (``_attention_bwd_math``),
    from the saved (alpha, v_att): only z is recomputed, and the softmax's
    S = g . v_att + alpha . g_alpha uses sum_n alpha_n (g . v_n) = g . v_att.
    ``ws`` is the unrounded score vector (as JAX's backward reads it), ``wv``
    is rounded to v's dtype. Returns (dv or None without ``feature_grad``,
    dqh, dwv, dws) in float32."""
    dt = v.dtype
    g, ga, alpha = g.float(), ga.float(), alpha.float()
    v_raw = v
    if normalize:
        r = torch.rsqrt(v.float().square().sum(-1, keepdim=True) + 1e-12)
        v = (v.float() * r).to(dt)
    vf = v.float()
    dalpha = torch.einsum("bc,bnc->bn", g.to(dt).float(), vf) + ga
    s = (g * vatt.float()).sum(-1) + (alpha * ga).sum(1)
    ds = alpha * (dalpha - s[:, None])
    wvf = wv.to(dt).float()
    # Scale after the matmul, as every forward path does, so the ReLU mask
    # matches the primal's.
    z = (v_raw.float() @ wvf) * r if normalize else vf @ wvf
    z = z + qh[:, None, :].float()
    dz = torch.where(z > 0, ds[:, :, None] * ws.float(), torch.zeros_like(z))
    dws = torch.einsum("bn,bnh->h", ds, torch.relu(z))
    dz_c = dz.to(dt).float()  # the one rounding of dz, as in JAX
    dqh = dz_c.sum(1)
    dwv = torch.einsum("bnc,bnh->ch", vf, dz_c)
    if not feature_grad:
        return None, dqh, dwv, dws
    dv = alpha[:, :, None] * g[:, None, :] + dz_c @ wvf.t()
    if normalize:
        # Through v_hat = v r: dv_raw = r (dv_hat - v_hat (v_hat . dv_hat)).
        inner = (dv * vf).sum(-1, keepdim=True)
        dv = r * (dv - vf * inner)
    return dv, dqh, dwv, dws


def _score_dot(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g . v_n for every cell: v [B, N, C] (dt), g [B, C] f32 -> [B, N]
    f32, from products of dt values (g rounded to dt) summed in f32. On the
    card one batched GEMV reads the grid once and returns f32 (for a bf16
    or float16 grid no f32 copy of it; a float32 grid takes cuBLAS's f32
    GEMV, in full f32 unless the caller turns TF32 on); on the CPU the
    operands are upcast."""
    gc = g.to(v.dtype)
    if v.device.type != "cuda":
        return torch.einsum("bnc,bc->bn", v.float(), gc.float())
    if v.dtype == torch.float32:
        return torch.bmm(v, gc[:, :, None])[:, :, 0]
    return torch.bmm(v, gc[:, :, None], out_dtype=torch.float32)[:, :, 0]


def _f32_rnorm(v: torch.Tensor) -> torch.Tensor:
    """rsqrt(|v_n|^2 + 1e-12) of every cell of v [B, N, C] from float32
    squares -> [B, N] f32 (JAX's gathered backward's ``r``), summed
    without an f32 copy of the grid."""
    n = torch.linalg.vector_norm(v, dim=-1, dtype=torch.float32)
    return torch.rsqrt(n.square() + 1e-12)


def _f16_norm_scale(v: torch.Tensor) -> torch.Tensor:
    """2^-k (a 0-d float16 device tensor, no host sync) with the least
    k >= 0 that brings every |value| of the float16 grid ``v`` to 2^7 or
    below, so that each value's float16 square (at most 2^14) is finite.
    The largest |value| is one reduction over the grid, with no copy."""
    m = torch.linalg.vector_norm(v, ord=float("inf")).float()
    k = torch.ceil(torch.log2(m * 2.0 ** -7)).clamp_min(0.0)
    return torch.exp2(-k).to(torch.float16)


def _f16_dzr_scale(ds: torch.Tensor, ws: torch.Tensor,
                   r: Optional[torch.Tensor]) -> torch.Tensor:
    """A power of two (a 0-d f32 device tensor, no host sync) that puts
    the bound max_n |ds_n| r_n * max |ws| of every |dz r| = |ds ws r| K8h
    rounds to float16 at 2^14..2^15. K8h's dW_v takes float16(dz r) as B6
    does, while JAX's training backward rounds dz before the r of its
    normalized grid: where the grid's cells are long (r small) dz r falls
    below float16's normal range and rounds to 0 or to a few bits. The
    bound takes ds and r of the same cell, so a short cell (r large) that
    draws little attention (ds small) does not push the others' dz r back
    down. The op scales ds by this before K8h and divides dqh, dW_v and
    dws by it after, which is exact in f32 and moves no float16 rounding
    of a normal value."""
    big = (ds.abs() if r is None else ds.abs() * r).amax() * ws.abs().amax()
    e = torch.floor(torch.log2(big.clamp_min(2.0 ** -100)))
    return torch.exp2((14.0 - e).clamp(-100.0, 100.0))


class _GatheredAttention(torch.autograd.Function):
    """Forward K2 (K2h on a float16 grid, K2f on a float32 one; the plain
    version on the CPU), saving the per-cell norm r that it computed.
    Backward: K8 (K8h, K8f) from
    the score cotangent formed here (the plain version on the CPU); with
    ``feature_grad`` or without
    ``bwd_kernel``, the explicit math of :func:`attention_bwd_math`.
    Without ``kernel`` (``model.use_pallas`` off), the JAX package's XLA
    forward and the explicit backward on any device."""

    @staticmethod
    def forward(ctx, v, qh, wv, ws, normalize, bwd_kernel, feature_grad,
                kernel, f32_r):
        wv_c = wv.to(v.dtype).contiguous()
        ws_c = ws.to(v.dtype).float().contiguous()
        qh_c = qh.float().contiguous()
        r = None
        if not kernel:  # the JAX package's XLA forward, in PyTorch
            oracle = (_reference_postscaled if normalize
                      else spatial_attention_reference)
            v_att, alpha = oracle(v, qh, wv, ws)
            bwd_kernel = False
        elif v.device.type == "cuda":
            v_att, alpha, r = attention_fwd(v, qh_c, wv_c, ws_c,
                                            normalize=normalize)
        else:
            v_att, alpha, r = attention_fwd_reference(v, qh_c, wv_c, ws_c,
                                                      normalize)
        ctx.save_for_backward(v, qh_c, wv_c, ws, ws_c, alpha, v_att, r)
        ctx.meta = (normalize, bwd_kernel, feature_grad, f32_r, qh.dtype,
                    wv.dtype, ws.dtype)
        return v_att, alpha

    @staticmethod
    def backward(ctx, g, ga):
        v, qh_c, wv_c, ws, ws_c, alpha, v_att, r = ctx.saved_tensors
        (normalize, bwd_kernel, feature_grad, f32_r, qh_dt, wv_dt,
         ws_dt) = ctx.meta
        g = torch.zeros_like(v_att) if g is None else g.float()
        ga = torch.zeros_like(alpha) if ga is None else ga.float()
        dv = None
        if feature_grad or not bwd_kernel:
            dv, dqh, dwv, dws = attention_bwd_math(
                v, qh_c, wv_c, ws, alpha, v_att, g, ga, normalize=normalize,
                feature_grad=feature_grad)
            dv = dv.to(v.dtype) if dv is not None else None
        else:
            if f32_r:
                # K2h squares each value in float16 (as B5 does), where a
                # value past 256 overflows and its cell's r falls to 0;
                # JAX's backward takes r from float32 squares.
                r = _f32_rnorm(v)
            dalpha = _score_dot(v, g)
            if normalize:
                dalpha = dalpha * r
            s = (g * v_att).sum(-1) + (alpha * ga).sum(-1)
            ds = (alpha * (dalpha + ga - s[:, None])).contiguous()
            bwd = (attention_bwd if v.device.type == "cuda"
                   else attention_bwd_reference)
            scale = None
            if v.dtype == torch.float16:
                scale = _f16_dzr_scale(ds, ws_c, r if normalize else None)
                ds = ds * scale
            dqh, dwv, dws = bwd(v, qh_c, wv_c, ws_c, ds, r, normalize)
            if scale is not None:
                dqh, dwv, dws = dqh / scale, dwv / scale, dws / scale
        return (dv, dqh.to(qh_dt), dwv.to(wv_dt), dws.to(ws_dt), None, None,
                None, None, None)


def spatial_attention(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                      w_score: torch.Tensor, *, normalize: bool = False,
                      bwd_kernel: bool = True, feature_grad: bool = True,
                      use_kernels: bool = True, train: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over a gathered grid: v [B, N, C] in the compute dtype, qh
    [B, H], wv [C, H], w_score [H] -> (v_att [B, C] f32, alpha [B, N] f32),
    differentiable in all four. ``wv`` and ``w_score`` are rounded to
    ``v.dtype``. On CUDA tensors the forward is kernel K2 (bf16 ``v``; K2h
    on float16, K2f on float32), in training too, and the backward kernel
    K8 (K8h, K8f) unless
    ``bwd_kernel`` is False or ``feature_grad`` asks for dv, when the
    explicit backward runs; on
    CPU tensors each path takes its plain version. ``feature_grad=False``
    gives the grid no gradient: only for features that are data.
    ``use_kernels=False`` (``model.use_pallas`` off) takes, on any device,
    the JAX package's XLA forward (:func:`_reference_postscaled`, or
    :func:`spatial_attention_reference` without ``normalize``) and the
    explicit backward, as JAX does with ``use_pallas`` off.

    ``train`` (a training step's forward) with ``normalize`` on a float16
    grid first scales it by a power of two (:func:`_f16_norm_scale`): K2h
    squares each value in float16 for its cell norms, as B5 does and JAX's
    evaluation and serving take it, so a value past 256 overflows and its
    cell's norm falls to 0, while JAX trains through its XLA forward, whose
    norms come from float32 squares. The scaled grid gives K2h's z, alpha
    and v_att those norms (the scale cancels in z * r and in the weighted
    sum), and K8h the forward's r; autograd takes dv through the scaling.
    A float16 grid's backward without that scaling (``train`` off) takes r
    from float32 squares of the grid, as JAX's backward does.

    One glimpse only, as in the JAX package: a 2-D ``w_score`` raises
    ``ValueError`` (:func:`spatial_attention_multi` takes G glimpses)."""
    if w_score.dim() != 1:
        raise ValueError(
            f"spatial_attention takes a 1-D w_score, got "
            f"{tuple(w_score.shape)}; use spatial_attention_multi for G "
            "glimpses")
    if v.device.type not in ("cuda", "cpu"):
        raise ValueError(f"spatial_attention: no path for device {v.device}")
    f16_norm = normalize and use_kernels and v.dtype == torch.float16
    if f16_norm and train:
        v = v * _f16_norm_scale(v.detach())
    return _GatheredAttention.apply(v, qh, wv, w_score, normalize,
                                    bwd_kernel, feature_grad, use_kernels,
                                    f16_norm and not train)


def attention_pad(Cp: int, Hp: int, v: torch.Tensor, qh: torch.Tensor,
                  wv: torch.Tensor, ws: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The gathered attention's inputs at C channels and H units
    zero-padded to ``Cp`` >= C and ``Hp`` >= H, as the 16-bit kernels take
    them (C a multiple of 32 for K2 and 128 for K8, H of 128), the way
    JAX's B6 pads its hidden axis: v [B, N, C] gets zero channels, W_v
    [C, H] zero rows and zero columns, qh [B, H] and ws [H] zero units.
    Returns (v, qh, wv, ws), each the input itself where its width is
    already padded.

    A zero channel adds 0 to every square of the per-cell norm and every
    product of v W_v, so r, the scores and alpha are unchanged, and its
    v_att entry (and dW_v row) is sliced off. A zero unit has z = 0 + 0,
    h = relu(0) = 0 and ws 0: it adds nothing to a score, and its dz is 0
    (z > 0 fails), so dqh, dW_v and dws of the real units are unchanged
    and its own are sliced off (:func:`attention_unpad`)."""
    C, H = wv.shape
    pad = torch.nn.functional.pad
    if Cp != C:
        v = pad(v, (0, Cp - C))
    if (Cp, Hp) != (C, H):
        wv = pad(wv, (0, Hp - H, 0, Cp - C))
    if Hp != H:
        qh, ws = pad(qh, (0, Hp - H)), pad(ws, (0, Hp - H))
    return v, qh, wv, ws


def attention_unpad(C: int, H: int, *outs: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """The padded kernels' outputs sliced back to C channels and H units:
    every axis of size Cp (v_att's last, dW_v's first) to C and of size Hp
    (dqh's and dW_v's last, dws) to H. The outputs are given in the order
    (v_att,) for K2's or (dqh, dwv, dws) for K8's; alpha and r need no
    slicing. Contiguous copies where a slice was taken."""
    if len(outs) == 1:
        v_att, = outs
        return (v_att[:, :C].contiguous() if v_att.shape[1] != C else v_att,)
    dqh, dwv, dws = outs
    if dwv.shape == (C, H):
        return dqh, dwv, dws
    return (dqh[:, :H].contiguous(), dwv[:C, :H].contiguous(),
            dws[:H].contiguous())


def _check_grid(v: torch.Tensor, H: int, what: str, dtype: torch.dtype
                ) -> Tuple[int, int, int]:
    if v.device.type != "cuda" or v.dim() != 3:
        raise ValueError(f"{what} takes a 3-D CUDA v")
    B, N, C = v.shape
    if B < 1 or N < 1 or C < 1 or H < 1:
        raise ValueError(f"{what} needs B, N, C, H >= 1, got v of shape "
                         f"{tuple(v.shape)} and H={H}")
    kernels.expect("v", v, dtype, (B, N, C), v.device)
    if v.data_ptr() % 16:
        raise ValueError(f"{what} reads v in 16-byte vectors: it must start "
                         "16-byte aligned")
    return B, N, C


@functools.lru_cache(maxsize=None)
def _lib(name: str = "attention_fwd") -> ctypes.CDLL:
    """The library of K2 (``name`` "attention_fwd") or K2h
    ("attention_fwd_f16"); both export the same entries."""
    lib = kernels.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attention_fwd.argtypes = [p] * 8 + [i] * 6 + [p, p]
    lib.attention_fwd.restype = i
    lib.attention_fwd_score_config.argtypes = [i] * 3 + [p]
    lib.attention_fwd_score_config.restype = i
    return lib


def score_launch_config(B: int, N: int, H: int,
                        dtype: torch.dtype = torch.bfloat16) -> dict:
    """The shape of K2's score launch (K2h's with ``dtype`` float16) as
    the C side sets it for ``B`` questions of ``N`` cells at width ``H``,
    in :func:`kernels.score_plan`'s keys."""
    lib = _lib(kernels.name16("attention_fwd", dtype))
    out = (ctypes.c_int * 7)()
    rc = lib.attention_fwd_score_config(B, N, H, ctypes.addressof(out))
    kernels.check(lib, rc, "attention_fwd_score_config")
    tm, tn, stages, smem, gx, gy, n_part = out
    return {"tile": [tm, tn], "stages": stages, "smem_bytes": smem,
            "grid": [gx, gy], "n_part": n_part}


def attention_fwd(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                  ws: torch.Tensor, *, normalize: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel K2 (``csrc/attention_fwd.cu``) on CUDA tensors:
    v [B, N, C] bf16, qh [B, H] f32, wv [C, H] bf16, ws [H] f32
    -> (v_att [B, C] f32, alpha [B, N] f32, r [B, N] f32, the per-cell norm
    the kernel used: ones unless ``normalize``). Any C and H >= 1: the
    wrapper zero-pads C to a multiple of 32 and H to one of 128
    (:func:`attention_pad`; a copy of v a call, only at a C off the
    multiple) and slices v_att back. The score launch reads W_v as its
    K-major copy ``wv.t()`` [H, C], made here, and runs as
    :func:`kernels.score_plan` plans it. One call makes the kernel's two
    launches on the current stream and adds the number launched (2) to
    ``attention_fwd.launches``. A float16 ``v``
    goes to :func:`attention_fwd_f16` (K2h), a float32 one to
    :func:`attention_fwd_f32` (K2f); another dtype raises ``TypeError``
    (:func:`kernels.kernel_dtype`)."""
    dt = kernels.kernel_dtype("attention_fwd", "v", v)
    if dt == torch.float32:
        return attention_fwd_f32(v, qh, wv, ws, normalize=normalize)
    if dt == torch.float16:
        return attention_fwd_f16(v, qh, wv, ws, normalize=normalize)
    return _attention_fwd16(v, qh, wv, ws, normalize, torch.bfloat16)


attention_fwd.launches = 0


def attention_fwd_f16(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                      ws: torch.Tensor, *, normalize: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel K2h (``csrc/attention_fwd_f16.cu``: K2's body with
    float16 as its element type) on CUDA tensors: as :func:`attention_fwd`
    with v [B, N, C] and wv [C, H] float16, the squares and the weights
    p * r rounded to float16. The same padding and launches as K2; two
    launches a call, added to ``attention_fwd_f16.launches``."""
    return _attention_fwd16(v, qh, wv, ws, normalize, torch.float16)


attention_fwd_f16.launches = 0


def _attention_fwd16(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                     ws: torch.Tensor, normalize: bool, dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's (``dtype`` bf16) or K2h's (float16) checks, plan and
    launches."""
    what = kernels.name16("attention_fwd", dtype)
    H = qh.shape[-1]
    B, N, C = _check_grid(v, H, what, dtype)
    dev = v.device
    if 2 * N * 4 > 48 * 1024:
        raise ValueError(f"{what}: N={N} cells exceed the softmax's "
                         "shared memory")
    kernels.expect("qh", qh, torch.float32, (B, H), dev)
    kernels.expect("wv", wv, dtype, (C, H), dev)
    kernels.expect("ws", ws, torch.float32, (H,), dev)
    C0, H0 = C, H
    C = kernels.round_up(C0, kernels.ATTENTION_FWD_CHANNELS)
    H = kernels.round_up(H0, kernels.ATTENTION_UNITS)
    v, qh, wv, ws = attention_pad(C, H, v, qh, wv, ws)
    n_part = kernels.score_plan(B, N, C, H)["n_part"]
    wvt = wv.t().contiguous()  # [H, C]: K-major, as the mainloop reads it
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty(n_part, B * N, **f32)
    rnorm = torch.empty(B, N, **f32)
    v_att = torch.empty(B, C, **f32)
    alpha = torch.empty(B, N, **f32)
    lib = _lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.attention_fwd(
            v.data_ptr(), wvt.data_ptr(), qh.data_ptr(), ws.data_ptr(),
            part.data_ptr(), rnorm.data_ptr(), v_att.data_ptr(),
            alpha.data_ptr(), B, N, C, H, n_part, int(normalize),
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    (attention_fwd_f16 if dtype == torch.float16
     else attention_fwd).launches += launched.value
    kernels.check(lib, rc, what)
    return attention_unpad(C0, H0, v_att) + (alpha, rnorm)


@functools.lru_cache(maxsize=None)
def _bwd_lib(name: str = "attention_bwd") -> ctypes.CDLL:
    """The library of K8 (``name`` "attention_bwd") or K8h
    ("attention_bwd_f16"); both export the same entries."""
    lib = kernels.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attention_bwd.argtypes = [p] * 14 + [i] * 7 + [p, p]
    lib.attention_bwd.restype = i
    lib.attention_bwd_dz_config.argtypes = [i] * 3 + [p]
    lib.attention_bwd_dz_config.restype = i
    return lib


def dz_launch_config(B: int, N: int, H: int,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """The shape of K8's dz launch (K8h's with ``dtype`` float16) as the C
    side sets it for ``B`` questions of ``N`` cells at width ``H``, in
    :func:`kernels.dz_plan`'s keys but ``partials``."""
    lib = _bwd_lib(kernels.name16("attention_bwd", dtype))
    out = (ctypes.c_int * 8)()
    rc = lib.attention_bwd_dz_config(B, N, H, ctypes.addressof(out))
    kernels.check(lib, rc, "attention_bwd_dz_config")
    tm, tn, stages, smem, epi, gx, gy, slots = out
    return {"tile": [tm, tn], "stages": stages, "smem_bytes": smem,
            "epilogue_bytes": epi, "grid": [gx, gy], "slots": slots}


def attention_bwd(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                  ws: torch.Tensor, ds: torch.Tensor, r: torch.Tensor,
                  normalize: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel K8 (``csrc/attention_bwd.cu``) on CUDA tensors: v
    [B, N, C] bf16, qh [B, H] f32, wv [C, H] bf16, ws [H] f32, ds and r
    [B, N] f32 -> (dqh [B, H], dwv [C, H], dws [H]), all f32. Any C and
    H >= 1: the wrapper zero-pads both to multiples of 128
    (:func:`attention_pad`; a copy of v a call, only at a C off the
    multiple) and slices the outputs back. One call makes the kernel's
    ``kernels.ATTENTION_BWD_LAUNCHES`` (4) launches on the current stream,
    its dz stage as :func:`kernels.dz_plan` and its dW_v GEMM as
    :func:`kernels.dwv_plan` plan them, and adds the number launched to
    ``attention_bwd.launches``. A float16 ``v`` goes to
    :func:`attention_bwd_f16` (K8h), a float32 one to
    :func:`attention_bwd_f32` (K8f); another dtype raises ``TypeError``
    (:func:`kernels.kernel_dtype`)."""
    dt = kernels.kernel_dtype("attention_bwd", "v", v)
    if dt == torch.float32:
        return attention_bwd_f32(v, qh, wv, ws, ds, r, normalize)
    if dt == torch.float16:
        return attention_bwd_f16(v, qh, wv, ws, ds, r, normalize)
    return _attention_bwd16(v, qh, wv, ws, ds, r, normalize, torch.bfloat16)


attention_bwd.launches = 0


def attention_bwd_f16(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                      ws: torch.Tensor, ds: torch.Tensor, r: torch.Tensor,
                      normalize: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel K8h (``csrc/attention_bwd_f16.cu``: K8's body with
    float16 as its element type) on CUDA tensors: as :func:`attention_bwd`
    with v [B, N, C] and wv [C, H] float16, dz * r rounded to float16 ahead
    of the dW_v product. The same padding and launches as K8; 4 launches a
    call, added to ``attention_bwd_f16.launches``."""
    return _attention_bwd16(v, qh, wv, ws, ds, r, normalize, torch.float16)


attention_bwd_f16.launches = 0


def _attention_bwd16(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                     ws: torch.Tensor, ds: torch.Tensor, r: torch.Tensor,
                     normalize: bool, dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's (``dtype`` bf16) or K8h's (float16) checks, plans and
    launches."""
    what = kernels.name16("attention_bwd", dtype)
    H = qh.shape[-1]
    B, N, C = _check_grid(v, H, what, dtype)
    dev = v.device
    kernels.expect("qh", qh, torch.float32, (B, H), dev)
    kernels.expect("wv", wv, dtype, (C, H), dev)
    kernels.expect("ws", ws, torch.float32, (H,), dev)
    kernels.expect("ds", ds, torch.float32, (B, N), dev)
    kernels.expect("r", r, torch.float32, (B, N), dev)
    if wv.data_ptr() % 16:
        raise ValueError(f"{what} reads wv in 16-byte vectors: it must "
                         "start 16-byte aligned")
    C0, H0 = C, H
    C = kernels.round_up(C0, kernels.ATTENTION_BWD_CHANNELS)
    H = kernels.round_up(H0, kernels.ATTENTION_UNITS)
    v, qh, wv, ws = attention_pad(C, H, v, qh, wv, ws)
    K = B * N
    dz = kernels.dz_plan(B, N, C, H)
    splits = kernels.dwv_plan(K, C, H, kernels.sm_count(dev))["splits"]
    f32 = dict(dtype=torch.float32, device=dev)
    wvt = wv.t().contiguous()  # [H, C]: K-major, as the mainloop reads it
    dzr = torch.empty(K, H, dtype=dtype, device=dev)
    qpart = torch.empty(dz["partials"], **f32)
    wpart = torch.empty(dz["partials"], **f32)
    dws_part = torch.empty(B, H, **f32)
    part = torch.empty(splits, C, H, **f32)
    dqh = torch.empty(B, H, **f32)
    dwv = torch.empty(C, H, **f32)
    dws = torch.empty(H, **f32)
    lib = _bwd_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.attention_bwd(
            v.data_ptr(), wvt.data_ptr(), qh.data_ptr(), ws.data_ptr(),
            ds.data_ptr(), r.data_ptr(), dzr.data_ptr(), qpart.data_ptr(),
            wpart.data_ptr(), dws_part.data_ptr(), part.data_ptr(),
            dqh.data_ptr(), dwv.data_ptr(), dws.data_ptr(),
            B, N, C, H, int(normalize), dz["slots"], splits,
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    (attention_bwd_f16 if dtype == torch.float16
     else attention_bwd).launches += launched.value
    kernels.check(lib, rc, what)
    return attention_unpad(C0, H0, dqh, dwv, dws)


# ---------------------------------------------------------------------------
# The float32 kernels K2f and K8f
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _f32_lib(name: str) -> ctypes.CDLL:
    """The library of K2f (``name`` "attention_fwd_f32") or K8f
    ("attention_bwd_f32")."""
    lib = kernels.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    getattr(lib, name).argtypes = ([p] * 8 + [i] * 9 if name ==
                                   "attention_fwd_f32"
                                   else [p] * 13 + [i] * 13) + [p, p]
    getattr(lib, name).restype = i
    return lib


def _check_grid_f32(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                    ws: torch.Tensor, what: str
                    ) -> Tuple[int, int, int, int]:
    """(B, N, C, H) of the float32 kernels' common inputs: v [B, N, C], qh
    [B, H], wv [C, H] and ws [H], all float32 on one CUDA device."""
    if v.device.type != "cuda" or v.dim() != 3:
        raise ValueError(f"{what} takes a 3-D CUDA v")
    B, N, C = v.shape
    H = qh.shape[-1]
    if B < 1 or N < 1 or C < 1 or H < 1:
        raise ValueError(f"{what} needs B, N, C, H >= 1, got v of shape "
                         f"{tuple(v.shape)} and H={H}")
    dev = v.device
    kernels.expect("v", v, torch.float32, (B, N, C), dev)
    kernels.expect("qh", qh, torch.float32, (B, H), dev)
    kernels.expect("wv", wv, torch.float32, (C, H), dev)
    kernels.expect("ws", ws, torch.float32, (H,), dev)
    return B, N, C, H


def f32_score_plan(v: torch.Tensor, wv: torch.Tensor) -> dict:
    """``kernels.f32_ring_plan`` of K2f's score launch and K8f's dz launch:
    v's rows K-major (C f32 channels a cell), W_v [C, H] f32."""
    C, H = wv.shape
    return kernels.f32_ring_plan(4, True, C * 4, v.data_ptr(), H * 4,
                                 wv.data_ptr())


def f32_dwv_plan(v: torch.Tensor, dzr: torch.Tensor) -> dict:
    """``kernels.f32_ring_plan`` of K8f's dW_v launch: v's rows MN-major
    (the cells are k, C f32 channels each), dz * r [B*N, H] f32."""
    return kernels.f32_ring_plan(4, False, v.shape[-1] * 4, v.data_ptr(),
                                 dzr.shape[-1] * 4, dzr.data_ptr())


def attention_fwd_f32(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                      ws: torch.Tensor, *, normalize: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel K2f (``csrc/attention_fwd_f32.cu``) on CUDA tensors,
    all float32: v [B, N, C], qh [B, H], wv [C, H], ws [H] -> (v_att [B, C],
    alpha [B, N], r [B, N], the per-cell norm: ones unless ``normalize``),
    :func:`attention_fwd_reference`'s math in FFMA with f32 sums. Any C and
    H; N * 4 bytes (the softmax) within 48 KB. One call launches, on the
    current stream, the per-cell norm (only when ``normalize``), the score
    product with its epilogue and the softmax with the weighted sum, and
    adds the number launched (2, or 3) to ``attention_fwd_f32.launches``."""
    what = "attention_fwd_f32"
    B, N, C, H = _check_grid_f32(v, qh, wv, ws, what)
    dev = v.device
    if N * 4 > 48 * 1024:
        raise ValueError(f"{what}: N={N} cells exceed the softmax's shared "
                         "memory")
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty(-(-H // kernels.F32_TILE), B * N, **f32)
    rnorm = (torch.empty(B, N, **f32) if normalize
             else torch.ones(B, N, **f32))
    v_att = torch.empty(B, C, **f32)
    alpha = torch.empty(B, N, **f32)
    plan = f32_score_plan(v, wv)
    lib = _f32_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.attention_fwd_f32(
            v.data_ptr(), wv.data_ptr(), qh.data_ptr(), ws.data_ptr(),
            part.data_ptr(), rnorm.data_ptr(), v_att.data_ptr(),
            alpha.data_ptr(), B, N, C, H, int(normalize), plan["a_width"],
            plan["b_width"], plan["stages"], plan["smem_bytes"],
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    attention_fwd_f32.launches += launched.value
    kernels.check(lib, rc, what)
    return v_att, alpha, rnorm


attention_fwd_f32.launches = 0


def attention_bwd_f32(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                      ws: torch.Tensor, ds: torch.Tensor, r: torch.Tensor,
                      normalize: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel K8f (``csrc/attention_bwd_f32.cu``) on CUDA tensors,
    all float32: v [B, N, C], qh [B, H], wv [C, H], ws [H], the score
    cotangent ds [B, N] and K2f's per-cell norm r [B, N] (read only when
    ``normalize``) -> (dqh [B, H], dwv [C, H], dws [H]),
    :func:`attention_bwd_reference`'s math in FFMA with f32 sums. Any C, H
    and N. One call launches, on the current stream, the recomputed score
    product with its dz epilogue (dz and, when ``normalize``, dz * r), the
    dW_v product over the B * N cells
    split ``kernels.f32_dwv_splits`` ways, and the reduction of dW_v's
    splits, each question's dqh and dws in a fixed order, and adds the
    number launched (3) to ``attention_bwd_f32.launches``."""
    what = "attention_bwd_f32"
    B, N, C, H = _check_grid_f32(v, qh, wv, ws, what)
    dev = v.device
    kernels.expect("ds", ds, torch.float32, (B, N), dev)
    kernels.expect("r", r, torch.float32, (B, N), dev)
    K = B * N
    splits = kernels.f32_dwv_splits(K, C, H, kernels.sm_count(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    dz = torch.empty(K, H, **f32)
    dzr = torch.empty(K, H, **f32) if normalize else dz  # dz * r
    wpart = torch.empty(-(-K // kernels.F32_TILE), H, **f32)
    part = torch.empty(splits, C, H, **f32)
    dqh = torch.empty(B, H, **f32)
    dwv = torch.empty(C, H, **f32)
    dws = torch.empty(H, **f32)
    p_dz, p_dwv = f32_score_plan(v, wv), f32_dwv_plan(v, dzr)
    lib = _f32_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.attention_bwd_f32(
            v.data_ptr(), wv.data_ptr(), qh.data_ptr(), ws.data_ptr(),
            ds.data_ptr(), r.data_ptr(), dz.data_ptr(), dzr.data_ptr(),
            wpart.data_ptr(), part.data_ptr(), dqh.data_ptr(),
            dwv.data_ptr(), dws.data_ptr(),
            B, N, C, H, int(normalize), splits, p_dz["a_width"],
            p_dz["b_width"], p_dz["smem_bytes"], p_dwv["a_width"],
            p_dwv["b_width"], p_dwv["smem_bytes"], p_dz["stages"],
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    attention_bwd_f32.launches += launched.value
    kernels.check(lib, rc, what)
    return dqh, dwv, dws


attention_bwd_f32.launches = 0
