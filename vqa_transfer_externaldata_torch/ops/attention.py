"""Single-glimpse spatial attention over the image feature grid:

    h      = relu(v @ Wv + qh)          # [B, N, H], qh = q @ Wq + bq
    score  = h @ w_s                    # [B, N]
    alpha  = softmax_N(score)           # [B, N]
    v_att  = sum_N alpha * v            # [B, C]

With ``normalize`` the per-cell L2 norm of ``v`` is fused in by scaling
after the matmul: h = relu((v @ Wv) * r + qh), v_att = sum (alpha r) v,
r = rsqrt(|v|^2 + 1e-12).

:func:`spatial_attention` is the forward entry point: on CUDA tensors it
launches the hand-written kernel ``csrc/attention_fwd.cu`` (wrapper
:func:`attention_fwd`), on CPU tensors its plain version
:func:`attention_fwd_reference`. :func:`spatial_attention_reference` and
:func:`_reference_postscaled` are the JAX package's oracles, in PyTorch.

Products of ``dt`` (bf16) values are taken as float32 matmuls of upcast
operands: the upcast copies are exact, so this is a ``dt`` matmul with
float32 accumulation, as ``preferred_element_type=float32`` is in JAX.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from vqa_transfer_externaldata_torch.ops import kernels

_SCORE_TILE_H = 128  # hidden columns per score tile (csrc/attention_fwd.cu)
_SCORE_TILE_C = 32  # channels per k-step


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


def attention_fwd_reference(v: torch.Tensor, qh: torch.Tensor,
                            wv: torch.Tensor, ws: torch.Tensor,
                            normalize: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel K2, in the kernel's rounding:
    v [B, N, C] (dt), qh [B, H] f32, wv [C, H] (dt), ws [H] f32
    -> (v_att [B, C] f32, alpha [B, N] f32). h stays f32 for the score,
    squares and the weights p * r are rounded to dt."""
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
    return v_att, p / d


def spatial_attention(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                      w_score: torch.Tensor, *, normalize: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only attention: v [B, N, C] in the compute dtype, qh [B, H],
    wv [C, H], w_score [H] -> (v_att [B, C] f32, alpha [B, N] f32).
    ``wv`` and ``w_score`` are rounded to ``v.dtype`` as the reference
    kernel's caller does. A CUDA tensor runs kernel K2 (which takes bf16
    ``v``), a CPU tensor the plain version."""
    wv = wv.to(v.dtype).contiguous()
    ws = w_score.to(v.dtype).float()
    qh = qh.float().contiguous()
    if v.device.type == "cuda":
        return attention_fwd(v, qh, wv, ws, normalize=normalize)
    if v.device.type == "cpu":
        return attention_fwd_reference(v, qh, wv, ws, normalize)
    raise ValueError(f"spatial_attention: no path for device {v.device}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = kernels.load("attention_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attention_fwd.argtypes = [p, p, p, p, p, p, p, p,
                                  i, i, i, i, i, p, p]
    lib.attention_fwd.restype = i
    return lib


def attention_fwd(v: torch.Tensor, qh: torch.Tensor, wv: torch.Tensor,
                  ws: torch.Tensor, *, normalize: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel K2 (``csrc/attention_fwd.cu``) on CUDA tensors:
    v [B, N, C] bf16, qh [B, H] f32, wv [C, H] bf16, ws [H] f32
    -> (v_att [B, C] f32, alpha [B, N] f32). Needs C % 32 == 0 and
    H % 128 == 0. One call makes the kernel's two launches on the current
    stream and adds the number launched (2) to ``attention_fwd.launches``."""
    if v.device.type != "cuda" or v.dim() != 3:
        raise ValueError("attention_fwd takes a 3-D CUDA v")
    B, N, C = v.shape
    H = qh.shape[-1]
    dev = v.device
    if C % _SCORE_TILE_C or H % _SCORE_TILE_H or B < 1 or N < 1:
        raise ValueError(f"attention_fwd needs C % {_SCORE_TILE_C} == 0 and "
                         f"H % {_SCORE_TILE_H} == 0, got C={C}, H={H}")
    if 2 * N * 4 > 48 * 1024:
        raise ValueError(f"attention_fwd: N={N} cells exceed the softmax's "
                         "shared memory")
    kernels.expect("v", v, torch.bfloat16, (B, N, C), dev)
    kernels.expect("qh", qh, torch.float32, (B, H), dev)
    kernels.expect("wv", wv, torch.bfloat16, (C, H), dev)
    kernels.expect("ws", ws, torch.float32, (H,), dev)
    if v.data_ptr() % 16 or wv.data_ptr() % 16:
        raise ValueError("attention_fwd reads v and wv in 16-byte vectors: "
                         "both must start 16-byte aligned")
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty(H // _SCORE_TILE_H, B * N, **f32)
    rnorm = torch.empty(B * N, **f32)
    v_att = torch.empty(B, C, **f32)
    alpha = torch.empty(B, N, **f32)
    lib = _lib()
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.attention_fwd(
            v.data_ptr(), wv.data_ptr(), qh.data_ptr(), ws.data_ptr(),
            part.data_ptr(), rnorm.data_ptr(), v_att.data_ptr(),
            alpha.data_ptr(), B, N, C, H, int(normalize),
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    attention_fwd.launches += launched.value
    kernels.check(lib, rc, "attention_fwd")
    return v_att, alpha


attention_fwd.launches = 0
