"""H100 probe P2: the ceiling of the resident attention backward's matrix
products.

The counterpart of the TPU probe ``tools/probe_bwd_ceiling.py`` of the
repository, with its structure and sizes: a store [M=64, Np=200, C=2048]
bf16, B=256 row indices, the saved h [B, Np, H=512] bf16 and a cotangent
row g [B, C] bf16:

    dal[b] = g[b] . store[rows[b]]^T                 [B, Np] f32
    dW_v   = sum_b store[rows[b]]^T bf16(h[b] * 0.5)  [C, H] f32

107.6 GFLOP a call. The kernel (``csrc/probe_bwd_ceiling.cu``) is K5's
structure without its softmax backward: K5's per-question pass
(``csrc/attention_rows.cuh``, one block a question) forms dal and the bf16
cotangent, then K5's own split-K dW_v GEMM with the store rows looked up
per cell (``csrc/attention_dwv.cuh``) and its fixed-order reduction, so the
probe times K5's GEMM under the same lookup.

Checks: dW_v and dal against the plain version (``TOL_REL`` of each
output's largest value). Times: ms per call over ``ITERS`` calls (CUDA
events, the rows rolled on the device between calls), TFLOP/s; beside them
cuBLAS's ``v_all^T @ dz_all`` (bf16) on the rows gathered once.

    python -m vqa_transfer_externaldata_torch.tools.probe_bwd_ceiling

runs on the card and prints one JSON object; without a card it raises.
"""

from __future__ import annotations

import ctypes
import functools
import json
from typing import Dict, Tuple

import numpy as np
import torch

from vqa_transfer_externaldata_torch.ops import kernels
from vqa_transfer_externaldata_torch.tools import (
    TOL_REL, loop_ms, rel_err, require_cuda)

M, Np, C, H = 64, 200, 2048, 512
B = 256
ITERS = 96
FLOPS = 2 * B * Np * C * (H + 1)  # 107.6 GFLOP a call


def make_inputs(device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The TPU probe's inputs, from ``seed``: store, h and g ~ N(0, 1) in
    bf16, and B random rows."""
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device, torch.bfloat16)

    store, h, g = bf16(M, Np, C), bf16(B, Np, H), bf16(B, C)
    rows = torch.from_numpy(rng.integers(0, M, size=B).astype(np.int32))
    return {"store": store, "h": h, "g": g, "rows": rows.to(device)}


def probe_bwd_ceiling_reference(store: torch.Tensor, rows: torch.Tensor,
                                h: torch.Tensor, g: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the probe: (dW_v [C, H] f32, dal [B, Np]
    f32), f32 sums of the bf16 products."""
    v = store[rows.long()].float()  # [B, Np, C]
    dz = (h.float() * 0.5).to(h.dtype).float()
    dwv = torch.einsum("bnc,bnh->ch", v, dz)
    dal = torch.einsum("bc,bnc->bn", g.float(), v)
    return dwv, dal


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = kernels.load("probe_bwd_ceiling")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_bwd_ceiling.argtypes = [p] * 8 + [i] * 5 + [p, p]
    lib.probe_bwd_ceiling.restype = i
    return lib


def probe_bwd_ceiling(store: torch.Tensor, rows: torch.Tensor,
                      h: torch.Tensor, g: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the probe kernel on CUDA tensors: store [M, Np, C] bf16, rows
    [B] int32 (each < M, which the caller guarantees), h [B, Np, H] bf16,
    g [B, C] bf16 -> (dW_v [C, H], dal [B, Np]), f32. Needs C % 128 == 0
    and H % 128 == 0. One call makes three launches (the per-question pass,
    the dW_v GEMM, the reduction) and adds the number launched to
    ``probe_bwd_ceiling.launches``."""
    if store.device.type != "cuda" or store.dim() != 3:
        raise ValueError("probe_bwd_ceiling takes a 3-D CUDA store")
    Ms, Nps, Cs = store.shape
    Bq, Hs = rows.shape[0], h.shape[-1]
    dev = store.device
    kernels.expect("store", store, torch.bfloat16, (Ms, Nps, Cs), dev)
    kernels.expect("rows", rows, torch.int32, (Bq,), dev)
    kernels.expect("h", h, torch.bfloat16, (Bq, Nps, Hs), dev)
    kernels.expect("g", g, torch.bfloat16, (Bq, Cs), dev)
    tile = kernels.DWV_TILE
    if Cs % tile or Hs % tile:
        raise ValueError(f"probe_bwd_ceiling needs C % {tile} == 0 and "
                         f"H % {tile} == 0, got C={Cs}, H={Hs}")
    if any(t.data_ptr() % 16 for t in (store, h, g)):
        raise ValueError("probe_bwd_ceiling reads in 16-byte vectors: "
                         "store, h and g must start 16-byte aligned")
    K = Bq * Nps
    splits = kernels.dwv_plan(K, Cs, Hs, kernels.sm_count(dev))["splits"]
    f32 = dict(dtype=torch.float32, device=dev)
    dal = torch.empty(Bq, Nps, **f32)
    dz = torch.empty(K, Hs, dtype=torch.bfloat16, device=dev)
    part = torch.empty(splits, Cs, Hs, **f32)
    dwv = torch.empty(Cs, Hs, **f32)
    lib = _lib()
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.probe_bwd_ceiling(
            store.data_ptr(), rows.data_ptr(), h.data_ptr(), g.data_ptr(),
            dal.data_ptr(), dz.data_ptr(), part.data_ptr(), dwv.data_ptr(),
            Bq, Nps, Cs, Hs, splits,
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    probe_bwd_ceiling.launches += launched.value
    kernels.check(lib, rc, "probe_bwd_ceiling")
    return dwv, dal


probe_bwd_ceiling.launches = 0


def run(iters: int = ITERS) -> dict:
    """The probe on the card: the check (``RuntimeError`` if it fails), its
    time, the plain version's and cuBLAS's. Makes ``iters + 2`` calls of
    the kernel (three launches each)."""
    dev = require_cuda("probe_bwd_ceiling")
    x = make_inputs(dev)
    store, rows, h, g = x["store"], x["rows"], x["h"], x["g"]
    got = probe_bwd_ceiling(store, rows, h, g)
    want = probe_bwd_ceiling_reference(store, rows, h, g)
    torch.cuda.synchronize()
    out: dict = {"shape": {"M": M, "Np": Np, "C": C, "H": H, "B": B},
                 "gflop_per_call": FLOPS / 1e9, "iters": iters}
    for name, a, b in zip(("dwv", "dal"), got, want):
        err = rel_err(a, b)
        if not err <= TOL_REL:
            raise RuntimeError(f"probe_bwd_ceiling {name}: {err} of "
                               f"max|{name}| against the plain version > "
                               f"{TOL_REL}")
        out[f"{name}_rel_err"] = err
    out["max_abs_err"] = max((a - b).abs().max().item()
                             for a, b in zip(got, want))
    out["ms"] = loop_ms(lambda r: probe_bwd_ceiling(store, r, h, g), rows,
                        iters)
    out["tflops"] = FLOPS / (out["ms"] * 1e-3) / 1e12
    out["plain_ms"] = loop_ms(
        lambda r: probe_bwd_ceiling_reference(store, r, h, g), rows, iters)
    # cuBLAS on the gathered rows: dW_v as one bf16 matmul (bf16 out).
    v_all = store.index_select(0, rows.long()).reshape(B * Np, C)
    dz_all = (h * 0.5).reshape(B * Np, H)
    out["cublas_ms"] = loop_ms(lambda r: v_all.t() @ dz_all, rows, iters)
    out["cublas_call"] = (f"[{C}, {B * Np}] bf16 @ [{B * Np}, {H}] bf16 -> "
                          "bf16 (v_all^T @ dz_all on rows gathered once)")
    # The least time: each distinct store row, h, g and rows read once,
    # dW_v and dal written once; 2 B Np C (H + 1) operations in bf16.
    uniq = int(torch.unique(rows).numel())
    nbytes = (uniq * Np * C * 2 + B * Np * H * 2 + B * C * 2 + B * 4
              + C * H * 4 + B * Np * 4)
    out["bound"] = {"bytes": nbytes, "flops": FLOPS, "unique_rows": uniq}
    return out


def main(argv=None) -> int:
    del argv
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
