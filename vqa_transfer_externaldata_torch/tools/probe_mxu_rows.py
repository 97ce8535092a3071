"""H100 probe P1: the tensor-core ceiling of the store-row score GEMM.

The counterpart of the TPU probe ``tools/probe_mxu_rows.py`` of the
repository, with its structure and sizes: a store [M=64, Np=200, C=2048]
bf16, B=252 row indices (divisible by 1..4), W_v [2048, 512] bf16. For
Q in 1..4, each group of Q questions computes one [Q*200, 2048] x
[2048, 512] product of its store rows, looked up by index in the loads as
kernel K4 does, into out [B/Q, Q*200, 512] f32: the same 105.7 GFLOP a call
at every Q. On the H100 the question is the 128-row tensor-core tiles inside
a group (:func:`tile_accounting`): 200 rows take 2 tiles (78% of the rows
useful), 400 take 4 (78%), 600 take 5 (94%), 800 take 7 (89%). The kernel
(``csrc/probe_mxu_rows.cu``) is K4's score mainloop (``csrc/score_gemm.cuh``:
wgmma fed by a cp.async ring) without its epilogue.

Checks: Q = 1 against the plain version (``TOL_REL`` of the largest value),
Q > 1 against Q = 1 (rtol 1e-5, as the TPU probe). Times: ms per call over
``ITERS`` launches (CUDA events, the rows rolled on the device between
launches), us per question, TFLOP/s; beside them the same product through
cuBLAS (``torch.matmul`` in bf16) on the rows gathered once, the gather
timed apart.

    python -m vqa_transfer_externaldata_torch.tools.probe_mxu_rows

runs on the card and prints one JSON object; without a card it raises.
"""

from __future__ import annotations

import ctypes
import functools
import json
from typing import Dict

import numpy as np
import torch

from vqa_transfer_externaldata_torch.ops import kernels
from vqa_transfer_externaldata_torch.tools import (
    TOL_REL, loop_ms, rel_err, require_cuda)

M, Np, C, H = 64, 200, 2048, 512
B = 252  # divisible by 1, 2, 3, 4
QS = (1, 2, 3, 4)
ITERS = 96
FLOPS = 2 * B * Np * C * H  # 105.7 GFLOP a call, at every Q
_TILE_H, _TILE_C = 128, 32  # H's and C's multiples
TILE_ROWS = 128  # rows of a tile (csrc/score_gemm.cuh)


def tile_accounting(q: int, np_: int = Np) -> tuple:
    """(tiles, useful share of the rows computed) of one group of ``q``
    questions of ``np_`` rows each: its q * np_ rows in TILE_ROWS-row
    tiles, the last one padded with zero rows."""
    tiles = -(-q * np_ // TILE_ROWS)
    return tiles, q * np_ / (tiles * TILE_ROWS)


def make_inputs(device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The TPU probe's inputs: store ~ N(0, 1), W_v ~ N(0, 0.02^2), both in
    bf16, and B random rows, from ``seed``."""
    rng = np.random.default_rng(seed)
    store = torch.from_numpy(rng.standard_normal((M, Np, C), np.float32))
    wv = torch.from_numpy(rng.standard_normal((C, H), np.float32) * 0.02)
    rows = torch.from_numpy(rng.integers(0, M, size=B).astype(np.int32))
    return {"store": store.to(device, torch.bfloat16),
            "wv": wv.to(device, torch.bfloat16), "rows": rows.to(device)}


def probe_mxu_rows_reference(store: torch.Tensor, rows: torch.Tensor,
                             wv: torch.Tensor, q: int) -> torch.Tensor:
    """Plain PyTorch version of the probe: [B/q, q*Np, H] f32, each group's
    q store rows times W_v with f32 sums of the bf16 products."""
    Bq, Npp = rows.shape[0], store.shape[1]
    v = store[rows.long()].float()  # [B, Np, C]
    return (v @ wv.float()).reshape(Bq // q, q * Npp, -1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = kernels.load("probe_mxu_rows")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_mxu_rows.argtypes = [p] * 4 + [i] * 5 + [p, p]
    lib.probe_mxu_rows.restype = i
    return lib


def probe_mxu_rows(store: torch.Tensor, rows: torch.Tensor, wv: torch.Tensor,
                   q: int) -> torch.Tensor:
    """Launch the probe kernel on CUDA tensors: store [M, Np, C] bf16, rows
    [B] int32 (each < M, which the caller guarantees), W_v [C, H] bf16 ->
    [B/q, q*Np, H] f32. Needs B % q == 0, C % 32 == 0, H % 128 == 0. The
    kernel reads W_v as its K-major copy ``wv.t()`` [H, C], made here, as
    K4's wrapper makes it. Adds the number launched (1) to
    ``probe_mxu_rows.launches``."""
    if store.device.type != "cuda" or store.dim() != 3:
        raise ValueError("probe_mxu_rows takes a 3-D CUDA store")
    Ms, Nps, Cs = store.shape
    Bq, Hs = rows.shape[0], wv.shape[-1]
    dev = store.device
    kernels.expect("store", store, torch.bfloat16, (Ms, Nps, Cs), dev)
    kernels.expect("rows", rows, torch.int32, (Bq,), dev)
    kernels.expect("wv", wv, torch.bfloat16, (Cs, Hs), dev)
    if q < 1 or Bq % q or Cs % _TILE_C or Hs % _TILE_H:
        raise ValueError(f"probe_mxu_rows needs B % q == 0, C % {_TILE_C} "
                         f"== 0 and H % {_TILE_H} == 0, got B={Bq}, q={q}, "
                         f"C={Cs}, H={Hs}")
    if store.data_ptr() % 16:
        raise ValueError("probe_mxu_rows reads in 16-byte vectors: the "
                         "store must start 16-byte aligned")
    wvt = wv.t().contiguous()
    out = torch.empty(Bq // q, q * Nps, Hs, dtype=torch.float32, device=dev)
    lib = _lib()
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.probe_mxu_rows(
            store.data_ptr(), rows.data_ptr(), wvt.data_ptr(), out.data_ptr(),
            Bq, q, Nps, Cs, Hs, torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    probe_mxu_rows.launches += launched.value
    kernels.check(lib, rc, "probe_mxu_rows")
    return out


probe_mxu_rows.launches = 0


def run(iters: int = ITERS) -> dict:
    """The probe on the card: checks (``RuntimeError`` if one fails) and
    times at every Q, the plain version's time and cuBLAS's. Launches the
    kernel ``len(QS) * (iters + 2)`` times."""
    dev = require_cuda("probe_mxu_rows")
    x = make_inputs(dev)
    store, rows, wv = x["store"], x["rows"], x["wv"]
    plain = probe_mxu_rows_reference(store, rows, wv, 1)
    out: dict = {"shape": {"M": M, "Np": Np, "C": C, "H": H, "B": B},
                 "gflop_per_call": FLOPS / 1e9, "iters": iters, "by_q": {}}
    ref = None
    for q in QS:
        got = probe_mxu_rows(store, rows, wv, q)
        torch.cuda.synchronize()
        flat = got.reshape(B, Np, H)
        if ref is None:
            err = rel_err(flat, plain.reshape(B, Np, H))
            if not err <= TOL_REL:
                raise RuntimeError(f"probe_mxu_rows Q=1: {err} of max|out| "
                                   f"against the plain version > {TOL_REL}")
            out["max_abs_err"] = (flat - plain.reshape(B, Np, H)).abs().max(
            ).item()
            out["rel_err_vs_plain"] = err
            ref = flat
        else:
            diff = (flat - ref).abs()
            if not bool((diff <= 1e-5 * ref.abs()).all()):
                raise RuntimeError(f"probe_mxu_rows Q={q} differs from Q=1 "
                                   f"by {diff.max().item()} (rtol 1e-5)")
        ms = loop_ms(lambda r, q=q: probe_mxu_rows(store, r, wv, q), rows,
                     iters)
        tiles, useful = tile_accounting(q)
        out["by_q"][q] = {
            "ms": ms, "us_per_question": ms * 1e3 / B,
            "tflops": FLOPS / (ms * 1e-3) / 1e12,
            "tiles_per_group": tiles, "useful_rows": useful,
            "max_diff_vs_q1": 0.0 if q == 1 else (flat - ref).abs().max(
            ).item()}
    out["plain_ms"] = loop_ms(
        lambda r: probe_mxu_rows_reference(store, r, wv, 1), rows, iters)
    # cuBLAS on the gathered rows: the product of one bf16 matmul (bf16
    # out), and the gather that feeds it, timed apart.
    gathered = store.index_select(0, rows.long()).reshape(B * Np, C)
    out["cublas_ms"] = loop_ms(lambda r: torch.matmul(gathered, wv), rows,
                               iters)
    out["cublas_gather_ms"] = loop_ms(
        lambda r: store.index_select(0, r.long()), rows, iters)
    out["cublas_call"] = (f"torch.matmul([{B * Np}, {C}] bf16, [{C}, {H}] "
                          "bf16) -> bf16, on rows gathered once")
    # The least time for the work: 2 B Np C H operations in bf16, against
    # each distinct store row, W_v and rows read once and out written once.
    uniq = int(torch.unique(rows).numel())
    nbytes = uniq * Np * C * 2 + C * H * 2 + B * 4 + B * Np * H * 4
    out["bound"] = {"bytes": nbytes, "flops": FLOPS, "unique_rows": uniq}
    return out


def main(argv=None) -> int:
    del argv
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
