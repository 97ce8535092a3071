"""Gather-free spatial attention over a feature store resident in device
memory, with G glimpses (1 <= G <= 8) that share the one v @ Wv product:

    v        = store[rows[b]]                   [Np, C] (Np padded cells)
    r        = rsqrt(|v|^2 + 1e-12) per cell    (1 unless ``normalize``)
    h        = relu((v @ Wv) * r + qh[b])       [Np, H]
    alpha_g  = softmax over the n_valid cells of h @ w_s[:, g] (padded: 0)
    v_att_g  = sum_n (alpha_gn r_n) v_n         [C], concatenated in g order

Each question's grid is read straight out of the [M, Np, C] store through
its row index, so no [B, Np, C] batch is ever built. The training forward
saves the post-ReLU ``h`` (compute dtype) and the backward works from it:
dqh, dWv and dws, while the store and the rows get no gradient (the store
is data). A 1-D ``w_score`` [H] is the single glimpse, with outputs
without the glimpse axis.

The store is bf16, float16 or float32 rows, float16 rows in a float32
model (widened to float32 as they are loaded, exactly: the values of the
JAX package's ``store.astype(float32)``), or int8 codes of an
L2-prenormalized store with one global dequantization scale
(:func:`quantize_store`, :func:`prenormalize_store` with
``quantize="int8"``): the kernels widen the codes to the compute dtype as
they load them (exact: |code| <= 127), and the scale stays outside them,
folded into Wv, applied to v_att after the forward, to the v_att cotangent
before the backward and to dWv after it. The compute dtype is the
store's, or qh's for int8 codes and float16 rows.

:func:`spatial_attention_resident` is the entry point. On CUDA tensors its
forward launches kernel K4 (``csrc/attention_resident_fwd.cu``, wrapper
:func:`attention_resident_fwd`) and its backward kernel K5
(``csrc/attention_resident_bwd.cu``, wrapper :func:`attention_resident_bwd`);
on CPU tensors their plain versions :func:`attention_resident_fwd_reference`
and :func:`attention_resident_bwd_reference`. A float16 computation takes
their float16 instances K4h (``csrc/attention_resident_fwd_f16.cu``,
:func:`attention_resident_fwd_f16`) and K5h
(``csrc/attention_resident_bwd_f16.cu``,
:func:`attention_resident_bwd_f16`), the same bodies with float16 in place
of bf16, and a float32 computation the float32 kernels: K4f
(``csrc/attention_resident_fwd_f32.cu``,
:func:`attention_resident_fwd_f32`) and K5f
(``csrc/attention_resident_bwd_f32.cu``,
:func:`attention_resident_bwd_f32`), plain FFMA with f32 sums, which save
and read h in float32. The rounding follows the kernels: f32 sums of
compute-dtype products, squares, each glimpse's ``alpha * r``, the v_att
cotangents and ``dz * r`` (dz summed over the glimpses in f32 first)
rounded to the compute dtype.

The 16-bit wrappers take any C and H, as the Pallas bodies do: H is
zero-padded to 128 (:func:`resident_pad_weights`), C to 32 (K4) or 128 (K5);
a store whose channels are off the multiple is read through the batch's
padded rows (:func:`resident_pad_store`), and the Trainer uploads its
stores with their channels padded to ``kernels.STORE_CHANNELS`` once
(:func:`prenormalize_store`'s ``channels``), so the main path pads nothing
a call but W_v's rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from vqa_transfer_externaldata_torch.ops import kernels

_NEG_INF = -1e30
_WSUM_STATIC = 32 * 4  # K4's wsum kernel's static reduction scratch
MAX_GLIMPSES = 8  # the kernels' limit, the TPU kernel's (its ws sublanes)
# Row dtypes that compute in the model's dtype (qh's), widened on load.
_WIDENED = (torch.int8, torch.float16)
# float32 rows, f16 rows widened to f32, int8 codes: the C side's row_type.
_F32_ROWS = {torch.float32: 0, torch.float16: 1, torch.int8: 2}


def pad_store_rows(grid: np.ndarray, multiple: int = 8,
                   channels: int = 1) -> np.ndarray:
    """Pad the cell axis of an [M, N, C] store (float, or int8 codes) to a
    multiple of ``multiple`` with zero rows (masked out by ``n_valid``),
    and its channel axis to a multiple of ``channels`` with zero channels
    (``kernels.store_channel_multiple``: the 16-bit kernels' C, padded here
    once rather than at every call; the op slices them off). int8 stores
    pad to 8 as float ones do: the JAX package pads them to 32, Mosaic's
    int8 sublane tile, which the H100 kernels do not have."""
    M, N, C = grid.shape
    pad, cpad = (-N) % multiple, (-C) % channels
    if pad == 0 and cpad == 0:
        return grid
    out = np.zeros((M, N + pad, C + cpad), grid.dtype)
    out[:, :N, :C] = grid
    return out


def _normalized(chunk: np.ndarray) -> np.ndarray:
    """A float32 copy of ``chunk`` with each cell L2-normalized, the
    kernels' ``x / sqrt(sum x^2 + 1e-12)`` (the source is never aliased)."""
    g32 = chunk.astype(np.float32)
    ssq = np.sum(np.square(g32), axis=-1, keepdims=True)
    g32 *= 1.0 / np.sqrt(ssq + 1e-12)
    return g32


def _codes(g32: np.ndarray, scale: float) -> np.ndarray:
    return np.clip(np.rint(g32 / scale), -127, 127).astype(np.int8)


def quantize_store(grid: np.ndarray) -> Tuple[np.ndarray, float]:
    """Symmetric int8 quantization of an L2-prenormalized [M, N, C] store
    with one global scale ``g = (max|x| or 1) / 127`` (after the per-cell
    normalization every cell has norm 1, so one scale serves them all).
    Returns ``(codes, g)`` with ``codes * g ~= x``."""
    g32 = np.asarray(grid, np.float32)
    scale = (float(np.max(np.abs(g32))) or 1.0) / 127.0
    return _codes(g32, scale), scale


def prenormalize_store(grid: np.ndarray,
                       out_dtype: Optional[torch.dtype] = None,
                       quantize: str = "",
                       chunk_bytes: int = 1 << 28,
                       device: Optional[torch.device] = None,
                       shard: Optional[Tuple[int, int]] = None,
                       channels: int = 1
                       ) -> Tuple[torch.Tensor, float]:
    """L2-normalize each cell of an [M, N, C] float store and pad the cell
    axis to a multiple of 8, chunk by chunk: each chunk is normalized in
    float32 on the host, cast to ``out_dtype`` (default: the store's own)
    and written into the padded output tensor on ``device`` (default: the
    CPU), so neither a full-size float32 copy nor a second host copy of the
    store is made. The source is never modified. Returns ``(padded store,
    scale)`` with scale 1.0.

    ``quantize="int8"``: two chunked passes, the global absmax of the
    normalized values, then the codes; the result is int8 with the
    dequantization scale, the codes equal to :func:`quantize_store` of the
    whole normalized store (``out_dtype`` is not used).

    ``shard=(d, n)`` (``train.store_sharded``): only the rows d, d + n,
    d + 2n, ... are written, as the rows of a [ceil(M / n), Np, C] store
    whose tail rows stay zero; an int8 scale is still the whole store's.

    ``channels``: the channel axis is padded to a multiple of it with zero
    channels (:func:`pad_store_rows`'s ``channels``). A zero channel keeps
    each cell's norm, and an int8 store's scale and codes are the unpadded
    store's: the departure from JAX's layout is only in the shape."""
    if quantize not in ("", "int8"):
        raise ValueError(f"quantize={quantize!r}: only 'int8' or ''")
    M, N, C = grid.shape
    Np = N + (-N) % 8
    rows = max(1, chunk_bytes // max(N * C * 4, 1))
    scale = 1.0
    if quantize:
        gmax = 0.0
        for lo in range(0, M, rows):
            gmax = max(gmax, float(np.max(np.abs(
                _normalized(grid[lo:lo + rows])))))
        scale = (gmax or 1.0) / 127.0
        out_dtype = torch.int8
    elif out_dtype is None:
        out_dtype = torch.from_numpy(np.zeros(0, grid.dtype)).dtype
    src, M_out = grid, M
    if shard is not None:
        src, M_out = grid[shard[0]::shard[1]], -(-M // shard[1])
    Cp = C + (-C) % channels
    out = torch.zeros((M_out, Np, Cp), dtype=out_dtype, device=device)
    for lo in range(0, src.shape[0], rows):
        g32 = _normalized(src[lo:lo + rows])
        chunk = torch.from_numpy(_codes(g32, scale) if quantize else g32)
        out[lo:lo + chunk.shape[0], :N, :C] = chunk.to(out.device, out_dtype)
    return out, scale


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _gather(store: torch.Tensor, rows: torch.Tensor, normalize: bool,
            dt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v [B, Np, C] f32 copies of the store rows, r [B, Np] f32). int8
    codes are cast to the compute dtype ``dt`` first, as the kernels
    widen them (exactly)."""
    v = store[rows.long()].to(dt)
    r = (torch.rsqrt((v * v).float().sum(-1) + 1e-12) if normalize
         else torch.ones(v.shape[:2], dtype=torch.float32, device=v.device))
    return v.float(), r


def _glimpses(ws: torch.Tensor, what: str) -> int:
    """G of a score matrix ``ws`` [H, G] (1 for a single-glimpse [H])."""
    G = 1 if ws.dim() == 1 else ws.shape[1]
    if ws.dim() not in (1, 2) or not 1 <= G <= MAX_GLIMPSES:
        raise ValueError(f"{what} takes w_score [H] or [H, G] with 1 <= G <= "
                         f"{MAX_GLIMPSES}, got {tuple(ws.shape)}")
    return G


def attention_resident_fwd_reference(
        store: torch.Tensor, rows: torch.Tensor, qh: torch.Tensor,
        wv: torch.Tensor, ws: torch.Tensor, *, n_valid: int,
        normalize: bool, save_h: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of kernel K4: store [M, Np, C] (dt, or int8
    codes), rows [B] int, qh [B, H] f32, wv [C, H] (dt: the compute dtype),
    ws [H, G] f32 -> (v_att [B, G*C] f32, alpha [B, Np, G] f32 (0 at
    padded cells), h [B, Np, H] in dt or None). A 1-D ws [H] gives v_att
    [B, C] and alpha [B, Np]. The outputs are in the codes' units (the
    caller applies an int8 store's scale). float16 rows compute in wv's
    dtype, as int8 codes do."""
    dt = wv.dtype if store.dtype in _WIDENED else store.dtype
    G = _glimpses(ws, "attention_resident_fwd_reference")
    vf, r = _gather(store, rows, normalize, dt)
    z = vf @ wv.float()
    h = torch.relu(z * r[:, :, None] + qh[:, None, :])
    s = h @ ws.reshape(ws.shape[0], G)  # [B, Np, G]
    cell = torch.arange(s.shape[1], device=s.device)[:, None]
    s = torch.where(cell < n_valid, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - s.amax(dim=1, keepdim=True))
    alpha = p / p.sum(dim=1, keepdim=True)
    w = (alpha * r[:, :, None]).to(dt).float()  # each glimpse's weights
    v_att = torch.einsum("bng,bnc->bgc", w, vf).reshape(vf.shape[0], -1)
    if ws.dim() == 1:
        alpha = alpha[:, :, 0]
    return v_att, alpha, (h.to(dt) if save_h else None)


def attention_resident_bwd_reference(
        store: torch.Tensor, rows: torch.Tensor, h: torch.Tensor,
        ws: torch.Tensor, alpha: torch.Tensor, g: torch.Tensor,
        sga: torch.Tensor, *, n_valid: int, normalize: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel K5, from the saved ``h`` [B, Np, H]:
    ws [H, G] f32, alpha and sga (= ga - S per glimpse) [B, Np, G] f32,
    g [B, G*C] f32 (the v_att cotangent) -> (dqh [B, H], dwv [C, H],
    dws [H, G]), all f32; a 1-D ws [H] takes alpha and sga [B, Np] and
    gives dws [H]. The glimpses' dz are summed in f32 before the one
    ``dz * r`` rounding. The padded cells (alpha 0) add nothing, so
    ``n_valid`` is not needed. The compute dtype is the store's, or h's
    for int8 codes (whose scale the caller applies to g and dwv) and
    float16 rows."""
    del n_valid
    dt = h.dtype if store.dtype in _WIDENED else store.dtype
    G = _glimpses(ws, "attention_resident_bwd_reference")
    B, Np = alpha.shape[:2]
    ws2 = ws.reshape(-1, G)
    vf, r = _gather(store, rows, normalize, dt)
    g3 = g.reshape(B, G, -1).to(dt).float()
    dalpha = torch.einsum("bgc,bnc->bng", g3, vf) * r[:, :, None]
    ds = alpha.reshape(B, Np, G) * (dalpha + sga.reshape(B, Np, G))
    hf = h.float()
    live = hf > 0
    dz = torch.zeros_like(hf)
    for k in range(G):  # in glimpse order, as the kernels sum
        dz = dz + torch.where(live, ds[:, :, k, None] * ws2[:, k],
                              torch.zeros_like(hf))
    dws = torch.einsum("bng,bnh->hg", ds, hf).reshape(ws.shape)
    dqh = dz.sum(1)
    dwv = torch.einsum("bnc,bnh->ch", vf,
                       (dz * r[:, :, None]).to(dt).float())
    return dqh, dwv, dws


# ---------------------------------------------------------------------------
# Widths: zero padding around the 16-bit kernels
# ---------------------------------------------------------------------------


def glimpse_channels(x: torch.Tensor, G: int, C: int) -> torch.Tensor:
    """x [B, G*C'] (G glimpses of C' channels, concatenated in glimpse
    order) -> [B, G*C]: each glimpse's channels cut to C, or zero-padded
    to C where C > C'."""
    B = x.shape[0]
    x3 = x.reshape(B, G, -1)
    Cx = x3.shape[2]
    if Cx == C:
        return x
    x3 = (x3[:, :, :C] if C < Cx
          else torch.nn.functional.pad(x3, (0, C - Cx)))
    return x3.reshape(B, G * C)


def resident_pad_store(Cp: int, store: torch.Tensor, rows: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A store [M, Np, C] whose channels are off the kernels' multiple,
    for one call: the rows the call reads, gathered ([B, Np, C]) and
    zero-padded to ``Cp`` channels, with the rows 0..B-1 that index them
    (a copy of the batch's cells, not of the store). The store and rows
    themselves where C == Cp. A store uploaded by the Trainer is padded
    once (:func:`prenormalize_store`'s ``channels``) and takes no copy."""
    C = store.shape[2]
    if C == Cp:
        return store, rows
    grid = torch.nn.functional.pad(store[rows.long()], (0, Cp - C))
    return grid, torch.arange(rows.shape[0], dtype=torch.int32,
                              device=rows.device)


def resident_pad_weights(Cp: int, Hp: int, wv: Optional[torch.Tensor],
                         ws: torch.Tensor, qh: Optional[torch.Tensor] = None
                         ) -> Tuple[Optional[torch.Tensor], ...]:
    """W_v [C, H] -> [Cp, Hp] with zero rows and zero columns, ws [H] or
    [H, G] -> [Hp] or [Hp, G] and qh [B, H] -> [B, Hp] with zero units (wv
    or qh None stays None), as JAX's B6 pads H. A zero channel adds 0 to
    every norm and product; a zero unit has z = 0, h = relu(0) = 0 and ws
    0, so it adds nothing to a score and its dz is 0: the real outputs are
    unchanged, and the padded ones are sliced off."""
    H = ws.shape[0]
    pad = torch.nn.functional.pad
    if wv is not None and tuple(wv.shape) != (Cp, Hp):
        wv = pad(wv, (0, Hp - H, 0, Cp - wv.shape[0]))
    if Hp != H:
        ws = pad(ws, (0, 0, 0, Hp - H) if ws.dim() == 2 else (0, Hp - H))
        qh = None if qh is None else pad(qh, (0, Hp - H))
    return wv, ws, qh


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fwd_lib(name: str = "attention_resident_fwd") -> ctypes.CDLL:
    """The library of K4 (``name`` "attention_resident_fwd") or K4h
    ("attention_resident_fwd_f16"); both export the same entries."""
    lib = kernels.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attention_resident_fwd.argtypes = [p] * 10 + [i] * 8 + [p, p]
    lib.attention_resident_fwd.restype = i
    lib.attention_resident_score_config.argtypes = [i] * 3 + [p] * 6
    lib.attention_resident_score_config.restype = i
    return lib


def score_launch_config(cells: int, H: int, int8: bool,
                        dtype: torch.dtype = torch.bfloat16) -> dict:
    """The shape of K4's score launch (K4h's with ``dtype`` float16) over
    ``cells`` cells at width ``H`` on 16-bit rows or int8 codes: its tile
    (rows x columns), ring stages, dynamic shared memory in bytes and grid
    (column tiles fastest)."""
    lib = _fwd_lib(kernels.name16("attention_resident_fwd", dtype))
    out = [ctypes.c_int(0) for _ in range(6)]
    rc = lib.attention_resident_score_config(
        cells, H, int(int8), *(ctypes.addressof(o) for o in out))
    kernels.check(lib, rc, "attention_resident_score_config")
    tm, tn, stages, smem, gx, gy = (o.value for o in out)
    return {"tile": [tm, tn], "stages": stages, "smem_bytes": smem,
            "grid": [gx, gy]}


@functools.lru_cache(maxsize=None)
def _bwd_lib(name: str = "attention_resident_bwd") -> ctypes.CDLL:
    """The library of K5 (``name`` "attention_resident_bwd") or K5h
    ("attention_resident_bwd_f16"); both export the same entries."""
    lib = kernels.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attention_resident_bwd.argtypes = [p] * 13 + [i] * 9 + [p, p]
    lib.attention_resident_bwd.restype = i
    lib.attention_resident_bwd_dwv_config.argtypes = [i] * 5 + [p]
    lib.attention_resident_bwd_dwv_config.restype = i
    lib.attention_resident_bwd_rows_config.argtypes = [i] * 5 + [p]
    lib.attention_resident_bwd_rows_config.restype = i
    return lib


def rows_launch_config(B: int, n_valid: int, G: int, C: int, H: int,
                       dtype: torch.dtype = torch.bfloat16) -> dict:
    """The shape of K5's rows launch (K5h's with ``dtype`` float16) as the
    C side sets it for ``B`` questions of ``n_valid`` cells at G glimpses,
    C x H, in :func:`kernels.rows_plan`'s keys."""
    lib = _bwd_lib(kernels.name16("attention_resident_bwd", dtype))
    out = (ctypes.c_int * 5)()
    rc = lib.attention_resident_bwd_rows_config(B, n_valid, G, C, H,
                                                 ctypes.addressof(out))
    kernels.check(lib, rc, "attention_resident_bwd_rows_config")
    gx, threads, smem, lanes, passes = out
    return {"grid": [gx], "threads": threads, "smem_bytes": smem,
            "cell_lanes": lanes, "unit_passes": passes}


def dwv_launch_config(K: int, C: int, H: int, int8: bool, splits: int,
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """The shape of K5's dW_v launch (K5h's with ``dtype`` float16) as the
    C side sets it (the same header serves K8 and P2) over ``K`` cells at
    ``C`` x ``H`` split ``splits`` ways, in :func:`kernels.dwv_plan`'s keys
    (``splits`` as given)."""
    lib = _bwd_lib(kernels.name16("attention_resident_bwd", dtype))
    out = (ctypes.c_int * 8)()
    rc = lib.attention_resident_bwd_dwv_config(K, C, H, int(int8), splits,
                                                ctypes.addressof(out))
    kernels.check(lib, rc, "attention_resident_bwd_dwv_config")
    tm, tn, stages, smem, per, gx, gy, gz = out
    return {"tile": [tm, tn], "stages": stages, "smem_bytes": smem,
            "splits": splits, "chunks_per_split": per, "grid": [gx, gy, gz]}


def _check_store(store: torch.Tensor, rows: torch.Tensor, n_valid: int,
                 normalize: bool, what: str,
                 dtypes: tuple = (torch.bfloat16, torch.int8)
                 ) -> Tuple[int, int, int, int]:
    """Shapes (M, Np, C, B) of a CUDA store of rows of one of ``dtypes``
    (bf16 rows or int8 codes for K4/K5, float16 rows or int8 codes for
    K4h/K5h) and its int32 row indices."""
    if store.device.type != "cuda" or store.dim() != 3:
        raise ValueError(f"{what} takes a 3-D CUDA store")
    M, Np, C = store.shape
    B = rows.shape[0] if rows.dim() == 1 else -1
    if store.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{what}: store must be {names}, got "
                        f"{store.dtype}")
    if store.dtype == torch.int8 and normalize:
        raise ValueError(f"{what}: an int8 store is normalized before it is "
                         "quantized, so normalize must be off")
    kernels.expect("store", store, store.dtype, (M, Np, C), store.device)
    kernels.expect("rows", rows, torch.int32, (B,), store.device)
    if B < 1 or not 1 <= n_valid <= Np:
        raise ValueError(f"{what} needs B >= 1 and 1 <= n_valid <= Np, got "
                         f"B={B}, n_valid={n_valid}, Np={Np}")
    if store.data_ptr() % 16:
        raise ValueError(f"{what} reads the store in 16-byte vectors: it "
                         "must start 16-byte aligned")
    return M, Np, C, B


def attention_resident_fwd(store: torch.Tensor, rows: torch.Tensor,
                           qh: torch.Tensor, wv: torch.Tensor,
                           ws: torch.Tensor, *, n_valid: int,
                           normalize: bool, save_h: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      Optional[torch.Tensor]]:
    """Launch kernel K4 on CUDA tensors: store [M, Np, C] bf16 or int8
    codes (normalize off), rows [B] int32 (each < M, which the caller
    guarantees), qh [B, H] f32, wv [C, H] bf16, ws [H, G] f32 with
    1 <= G <= 8 -> (v_att [B, G*C] f32, alpha [B, Np, G] f32, h [B, Np, H]
    bf16 when ``save_h`` else None); a 1-D ws [H] gives v_att [B, C] and
    alpha [B, Np]. Any C and H >= 1: H is zero-padded to a multiple of 128
    (:func:`resident_pad_weights`), and a store whose C is off a multiple
    of 32 is read through :func:`resident_pad_store` (a copy of the
    batch's rows; the Trainer's stores are padded at upload and take
    none); the outputs are sliced back. The score GEMM
    reads W_v as its K-major copy ``wv.t()`` [H, C], made here (2 MB at
    C=2048, H=512). One call makes the kernel's two launches on the current
    stream and adds the number launched (2) to
    ``attention_resident_fwd.launches`` (bf16 rows) or
    ``attention_resident_fwd.launches_int8`` (int8 rows). A float16 ``wv``
    goes to :func:`attention_resident_fwd_f16` (K4h), a float32 one to
    :func:`attention_resident_fwd_f32` (K4f); another dtype raises
    ``TypeError`` (:func:`kernels.kernel_dtype`)."""
    dt = kernels.kernel_dtype("attention_resident_fwd", "wv", wv)
    if dt == torch.float32:
        return attention_resident_fwd_f32(store, rows, qh, wv, ws,
                                          n_valid=n_valid,
                                          normalize=normalize, save_h=save_h)
    if dt == torch.float16:
        return attention_resident_fwd_f16(store, rows, qh, wv, ws,
                                          n_valid=n_valid,
                                          normalize=normalize, save_h=save_h)
    v_att, alpha, h, _ = _launch_fwd(store, rows, qh, wv, ws, n_valid,
                                     normalize, save_h)
    return v_att, alpha, h


attention_resident_fwd.launches = 0
attention_resident_fwd.launches_int8 = 0


def attention_resident_fwd_f16(store: torch.Tensor, rows: torch.Tensor,
                               qh: torch.Tensor, wv: torch.Tensor,
                               ws: torch.Tensor, *, n_valid: int,
                               normalize: bool, save_h: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          Optional[torch.Tensor]]:
    """Launch kernel K4h (``csrc/attention_resident_fwd_f16.cu``: K4's body
    with float16 as its element type) on CUDA tensors: as
    :func:`attention_resident_fwd` with a float16 or int8 store, wv [C, H]
    float16 and h saved in float16 (the squares of the norm and each
    glimpse's alpha * r rounded to float16). The same padding and launches
    as K4; 2 launches a call, added to
    ``attention_resident_fwd_f16.launches`` (float16 rows) or
    ``attention_resident_fwd_f16.launches_int8`` (int8 rows)."""
    v_att, alpha, h, _ = _launch_fwd(store, rows, qh, wv, ws, n_valid,
                                     normalize, save_h)
    return v_att, alpha, h


attention_resident_fwd_f16.launches = 0
attention_resident_fwd_f16.launches_int8 = 0


def _launch_fwd(store: torch.Tensor, rows: torch.Tensor, qh: torch.Tensor,
                wv: torch.Tensor, ws: torch.Tensor, n_valid: int,
                normalize: bool, save_h: bool
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor], torch.Tensor]:
    """K4's launch (K4h's on a float16 ``wv``), also returning the per-cell
    norm r [B*Np] f32 that its score launch wrote (ones unless
    ``normalize``)."""
    dt = wv.dtype
    what = kernels.name16("attention_resident_fwd", dt)
    M, Np, C, B = _check_store(store, rows, n_valid, normalize, what,
                               (dt, torch.int8))
    int8 = store.dtype == torch.int8
    H = qh.shape[-1]
    dev = store.device
    G = _glimpses(ws, what)
    if C < 1 or H < 1:
        raise ValueError(f"{what} needs C, H >= 1, got C={C}, H={H}")
    smem = 2 * G * Np * 4  # the wsum launch's softmaxes: p and w, [G, Np]
    if smem + _WSUM_STATIC > kernels.SMEM_OPTIN:
        raise ValueError(f"{what}: Np={Np} cells of G={G} glimpses need "
                         f"{smem} B of the softmax's shared memory, over a "
                         f"block's {kernels.SMEM_OPTIN} B")
    kernels.expect("qh", qh, torch.float32, (B, H), dev)
    kernels.expect("wv", wv, dt, (C, H), dev)
    kernels.expect("ws", ws, torch.float32,
                   (H, G) if ws.dim() == 2 else (H,), dev)
    C0, H0 = C, H
    C = kernels.round_up(C0, kernels.ATTENTION_FWD_CHANNELS)
    H = kernels.round_up(H0, kernels.ATTENTION_UNITS)
    store, rows = resident_pad_store(C, store, rows)
    wv, ws, qh = resident_pad_weights(C, H, wv, ws, qh)
    wvt = wv.t().contiguous()  # [H, C]: K-major, as the score GEMM reads it
    ws_gh = ws.reshape(H, G).t().contiguous()  # [G, H]: one row a glimpse
    f32 = dict(dtype=torch.float32, device=dev)
    # One partial score per cell and column tile: H / 128 slices, of which
    # the kernel fills H / 256 where its tile is 256 columns wide.
    part = torch.empty(H // kernels.ATTENTION_UNITS, G, B * Np, **f32)
    rnorm = torch.empty(B * Np, **f32)
    v_att = torch.empty(B, G * C, **f32)
    alpha = torch.empty(B, Np, G, **f32)
    h = torch.empty(B, Np, H, dtype=dt, device=dev) if save_h else None
    lib = _fwd_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.attention_resident_fwd(
            store.data_ptr(), rows.data_ptr(), wvt.data_ptr(), qh.data_ptr(),
            ws_gh.data_ptr(), part.data_ptr(), rnorm.data_ptr(),
            h.data_ptr() if save_h else None, v_att.data_ptr(),
            alpha.data_ptr(), B, Np, n_valid, C, H, G, int(normalize),
            int(int8), torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    counter = (attention_resident_fwd_f16 if dt == torch.float16
               else attention_resident_fwd)
    if int8:
        counter.launches_int8 += launched.value
    else:
        counter.launches += launched.value
    kernels.check(lib, rc, what)
    if h is not None and H != H0:
        h = h[..., :H0].contiguous()
    return (glimpse_channels(v_att, G, C0),
            (alpha if ws.dim() == 2 else alpha[:, :, 0]), h, rnorm)


def attention_resident_bwd(store: torch.Tensor, rows: torch.Tensor,
                           h: torch.Tensor, ws: torch.Tensor,
                           alpha: torch.Tensor, g: torch.Tensor,
                           sga: torch.Tensor, *, n_valid: int,
                           normalize: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Launch kernel K5 on CUDA tensors: store [M, Np, C] bf16 or int8
    codes (normalize off), rows [B] int32, h [B, Np, H] bf16 (K4's
    residual), ws [H, G] f32 with 1 <= G <= 8, alpha and sga [B, Np, G]
    f32, g [B, G*C] f32 -> (dqh [B, H], dwv [C, H], dws [H, G]), all f32; a
    1-D ws [H] takes alpha and sga [B, Np] and gives dws [H]. Any C and
    H >= 1, both zero-padded to multiples of 128 (the store as
    :func:`attention_resident_fwd` pads it, h, ws and g with zero units
    and channels) and the outputs sliced back; h 16-byte aligned, and the
    rows launch's shared memory within a block's
    (:func:`kernels.rows_plan`).
    One call makes the kernel's three launches on the current stream and
    adds the number launched (3) to
    ``attention_resident_bwd.launches`` (bf16 rows) or
    ``attention_resident_bwd.launches_int8`` (int8 rows). A float16 ``h``
    (K4h's residual) goes to :func:`attention_resident_bwd_f16` (K5h), a
    float32 one (K4f's) to :func:`attention_resident_bwd_f32` (K5f);
    another dtype raises ``TypeError`` (:func:`kernels.kernel_dtype`)."""
    dt = kernels.kernel_dtype("attention_resident_bwd", "h", h)
    if dt == torch.float32:
        return attention_resident_bwd_f32(store, rows, h, ws, alpha, g, sga,
                                          n_valid=n_valid,
                                          normalize=normalize)
    if dt == torch.float16:
        return attention_resident_bwd_f16(store, rows, h, ws, alpha, g, sga,
                                          n_valid=n_valid,
                                          normalize=normalize)
    return _launch_bwd(store, rows, h, ws, alpha, g, sga, n_valid, normalize)


attention_resident_bwd.launches = 0
attention_resident_bwd.launches_int8 = 0


def attention_resident_bwd_f16(store: torch.Tensor, rows: torch.Tensor,
                               h: torch.Tensor, ws: torch.Tensor,
                               alpha: torch.Tensor, g: torch.Tensor,
                               sga: torch.Tensor, *, n_valid: int,
                               normalize: bool
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Launch kernel K5h (``csrc/attention_resident_bwd_f16.cu``: K5's body
    with float16 as its element type) on CUDA tensors: as
    :func:`attention_resident_bwd` with a float16 or int8 store and h
    [B, Np, H] float16 (K4h's residual), g and dz * r rounded to float16
    ahead of their products. The same padding and launches as K5; 3
    launches a call, added to ``attention_resident_bwd_f16.launches``
    (float16 rows) or ``attention_resident_bwd_f16.launches_int8`` (int8
    rows)."""
    return _launch_bwd(store, rows, h, ws, alpha, g, sga, n_valid, normalize)


attention_resident_bwd_f16.launches = 0
attention_resident_bwd_f16.launches_int8 = 0


def _launch_bwd(store: torch.Tensor, rows: torch.Tensor, h: torch.Tensor,
                ws: torch.Tensor, alpha: torch.Tensor, g: torch.Tensor,
                sga: torch.Tensor, n_valid: int, normalize: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's checks and launches (K5h's on a float16 ``h``)."""
    dt = h.dtype
    what = kernels.name16("attention_resident_bwd", dt)
    M, Np, C, B = _check_store(store, rows, n_valid, normalize, what,
                               (dt, torch.int8))
    int8 = store.dtype == torch.int8
    H = h.shape[-1]
    dev = store.device
    G = _glimpses(ws, what)
    if C < 1 or H < 1:
        raise ValueError(f"{what} needs C, H >= 1, got C={C}, H={H}")
    per_cell = (B, Np) + ((G,) if ws.dim() == 2 else ())
    kernels.expect("h", h, dt, (B, Np, H), dev)
    kernels.expect("ws", ws, torch.float32, (H,) + per_cell[2:], dev)
    kernels.expect("alpha", alpha, torch.float32, per_cell, dev)
    kernels.expect("g", g, torch.float32, (B, G * C), dev)
    kernels.expect("sga", sga, torch.float32, per_cell, dev)
    if h.data_ptr() % 16:
        raise ValueError(f"{what} reads h in 16-byte vectors: h must start "
                         "16-byte aligned")
    C0, H0 = C, H
    C = kernels.round_up(C0, kernels.ATTENTION_BWD_CHANNELS)
    H = kernels.round_up(H0, kernels.ATTENTION_UNITS)
    kernels.rows_plan(B, n_valid, G, C, H)  # raises where it cannot launch
    ws_shape = ws.shape
    store, rows = resident_pad_store(C, store, rows)
    ws = resident_pad_weights(C, H, None, ws)[1]
    if H != H0:
        h = torch.nn.functional.pad(h, (0, H - H0))
    g = glimpse_channels(g, G, C).contiguous()
    ws_gh = ws.reshape(H, G).t().contiguous()  # [G, H]: one row a glimpse
    K = B * n_valid
    splits = kernels.dwv_plan(K, C, H, kernels.sm_count(dev), int8)["splits"]
    f32 = dict(dtype=torch.float32, device=dev)
    dzr = torch.empty(K, H, dtype=dt, device=dev)
    dws_part = torch.empty(B, G, H, **f32)
    part = torch.empty(splits, C, H, **f32)
    dqh = torch.empty(B, H, **f32)
    dwv = torch.empty(C, H, **f32)
    dws = torch.empty(G, H, **f32)
    lib = _bwd_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.attention_resident_bwd(
            store.data_ptr(), rows.data_ptr(), h.data_ptr(),
            ws_gh.data_ptr(), alpha.data_ptr(), g.data_ptr(), sga.data_ptr(),
            dzr.data_ptr(), dws_part.data_ptr(), part.data_ptr(),
            dqh.data_ptr(), dwv.data_ptr(), dws.data_ptr(), B, Np, n_valid,
            C, H, G, int(normalize), int(int8), splits,
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    counter = (attention_resident_bwd_f16 if dt == torch.float16
               else attention_resident_bwd)
    if int8:
        counter.launches_int8 += launched.value
    else:
        counter.launches += launched.value
    kernels.check(lib, rc, what)
    dws = dws[:, :H0].t().contiguous().reshape(ws_shape)
    if (C, H) != (C0, H0):
        dqh, dwv = dqh[:, :H0].contiguous(), dwv[:C0, :H0].contiguous()
    return dqh, dwv, dws


@functools.lru_cache(maxsize=None)
def _f32_lib(name: str) -> ctypes.CDLL:
    """The library of K4f (``name`` "attention_resident_fwd_f32") or K5f
    ("attention_resident_bwd_f32")."""
    lib = kernels.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd = name == "attention_resident_fwd_f32"
    getattr(lib, name).argtypes = ([p] * 10 + [i] * 12 if fwd
                                   else [p] * 13 + [i] * 13) + [p, p]
    getattr(lib, name).restype = i
    return lib


def f32_bwd_smem(n_valid: int, G: int, C: int) -> int:
    """Bytes of dynamic shared memory of K5f's rows launch: the G
    cotangent rows [G, C], ds [n_valid, G] and r [n_valid], all f32."""
    return 4 * (G * C + (G + 1) * n_valid)


def f32_score_plan(store: torch.Tensor, wv: torch.Tensor) -> dict:
    """``kernels.f32_ring_plan`` of K4f's score launch: the store's rows
    K-major (C channels a cell, in the store's dtype), W_v [C, H] f32."""
    C, H = wv.shape
    es = store.element_size()
    return kernels.f32_ring_plan(es, True, C * es, store.data_ptr(), H * 4,
                                 wv.data_ptr())


def f32_dwv_plan(store: torch.Tensor, dzr: torch.Tensor) -> dict:
    """``kernels.f32_ring_plan`` of K5f's dW_v launch: the store's rows
    MN-major (the cells are k, C channels each), dz * r [K, H] f32."""
    es = store.element_size()
    return kernels.f32_ring_plan(es, False, store.shape[-1] * es,
                                 store.data_ptr(), dzr.shape[-1] * 4,
                                 dzr.data_ptr())


def attention_resident_fwd_f32(store: torch.Tensor, rows: torch.Tensor,
                               qh: torch.Tensor, wv: torch.Tensor,
                               ws: torch.Tensor, *, n_valid: int,
                               normalize: bool, save_h: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          Optional[torch.Tensor]]:
    """Launch kernel K4f (``csrc/attention_resident_fwd_f32.cu``) on CUDA
    tensors: store [M, Np, C] of f32 or f16 rows (widened to f32 on load)
    or int8 codes (normalize off), rows [B] int32 (each < M, which the
    caller guarantees), qh [B, H], wv [C, H] and ws [H, G] (1 <= G <= 8) in
    f32 -> (v_att [B, G*C], alpha [B, Np, G], h [B, Np, H] when ``save_h``
    else None), all f32; a 1-D ws [H] gives v_att [B, C] and alpha [B, Np].
    :func:`attention_resident_fwd_reference`'s math in FFMA with f32 sums;
    any C and H. One call launches, on the current stream, the per-cell
    norm (only when ``normalize``), the score product with its epilogue
    and the softmaxes with the weighted sums, and adds the number launched
    (2, or 3) to ``attention_resident_fwd_f32.launches``."""
    what = "attention_resident_fwd_f32"
    M, Np, C, B = _check_store(store, rows, n_valid, normalize, what,
                               tuple(_F32_ROWS))
    G = _glimpses(ws, what)
    H = qh.shape[-1]
    dev = store.device
    smem = G * Np * 4  # the wsum launch's softmaxes: [Np, G]
    if smem > kernels.SMEM_OPTIN:
        raise ValueError(f"{what}: Np={Np} cells of G={G} glimpses need "
                         f"{smem} B of the softmax's shared memory, over a "
                         f"block's {kernels.SMEM_OPTIN} B")
    kernels.expect("qh", qh, torch.float32, (B, H), dev)
    kernels.expect("wv", wv, torch.float32, (C, H), dev)
    kernels.expect("ws", ws, torch.float32,
                   (H, G) if ws.dim() == 2 else (H,), dev)
    ws_gh = ws.reshape(H, G).t().contiguous()  # [G, H]: one row a glimpse
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty(-(-H // kernels.F32_TILE), G, B * Np, **f32)
    rnorm = torch.empty(B * Np, **f32)
    v_att = torch.empty(B, G * C, **f32)
    alpha = torch.empty(B, Np, G, **f32)
    h = torch.empty(B, Np, H, **f32) if save_h else None
    plan = f32_score_plan(store, wv)
    lib = _f32_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.attention_resident_fwd_f32(
            store.data_ptr(), rows.data_ptr(), wv.data_ptr(), qh.data_ptr(),
            ws_gh.data_ptr(), part.data_ptr(), rnorm.data_ptr(),
            h.data_ptr() if save_h else None, v_att.data_ptr(),
            alpha.data_ptr(), B, Np, n_valid, C, H, G, int(normalize),
            _F32_ROWS[store.dtype], plan["a_width"], plan["b_width"],
            plan["stages"], plan["smem_bytes"],
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    attention_resident_fwd_f32.launches += launched.value
    kernels.check(lib, rc, what)
    return v_att, (alpha if ws.dim() == 2 else alpha[:, :, 0]), h


attention_resident_fwd_f32.launches = 0


def attention_resident_bwd_f32(store: torch.Tensor, rows: torch.Tensor,
                               h: torch.Tensor, ws: torch.Tensor,
                               alpha: torch.Tensor, g: torch.Tensor,
                               sga: torch.Tensor, *, n_valid: int,
                               normalize: bool
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Launch kernel K5f (``csrc/attention_resident_bwd_f32.cu``) on CUDA
    tensors: store and rows as :func:`attention_resident_fwd_f32`'s, h
    [B, Np, H] f32 (K4f's residual), ws [H, G] f32 (1 <= G <= 8), alpha and
    sga [B, Np, G] f32, g [B, G*C] f32 -> (dqh [B, H], dwv [C, H],
    dws [H, G]), all f32; a 1-D ws [H] takes alpha and sga [B, Np] and
    gives dws [H]. :func:`attention_resident_bwd_reference`'s math in FFMA
    with f32 sums; any C and H, the rows launch's shared memory
    (:func:`f32_bwd_smem`) within a block's. One call launches, on the
    current stream, the rows stage (one block a question: dalpha, ds, dz,
    dqh, the question's dws and dz * r), the dW_v product over the
    B * n_valid cells split ``kernels.f32_dwv_splits`` ways, and the
    reduction of the splits and of dws in a fixed order, and adds the number
    launched (3) to ``attention_resident_bwd_f32.launches``."""
    what = "attention_resident_bwd_f32"
    M, Np, C, B = _check_store(store, rows, n_valid, normalize, what,
                               tuple(_F32_ROWS))
    G = _glimpses(ws, what)
    H = h.shape[-1]
    dev = store.device
    smem = f32_bwd_smem(n_valid, G, C)
    if smem > kernels.SMEM_OPTIN:
        raise ValueError(f"{what}: {n_valid} cells of G={G} glimpses at "
                         f"C={C} need {smem} B of shared memory, over a "
                         f"block's {kernels.SMEM_OPTIN} B")
    per_cell = (B, Np) + ((G,) if ws.dim() == 2 else ())
    kernels.expect("h", h, torch.float32, (B, Np, H), dev)
    kernels.expect("ws", ws, torch.float32, (H,) + per_cell[2:], dev)
    kernels.expect("alpha", alpha, torch.float32, per_cell, dev)
    kernels.expect("g", g, torch.float32, (B, G * C), dev)
    kernels.expect("sga", sga, torch.float32, per_cell, dev)
    ws_gh = ws.reshape(H, G).t().contiguous()  # [G, H]: one row a glimpse
    K = B * n_valid
    splits = kernels.f32_dwv_splits(K, C, H, kernels.sm_count(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    dzr = torch.empty(K, H, **f32)
    dws_part = torch.empty(B, G, H, **f32)
    part = torch.empty(splits, C, H, **f32)
    dqh = torch.empty(B, H, **f32)
    dwv = torch.empty(C, H, **f32)
    dws = torch.empty(G, H, **f32)
    plan = f32_dwv_plan(store, dzr)
    lib = _f32_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.attention_resident_bwd_f32(
            store.data_ptr(), rows.data_ptr(), h.data_ptr(),
            ws_gh.data_ptr(), alpha.data_ptr(), g.data_ptr(), sga.data_ptr(),
            dzr.data_ptr(), dws_part.data_ptr(), part.data_ptr(),
            dqh.data_ptr(), dwv.data_ptr(), dws.data_ptr(), B, Np, n_valid,
            C, H, G, int(normalize), _F32_ROWS[store.dtype], splits,
            plan["a_width"], plan["b_width"], plan["stages"],
            plan["smem_bytes"], torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    attention_resident_bwd_f32.launches += launched.value
    kernels.check(lib, rc, what)
    return dqh, dwv, dws.t().contiguous().reshape(ws.shape)


attention_resident_bwd_f32.launches = 0


# ---------------------------------------------------------------------------
# The differentiable op
# ---------------------------------------------------------------------------


class _ResidentAttention(torch.autograd.Function):
    """Forward K4 (saving h only when a gradient is wanted), backward K5.
    The softmax backward's per-question, per-glimpse scalar S_g = g_g .
    v_att_g + alpha_g . ga_g is packed outside the kernel into
    sga = ga - S. An int8 store computes in qh's dtype, and its scale is
    applied here, never in a kernel: folded into wv, to v_att after the
    forward, to g ahead of K5 (its dalpha dots read the codes) and to dwv
    after it; S takes the scaled v_att and the unscaled g. A store whose
    channels were padded at upload (wider than wv's C rows) takes wv with
    zero rows, and v_att and dW_v are cut back to C."""

    @staticmethod
    def forward(ctx, store, rows, qh, wv, ws, n_valid, normalize, save_h,
                scale):
        dt = qh.dtype if store.dtype in _WIDENED else store.dtype
        C, Cs = wv.shape[0], store.shape[2]
        wv_c = (wv * scale if scale != 1.0 else wv).to(dt)
        wv_c = resident_pad_weights(Cs, wv.shape[1], wv_c, ws)[0].contiguous()
        ws_c = ws.to(dt).float().contiguous()
        fwd = (attention_resident_fwd if store.device.type == "cuda"
               else attention_resident_fwd_reference)
        v_att, alpha, h = fwd(store, rows, qh.float().contiguous(), wv_c,
                              ws_c, n_valid=n_valid, normalize=normalize,
                              save_h=save_h)
        v_att = glimpse_channels(v_att, _glimpses(ws, "the op"), C)
        if scale != 1.0:
            v_att = v_att * scale
        if save_h:
            ctx.save_for_backward(store, rows, h, ws_c, alpha, v_att)
        ctx.meta = (n_valid, normalize, scale, qh.dtype, wv.dtype, ws.dtype)
        return v_att, alpha

    @staticmethod
    def backward(ctx, g, ga):
        store, rows, h, ws_c, alpha, v_att = ctx.saved_tensors
        n_valid, normalize, scale, qh_dt, wv_dt, ws_dt = ctx.meta
        g = torch.zeros_like(v_att) if g is None else g.float()
        ga = torch.zeros_like(alpha) if ga is None else ga.float()
        B, G = alpha.shape[0], 1 if ws_c.dim() == 1 else ws_c.shape[1]
        a3, ga3 = alpha.reshape(B, -1, G), ga.reshape(B, -1, G)
        s = ((g.reshape(B, G, -1) * v_att.reshape(B, G, -1)).sum(-1)
             + (a3 * ga3).sum(1))  # [B, G]
        sga = (ga3 - s[:, None, :]).reshape(alpha.shape).contiguous()
        if scale != 1.0:
            g = g * scale
        C = v_att.shape[1] // G
        g = glimpse_channels(g, G, store.shape[2])
        bwd = (attention_resident_bwd if store.device.type == "cuda"
               else attention_resident_bwd_reference)
        dqh, dwv, dws = bwd(store, rows, h, ws_c, alpha, g.contiguous(), sga,
                            n_valid=n_valid, normalize=normalize)
        dwv = dwv[:C]
        if scale != 1.0:
            dwv = dwv * scale
        return (None, None, dqh.to(qh_dt), dwv.to(wv_dt), dws.to(ws_dt),
                None, None, None, None)


def spatial_attention_resident(
    store: torch.Tensor,  # [M, Np, C] resident feature store (padded)
    rows: torch.Tensor,  # [B] int32 store row per question
    qh: torch.Tensor,  # [B, H] projected question
    wv: torch.Tensor,  # [C, H]
    w_score: torch.Tensor,  # [H], or [H, G] for G glimpses
    *,
    n_valid: int,  # true cell count (<= Np; the rest is masked)
    normalize: bool = False,
    store_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather-free attention: (v_att [B, C] f32, alpha [B, n_valid] f32),
    or with a 2-D ``w_score`` [H, G] (1 <= G <= 8, else ``ValueError``) the
    G-glimpse variant, G softmaxes sharing the one v @ Wv product: (v_att
    [B, G*C] f32, concatenated in glimpse order, alpha [B, n_valid, G]
    f32). Differentiable in ``qh``, ``wv`` and ``w_score``, which are
    rounded to the compute dtype inside: the store's, or ``qh``'s for an
    int8 store and for float16 rows. A CUDA store runs kernels K4/K5 in
    bf16 (bf16 rows or int8 codes), K4h/K5h in float16 (f16 rows or int8
    codes) and K4f/K5f in float32 (f32 or f16 rows or int8 codes), a CPU
    store their plain versions. Any C and H: the 16-bit kernels' wrappers
    pad both (``ops/kernels.py``'s multiples), and a store may carry zero
    channels past wv's C rows (padded once at upload,
    :func:`prenormalize_store`'s ``channels``), which are sliced off.

    ``store`` may hold the int8 codes of an L2-prenormalized store
    (:func:`prenormalize_store` with ``quantize="int8"``) with their
    ``store_scale``, which is applied outside the kernels; such a store
    needs ``normalize=False`` (``ValueError`` otherwise).

    Data parallelism needs nothing of the op: each rank runs it on its own
    questions against its store (the whole store, or its row shard under
    ``train.store_sharded`` with ``rows`` local to it), with no collective;
    the trainer's gradient all-reduce sums the ranks' partial dW_v and
    dws, as the transpose of the JAX package's ``shard_map`` does. K4 and
    K5 take any batch of at least one question."""
    int8 = store.dtype == torch.int8
    if not (store.is_floating_point() or int8):
        raise TypeError(f"spatial_attention_resident takes a float or int8 "
                        f"store, got {store.dtype}")
    if int8 and normalize:
        raise ValueError("spatial_attention_resident: an int8 store is "
                         "L2-normalized before it is quantized, so "
                         "normalize must be off")
    _glimpses(w_score, "spatial_attention_resident")
    if store.device.type not in ("cuda", "cpu"):
        raise ValueError(f"spatial_attention_resident: no path for device "
                         f"{store.device}")
    # Save h only when a gradient will be taken. Inside the Function the
    # grad mode reads off and needs_input_grad follows requires_grad alone,
    # so under no_grad (evaluation) it would still ask for h.
    save_h = torch.is_grad_enabled() and any(
        t.requires_grad for t in (qh, wv, w_score))
    v_att, alpha = _ResidentAttention.apply(
        store, rows.to(torch.int32).contiguous(), qh, wv, w_score, n_valid,
        normalize, save_h, float(store_scale))
    # The padded cells are sliced off outside the Function: their
    # cotangent arrives as the zeros that match their zero alpha.
    return v_att, alpha[:, :n_valid]
