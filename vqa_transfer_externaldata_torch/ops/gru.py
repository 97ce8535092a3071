"""GRU question encoder (cuDNN-style gates: the reset gate acts after the
hidden matmul, so ``b_hn`` sits inside ``r * (...)``):

    r  = sigmoid(x W_r + h U_r + b_r)
    z  = sigmoid(x W_z + h U_z + b_z)
    n  = tanh   (x W_n + r * (h U_n + b_hn) + b_n)
    h' = (1 - z) * n + z * h

The input projection ``x @ W_x + b`` is hoisted out of the recurrence and
computed once for all timesteps, time-major; only ``h @ U_h`` and the gates
run per step. Steps at or past a row's length carry the state through
(prefix mask ``t < lens``), so the final state is each row's state at its
true length.

``gru_fused`` runs the recurrence and is differentiable in ``gx_t``, ``uh``
and ``bhn``: on a CUDA tensor its forward launches the hand-written kernel
``csrc/gru_fwd.cu`` (K1, wrapper :func:`gru_fwd`: one persistent launch for
all timesteps) and its backward the BPTT kernel ``csrc/gru_bwd.cu`` (K3,
wrapper :func:`gru_bwd`); on a CPU tensor their plain versions
:func:`gru_reference` and :func:`gru_bwd_reference`. The wrappers dispatch
on U_h's dtype: bf16 takes K1/K3, float16 their float16 instances
``csrc/gru_fwd_f16.cu`` (K1h, :func:`gru_fwd_f16`) and
``csrc/gru_bwd_f16.cu`` (K3h, :func:`gru_bwd_f16`), the same bodies with
float16 in place of bf16, float32 the float32 kernels
``csrc/gru_fwd_f32.cu`` (K1f, :func:`gru_fwd_f32`) and
``csrc/gru_bwd_f32.cu`` (K3f, :func:`gru_bwd_f32`), plain FFMA with f32
sums: the persistent kernels of ``csrc/gru_seq_f32.cuh`` (K1f one
cooperative launch for all timesteps, K3f every step's gh up front, then
one for the chain) where U_h's slices fit in shared memory
(``kernels.gru_f32_route``), else the step forms, bit-equal: K1f one
launch a step of ``csrc/gru_step_f32.cuh``, K3f that of
``csrc/gru_bptt_f32.cuh`` (the lists of each step's live rows, every live
row-step's gh, one fused carry and gate backward a step over the live rows
only, dU_h over the live row-steps, db_hn). ``use_kernels=False`` (the
model's ``model.use_pallas`` off) runs the plain versions on CUDA too, as
the JAX package runs its XLA scan.
The input projection's gradients (dx, dW_x, db) are autograd matmuls.

The 16-bit wrappers take any width, as the Pallas bodies do: H is
zero-padded to the kernels' multiple (16 forward, 64 backward;
:func:`gru_pad`, whose padded units stay exactly 0) and the outputs are
sliced back. Each then takes one of two forms by shape alone
(``kernels.gru_fwd_route`` / ``kernels.gru_bwd_route``): the persistent
kernels where U_h's slices fit in a block's shared memory and the grid can
be resident, the forward up to ``kernels.GRU_FWD_STEP_ABOVE`` units and
the backward up to 576 on an H100, else the step form of
``csrc/gru_wide_step.cuh`` (``csrc/gru_fwd_wide.cu``,
``csrc/gru_bwd_wide.cu`` and their float16 builds; wrappers
:func:`gru_fwd_wide`, :func:`gru_bwd_wide`, :func:`bigru_fwd_wide`,
:func:`bigru_bwd_wide`): ``wgmma`` GEMM tiles with U_h read through L2,
one launch a timestep forward, and backward every step's gh in one GEMM
up front, then one launch a timestep. No form gives way to another or to
a plain version: a launch that fails raises.

:class:`BiGRUEncoder` concatenates a forward and a reverse encoder's final
states. It projects each direction as :class:`GRUEncoder` does and runs both
recurrences through ``bigru_fused``: on a CUDA tensor kernel
``csrc/bigru_fwd.cu`` (K6, wrapper :func:`bigru_fwd`: K1's persistent
kernel, both chains in one launch) advances both chains and
``csrc/bigru_bwd.cu`` (K7, wrapper :func:`bigru_bwd`) walks both BPTTs
(on float16 U_h their float16 instances ``csrc/bigru_fwd_f16.cu`` and
``csrc/bigru_bwd_f16.cu``, K6h and K7h; on float32 U_h,
``csrc/bigru_fwd_f32.cu`` and ``csrc/bigru_bwd_f32.cu``, K6f and K7f: K1f's
persistent kernel and K3f's four launches with both chains in each launch,
the chain on ``blockIdx.z``, routed and planned by ``kernels.gru_f32_route``
/ ``gru_f32_plan`` with two directions (K6f on 128-row b-tiles where a
block would walk two of 64 rows a step); one cooperative launch a chain
where a row of both chains' unit tiles cannot be resident at once, and the
step form, K1f's and K3f's steps with both chains in each launch, past
K1f's and K3f's shared memory; every form bit-equal to two K1f / K3f calls.
``PERF.md`` has their times on an H100 80GB HBM3 at 700 W beside
two K1f / K3f calls);
on a CPU tensor their plain versions
:func:`bigru_reference` and :func:`bigru_bwd_reference`. The JAX package
keeps this fused path behind ``fuse_directions`` (off); its outputs and
gradients equal the two per-direction encoders', and here it is the only
path.

:class:`TFGRUEncoder` is the TF1 ``GRUCell``-exact variant of the
checkpoint-fidelity path (``model.rnn_variant tf``): packed gate and
candidate kernels over ``[x, h]``, the reset gate applied to h before the
candidate matmul. The JAX package runs it as an XLA scan with no Pallas
body, so here it is plain PyTorch on every device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch import nn

from vqa_transfer_externaldata_torch.ops import kernels
from vqa_transfer_externaldata_torch.ops.layers import glorot_uniform_

_TILE = 16  # hidden units per block of the step kernels (csrc/*_step.cuh)


class GRUEncoder(nn.Module):
    """Masked GRU over a time-major [T, B, D] sequence (mask [B, T]);
    returns the final state [B, H] in ``dtype``. Parameters keep the JAX
    package's layout: ``wx`` [D, 3H], ``uh`` [H, 3H], ``b`` [3H],
    ``bhn`` [H]. ``use_pallas`` (``model.use_pallas``) False runs the
    recurrence's plain version on CUDA as well."""

    def __init__(self, in_dim: int, hidden: int = 512, *,
                 dtype: torch.dtype = torch.bfloat16, reverse: bool = False,
                 use_pallas: bool = True,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.reverse = reverse
        self.use_pallas = use_pallas
        H3 = 3 * hidden
        self.wx = nn.Parameter(torch.empty(in_dim, H3))
        self.uh = nn.Parameter(torch.empty(hidden, H3))
        self.b = nn.Parameter(torch.zeros(H3))
        self.bhn = nn.Parameter(torch.zeros(hidden))
        with torch.no_grad():
            glorot_uniform_(self.wx, in_dim, H3, generator)
            glorot_uniform_(self.uh, hidden, H3, generator)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The input projection x@Wx + b of a time-major [T, B, D] x:
        [T, B, 3H] f32, hoisted out of the recurrence."""
        T, B, D = x.shape
        dt = self.dtype
        # f32 accumulation of dt products: the upcast operands are exact
        # copies of the dt values, so this is x@Wx in dt with f32 sums.
        gx = (x.to(dt).float().reshape(T * B, D)
              @ self.wx.to(dt).float()) + self.b
        return gx.reshape(T, B, 3 * self.hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        lens = mask.sum(1).to(torch.int32)
        hT = gru_fused(self.project(x), lens, self.uh.to(self.dtype),
                       self.bhn, reverse=self.reverse,
                       use_kernels=self.use_pallas)
        return hT.to(self.dtype)


class BiGRUEncoder(nn.Module):
    """Bidirectional GRU over a time-major [T, B, D] sequence (mask
    [B, T]): the forward and reverse final states concatenated, [B, 2H] in
    ``dtype``. Parameters sit under ``fwd.*`` and ``bwd.*`` in
    :class:`GRUEncoder`'s layout; each direction is projected by its own
    encoder and both recurrences run through :func:`bigru_fused` (kernels
    K6/K7 on CUDA, their plain versions with ``use_pallas`` False)."""

    def __init__(self, in_dim: int, hidden: int = 512, *,
                 dtype: torch.dtype = torch.bfloat16, use_pallas: bool = True,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.fwd = GRUEncoder(in_dim, hidden, dtype=dtype,
                              generator=generator)
        self.bwd = GRUEncoder(in_dim, hidden, dtype=dtype, reverse=True,
                              generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        f, b, dt = self.fwd, self.bwd, self.dtype
        lens = mask.sum(1).to(torch.int32)
        hTf, hTb = bigru_fused(f.project(x), b.project(x), lens,
                               f.uh.to(dt), b.uh.to(dt), f.bhn, b.bhn,
                               use_kernels=self.use_pallas)
        return torch.cat([hTf, hTb], dim=-1).to(dt)


class TFGRUEncoder(nn.Module):
    """TF1 ``tf.nn.rnn_cell.GRUCell``-exact encoder (``model.rnn_variant
    tf``, the checkpoint-fidelity path) over a batch-major [B, T, D]
    sequence (mask [B, T]); returns the final state [B, H] in ``dtype``:

        r, z = sigmoid([x, h] @ W_g + b_g)          (b_g starts at 1.0)
        c    = tanh([x, r*h] @ W_c + b_c)
        h'   = z*h + (1-z)*c

    Parameters keep the JAX package's names and layout
    (``ops/gru.py::TFGRUEncoder``): ``gates_kernel`` [D+H, 2H],
    ``gates_bias`` [2H], ``candidate_kernel`` [D+H, H], ``candidate_bias``
    [H]. The x-side of both products is hoisted out of the recurrence;
    operands are rounded to ``dtype`` and summed in f32, the state stays
    f32, and a padded step carries the state through. Plain PyTorch on
    every device (the JAX package runs it as an XLA scan), with no host
    synchronization, so a CUDA graph can capture it."""

    def __init__(self, in_dim: int, hidden: int = 512, *,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        DH = in_dim + hidden
        self.gates_kernel = nn.Parameter(torch.empty(DH, 2 * hidden))
        self.gates_bias = nn.Parameter(torch.ones(2 * hidden))
        self.candidate_kernel = nn.Parameter(torch.empty(DH, hidden))
        self.candidate_bias = nn.Parameter(torch.zeros(hidden))
        with torch.no_grad():
            glorot_uniform_(self.gates_kernel, DH, 2 * hidden, generator)
            glorot_uniform_(self.candidate_kernel, DH, hidden, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        H, dt = self.hidden, self.dtype
        # Products of dt values as f32 matmuls of exact upcast copies: dt
        # products with f32 sums, as ``preferred_element_type=float32``.
        wg = self.gates_kernel.to(dt).float()
        wc = self.candidate_kernel.to(dt).float()
        xd = x.to(dt).float().reshape(B * T, D)
        gx = (xd @ wg[:D] + self.gates_bias).reshape(B, T, 2 * H)
        cx = (xd @ wc[:D] + self.candidate_bias).reshape(B, T, H)
        wg_h, wc_h = wg[D:], wc[D:]
        m_seq = mask.float()
        h = x.new_zeros(B, H, dtype=torch.float32)
        for t in range(T):
            gates = gx[:, t] + h.to(dt).float() @ wg_h
            r = torch.sigmoid(gates[:, :H])
            z = torch.sigmoid(gates[:, H:])
            c = torch.tanh(cx[:, t] + (r * h).to(dt).float() @ wc_h)
            h_new = z * h + (1.0 - z) * c
            m = m_seq[:, t, None]
            h = m * h_new + (1.0 - m) * h
        return h.to(dt)


def gru_fused(gx_t: torch.Tensor, lens: torch.Tensor, uh: torch.Tensor,
              bhn: torch.Tensor, *, reverse: bool = False,
              use_kernels: bool = True) -> torch.Tensor:
    """Fused recurrence: gx_t [T, B, 3H] f32 (= x@Wx + b, time-major),
    lens [B] int32, uh [H, 3H], bhn [H] f32 -> final state [B, H] f32,
    differentiable in gx_t, uh and bhn. A CUDA tensor runs the kernels
    (K1/K3 on bf16 ``uh``, K1h/K3h on float16, K1f/K3f on float32), a CPU
    tensor the plain versions, and so does a CUDA tensor with
    ``use_kernels`` False."""
    if gx_t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"gru_fused: no path for device {gx_t.device}")
    return _GRUFused.apply(gx_t.contiguous(), lens.to(torch.int32),
                           uh.contiguous(), bhn.contiguous(), reverse,
                           use_kernels and gx_t.device.type == "cuda")


class _GRUFused(torch.autograd.Function):
    """The recurrence with its BPTT as the backward (JAX's ``custom_vjp``
    of ``gru_fused``): the residuals are the forward's inputs and the state
    sequence ``hseq`` that K1 writes anyway."""

    @staticmethod
    def forward(ctx, gx_t, lens, uh, bhn, reverse, kernel):
        fwd = gru_fwd if kernel else gru_reference
        hT, hseq = fwd(gx_t, lens, uh, bhn, reverse=reverse)
        ctx.save_for_backward(gx_t, hseq, lens, uh, bhn)
        ctx.reverse, ctx.kernel = reverse, kernel
        return hT

    @staticmethod
    def backward(ctx, ghT):
        gx_t, hseq, lens, uh, bhn = ctx.saved_tensors
        bwd = gru_bwd if ctx.kernel else gru_bwd_reference
        dgx, duh, dbhn = bwd(gx_t, hseq, lens, uh, bhn,
                             ghT.float().contiguous(), reverse=ctx.reverse)
        # uh arrives in the compute dtype: its cotangent is rounded to it,
        # as JAX's ``duh.astype(uh.dtype)``.
        return dgx, None, duh.to(uh.dtype), dbhn.to(bhn.dtype), None, None


def gru_reference(gx_t: torch.Tensor, lens: torch.Tensor, uh: torch.Tensor,
                  bhn: torch.Tensor, *, reverse: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, step by step:
    -> (hT [B, H] f32, hseq [T, B, H] f32), hseq[t] being the state after
    actual timestep t. ``h`` is rounded to ``uh.dtype`` before the hidden
    matmul, whose sums run in f32."""
    T, B, H3 = gx_t.shape
    H = H3 // 3
    uf = uh.float()
    h = gx_t.new_zeros(B, H)
    hseq = gx_t.new_empty(T, B, H)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gx = gx_t[t]
        gh = h.to(uh.dtype).float() @ uf
        r = torch.sigmoid(gx[:, :H] + gh[:, :H])
        z = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gx[:, 2 * H:] + r * (gh[:, 2 * H:] + bhn))
        h_new = (1.0 - z) * n + z * h
        h = torch.where((t < lens)[:, None], h_new, h)
        hseq[t] = h
    return h, hseq


def gru_bwd_reference(gx_t: torch.Tensor, hseq: torch.Tensor,
                      lens: torch.Tensor, uh: torch.Tensor, bhn: torch.Tensor,
                      ghT: torch.Tensor, *, reverse: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel K3, the BPTT of
    :func:`gru_reference`, step by step as JAX's ``_gru_cell_bwd``:
    -> (dgx_t [T, B, 3H], duh [H, 3H], dbhn [H]), all f32. The gates are
    recomputed from gx_t and the pre-step state; h_prev and the gate
    cotangents are rounded to ``uh.dtype`` ahead of their products, whose
    sums run in f32."""
    T, B, H3 = gx_t.shape
    H = H3 // 3
    dt = uh.dtype
    uf = uh.float()
    dh = ghT.float()
    dgx = gx_t.new_empty(T, B, H3)
    duh = gx_t.new_zeros(H, H3)
    dbhn = gx_t.new_zeros(H)
    zero = gx_t.new_zeros(B, H)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        first = t == (T - 1 if reverse else 0)
        h_prev = zero if first else hseq[t + 1 if reverse else t - 1]
        gx = gx_t[t]
        gh = h_prev.to(dt).float() @ uf
        ghn_b = gh[:, 2 * H:] + bhn
        r = torch.sigmoid(gx[:, :H] + gh[:, :H])
        z = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gx[:, 2 * H:] + r * ghn_b)
        m = (t < lens)[:, None].float()
        dh_new = m * dh
        dh_prev = (1.0 - m) * dh + dh_new * z
        dz = dh_new * (h_prev - n)
        dn = dh_new * (1.0 - z)
        da_n = dn * (1.0 - n * n)
        dgh_n = da_n * r
        da_r = da_n * ghn_b * r * (1.0 - r)
        da_z = dz * z * (1.0 - z)
        dgx[t] = torch.cat([da_r, da_z, da_n], dim=1)
        hp = h_prev.to(dt).float()
        for g, (lo, hi) in zip((da_r, da_z, dgh_n),
                               ((0, H), (H, 2 * H), (2 * H, H3))):
            gq = g.to(dt).float()
            dh_prev = dh_prev + gq @ uf[:, lo:hi].t()
            duh[:, lo:hi] += hp.t() @ gq
        dbhn += dgh_n.sum(0)
        dh = dh_prev
    return dgx, duh, dbhn


def _pad_gates(x: torch.Tensor, H: int, Hp: int) -> torch.Tensor:
    """x [..., 3H] -> [..., 3Hp]: each gate block (r, z, n) zero-padded
    from H to Hp columns."""
    lead = x.shape[:-1]
    out = x.new_zeros(*lead, 3, Hp)
    out[..., :H] = x.reshape(*lead, 3, H)
    return out.reshape(*lead, 3 * Hp)


def _unpad_gates(x: torch.Tensor, H: int) -> torch.Tensor:
    """x [..., 3Hp] -> [..., 3H]: the first H columns of each gate block,
    contiguous."""
    lead = x.shape[:-1]
    Hp = x.shape[-1] // 3
    return x.reshape(*lead, 3, Hp)[..., :H].reshape(*lead, 3 * H)


def gru_pad(Hp: int, gx_t: torch.Tensor, uh: torch.Tensor,
            bhn: torch.Tensor, hseq: Optional[torch.Tensor] = None,
            ghT: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The recurrence's inputs at width H zero-padded to ``Hp`` >= H units,
    as the 16-bit kernels take them (H a multiple of 16 for K1/K6, of 64
    for K3/K7), the way JAX's B6 pads its hidden axis: gx_t [T, B, 3H] ->
    [T, B, 3Hp] and U_h [H, 3H] -> [Hp, 3Hp] with zeros in each gate
    block's new columns, U_h with zero rows too; b_hn, hseq and ghT get
    zero units. Returns (gx_t, uh, bhn, hseq, ghT), the last two None
    where not given; the inputs themselves where Hp == H.

    A padded unit starts at 0 and stays exactly 0: its gx and gh are 0, so
    r = z = 1/2 and n = tanh(0 + r (0 + 0)) = 0, and h' = n/2 + h/2 = 0.
    It adds only exact zeros to the real units' sums (its U_h row meets a
    zero state, its U_h columns are zero) and to their cotangents: its
    cotangent starts at 0, so its gate cotangents, its share of dU_h and
    db_hn and its carry through U_h^T are all 0. :func:`gru_unpad_fwd` and
    :func:`gru_unpad_bwd` slice the outputs back to H."""
    H = uh.shape[0]
    if Hp == H:
        return gx_t, uh, bhn, hseq, ghT
    if Hp < H:
        raise ValueError(f"gru_pad: Hp={Hp} is narrower than H={H}")
    grow = (0, Hp - H)
    uh_p = _pad_gates(torch.nn.functional.pad(uh, (0, 0) + grow), H, Hp)
    return (_pad_gates(gx_t, H, Hp), uh_p,
            torch.nn.functional.pad(bhn, grow),
            None if hseq is None else torch.nn.functional.pad(hseq, grow),
            None if ghT is None else torch.nn.functional.pad(ghT, grow))


def gru_unpad_fwd(H: int, hT: torch.Tensor, hseq: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's outputs at Hp sliced back to H units: (hT [B, H],
    hseq [T, B, H]), contiguous (as they are where Hp == H)."""
    if hT.shape[-1] == H:
        return hT, hseq
    return hT[:, :H].contiguous(), hseq[..., :H].contiguous()


def gru_unpad_bwd(H: int, dgx: torch.Tensor, duh: torch.Tensor,
                  dbhn: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The BPTT's outputs at Hp sliced back to H units: (dgx [T, B, 3H],
    duh [H, 3H], dbhn [H]), each gate block's first H columns."""
    if dbhn.shape[-1] == H:
        return dgx, duh, dbhn
    return (_unpad_gates(dgx, H), _unpad_gates(duh[:H], H),
            dbhn[:H].contiguous())


def _dtype16(what: str, name: str, x: torch.Tensor) -> torch.dtype:
    """The 16-bit dtype of ``x`` for a step-form wrapper: bf16 or float16;
    float32 (whose kernels K1f/K3f have a step form of their own, in
    ``csrc/gru_step_f32.cuh``) and every other dtype raise
    ``TypeError``."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"{what}: {name} must be torch.bfloat16 or "
                        f"torch.float16, got {x.dtype}")
    return x.dtype


@functools.lru_cache(maxsize=None)
def _wide_lib(name: str) -> ctypes.CDLL:
    """The library of the step form: "gru_fwd_wide" (K1's and K6's,
    exporting ``gru_fwd_wide`` and ``bigru_fwd_wide``), "gru_bwd_wide"
    (K3's and K7's, ``gru_bwd_wide`` and ``bigru_bwd_wide``), or their
    float16 builds ("..._f16")."""
    lib = kernels.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name.startswith("gru_fwd_wide"):
        entries = {"gru_fwd_wide": (7, 4), "bigru_fwd_wide": (10, 3)}
    else:
        entries = {"gru_bwd_wide": (12, 4), "bigru_bwd_wide": (16, 3)}
        lib.gru_bwd_wide_clusters.argtypes = [i, i, i, p]
        lib.gru_bwd_wide_clusters.restype = i
    for entry, (pointers, ints) in entries.items():
        getattr(lib, entry).argtypes = [p] * pointers + [i] * ints + [p, p]
        getattr(lib, entry).restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _lib(name: str = "gru_fwd") -> ctypes.CDLL:
    """The library of K1 (``name`` "gru_fwd") or K1h ("gru_fwd_f16"); both
    export ``gru_fwd`` and ``gru_fwd_config``."""
    lib = kernels.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gru_fwd.argtypes = [p] * 7 + [i] * 5 + [p, p]
    lib.gru_fwd.restype = i
    lib.gru_fwd_config.argtypes = [i, i, i, p, p, p, p]
    lib.gru_fwd_config.restype = i
    return lib


def _fwd_config(kernel: str, B: int, H: int, rows: int,
                device: torch.device) -> dict:
    """The C side's launch of K1 (``kernel`` "gru_fwd"), K1h
    ("gru_fwd_f16"), K6 ("bigru_fwd") or K6h ("bigru_fwd_f16") at batch
    ``B`` and width ``H`` with
    ``rows`` batch rows a block on CUDA ``device``: its grid (j-tiles, rows
    of blocks, directions a launch; [0, 0, 0] where not even one
    direction's row of j-tiles can be resident at once), the launches a
    call takes, blocks resident per SM (0 where the block's shared memory
    does not fit) and dynamic shared memory in bytes."""
    bigru = kernel.startswith("bigru_fwd")
    lib = _bigru_lib(kernel) if bigru else _lib(kernel)
    grid = (ctypes.c_int * 3)()
    launches, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    smem = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        rc = (lib.bigru_fwd_config if bigru else lib.gru_fwd_config)(
            B, H, rows, ctypes.addressof(grid), ctypes.addressof(launches),
            ctypes.addressof(per_sm), ctypes.addressof(smem))
    kernels.check(lib, rc, kernel)
    return {"grid": list(grid), "launches": launches.value,
            "blocks_per_sm": per_sm.value, "smem_bytes": smem.value}


@functools.lru_cache(maxsize=None)
def _fwd_blocks_per_sm(kernel: str, index: int, H: int) -> dict:
    """K1's, K1h's, K6's or K6h's blocks resident per SM of card ``index`` at
    width ``H``, by the batch rows of each of its tilings
    (``kernels.GRU_FWD_ROWS``), from its own library's instance."""
    dev = torch.device("cuda", index)
    return {rows: _fwd_config(kernel, 1, H, rows, dev)["blocks_per_sm"]
            for rows in kernels.GRU_FWD_ROWS}


def _fwd_plan(kernel: str, B: int, H: int, device: torch.device
              ) -> Tuple[dict, dict]:
    """``kernels.gru_fwd_plan`` for K1 or K1h (one direction) or K6 or K6h
    (two) at (B, H) on CUDA ``device``, and the blocks per SM it was
    given."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    per_sm = _fwd_blocks_per_sm(kernel, index, H)
    plan = kernels.gru_fwd_plan(B, H, kernels.sm_count(device), per_sm,
                                2 if kernel.startswith("bigru") else 1)
    return plan, per_sm


def _fwd_route(kernel: str, B: int, H: int, device: torch.device) -> str:
    """``kernels.gru_fwd_route`` for K1 or K1h (one direction) or K6 or
    K6h (two) at (B, H) on CUDA ``device``, from the persistent kernel's
    blocks per SM that its own library reports."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return kernels.gru_fwd_route(B, H, kernels.sm_count(device),
                                 _fwd_blocks_per_sm(kernel, index, H),
                                 2 if kernel.startswith("bigru") else 1)


def _fwd_launch_config(kernel: str, B: int, H: int,
                       device: torch.device) -> dict:
    plan, per_sm = _fwd_plan(kernel, B, H, device)
    cfg = _fwd_config(kernel, B, H, plan["rows"], device)
    return {"rows": plan["rows"], "b_tiles": plan["b_tiles"], **cfg,
            "per_sm_by_rows": dict(per_sm)}


def gru_fwd(gx_t: torch.Tensor, lens: torch.Tensor, uh: torch.Tensor,
            bhn: torch.Tensor, *, reverse: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel K1 (``csrc/gru_fwd.cu``) on CUDA tensors:
    gx_t [T, B, 3H] f32, lens [B] int32, uh [H, 3H] bf16, bhn [H] f32
    -> (hT [B, H] f32, hseq [T, B, H] f32); a float16 ``uh`` goes to
    :func:`gru_fwd_f16` (K1h), a float32 one to :func:`gru_fwd_f32` (K1f),
    another dtype raises ``TypeError`` (:func:`kernels.kernel_dtype`).
    Any H >= 1: H is zero-padded to a multiple of 16 (:func:`gru_pad`, the
    outputs sliced back). Up to ``kernels.GRU_FWD_STEP_ABOVE`` units, where
    a block's U_h slice and 16-row b-tile fit in shared memory and a row of
    the j-tiles can be resident at once (``kernels.gru_fwd_route``), one
    call makes one cooperative launch of the persistent kernel for all T
    steps, with the batch rows a block of ``kernels.gru_fwd_plan``, on the
    current stream and adds it (1) to ``gru_fwd.launches``; elsewhere it
    runs the step form, :func:`gru_fwd_wide` (T launches, counted there).
    A launch that fails raises."""
    dt = kernels.kernel_dtype("gru_fwd", "uh", uh)
    if dt == torch.float32:
        return gru_fwd_f32(gx_t, lens, uh, bhn, reverse=reverse)
    if dt == torch.float16:
        return gru_fwd_f16(gx_t, lens, uh, bhn, reverse=reverse)
    return _gru_fwd16(gx_t, lens, uh, bhn, reverse, torch.bfloat16)


gru_fwd.launches = 0


def gru_fwd_f16(gx_t: torch.Tensor, lens: torch.Tensor, uh: torch.Tensor,
                bhn: torch.Tensor, *, reverse: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel K1h (``csrc/gru_fwd_f16.cu``: K1's body with float16
    as its element type) on CUDA tensors: as :func:`gru_fwd` with uh
    [H, 3H] float16, the state rounded to float16 ahead of each step's
    product and exchanged as a float16 copy. The same padding, route and
    launch plan as K1; the persistent launch (one a call) is added to
    ``gru_fwd_f16.launches``, the step form's to
    ``gru_fwd_wide_f16.launches``."""
    return _gru_fwd16(gx_t, lens, uh, bhn, reverse, torch.float16)


gru_fwd_f16.launches = 0


def _gru_fwd16(gx_t: torch.Tensor, lens: torch.Tensor, uh: torch.Tensor,
               bhn: torch.Tensor, reverse: bool, dtype: torch.dtype,
               form: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's (``dtype`` bf16) or K1h's (float16) checks, padding, route and
    launch: ``form`` "persistent" or "step", or None for
    ``kernels.gru_fwd_route``'s choice."""
    what = kernels.name16("gru_fwd", dtype)
    if gx_t.device.type != "cuda" or gx_t.dim() != 3:
        raise ValueError(f"{what} takes a 3-D CUDA gx_t")
    T, B, H3 = gx_t.shape
    H = H3 // 3
    dev = gx_t.device
    if T < 1 or B < 1 or H < 1 or H3 != 3 * H:
        raise ValueError(f"{what} needs T, B, H >= 1, got gx_t of shape "
                         f"{tuple(gx_t.shape)}")
    kernels.expect("gx_t", gx_t, torch.float32, (T, B, 3 * H), dev)
    kernels.expect("lens", lens, torch.int32, (B,), dev)
    kernels.expect("uh", uh, dtype, (H, 3 * H), dev)
    kernels.expect("bhn", bhn, torch.float32, (H,), dev)
    Hp = kernels.round_up(H, kernels.GRU_FWD_PAD)
    gx_p, uh_p, bhn_p, _, _ = gru_pad(Hp, gx_t, uh, bhn)
    if (form or _fwd_route(what, B, Hp, dev)) == "persistent":
        plan, _ = _fwd_plan(what, B, Hp, dev)
        hT, hseq = _launch_fwd(gx_p, lens, uh_p, bhn_p, reverse,
                               plan["rows"])
    else:
        hT, hseq = _launch_fwd_wide(gx_p, lens, uh_p, bhn_p, reverse)
    return gru_unpad_fwd(H, hT, hseq)


def _launch_fwd(gx_t: torch.Tensor, lens: torch.Tensor, uh: torch.Tensor,
                bhn: torch.Tensor, reverse: bool, rows: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's launch (K1h's on a float16 ``uh``) with ``rows`` batch rows a
    block on inputs that :func:`gru_fwd` has checked (chip_smoke.py also
    times the tiling that the plan does not take through it)."""
    T, B, H3 = gx_t.shape
    H = H3 // 3
    dev = gx_t.device
    hseq = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    hT = torch.empty(B, H, dtype=torch.float32, device=dev)
    hbf = torch.empty(2, B, H, dtype=uh.dtype, device=dev)
    lib = _lib(kernels.name16("gru_fwd", uh.dtype))
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.gru_fwd(gx_t.data_ptr(), lens.data_ptr(), uh.data_ptr(),
                         bhn.data_ptr(), hseq.data_ptr(), hT.data_ptr(),
                         hbf.data_ptr(), T, B, H, int(reverse), rows,
                         torch.cuda.current_stream(dev).cuda_stream,
                         ctypes.addressof(launched))
    (gru_fwd_f16 if uh.dtype == torch.float16 else gru_fwd).launches += (
        launched.value)
    kernels.check(lib, rc, "gru_fwd")
    return hT, hseq


def _launch_fwd_wide(gx_t: torch.Tensor, lens: torch.Tensor,
                     uh: torch.Tensor, bhn: torch.Tensor, reverse: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step form's T launches (``csrc/gru_fwd_wide.cu``, its float16
    build on a float16 ``uh``) on checked inputs at a width H % 16 == 0,
    added to ``gru_fwd_wide.launches`` (``gru_fwd_wide_f16.launches``)."""
    T, B, H3 = gx_t.shape
    H = H3 // 3
    dev = gx_t.device
    hseq = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    hT = torch.empty(B, H, dtype=torch.float32, device=dev)
    hbf = torch.empty(2, B, H, dtype=uh.dtype, device=dev)
    what = kernels.name16("gru_fwd_wide", uh.dtype)
    lib = _wide_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.gru_fwd_wide(gx_t.data_ptr(), lens.data_ptr(),
                              uh.data_ptr(), bhn.data_ptr(), hseq.data_ptr(),
                              hT.data_ptr(), hbf.data_ptr(), T, B, H,
                              int(reverse),
                              torch.cuda.current_stream(dev).cuda_stream,
                              ctypes.addressof(launched))
    (gru_fwd_wide_f16 if uh.dtype == torch.float16
     else gru_fwd_wide).launches += launched.value
    kernels.check(lib, rc, what)
    return hT, hseq


def gru_fwd_wide(gx_t: torch.Tensor, lens: torch.Tensor, uh: torch.Tensor,
                 bhn: torch.Tensor, *, reverse: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's step form (``csrc/gru_fwd_wide.cu``) on CUDA tensors, what
    :func:`gru_fwd` runs where the persistent kernel cannot
    (``kernels.gru_fwd_route``), at any width: the inputs and outputs of
    :func:`gru_fwd` with a bf16 ``uh`` (a float16 one goes to
    :func:`gru_fwd_wide_f16`; another dtype raises ``TypeError``), H
    zero-padded to a multiple of 16. One launch a step, each advancing all
    rows (``kernels.gru_step_plan``): T launches a call on the current
    stream, added to ``gru_fwd_wide.launches``."""
    if _dtype16("gru_fwd_wide", "uh", uh) == torch.float16:
        return gru_fwd_wide_f16(gx_t, lens, uh, bhn, reverse=reverse)
    return _gru_fwd16(gx_t, lens, uh, bhn, reverse, torch.bfloat16, "step")


gru_fwd_wide.launches = 0


def gru_fwd_wide_f16(gx_t: torch.Tensor, lens: torch.Tensor,
                     uh: torch.Tensor, bhn: torch.Tensor, *,
                     reverse: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1h's step form (``csrc/gru_fwd_wide_f16.cu``: the step form's body
    with float16 as its element type): as :func:`gru_fwd_wide` with uh
    [H, 3H] float16; T launches a call, added to
    ``gru_fwd_wide_f16.launches``."""
    return _gru_fwd16(gx_t, lens, uh, bhn, reverse, torch.float16, "step")


gru_fwd_wide_f16.launches = 0


def gru_fwd_launch_config(B: int, H: int, device: torch.device,
                          dtype: torch.dtype = torch.bfloat16) -> dict:
    """The shape of K1's persistent launch (K1h's with ``dtype`` float16)
    at batch ``B`` and width ``H`` on CUDA ``device``: the batch ``rows`` a
    block and the b-tiles that the plan takes, the C side's grid (j-tiles,
    rows of blocks, 1) and launches (1), blocks resident per SM and
    dynamic shared memory in bytes at those rows, and the blocks per SM of
    every tiling that the plan was given (``per_sm_by_rows``). ``H`` is a
    multiple of 16. Raises where the persistent kernel cannot run
    (:func:`gru_fwd` takes the step form there)."""
    return _fwd_launch_config(kernels.name16("gru_fwd", dtype), B, H, device)


@functools.lru_cache(maxsize=None)
def _bwd_lib(name: str = "gru_bwd") -> ctypes.CDLL:
    """The library of K3 (``name`` "gru_bwd") or K3h ("gru_bwd_f16"); both
    export ``gru_bwd`` and ``gru_bwd_config``."""
    lib = kernels.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gru_bwd.argtypes = [p] * 12 + [i] * 5 + [p, p]
    lib.gru_bwd.restype = i
    lib.gru_bwd_config.argtypes = [i, p, p, p]
    lib.gru_bwd_config.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _bptt_occupancy(kernel: str, index: int, H: int) -> dict:
    """The persistent BPTT step kernel of K3 (``kernel`` "gru_bwd"), K3h
    ("gru_bwd_f16"), K7 ("bigru_bwd") or K7h ("bigru_bwd_f16") at width
    ``H`` on card ``index``, as the C side reports it: blocks resident per
    SM (0 where a block's shared memory does not fit), dynamic shared
    memory in bytes and the widest H that fits."""
    bigru = kernel.startswith("bigru_bwd")
    lib = _bigru_bwd_lib(kernel) if bigru else _bwd_lib(kernel)
    per_sm, max_width = ctypes.c_int(0), ctypes.c_int(0)
    smem = ctypes.c_longlong(0)
    with torch.cuda.device(index):
        rc = (lib.bigru_bwd_config if bigru else lib.gru_bwd_config)(
            H, ctypes.addressof(per_sm), ctypes.addressof(smem),
            ctypes.addressof(max_width))
    kernels.check(lib, rc, kernel)
    return {"blocks_per_sm": per_sm.value, "smem_bytes": smem.value,
            "max_width": max_width.value}


def _bptt_plan(kernel: str, B: int, H: int, device: torch.device,
               directions: int) -> dict:
    """``kernels.gru_bwd_plan`` for K3, K3h, K7 or K7h at (B, H) on CUDA
    ``device``, with the C side's occupancy beside it. Raises where U_h's
    slices do not fit in a block's shared memory, naming the widest H that
    does."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    occ = _bptt_occupancy(kernel, index, H)
    if occ["blocks_per_sm"] < 1:
        raise RuntimeError(
            f"{kernel}: U_h's slices and the step's ring take "
            f"{occ['smem_bytes']} bytes of shared memory a block at H={H}, "
            f"more than a block may have on this card; it takes "
            f"H <= {occ['max_width']}")
    plan = kernels.gru_bwd_plan(B, H, kernels.sm_count(device),
                                occ["blocks_per_sm"], directions)
    return {**plan, **occ}


def _bwd_route(kernel: str, B: int, H: int, device: torch.device,
               directions: int) -> str:
    """``kernels.gru_bwd_route`` for K3, K3h, K7 or K7h at (B, H) on CUDA
    ``device``, from the persistent step kernel's blocks per SM that its
    own library reports."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    occ = _bptt_occupancy(kernel, index, H)
    return kernels.gru_bwd_route(B, H, kernels.sm_count(device),
                                 occ["blocks_per_sm"], directions)


def gru_bwd(gx_t: torch.Tensor, hseq: torch.Tensor, lens: torch.Tensor,
            uh: torch.Tensor, bhn: torch.Tensor, ghT: torch.Tensor, *,
            reverse: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel K3 (``csrc/gru_bwd.cu``) on CUDA tensors: gx_t
    [T, B, 3H] f32, hseq [T, B, H] f32 (K1's residual), lens [B] int32,
    uh [H, 3H] bf16, bhn [H] f32, ghT [B, H] f32 -> (dgx_t [T, B, 3H],
    duh [H, 3H], dbhn [H]), all f32; a float16 ``uh`` goes to
    :func:`gru_bwd_f16` (K3h), a float32 one to :func:`gru_bwd_f32` (K3f),
    another dtype raises ``TypeError`` (:func:`kernels.kernel_dtype`).
    Any H >= 1: H is zero-padded to a multiple of 64 (16 for the step
    form; :func:`gru_pad`, the outputs sliced back). Where U_h's slices fit
    in a block's shared
    memory and a row of the j-tiles can be resident at once
    (``kernels.gru_bwd_route``: up to H = 576 on an H100), one call
    launches the persistent step kernel (one cooperative launch for all T
    steps, on the grid of ``kernels.gru_bwd_plan``), the dU_h GEMM and the
    db_hn sum on the current stream and adds the number launched (3) to
    ``gru_bwd.launches``; elsewhere it runs the step form,
    :func:`gru_bwd_wide` (T + 4 launches, counted there). A launch that
    fails raises."""
    dt = kernels.kernel_dtype("gru_bwd", "uh", uh)
    if dt == torch.float32:
        return gru_bwd_f32(gx_t, hseq, lens, uh, bhn, ghT, reverse=reverse)
    if dt == torch.float16:
        return gru_bwd_f16(gx_t, hseq, lens, uh, bhn, ghT, reverse=reverse)
    return _gru_bwd16(gx_t, hseq, lens, uh, bhn, ghT, reverse,
                      torch.bfloat16)


gru_bwd.launches = 0


def gru_bwd_f16(gx_t: torch.Tensor, hseq: torch.Tensor, lens: torch.Tensor,
                uh: torch.Tensor, bhn: torch.Tensor, ghT: torch.Tensor, *,
                reverse: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel K3h (``csrc/gru_bwd_f16.cu``: K3's body with float16
    as its element type) on CUDA tensors: as :func:`gru_bwd` with uh
    [H, 3H] float16, h_prev and the gate cotangents rounded to float16
    ahead of the U_h^T product and dU_h. The same padding, route and
    launches as K3; the persistent form's 3 launches a call are added to
    ``gru_bwd_f16.launches``, the step form's to
    ``gru_bwd_wide_f16.launches``."""
    return _gru_bwd16(gx_t, hseq, lens, uh, bhn, ghT, reverse,
                      torch.float16)


gru_bwd_f16.launches = 0


def _gru_bwd16(gx_t: torch.Tensor, hseq: torch.Tensor, lens: torch.Tensor,
               uh: torch.Tensor, bhn: torch.Tensor, ghT: torch.Tensor,
               reverse: bool, dtype: torch.dtype, form: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's (``dtype`` bf16) or K3h's (float16) checks, padding, route and
    launches: ``form`` "persistent" or "step", or None for
    ``kernels.gru_bwd_route``'s choice."""
    what = kernels.name16("gru_bwd", dtype)
    if gx_t.device.type != "cuda" or gx_t.dim() != 3:
        raise ValueError(f"{what} takes a 3-D CUDA gx_t")
    T, B, H3 = gx_t.shape
    H = H3 // 3
    dev = gx_t.device
    if T < 1 or B < 1 or H < 1 or H3 != 3 * H:
        raise ValueError(f"{what} needs T, B, H >= 1, got gx_t of shape "
                         f"{tuple(gx_t.shape)}")
    kernels.expect("gx_t", gx_t, torch.float32, (T, B, 3 * H), dev)
    kernels.expect("hseq", hseq, torch.float32, (T, B, H), dev)
    kernels.expect("lens", lens, torch.int32, (B,), dev)
    kernels.expect("uh", uh, dtype, (H, 3 * H), dev)
    kernels.expect("bhn", bhn, torch.float32, (H,), dev)
    kernels.expect("ghT", ghT, torch.float32, (B, H), dev)
    Hp = kernels.round_up(H, kernels.GRU_BWD_PAD)
    form = form or _bwd_route(what, B, Hp, dev, 1)
    if form == "step":
        Hp = kernels.round_up(H, kernels.GRU_STEP_PAD)
    padded = gru_pad(Hp, gx_t, uh, bhn, hseq, ghT)
    if form == "persistent":
        out = _launch_bwd(*padded, lens, reverse)
    else:
        out = _launch_bwd_wide(*padded, lens, reverse)
    return gru_unpad_bwd(H, *out)


def _launch_bwd(gx_t: torch.Tensor, uh: torch.Tensor, bhn: torch.Tensor,
                hseq: torch.Tensor, ghT: torch.Tensor, lens: torch.Tensor,
                reverse: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's persistent launches (K3h's on a float16 ``uh``) on checked
    inputs at a width H % 64 == 0, on the grid of ``kernels.gru_bwd_plan``
    (which raises where the step kernel cannot be resident)."""
    T, B, H3 = gx_t.shape
    H = H3 // 3
    dev = gx_t.device
    dtype = uh.dtype
    what = kernels.name16("gru_bwd", dtype)
    plan = _bptt_plan(what, B, H, dev, 1)
    f32 = dict(dtype=torch.float32, device=dev)
    dhe = ghT.clone()  # the carried cotangent, overwritten step by step
    g = torch.empty(T, B, 3 * H, dtype=dtype, device=dev)
    part = torch.empty(T, -(-B // _TILE), H, **f32)
    dgx = torch.empty(T, B, 3 * H, **f32)
    duh = torch.empty(H, 3 * H, **f32)
    dbhn = torch.empty(H, **f32)
    hbf = torch.empty(T, B, H, dtype=dtype, device=dev)
    lib = _bwd_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.gru_bwd(gx_t.data_ptr(), hseq.data_ptr(), lens.data_ptr(),
                         uh.data_ptr(), bhn.data_ptr(), dhe.data_ptr(),
                         dgx.data_ptr(), g.data_ptr(), part.data_ptr(),
                         duh.data_ptr(), dbhn.data_ptr(), hbf.data_ptr(),
                         T, B, H, int(reverse), plan["grid"][1],
                         torch.cuda.current_stream(dev).cuda_stream,
                         ctypes.addressof(launched))
    (gru_bwd_f16 if dtype == torch.float16 else gru_bwd).launches += (
        launched.value)
    kernels.check(lib, rc, what)
    return dgx, duh, dbhn


def _launch_bwd_wide(gx_t: torch.Tensor, uh: torch.Tensor,
                     bhn: torch.Tensor, hseq: torch.Tensor,
                     ghT: torch.Tensor, lens: torch.Tensor, reverse: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step form's T + 4 launches (``csrc/gru_bwd_wide.cu``, its
    float16 build on a float16 ``uh``) on checked inputs at a width
    H % 16 == 0, added to ``gru_bwd_wide.launches``
    (``gru_bwd_wide_f16.launches``). The E copies of the states and gate
    cotangents are Hq = H rounded up to ``kernels.GRU_STEP_DUH_TILE``
    wide (dU_h's tiles); dU_h comes back [Hq, 3Hq] and is sliced to H."""
    T, B, H3 = gx_t.shape
    H = H3 // 3
    dev = gx_t.device
    dtype = uh.dtype
    Hq = kernels.round_up(H, kernels.GRU_STEP_DUH_TILE)
    f32 = dict(dtype=torch.float32, device=dev)
    dpart = ghT.clone()  # the carried cotangent's part, step by step
    g = torch.empty(T, B, 3 * Hq, dtype=dtype, device=dev)
    part = torch.empty(T, kernels.gru_step_plan(T, B, H, True)["partials"],
                       H, **f32)
    dgx = torch.empty(T, B, 3 * H, **f32)
    duh = torch.empty(Hq, 3 * Hq, **f32)
    dbhn = torch.empty(H, **f32)
    hbf = torch.empty(T, B, Hq, dtype=dtype, device=dev)
    what = kernels.name16("gru_bwd_wide", dtype)
    lib = _wide_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.gru_bwd_wide(gx_t.data_ptr(), hseq.data_ptr(),
                              lens.data_ptr(), uh.data_ptr(), bhn.data_ptr(),
                              dpart.data_ptr(), dgx.data_ptr(), g.data_ptr(),
                              part.data_ptr(), duh.data_ptr(),
                              dbhn.data_ptr(), hbf.data_ptr(), T, B, H,
                              int(reverse),
                              torch.cuda.current_stream(dev).cuda_stream,
                              ctypes.addressof(launched))
    (gru_bwd_wide_f16 if dtype == torch.float16
     else gru_bwd_wide).launches += launched.value
    kernels.check(lib, rc, what)
    return dgx, _unpad_gates(duh[:H], H), dbhn


def gru_bwd_wide(gx_t: torch.Tensor, hseq: torch.Tensor, lens: torch.Tensor,
                 uh: torch.Tensor, bhn: torch.Tensor, ghT: torch.Tensor, *,
                 reverse: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's step form (``csrc/gru_bwd_wide.cu``) on CUDA tensors, what
    :func:`gru_bwd` runs where the persistent step kernel cannot
    (``kernels.gru_bwd_route``), at any width: the inputs and outputs of
    :func:`gru_bwd` with a bf16 ``uh`` (a float16 one goes to
    :func:`gru_bwd_wide_f16`; another dtype raises ``TypeError``), H
    zero-padded to a multiple of 16. The E copy of the pre-step states,
    every step's gh in one GEMM, one launch a step (the carry through
    U_h^T, but at the first step, and the step's gate backward), then the
    dU_h GEMM and the db_hn sum (``kernels.gru_step_plan``): T + 4
    launches a call on the current stream, added to
    ``gru_bwd_wide.launches``."""
    if _dtype16("gru_bwd_wide", "uh", uh) == torch.float16:
        return gru_bwd_wide_f16(gx_t, hseq, lens, uh, bhn, ghT,
                                reverse=reverse)
    return _gru_bwd16(gx_t, hseq, lens, uh, bhn, ghT, reverse,
                      torch.bfloat16, "step")


gru_bwd_wide.launches = 0


def gru_bwd_wide_f16(gx_t: torch.Tensor, hseq: torch.Tensor,
                     lens: torch.Tensor, uh: torch.Tensor, bhn: torch.Tensor,
                     ghT: torch.Tensor, *, reverse: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3h's step form (``csrc/gru_bwd_wide_f16.cu``): as
    :func:`gru_bwd_wide` with uh [H, 3H] float16; T + 4 launches a call,
    added to ``gru_bwd_wide_f16.launches``."""
    return _gru_bwd16(gx_t, hseq, lens, uh, bhn, ghT, reverse,
                      torch.float16, "step")


gru_bwd_wide_f16.launches = 0


# The float32 kernels' entries: (pointers, ints) ahead of the stream and
# the launch count. Each library (K1f "gru_fwd_f32", K3f "gru_bwd_f32", K6f
# "bigru_fwd_f32", K7f "bigru_bwd_f32") exports its persistent form under
# its own name, the step form as "<name>_step" and the persistent launch's
# query as "<name>_config" (K6f's takes the b-tile's rows, 64 or 128).
_F32_ARGS = {"gru_fwd_f32": (6, 4), "gru_fwd_f32_step": (6, 4),
             "gru_bwd_f32": (12, 11), "gru_bwd_f32_step": (12, 12),
             "bigru_fwd_f32": (9, 5), "bigru_fwd_f32_step": (9, 3),
             "bigru_bwd_f32": (17, 11), "bigru_bwd_f32_step": (16, 11)}
_F32_ROWS_ARG = "bigru_fwd_f32"  # the library whose query takes the rows
# Each library's (backward, chains): K3f and K7f run the BPTT, K6f and K7f
# both chains of a bidirectional GRU.
_F32_KINDS = {"gru_fwd_f32": (False, 1), "gru_bwd_f32": (True, 1),
              "bigru_fwd_f32": (False, 2), "bigru_bwd_f32": (True, 2)}
# A call's forms: the route's persistent launch, the persistent kernels
# with one chain a launch (K6f and K7f only), K6f's both chains a launch
# on 64-row b-tiles where the plan takes 128, the step form.
_F32_FORMS = {"persistent": "", "per_chain": "", "persistent64": "",
              "step": "_step"}


@functools.lru_cache(maxsize=None)
def _f32_lib(name: str) -> ctypes.CDLL:
    """The library of K1f (``name`` "gru_fwd_f32"), K3f ("gru_bwd_f32"),
    K6f ("bigru_fwd_f32") or K7f ("bigru_bwd_f32"), each with the entries
    ``<name>`` (the persistent form), ``<name>_step`` and
    ``<name>_config``."""
    lib = kernels.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry in (name, name + "_step"):
        pointers, ints = _F32_ARGS[entry]
        getattr(lib, entry).argtypes = [p] * pointers + [i] * ints + [p, p]
        getattr(lib, entry).restype = i
    rows = [i] if name == _F32_ROWS_ARG else []
    getattr(lib, name + "_config").argtypes = [i, i, *rows, p, p, p]
    getattr(lib, name + "_config").restype = i
    return lib


def _f32_config(name: str, B: int, H: int, device: torch.device,
                rows: int = kernels.GRU_F32_ROWS) -> dict:
    """The C side's persistent launch of K1f (``name`` "gru_fwd_f32"), K3f's
    chain ("gru_bwd_f32"), K6f ("bigru_fwd_f32", in the tiling of
    ``rows``-row b-tiles) or K7f's chains ("bigru_bwd_f32") at (B, H) on
    CUDA ``device``: its grid (z the chains a launch; [0, 0, 0] where a
    row of one chain's unit tiles cannot be resident at once or a block's
    shared memory does not fit), blocks resident per SM (0 where that
    memory does not fit) and dynamic shared memory in bytes."""
    lib = _f32_lib(name)
    grid = (ctypes.c_int * 3)()
    per_sm, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(device):
        rc = getattr(lib, name + "_config")(
            B, H, *([rows] if name == _F32_ROWS_ARG else []),
            ctypes.addressof(grid), ctypes.addressof(per_sm),
            ctypes.addressof(smem))
    kernels.check(lib, rc, name)
    return {"grid": list(grid), "blocks_per_sm": per_sm.value,
            "smem_bytes": smem.value}


@functools.lru_cache(maxsize=None)
def _f32_blocks_per_sm(name: str, index: int, H: int,
                       rows: int = kernels.GRU_F32_ROWS) -> int:
    """``name``'s persistent blocks resident per SM of card ``index`` at
    width ``H`` (K6f's in the tiling of ``rows``-row b-tiles)."""
    return _f32_config(name, 1, H, torch.device("cuda", index),
                       rows)["blocks_per_sm"]


def _f32_occupancy(name: str, H: int, device: torch.device
                   ) -> Tuple[int, int]:
    """(SMs, ``name``'s persistent blocks per SM) of CUDA ``device``."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return kernels.sm_count(device), _f32_blocks_per_sm(name, index, H)


def _f32_plan(name: str, B: int, H: int, device: torch.device,
              form: Optional[str] = None) -> dict:
    """``kernels.gru_f32_plan`` for ``name``'s persistent launch at (B, H)
    on CUDA ``device`` from the occupancy its library reports (K6f's also
    of its 128-row tiling): ``form`` "per_chain", the plan of one chain,
    whose launch K6f and K7f then take a chain at a time; "persistent64",
    K6f's plan without the 128-row tiling."""
    backward, directions = _F32_KINDS[name]
    pair = 0
    if name == _F32_ROWS_ARG and form not in ("per_chain", "persistent64"):
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        pair = _f32_blocks_per_sm(name, index, H, kernels.GRU_F32_PAIR_ROWS)
    return kernels.gru_f32_plan(
        B, H, *_f32_occupancy(name, H, device), backward,
        1 if form == "per_chain" else directions, pair)


def _f32_route(name: str, B: int, H: int, device: torch.device) -> str:
    """``kernels.gru_f32_route`` for K1f, K3f, K6f or K7f (``name`` as
    :func:`_f32_lib`'s) at (B, H) on CUDA ``device``, from the occupancy
    that its own library reports."""
    return kernels.gru_f32_route(B, H, *_f32_occupancy(name, H, device),
                                 *_F32_KINDS[name])


def _f32_launch_config(name: str, B: int, H: int,
                       device: torch.device) -> dict:
    """``kernels.gru_f32_plan`` for K1f, K3f's chain, K6f or K7f's chains
    (``name`` as :func:`_f32_lib`'s) at (B, H) on CUDA ``device``, beside
    the C side's grid, blocks per SM and shared memory (``c_grid``,
    ``blocks_per_sm``, ``c_smem_bytes``). Raises where the route takes the
    step form."""
    plan = _f32_plan(name, B, H, device)
    cfg = _f32_config(name, B, H, device, plan["rows"])
    return {**plan, "c_grid": cfg["grid"],
            "blocks_per_sm": cfg["blocks_per_sm"],
            "c_smem_bytes": cfg["smem_bytes"]}


def _f32_form(name: str, form: Optional[str], B: int, H: int,
              device: torch.device) -> str:
    """The entry of ``name``'s library that a call launches: ``form``
    "persistent", "per_chain" (K6f and K7f: the persistent kernels, one
    launch a chain), "persistent64" (K6f: both chains a launch on 64-row
    b-tiles) or "step", or None for ``kernels.gru_f32_route``'s choice."""
    form = form or _f32_route(name, B, H, device)
    if form not in _F32_FORMS or (
            form == "per_chain" and _F32_KINDS[name][1] == 1) or (
            form == "persistent64" and name != _F32_ROWS_ARG):
        raise ValueError(f"{name}: form must be 'persistent', 'step' or, "
                         f"for two chains, 'per_chain' (K6f also "
                         f"'persistent64'), got {form!r}")
    return name + _F32_FORMS[form]


def _f32_launch_args(name: str, form: Optional[str], B: int, H: int,
                     device: torch.device) -> Tuple[int, int]:
    """(rows of a b-tile, chains a launch) of a persistent call of K6f or
    K7f in ``form`` (:func:`_f32_plan`'s): the plan's rows and grid
    depth."""
    plan = _f32_plan(name, B, H, device, form)
    return plan["rows"], plan["grid"][2]


def _f32_carry_units(B: int, H: int, device: torch.device,
                     directions: int) -> int:
    """The units a thread of the BPTT step form's carry launch
    (``kernels.gru_f32_carry_plan`` on CUDA ``device``'s SMs)."""
    return kernels.gru_f32_carry_plan(B, H, kernels.sm_count(device),
                                      directions)["units"]


def _check_f32(what: str, gx_t: torch.Tensor, lens: torch.Tensor,
               uh: torch.Tensor, bhn: torch.Tensor
               ) -> Tuple[int, int, int, torch.device]:
    """(T, B, H, device) of the float32 kernels' common inputs."""
    if gx_t.device.type != "cuda" or gx_t.dim() != 3:
        raise ValueError(f"{what} takes a 3-D CUDA gx_t")
    T, B, H3 = gx_t.shape
    H = H3 // 3
    dev = gx_t.device
    if T < 1 or B < 1 or H < 1 or H3 != 3 * H:
        raise ValueError(f"{what} needs T, B, H >= 1, got gx_t of shape "
                         f"{tuple(gx_t.shape)}")
    kernels.expect("gx_t", gx_t, torch.float32, (T, B, 3 * H), dev)
    kernels.expect("lens", lens, torch.int32, (B,), dev)
    kernels.expect("uh", uh, torch.float32, (H, 3 * H), dev)
    kernels.expect("bhn", bhn, torch.float32, (H,), dev)
    return T, B, H, dev


def gru_fwd_f32(gx_t: torch.Tensor, lens: torch.Tensor, uh: torch.Tensor,
                bhn: torch.Tensor, *, reverse: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel K1f (``csrc/gru_fwd_f32.cu``) on CUDA tensors, all
    float32: gx_t [T, B, 3H], lens [B] int32, uh [H, 3H], bhn [H] -> (hT
    [B, H], hseq [T, B, H]), :func:`gru_reference`'s recurrence with FFMA
    products and f32 sums. Any B and H. Where a block's U_h slice and ring
    fit in shared memory and a row of the ceil(H / 16) unit tiles can be
    resident at once (``kernels.gru_f32_route``: up to H = 1024 on an
    H100), one cooperative launch of the persistent kernel of
    ``csrc/gru_seq_f32.cuh`` for all T steps, on the grid of
    ``kernels.gru_f32_plan``; elsewhere the step form, one launch a step (T
    a call). On the current stream, added to ``gru_fwd_f32.launches``. Both
    forms give the same bits; a launch that fails raises."""
    return _gru_fwd32(gx_t, lens, uh, bhn, reverse)


gru_fwd_f32.launches = 0


def _gru_fwd32(gx_t: torch.Tensor, lens: torch.Tensor, uh: torch.Tensor,
               bhn: torch.Tensor, reverse: bool, form: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1f's checks, route and launch: ``form`` "persistent" or "step", or
    None for ``kernels.gru_f32_route``'s choice."""
    T, B, H, dev = _check_f32("gru_fwd_f32", gx_t, lens, uh, bhn)
    entry = _f32_form("gru_fwd_f32", form, B, H, dev)
    hseq = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    hT = torch.empty(B, H, dtype=torch.float32, device=dev)
    lib = _f32_lib("gru_fwd_f32")
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            gx_t.data_ptr(), lens.data_ptr(), uh.data_ptr(), bhn.data_ptr(),
            hseq.data_ptr(), hT.data_ptr(), T, B, H, int(reverse),
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    gru_fwd_f32.launches += launched.value
    kernels.check(lib, rc, entry)
    return hT, hseq


def gru_bwd_f32(gx_t: torch.Tensor, hseq: torch.Tensor, lens: torch.Tensor,
                uh: torch.Tensor, bhn: torch.Tensor, ghT: torch.Tensor, *,
                reverse: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel K3f (``csrc/gru_bwd_f32.cu``) on CUDA tensors, all
    float32: gx_t [T, B, 3H], hseq [T, B, H] (K1f's residual), lens [B]
    int32, uh [H, 3H], bhn [H], ghT [B, H] -> (dgx_t [T, B, 3H], duh
    [H, 3H], dbhn [H]), :func:`gru_bwd_reference`'s BPTT with FFMA products
    and f32 sums. Any B and H. Where the chain's U_h rows and ring fit in
    a block's shared memory and a row of its unit tiles can be resident at
    once (``kernels.gru_f32_route``: up to H = 1013 on an H100), every
    step's gh in one product, the chain in one cooperative launch
    (``kernels.gru_f32_plan``), the dU_h product over the (T-1)*B rows and
    the db_hn sum: 4 launches a call at any T. Elsewhere the step form
    (``csrc/gru_bptt_f32.cuh``): the lists of each step's live rows, every
    live row-step's gh in one product, one launch a step that carries dh
    through U_h^T for the step's live rows and runs their gate backward,
    then dU_h over the live row-steps and db_hn: T + 4 a call. On the
    current stream, added to ``gru_bwd_f32.launches``. Both forms give
    the same bits; a launch that fails raises."""
    return _gru_bwd32(gx_t, hseq, lens, uh, bhn, ghT, reverse)


gru_bwd_f32.launches = 0


def _gru_bwd32(gx_t: torch.Tensor, hseq: torch.Tensor, lens: torch.Tensor,
               uh: torch.Tensor, bhn: torch.Tensor, ghT: torch.Tensor,
               reverse: bool, form: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3f's checks, route and launches: ``form`` "persistent" or "step",
    or None for ``kernels.gru_f32_route``'s choice."""
    T, B, H, dev = _check_f32("gru_bwd_f32", gx_t, lens, uh, bhn)
    kernels.expect("hseq", hseq, torch.float32, (T, B, H), dev)
    kernels.expect("ghT", ghT, torch.float32, (B, H), dev)
    entry = _f32_form("gru_bwd_f32", form, B, H, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    gq = torch.empty(T, B, 3 * H, **f32)
    dgx = torch.empty(T, B, 3 * H, **f32)
    duh = torch.empty(H, 3 * H, **f32)
    dbhn = torch.empty(H, **f32)
    # Every step's gh but the chain's first, over the saved states of live
    # h_prev (hseq shifted by a step; none at T = 1), against g of the
    # steps they precede.
    gh = torch.empty(max(T - 1, 1), B, 3 * H, **f32)
    step = T > 1
    hp = hseq.data_ptr() + (B * H * 4 if reverse and step else 0)
    gp = gq.data_ptr() + (3 * B * H * 4 if step and not reverse else 0)
    ring = kernels.f32_ring_plan(4, True, H * 4, hp, 3 * H * 4,
                                 uh.data_ptr())
    duh_ring = kernels.f32_ring_plan(4, False, H * 4, hp, 3 * H * 4, gp,
                                     b_listed=True)
    plans = (ring["a_width"], ring["b_width"], ring["stages"],
             ring["smem_bytes"], duh_ring["a_width"], duh_ring["b_width"],
             duh_ring["smem_bytes"])
    lib = _f32_lib("gru_bwd_f32")
    launched = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if entry == "gru_bwd_f32":
            dpart = torch.empty(B, H, **f32)
            rc = lib.gru_bwd_f32(
                gx_t.data_ptr(), hseq.data_ptr(), lens.data_ptr(),
                uh.data_ptr(), bhn.data_ptr(), ghT.data_ptr(),
                dpart.data_ptr(), gq.data_ptr(), gh.data_ptr(),
                dgx.data_ptr(), duh.data_ptr(), dbhn.data_ptr(), T, B, H,
                int(reverse), *plans, stream, ctypes.addressof(launched))
        else:
            dpart = ghT.clone()  # the carried cotangent's part, in place
            lists = torch.empty(kernels.gru_f32_lists_ints(T, B),
                                dtype=torch.int32, device=dev)
            rc = lib.gru_bwd_f32_step(
                gx_t.data_ptr(), hseq.data_ptr(), lens.data_ptr(),
                uh.data_ptr(), bhn.data_ptr(), dpart.data_ptr(),
                lists.data_ptr(), gh.data_ptr(), gq.data_ptr(),
                dgx.data_ptr(), duh.data_ptr(), dbhn.data_ptr(), T, B, H,
                int(reverse), _f32_carry_units(B, H, dev, 1), *plans,
                stream, ctypes.addressof(launched))
    gru_bwd_f32.launches += launched.value
    kernels.check(lib, rc, entry)
    return dgx, duh, dbhn


def gru_bwd_launch_config(B: int, H: int, device: torch.device,
                          dtype: torch.dtype = torch.bfloat16) -> dict:
    """The shape of K3's persistent step launch (K3h's with ``dtype``
    float16) at batch ``B`` and width ``H`` on CUDA ``device``:
    ``kernels.gru_bwd_plan``'s b-tiles and grid (16-unit j-tiles, rows of
    64-row b-tile blocks, 1 direction), the blocks resident per SM, its
    dynamic shared memory in bytes and the widest H whose shared memory
    fits. ``H`` is a multiple of 64. Raises where the persistent step
    kernel cannot run (:func:`gru_bwd` takes the step form there)."""
    return _bptt_plan(kernels.name16("gru_bwd", dtype), B, H, device, 1)


def bigru_fused(gxf: torch.Tensor, gxb: torch.Tensor, lens: torch.Tensor,
                uhf: torch.Tensor, uhb: torch.Tensor, bhnf: torch.Tensor,
                bhnb: torch.Tensor, *, use_kernels: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both recurrences of a bidirectional GRU: gxf, gxb [T, B, 3H] f32
    (each direction's x@Wx + b, time-major), lens [B] int32, uhf, uhb
    [H, 3H], bhnf, bhnb [H] f32 -> (hT_fwd, hT_bwd) [B, H] f32, the
    backward chain reversed over each row's valid prefix as
    ``gru_fused(reverse=True)``. Differentiable in gx*, uh* and bhn*. A
    CUDA tensor runs kernels K6/K7 (K6h/K7h on float16 ``uh*``, K6f/K7f
    on float32), a CPU
    tensor the plain versions, and so does a CUDA tensor with
    ``use_kernels`` False."""
    if gxf.device.type not in ("cuda", "cpu"):
        raise ValueError(f"bigru_fused: no path for device {gxf.device}")
    return _BiGRUFused.apply(gxf.contiguous(), gxb.contiguous(),
                             lens.to(torch.int32), uhf.contiguous(),
                             uhb.contiguous(), bhnf.contiguous(),
                             bhnb.contiguous(),
                             use_kernels and gxf.device.type == "cuda")


class _BiGRUFused(torch.autograd.Function):
    """Both recurrences with their joint BPTT as the backward (JAX's
    ``custom_vjp`` of ``bigru_fused``); the residuals are the inputs and
    the two state sequences that K6 writes anyway."""

    @staticmethod
    def forward(ctx, gxf, gxb, lens, uhf, uhb, bhnf, bhnb, kernel):
        fwd = bigru_fwd if kernel else bigru_reference
        hTf, hTb, hseqf, hseqb = fwd(gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
        ctx.save_for_backward(gxf, gxb, hseqf, hseqb, lens, uhf, uhb, bhnf,
                              bhnb)
        ctx.kernel = kernel
        return hTf, hTb

    @staticmethod
    def backward(ctx, ghTf, ghTb):
        gxf, gxb, hseqf, hseqb, lens, uhf, uhb, bhnf, bhnb = ctx.saved_tensors
        bwd = bigru_bwd if ctx.kernel else bigru_bwd_reference
        dgxf, dgxb, duhf, duhb, dbhnf, dbhnb = bwd(
            gxf, gxb, hseqf, hseqb, lens, uhf, uhb, bhnf, bhnb,
            ghTf.float().contiguous(), ghTb.float().contiguous())
        return (dgxf, dgxb, None, duhf.to(uhf.dtype), duhb.to(uhb.dtype),
                dbhnf.to(bhnf.dtype), dbhnb.to(bhnb.dtype), None)


def bigru_reference(gxf: torch.Tensor, gxb: torch.Tensor, lens: torch.Tensor,
                    uhf: torch.Tensor, uhb: torch.Tensor, bhnf: torch.Tensor,
                    bhnb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of kernel K6: the two chains are independent,
    so it is :func:`gru_reference` forward on the first and reversed on the
    second -> (hTf, hTb [B, H], hseqf, hseqb [T, B, H]), all f32."""
    hTf, hseqf = gru_reference(gxf, lens, uhf, bhnf)
    hTb, hseqb = gru_reference(gxb, lens, uhb, bhnb, reverse=True)
    return hTf, hTb, hseqf, hseqb


def bigru_bwd_reference(gxf: torch.Tensor, gxb: torch.Tensor,
                        hseqf: torch.Tensor, hseqb: torch.Tensor,
                        lens: torch.Tensor, uhf: torch.Tensor,
                        uhb: torch.Tensor, bhnf: torch.Tensor,
                        bhnb: torch.Tensor, ghTf: torch.Tensor,
                        ghTb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of kernel K7, the BPTT of
    :func:`bigru_reference`: :func:`gru_bwd_reference` on each chain ->
    (dgxf, dgxb [T, B, 3H], duhf, duhb [H, 3H], dbhnf, dbhnb [H]), all
    f32."""
    dgxf, duhf, dbhnf = gru_bwd_reference(gxf, hseqf, lens, uhf, bhnf, ghTf)
    dgxb, duhb, dbhnb = gru_bwd_reference(gxb, hseqb, lens, uhb, bhnb, ghTb,
                                          reverse=True)
    return dgxf, dgxb, duhf, duhb, dbhnf, dbhnb


def _expect_pair(T: int, B: int, H: int, dev: torch.device,
                 dtype: torch.dtype, **pairs) -> None:
    """``kernels.expect`` on both tensors of each direction pair, U_h in
    ``dtype``."""
    shapes = {"gx": ((T, B, 3 * H), torch.float32),
              "hseq": ((T, B, H), torch.float32),
              "uh": ((H, 3 * H), dtype),
              "bhn": ((H,), torch.float32), "ghT": ((B, H), torch.float32)}
    for name, (f, b) in pairs.items():
        shape, dt = shapes[name]
        for x, tag in ((f, f"{name}f"), (b, f"{name}b")):
            kernels.expect(tag, x, dt, shape, dev)


@functools.lru_cache(maxsize=None)
def _bigru_lib(name: str = "bigru_fwd") -> ctypes.CDLL:
    """The library of K6 (``name`` "bigru_fwd") or K6h ("bigru_fwd_f16");
    both export ``bigru_fwd`` and ``bigru_fwd_config``."""
    lib = kernels.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bigru_fwd.argtypes = [p] * 10 + [i] * 4 + [p, p]
    lib.bigru_fwd.restype = i
    lib.bigru_fwd_config.argtypes = [i, i, i, p, p, p, p]
    lib.bigru_fwd_config.restype = i
    return lib


def bigru_fwd(gxf: torch.Tensor, gxb: torch.Tensor, lens: torch.Tensor,
              uhf: torch.Tensor, uhb: torch.Tensor, bhnf: torch.Tensor,
              bhnb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launch kernel K6 (``csrc/bigru_fwd.cu``) on CUDA tensors: gxf, gxb
    [T, B, 3H] f32, lens [B] int32, uhf, uhb [H, 3H] bf16, bhnf, bhnb [H]
    f32 -> (hTf, hTb [B, H], hseqf, hseqb [T, B, H]), all f32, each
    direction bit-equal to a :func:`gru_fwd` call on its inputs. Any H >= 1,
    zero-padded to a multiple of 16 (:func:`gru_pad`). Where
    ``kernels.gru_fwd_route`` takes the persistent kernel (as for
    :func:`gru_fwd`, up to ``kernels.GRU_FWD_STEP_ABOVE`` units), one call
    makes one cooperative launch of K1's persistent kernel for all T steps
    of both chains, with the batch rows a block of ``kernels.gru_fwd_plan``
    with two directions (or, where the plan says that both directions'
    j-tiles cannot be resident at once, one launch a chain), on the
    current stream and adds
    the number launched (1, or 2) to ``bigru_fwd.launches``; elsewhere the
    step form, :func:`bigru_fwd_wide`. A float16 ``uhf`` goes to
    :func:`bigru_fwd_f16` (K6h), a float32 one to :func:`bigru_fwd_f32`
    (K6f), another dtype raises ``TypeError`` (:func:`kernels.kernel_dtype`),
    and so does a ``uhb`` of another dtype than ``uhf``."""
    dt = kernels.kernel_dtype("bigru_fwd", "uhf", uhf)
    if dt == torch.float32:
        return bigru_fwd_f32(gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    if dt == torch.float16:
        return bigru_fwd_f16(gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    return _bigru_fwd16(gxf, gxb, lens, uhf, uhb, bhnf, bhnb, torch.bfloat16)


bigru_fwd.launches = 0


def bigru_fwd_f16(gxf: torch.Tensor, gxb: torch.Tensor, lens: torch.Tensor,
                  uhf: torch.Tensor, uhb: torch.Tensor, bhnf: torch.Tensor,
                  bhnb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launch kernel K6h (``csrc/bigru_fwd_f16.cu``: K6's body with float16
    as its element type) on CUDA tensors: as :func:`bigru_fwd` with uhf,
    uhb [H, 3H] float16, each direction bit-equal to a :func:`gru_fwd_f16`
    call on its inputs. The same padding, route and launch plan as K6; the
    persistent launches (1, or 2) are added to ``bigru_fwd_f16.launches``,
    the step form's to ``bigru_fwd_wide_f16.launches``."""
    return _bigru_fwd16(gxf, gxb, lens, uhf, uhb, bhnf, bhnb, torch.float16)


bigru_fwd_f16.launches = 0


def _bigru_fwd16(gxf: torch.Tensor, gxb: torch.Tensor, lens: torch.Tensor,
                 uhf: torch.Tensor, uhb: torch.Tensor, bhnf: torch.Tensor,
                 bhnb: torch.Tensor, dtype: torch.dtype,
                 form: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """K6's (``dtype`` bf16) or K6h's (float16) checks, padding, route and
    launch: ``form`` "persistent" or "step", or None for
    ``kernels.gru_fwd_route``'s choice with two directions."""
    what = kernels.name16("bigru_fwd", dtype)
    if gxf.device.type != "cuda" or gxf.dim() != 3:
        raise ValueError(f"{what} takes 3-D CUDA gx tensors")
    T, B, H3 = gxf.shape
    H = H3 // 3
    dev = gxf.device
    if T < 1 or B < 1 or H < 1 or H3 != 3 * H:
        raise ValueError(f"{what} needs T, B, H >= 1, got gxf of shape "
                         f"{tuple(gxf.shape)}")
    _expect_pair(T, B, H, dev, dtype, gx=(gxf, gxb), uh=(uhf, uhb),
                 bhn=(bhnf, bhnb))
    kernels.expect("lens", lens, torch.int32, (B,), dev)
    Hp = kernels.round_up(H, kernels.GRU_FWD_PAD)
    gxf, uhf, bhnf, _, _ = gru_pad(Hp, gxf, uhf, bhnf)
    gxb, uhb, bhnb, _, _ = gru_pad(Hp, gxb, uhb, bhnb)
    if (form or _fwd_route(what, B, Hp, dev)) == "persistent":
        plan, _ = _fwd_plan(what, B, Hp, dev)
        out = _launch_bigru_fwd(gxf, gxb, lens, uhf, uhb, bhnf, bhnb,
                                plan["rows"])
    else:
        out = _launch_bigru_fwd_wide(gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    hTf, hTb, hseqf, hseqb = out
    hTf, hseqf = gru_unpad_fwd(H, hTf, hseqf)
    hTb, hseqb = gru_unpad_fwd(H, hTb, hseqb)
    return hTf, hTb, hseqf, hseqb


def _launch_bigru_fwd(gxf: torch.Tensor, gxb: torch.Tensor,
                      lens: torch.Tensor, uhf: torch.Tensor,
                      uhb: torch.Tensor, bhnf: torch.Tensor,
                      bhnb: torch.Tensor, rows: int
                      ) -> Tuple[torch.Tensor, ...]:
    """K6's launch (K6h's on a float16 ``uhf``) with ``rows`` batch rows a
    block on inputs that :func:`bigru_fwd` has checked (chip_smoke.py also
    times the tiling that the plan does not take through it)."""
    T, B, H3 = gxf.shape
    H = H3 // 3
    dev = gxf.device
    what = kernels.name16("bigru_fwd", uhf.dtype)
    hseq = torch.empty(2, T, B, H, dtype=torch.float32, device=dev)
    hT = torch.empty(2, B, H, dtype=torch.float32, device=dev)
    hbf = torch.empty(2, 2, B, H, dtype=uhf.dtype, device=dev)
    lib = _bigru_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.bigru_fwd(gxf.data_ptr(), gxb.data_ptr(), lens.data_ptr(),
                           uhf.data_ptr(), uhb.data_ptr(), bhnf.data_ptr(),
                           bhnb.data_ptr(), hseq.data_ptr(), hT.data_ptr(),
                           hbf.data_ptr(), T, B, H, rows,
                           torch.cuda.current_stream(dev).cuda_stream,
                           ctypes.addressof(launched))
    (bigru_fwd_f16 if uhf.dtype == torch.float16
     else bigru_fwd).launches += launched.value
    kernels.check(lib, rc, what)
    return hT[0], hT[1], hseq[0], hseq[1]


def _launch_bigru_fwd_wide(gxf: torch.Tensor, gxb: torch.Tensor,
                           lens: torch.Tensor, uhf: torch.Tensor,
                           uhb: torch.Tensor, bhnf: torch.Tensor,
                           bhnb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The step form's T launches for both chains (``bigru_fwd_wide`` of
    ``csrc/gru_fwd_wide.cu``, its float16 build on a float16 ``uhf``) on
    checked inputs at a width H % 16 == 0, added to
    ``bigru_fwd_wide.launches`` (``bigru_fwd_wide_f16.launches``)."""
    T, B, H3 = gxf.shape
    H = H3 // 3
    dev = gxf.device
    hseq = torch.empty(2, T, B, H, dtype=torch.float32, device=dev)
    hT = torch.empty(2, B, H, dtype=torch.float32, device=dev)
    hbf = torch.empty(2, 2, B, H, dtype=uhf.dtype, device=dev)
    what = kernels.name16("gru_fwd_wide", uhf.dtype)
    lib = _wide_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.bigru_fwd_wide(gxf.data_ptr(), gxb.data_ptr(),
                                lens.data_ptr(), uhf.data_ptr(),
                                uhb.data_ptr(), bhnf.data_ptr(),
                                bhnb.data_ptr(), hseq.data_ptr(),
                                hT.data_ptr(), hbf.data_ptr(), T, B, H,
                                torch.cuda.current_stream(dev).cuda_stream,
                                ctypes.addressof(launched))
    (bigru_fwd_wide_f16 if uhf.dtype == torch.float16
     else bigru_fwd_wide).launches += launched.value
    kernels.check(lib, rc, what)
    return hT[0], hT[1], hseq[0], hseq[1]


def bigru_fwd_wide(gxf: torch.Tensor, gxb: torch.Tensor, lens: torch.Tensor,
                   uhf: torch.Tensor, uhb: torch.Tensor, bhnf: torch.Tensor,
                   bhnb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K6's step form (``bigru_fwd_wide`` of ``csrc/gru_fwd_wide.cu``) on
    CUDA tensors, what :func:`bigru_fwd` runs where the persistent kernel
    cannot, at any width: :func:`bigru_fwd`'s inputs and outputs with bf16
    ``uhf``, ``uhb`` (float16 ones go to :func:`bigru_fwd_wide_f16`),
    each direction bit-equal to a :func:`gru_fwd_wide` call on its inputs.
    T launches a call, each advancing both chains, added to
    ``bigru_fwd_wide.launches``."""
    if _dtype16("bigru_fwd_wide", "uhf", uhf) == torch.float16:
        return bigru_fwd_wide_f16(gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    return _bigru_fwd16(gxf, gxb, lens, uhf, uhb, bhnf, bhnb, torch.bfloat16,
                        "step")


bigru_fwd_wide.launches = 0


def bigru_fwd_wide_f16(gxf: torch.Tensor, gxb: torch.Tensor,
                       lens: torch.Tensor, uhf: torch.Tensor,
                       uhb: torch.Tensor, bhnf: torch.Tensor,
                       bhnb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K6h's step form (``csrc/gru_fwd_wide_f16.cu``): as
    :func:`bigru_fwd_wide` with float16 ``uhf``, ``uhb``; T launches a
    call, added to ``bigru_fwd_wide_f16.launches``."""
    return _bigru_fwd16(gxf, gxb, lens, uhf, uhb, bhnf, bhnb, torch.float16,
                        "step")


bigru_fwd_wide_f16.launches = 0


def bigru_fwd_launch_config(B: int, H: int, device: torch.device,
                            dtype: torch.dtype = torch.bfloat16) -> dict:
    """The shape of K6's persistent launch (K6h's with ``dtype`` float16)
    at batch ``B`` and width ``H`` on CUDA ``device``, as
    :func:`gru_fwd_launch_config` gives K1's, from K6's own instance of the
    kernel: the grid is (j-tiles, rows of blocks, 2 directions), or
    (j-tiles, rows of blocks, 1) with ``launches`` 2 where both
    directions' j-tiles cannot be resident at once. Raises where
    :func:`bigru_fwd` would."""
    return _fwd_launch_config(kernels.name16("bigru_fwd", dtype), B, H,
                              device)


@functools.lru_cache(maxsize=None)
def _bigru_bwd_lib(name: str = "bigru_bwd") -> ctypes.CDLL:
    """The library of K7 (``name`` "bigru_bwd") or K7h ("bigru_bwd_f16");
    both export ``bigru_bwd`` and ``bigru_bwd_config``."""
    lib = kernels.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bigru_bwd.argtypes = [p] * 16 + [i] * 4 + [p, p]
    lib.bigru_bwd.restype = i
    lib.bigru_bwd_config.argtypes = [i, p, p, p]
    lib.bigru_bwd_config.restype = i
    return lib


def bigru_bwd(gxf: torch.Tensor, gxb: torch.Tensor, hseqf: torch.Tensor,
              hseqb: torch.Tensor, lens: torch.Tensor, uhf: torch.Tensor,
              uhb: torch.Tensor, bhnf: torch.Tensor, bhnb: torch.Tensor,
              ghTf: torch.Tensor, ghTb: torch.Tensor
              ) -> Tuple[torch.Tensor, ...]:
    """Launch kernel K7 (``csrc/bigru_bwd.cu``) on CUDA tensors: gxf, gxb
    [T, B, 3H] f32, hseqf, hseqb [T, B, H] f32 (K6's residuals), lens [B]
    int32, uhf, uhb [H, 3H] bf16, bhnf, bhnb [H] f32, ghTf, ghTb [B, H] f32
    -> (dgxf, dgxb [T, B, 3H], duhf, duhb [H, 3H], dbhnf, dbhnb [H]), all
    f32, each direction bit-equal to a :func:`gru_bwd` call on its inputs.
    Any H >= 1, zero-padded to a multiple of 64 (16 for the step form;
    :func:`gru_pad`). Where ``kernels.gru_bwd_route`` takes the persistent
    step kernel with two directions (up to H = 576, as :func:`gru_bwd`),
    one call launches it (one cooperative launch for all T steps of both
    chains, on the grid of
    ``kernels.gru_bwd_plan`` with two directions), the dU_h GEMM and the
    db_hn sum of both directions on the current stream and adds the number
    launched (3) to ``bigru_bwd.launches``; elsewhere the step form,
    :func:`bigru_bwd_wide`. A float16 ``uhf`` goes to :func:`bigru_bwd_f16` (K7h), a float32
    one to :func:`bigru_bwd_f32` (K7f), another dtype raises ``TypeError``
    (:func:`kernels.kernel_dtype`), and so does a ``uhb`` of another dtype
    than ``uhf``."""
    dt = kernels.kernel_dtype("bigru_bwd", "uhf", uhf)
    args = (gxf, gxb, hseqf, hseqb, lens, uhf, uhb, bhnf, bhnb, ghTf, ghTb)
    if dt == torch.float32:
        return bigru_bwd_f32(*args)
    if dt == torch.float16:
        return bigru_bwd_f16(*args)
    return _bigru_bwd16(*args, torch.bfloat16)


bigru_bwd.launches = 0


def bigru_bwd_f16(gxf: torch.Tensor, gxb: torch.Tensor, hseqf: torch.Tensor,
                  hseqb: torch.Tensor, lens: torch.Tensor, uhf: torch.Tensor,
                  uhb: torch.Tensor, bhnf: torch.Tensor, bhnb: torch.Tensor,
                  ghTf: torch.Tensor, ghTb: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """Launch kernel K7h (``csrc/bigru_bwd_f16.cu``: K7's body with float16
    as its element type) on CUDA tensors: as :func:`bigru_bwd` with uhf,
    uhb [H, 3H] float16, each direction bit-equal to a :func:`gru_bwd_f16`
    call on its inputs. The same padding, route and launches as K7; the
    persistent form's 3 launches a call are added to
    ``bigru_bwd_f16.launches``, the step form's to
    ``bigru_bwd_wide_f16.launches``."""
    return _bigru_bwd16(gxf, gxb, hseqf, hseqb, lens, uhf, uhb, bhnf, bhnb,
                        ghTf, ghTb, torch.float16)


bigru_bwd_f16.launches = 0


def _bigru_bwd16(gxf: torch.Tensor, gxb: torch.Tensor, hseqf: torch.Tensor,
                 hseqb: torch.Tensor, lens: torch.Tensor, uhf: torch.Tensor,
                 uhb: torch.Tensor, bhnf: torch.Tensor, bhnb: torch.Tensor,
                 ghTf: torch.Tensor, ghTb: torch.Tensor, dtype: torch.dtype,
                 form: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """K7's (``dtype`` bf16) or K7h's (float16) checks, padding, route and
    launches: ``form`` "persistent" or "step", or None for
    ``kernels.gru_bwd_route``'s choice with two directions."""
    what = kernels.name16("bigru_bwd", dtype)
    if gxf.device.type != "cuda" or gxf.dim() != 3:
        raise ValueError(f"{what} takes 3-D CUDA gx tensors")
    T, B, H3 = gxf.shape
    H = H3 // 3
    dev = gxf.device
    if T < 1 or B < 1 or H < 1 or H3 != 3 * H:
        raise ValueError(f"{what} needs T, B, H >= 1, got gxf of shape "
                         f"{tuple(gxf.shape)}")
    _expect_pair(T, B, H, dev, dtype, gx=(gxf, gxb), hseq=(hseqf, hseqb),
                 uh=(uhf, uhb), bhn=(bhnf, bhnb), ghT=(ghTf, ghTb))
    kernels.expect("lens", lens, torch.int32, (B,), dev)
    Hp = kernels.round_up(H, kernels.GRU_BWD_PAD)
    form = form or _bwd_route(what, B, Hp, dev, 2)
    if form == "step":
        Hp = kernels.round_up(H, kernels.GRU_STEP_PAD)
    gxf, uhf, bhnf, hseqf, ghTf = gru_pad(Hp, gxf, uhf, bhnf, hseqf, ghTf)
    gxb, uhb, bhnb, hseqb, ghTb = gru_pad(Hp, gxb, uhb, bhnb, hseqb, ghTb)
    args = (gxf, gxb, hseqf, hseqb, lens, uhf, uhb, bhnf, bhnb, ghTf, ghTb)
    if form == "persistent":
        dgx, duh, dbhn = _launch_bigru_bwd(*args)
    else:
        dgx, duh, dbhn = _launch_bigru_bwd_wide(*args)
    dgxf, duhf, dbhnf = gru_unpad_bwd(H, dgx[0], duh[0], dbhn[0])
    dgxb, duhb, dbhnb = gru_unpad_bwd(H, dgx[1], duh[1], dbhn[1])
    return dgxf, dgxb, duhf, duhb, dbhnf, dbhnb


def _launch_bigru_bwd(gxf: torch.Tensor, gxb: torch.Tensor,
                      hseqf: torch.Tensor, hseqb: torch.Tensor,
                      lens: torch.Tensor, uhf: torch.Tensor,
                      uhb: torch.Tensor, bhnf: torch.Tensor,
                      bhnb: torch.Tensor, ghTf: torch.Tensor,
                      ghTb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K7's persistent launches (K7h's on a float16 ``uhf``) on checked
    inputs at a width H % 64 == 0 -> (dgx [2, T, B, 3H], duh [2, H, 3H],
    dbhn [2, H]), forward chain first."""
    T, B, H3 = gxf.shape
    H = H3 // 3
    dev = gxf.device
    dtype = uhf.dtype
    what = kernels.name16("bigru_bwd", dtype)
    plan = _bptt_plan(what, B, H, dev, 2)
    f32 = dict(dtype=torch.float32, device=dev)
    dhe = torch.stack([ghTf, ghTb])  # the carried cotangents, overwritten
    g = torch.empty(2, T, B, 3 * H, dtype=dtype, device=dev)
    hbf = torch.empty(2, T, B, H, dtype=dtype, device=dev)
    part = torch.empty(2, T, -(-B // _TILE), H, **f32)
    dgx = torch.empty(2, T, B, 3 * H, **f32)
    duh = torch.empty(2, H, 3 * H, **f32)
    dbhn = torch.empty(2, H, **f32)
    lib = _bigru_bwd_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.bigru_bwd(gxf.data_ptr(), gxb.data_ptr(), hseqf.data_ptr(),
                           hseqb.data_ptr(), lens.data_ptr(), uhf.data_ptr(),
                           uhb.data_ptr(), bhnf.data_ptr(), bhnb.data_ptr(),
                           dhe.data_ptr(), dgx.data_ptr(), g.data_ptr(),
                           part.data_ptr(), duh.data_ptr(), dbhn.data_ptr(),
                           hbf.data_ptr(), T, B, H, plan["grid"][1],
                           torch.cuda.current_stream(dev).cuda_stream,
                           ctypes.addressof(launched))
    (bigru_bwd_f16 if dtype == torch.float16
     else bigru_bwd).launches += launched.value
    kernels.check(lib, rc, what)
    return dgx, duh, dbhn


def _launch_bigru_bwd_wide(gxf: torch.Tensor, gxb: torch.Tensor,
                           hseqf: torch.Tensor, hseqb: torch.Tensor,
                           lens: torch.Tensor, uhf: torch.Tensor,
                           uhb: torch.Tensor, bhnf: torch.Tensor,
                           bhnb: torch.Tensor, ghTf: torch.Tensor,
                           ghTb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The step form's T + 5 launches for both chains (``bigru_bwd_wide``
    of ``csrc/gru_bwd_wide.cu``, its float16 build on a float16 ``uhf``)
    on checked inputs at a width H % 16 == 0, added to
    ``bigru_bwd_wide.launches`` (``bigru_bwd_wide_f16.launches``): dgx
    [2, T, B, 3H], duh [2, H, 3H], dbhn [2, H], forward chain first."""
    T, B, H3 = gxf.shape
    H = H3 // 3
    dev = gxf.device
    dtype = uhf.dtype
    Hq = kernels.round_up(H, kernels.GRU_STEP_DUH_TILE)
    f32 = dict(dtype=torch.float32, device=dev)
    dpart = torch.stack([ghTf, ghTb])  # the carried cotangents' parts
    g = torch.empty(2, T, B, 3 * Hq, dtype=dtype, device=dev)
    hbf = torch.empty(2, T, B, Hq, dtype=dtype, device=dev)
    part = torch.empty(2, T, kernels.gru_step_plan(T, B, H, True)["partials"],
                       H, **f32)
    dgx = torch.empty(2, T, B, 3 * H, **f32)
    duh = torch.empty(2, Hq, 3 * Hq, **f32)
    dbhn = torch.empty(2, H, **f32)
    what = kernels.name16("gru_bwd_wide", dtype)
    lib = _wide_lib(what)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.bigru_bwd_wide(
            gxf.data_ptr(), gxb.data_ptr(), hseqf.data_ptr(),
            hseqb.data_ptr(), lens.data_ptr(), uhf.data_ptr(), uhb.data_ptr(),
            bhnf.data_ptr(), bhnb.data_ptr(), dpart.data_ptr(),
            dgx.data_ptr(), g.data_ptr(), part.data_ptr(), duh.data_ptr(),
            dbhn.data_ptr(), hbf.data_ptr(), T, B, H,
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    (bigru_bwd_wide_f16 if dtype == torch.float16
     else bigru_bwd_wide).launches += launched.value
    kernels.check(lib, rc, what)
    return dgx, _unpad_gates(duh[:, :H], H), dbhn


def bigru_bwd_wide(gxf: torch.Tensor, gxb: torch.Tensor, hseqf: torch.Tensor,
                   hseqb: torch.Tensor, lens: torch.Tensor, uhf: torch.Tensor,
                   uhb: torch.Tensor, bhnf: torch.Tensor, bhnb: torch.Tensor,
                   ghTf: torch.Tensor, ghTb: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """K7's step form (``bigru_bwd_wide`` of ``csrc/gru_bwd_wide.cu``) on
    CUDA tensors, what :func:`bigru_bwd` runs where the persistent step
    kernel cannot, at any width: :func:`bigru_bwd`'s inputs and outputs
    with bf16 ``uhf``, ``uhb`` (float16 ones go to
    :func:`bigru_bwd_wide_f16`), each direction bit-equal to a
    :func:`gru_bwd_wide` call on its inputs. T + 5 launches a call for
    both chains, added to ``bigru_bwd_wide.launches``."""
    args = (gxf, gxb, hseqf, hseqb, lens, uhf, uhb, bhnf, bhnb, ghTf, ghTb)
    if _dtype16("bigru_bwd_wide", "uhf", uhf) == torch.float16:
        return bigru_bwd_wide_f16(*args)
    return _bigru_bwd16(*args, torch.bfloat16, "step")


bigru_bwd_wide.launches = 0


def bigru_bwd_wide_f16(gxf: torch.Tensor, gxb: torch.Tensor,
                       hseqf: torch.Tensor, hseqb: torch.Tensor,
                       lens: torch.Tensor, uhf: torch.Tensor,
                       uhb: torch.Tensor, bhnf: torch.Tensor,
                       bhnb: torch.Tensor, ghTf: torch.Tensor,
                       ghTb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K7h's step form (``csrc/gru_bwd_wide_f16.cu``): as
    :func:`bigru_bwd_wide` with float16 ``uhf``, ``uhb``; T + 5 launches a
    call, added to ``bigru_bwd_wide_f16.launches``."""
    return _bigru_bwd16(gxf, gxb, hseqf, hseqb, lens, uhf, uhb, bhnf, bhnb,
                        ghTf, ghTb, torch.float16, "step")


bigru_bwd_wide_f16.launches = 0


def gru_step_clusters(B: int, H: int, device: torch.device,
                      dtype: torch.dtype = torch.bfloat16,
                      directions: int = 1) -> int:
    """How many of the step form's carry clusters (three blocks a tile,
    ``kernels.gru_step_plan``) the card of CUDA ``device`` holds at once at
    batch ``B`` and width ``H`` (a multiple of 16) with ``directions``
    chains, as the C side's occupancy query reports it: a step whose
    clusters are more runs them in turns."""
    what = kernels.name16("gru_bwd_wide", dtype)
    lib = _wide_lib(what)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.gru_bwd_wide_clusters(B, H, directions,
                                       ctypes.addressof(out))
    kernels.check(lib, rc, what)
    return out.value


def bigru_bwd_launch_config(B: int, H: int, device: torch.device,
                            dtype: torch.dtype = torch.bfloat16) -> dict:
    """The shape of K7's persistent step launch (K7h's with ``dtype``
    float16) at batch ``B`` and width ``H`` on CUDA ``device``, as
    :func:`gru_bwd_launch_config` gives K3's: the grid is (16-unit
    j-tiles, rows of 64-row b-tile blocks, 2 directions). Raises where
    :func:`bigru_bwd` would."""
    return _bptt_plan(kernels.name16("bigru_bwd", dtype), B, H, device, 2)


def _check_pair_f32(what: str, gxf: torch.Tensor, gxb: torch.Tensor,
                    lens: torch.Tensor, uhf: torch.Tensor, uhb: torch.Tensor,
                    bhnf: torch.Tensor, bhnb: torch.Tensor
                    ) -> Tuple[int, int, int, torch.device]:
    """(T, B, H, device) of both chains' common float32 inputs."""
    T, B, H, dev = _check_f32(what, gxf, lens, uhf, bhnf)
    _expect_pair(T, B, H, dev, torch.float32, gx=(gxf, gxb), uh=(uhf, uhb),
                 bhn=(bhnf, bhnb))
    return T, B, H, dev


def bigru_fwd_f32(gxf: torch.Tensor, gxb: torch.Tensor, lens: torch.Tensor,
                  uhf: torch.Tensor, uhb: torch.Tensor, bhnf: torch.Tensor,
                  bhnb: torch.Tensor, *, form: Optional[str] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """Launch kernel K6f (``csrc/bigru_fwd_f32.cu``) on CUDA tensors, all
    float32: gxf, gxb [T, B, 3H], lens [B] int32, uhf, uhb [H, 3H], bhnf,
    bhnb [H] -> (hTf, hTb [B, H], hseqf, hseqb [T, B, H]), each direction
    bit-equal to a :func:`gru_fwd_f32` call on its inputs. Any B and H.
    Where K1f's persistent kernel fits (``kernels.gru_f32_route`` with two
    directions: up to H = 1024 on an H100), one cooperative launch of it
    for both chains and all T steps, the chain on ``blockIdx.z``, on the
    grid and b-tile rows of ``kernels.gru_f32_plan`` (128-row b-tiles where
    a block would walk two of 64 rows a step, as at B = 256; one launch a
    chain where a row of both chains' unit tiles cannot be resident at
    once); elsewhere the step form, one launch a step for both chains (T
    a call). On the current stream, added to ``bigru_fwd_f32.launches``.
    ``form`` ("persistent"; "per_chain": one launch a chain on K1f's plan;
    "persistent64": both chains a launch on 64-row b-tiles; "step"; None
    for the route's) lets tests and ``chip_smoke.py`` hold the forms
    against each other: all give the same bits; a launch that fails
    raises."""
    what = "bigru_fwd_f32"
    T, B, H, dev = _check_pair_f32(what, gxf, gxb, lens, uhf, uhb, bhnf,
                                   bhnb)
    entry = _f32_form(what, form, B, H, dev)
    hseq = torch.empty(2, T, B, H, dtype=torch.float32, device=dev)
    hT = torch.empty(2, B, H, dtype=torch.float32, device=dev)
    lib = _f32_lib(what)
    launched = ctypes.c_int(0)
    args = [gxf.data_ptr(), gxb.data_ptr(), lens.data_ptr(),
            uhf.data_ptr(), uhb.data_ptr(), bhnf.data_ptr(),
            bhnb.data_ptr(), hseq.data_ptr(), hT.data_ptr(), T, B, H]
    if entry == what:
        args.extend(_f32_launch_args(what, form, B, H, dev))
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            *args, torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))
    bigru_fwd_f32.launches += launched.value
    kernels.check(lib, rc, entry)
    return hT[0], hT[1], hseq[0], hseq[1]


bigru_fwd_f32.launches = 0


def bigru_bwd_f32(gxf: torch.Tensor, gxb: torch.Tensor, hseqf: torch.Tensor,
                  hseqb: torch.Tensor, lens: torch.Tensor, uhf: torch.Tensor,
                  uhb: torch.Tensor, bhnf: torch.Tensor, bhnb: torch.Tensor,
                  ghTf: torch.Tensor, ghTb: torch.Tensor, *,
                  form: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """Launch kernel K7f (``csrc/bigru_bwd_f32.cu``) on CUDA tensors, all
    float32: gxf, gxb [T, B, 3H], hseqf, hseqb [T, B, H] (K6f's residuals),
    lens [B] int32, uhf, uhb [H, 3H], bhnf, bhnb [H], ghTf, ghTb [B, H] ->
    (dgxf, dgxb [T, B, 3H], duhf, duhb [H, 3H], dbhnf, dbhnb [H]), each
    direction bit-equal to a :func:`gru_bwd_f32` call on its inputs. Any B
    and H. Where K3f's chain fits (``kernels.gru_f32_route`` with two
    directions: up to H = 1013 on an H100), K3f's four launches, each
    taking both chains: every step's gh, the chains as one cooperative
    launch (``kernels.gru_f32_plan``; one a chain where a row of both
    chains' unit tiles cannot be resident at once: 5 launches), dU_h and
    db_hn. Elsewhere K3f's step form with both chains in each launch (the
    lists of live rows shared): T + 4 a call. On the current stream, added
    to ``bigru_bwd_f32.launches``. ``form`` as :func:`bigru_fwd_f32`'s;
    all forms give the same bits; a launch that fails raises."""
    what = "bigru_bwd_f32"
    T, B, H, dev = _check_pair_f32(what, gxf, gxb, lens, uhf, uhb, bhnf,
                                   bhnb)
    _expect_pair(T, B, H, dev, torch.float32, hseq=(hseqf, hseqb),
                 ghT=(ghTf, ghTb))
    entry = _f32_form(what, form, B, H, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dpart = torch.empty(2, B, H, **f32)
    gq = torch.empty(2, T, B, 3 * H, **f32)
    dgx = torch.empty(2, T, B, 3 * H, **f32)
    duh = torch.empty(2, H, 3 * H, **f32)
    dbhn = torch.empty(2, H, **f32)
    lib = _f32_lib(what)
    launched = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ins = [gxf.data_ptr(), gxb.data_ptr(), hseqf.data_ptr(),
           hseqb.data_ptr(), lens.data_ptr(), uhf.data_ptr(), uhb.data_ptr(),
           bhnf.data_ptr(), bhnb.data_ptr()]
    # Every step's gh of both chains but each chain's first, over the
    # saved states of live h_prev (forward hseqf[0 .. T-2], backward
    # hseqb[1 .. T-1]; none at T = 1), against g of the steps they precede
    # (forward g[1 ..], backward g[.. T-2]). One ring plan serves both
    # chains: that of the OR of their addresses, aligned as the less
    # aligned of the two.
    gh = torch.empty(2, max(T - 1, 1), B, 3 * H, **f32)
    step = 4 * B * H if T > 1 else 0
    hp = hseqf.data_ptr() | (hseqb.data_ptr() + step)
    gp = (gq[0].data_ptr() + 3 * step) | gq[1].data_ptr()
    ring = kernels.f32_ring_plan(4, True, H * 4, hp, 3 * H * 4,
                                 uhf.data_ptr() | uhb.data_ptr())
    duh_ring = kernels.f32_ring_plan(4, False, H * 4, hp, 3 * H * 4, gp,
                                     b_listed=True)
    plans = (ring["a_width"], ring["b_width"], ring["stages"],
             ring["smem_bytes"], duh_ring["a_width"], duh_ring["b_width"],
             duh_ring["smem_bytes"])
    with torch.cuda.device(dev):
        if entry == what:
            rc = lib.bigru_bwd_f32(
                *ins, ghTf.data_ptr(), ghTb.data_ptr(), dpart.data_ptr(),
                gq.data_ptr(), gh.data_ptr(), dgx.data_ptr(), duh.data_ptr(),
                dbhn.data_ptr(), T, B, H,
                _f32_launch_args(what, form, B, H, dev)[1], *plans, stream,
                ctypes.addressof(launched))
        else:
            dpart[0].copy_(ghTf)  # each chain's carried cotangent's part
            dpart[1].copy_(ghTb)
            lists = torch.empty(kernels.gru_f32_lists_ints(T, B),
                                dtype=torch.int32, device=dev)
            rc = lib.bigru_bwd_f32_step(
                *ins, dpart.data_ptr(), lists.data_ptr(), gh.data_ptr(),
                gq.data_ptr(), dgx.data_ptr(), duh.data_ptr(),
                dbhn.data_ptr(), T, B, H, _f32_carry_units(B, H, dev, 2),
                *plans, stream, ctypes.addressof(launched))
    bigru_bwd_f32.launches += launched.value
    kernels.check(lib, rc, entry)
    return dgx[0], dgx[1], duh[0], duh[1], dbhn[0], dbhn[1]


bigru_bwd_f32.launches = 0
