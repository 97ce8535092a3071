// K3 and K7 in the step form, `gru_bwd_wide` (one direction) and
// `bigru_bwd_wide` (both chains of a bidirectional GRU), for Hopper
// (sm_90a). The same source builds csrc/gru_bwd_wide_f16.cu, the float16
// instance: E = KernelElem (elem16.cuh) is bf16 here and float16 there, the
// type of U_h, of the copy of the pre-step states and of the staged gate
// cotangents.
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_bwd_kernel (B2)
// and ::_bigru_bwd_kernel (B8) at the widths the persistent step kernel of
// gru_bwd_step.cuh cannot take (U_h's slices and its ring past a block's
// shared memory: H above 576 on an H100): ops/kernels.py::gru_bwd_route
// picks this form by shape.
//
// What bounds it on an H100: at B = 256, T = 26, H = 1024 the three
// products of a step (gh, the U_h^T carry, dU_h) are 6 x 256 x 1024 x 3072
// operations (4.8 GFLOP, 4.9 us at the 16-bit peak), and every step reads
// U_h (6.3 MB) once per 64-row b-tile for each of its two products, out of
// L2; the L2's rate and the 2T dependent launches bound it.
//
// Design: gru_wide_step.cuh's bwd_run: the E copy of the pre-step states,
// two launches a step (gates' cotangents with gh recomputed; the carry
// through U_h^T, but after the last step), then K3's dU_h GEMM and db_hn
// sum (gru_bwd_step.cuh): 2T + 2 launches a call, the direction on
// blockIdx.z, each direction of a bigru_bwd_wide call bit-equal to a
// gru_bwd_wide call with the same `reverse`. No atomics.

#include "gru_wide_step.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gx_t [T, B, 3H] f32, hseq [T, B, H] f32 (the forward's), lens [B] i32,
// uh [H, 3H] E, bhn [H] f32; dh [B, H] f32 holds the cotangent of the
// final state on entry and is clobbered. Scratch: dpart [B, H] f32, g
// [T, B, 3H] E, part [T, ceil(B/16), H] f32, hbf [T, B, H] E. Outputs:
// dgx [T, B, 3H], duh [H, 3H], dbhn [H], all f32. Needs H % 64 == 0 (the
// wrapper pads H). 2T + 2 launches on `stream`, counted in *launched;
// returns the first CUDA error.
int gru_bwd_wide(const void* gx_t, const void* hseq, const void* lens,
                 const void* uh, const void* bhn, void* dh, void* dpart,
                 void* dgx, void* g, void* part, void* duh, void* dbhn,
                 void* hbf, int T, int B, int H, int reverse, void* stream,
                 int* launched) {
  using E = KernelElem;
  const wide::Bwd<E> p{static_cast<const float*>(gx_t),
                       static_cast<const float*>(hseq),
                       static_cast<E*>(hbf),
                       static_cast<const int*>(lens),
                       static_cast<const E*>(uh),
                       static_cast<const float*>(bhn),
                       static_cast<float*>(dh),
                       static_cast<float*>(dpart),
                       static_cast<float*>(dgx),
                       static_cast<E*>(g),
                       static_cast<float*>(part),
                       T, B, H, reverse};
  float* const du = static_cast<float*>(duh);
  float* const db = static_cast<float*>(dbhn);
  return wide::bwd_run<E>({p, p}, {du, du}, {db, db}, 1,
                          static_cast<cudaStream_t>(stream), launched);
}

// Both chains, forward chain first in every stacked buffer: gxf, gxb
// [T, B, 3H], hseqf, hseqb [T, B, H], lens [B], uhf, uhb [H, 3H] E, bhnf,
// bhnb [H]; dh [2, B, H] holds the final states' cotangents (clobbered);
// scratch dpart [2, B, H], g [2, T, B, 3H] E, part [2, T, ceil(B/16), H],
// hbf [2, T, B, H] E; outputs dgx [2, T, B, 3H], duh [2, H, 3H], dbhn
// [2, H]. 2T + 2 launches.
int bigru_bwd_wide(const void* gxf, const void* gxb, const void* hseqf,
                   const void* hseqb, const void* lens, const void* uhf,
                   const void* uhb, const void* bhnf, const void* bhnb,
                   void* dh, void* dpart, void* dgx, void* g, void* part,
                   void* duh, void* dbhn, void* hbf, int T, int B, int H,
                   void* stream, int* launched) {
  const size_t step_h = static_cast<size_t>(B) * H;
  const size_t seq_h = T * step_h;
  const size_t seq_gx = 3 * seq_h;
  const size_t seq_part = static_cast<size_t>(T) * ((B + 15) / 16) * H;
  const int* ln = static_cast<const int*>(lens);
  float* const dhp = static_cast<float*>(dh);
  float* const dpp = static_cast<float*>(dpart);
  float* const dg = static_cast<float*>(dgx);
  using E = KernelElem;
  E* const gs = static_cast<E*>(g);
  float* const pt = static_cast<float*>(part);
  E* const hb = static_cast<E*>(hbf);
  const wide::Bwd<E> f{static_cast<const float*>(gxf),
                       static_cast<const float*>(hseqf), hb, ln,
                       static_cast<const E*>(uhf),
                       static_cast<const float*>(bhnf), dhp, dpp, dg, gs, pt,
                       T, B, H, 0};
  const wide::Bwd<E> b{static_cast<const float*>(gxb),
                       static_cast<const float*>(hseqb), hb + seq_h, ln,
                       static_cast<const E*>(uhb),
                       static_cast<const float*>(bhnb), dhp + step_h,
                       dpp + step_h, dg + seq_gx, gs + seq_gx, pt + seq_part,
                       T, B, H, 1};
  float* const du = static_cast<float*>(duh);
  float* const db = static_cast<float*>(dbhn);
  return wide::bwd_run<E>({f, b}, {du, du + static_cast<size_t>(H) * 3 * H},
                          {db, db + H}, 2, static_cast<cudaStream_t>(stream),
                          launched);
}

}  // extern "C"
