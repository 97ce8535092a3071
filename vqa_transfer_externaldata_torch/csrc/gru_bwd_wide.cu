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
// What bounds it on an H100: at B = 256, T = 26, H = 2400 the three
// products (every step's gh, the U_h^T carry of each step, dU_h) are
// 3 x 2 x 6400 x 2400 x 7200 operations (664 GFLOP, 0.67 ms at the 16-bit
// peak), each bound by the L2 bytes its tiles read; only the carry is on
// the chain of T dependent steps.
//
// Design: gru_wide_step.cuh's bwd_run: the E copy of the pre-step states,
// every step's gh in one wgmma GEMM (U_h's gate columns read as they lie),
// one carry launch a step (a
// cluster of three blocks a tile, one a gate, its epilogue this step's
// gate backward), dU_h on attention_dwv.cuh's wgmma dW_v product (one
// launch a direction), then K3's db_hn sum (gru_bwd_step.cuh): T + 4
// launches a gru_bwd_wide call, T + 5 a bigru_bwd_wide call, the direction
// on blockIdx.z, each direction of a bigru_bwd_wide call bit-equal to a
// gru_bwd_wide call with the same `reverse`. No atomics.

#include "gru_wide_step.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// With Hq = H rounded up to 256 (dU_h's tiles): gx_t [T, B, 3H] f32, hseq
// [T, B, H] f32 (the forward's), lens [B] i32, uh [H, 3H] E, bhn [H] f32;
// dpart [B, H] f32 holds the cotangent of the final state on entry and is
// clobbered. Scratch: g [T, B, 3Hq] E, part [T, 3 ceil(B/128), H] f32, hbf
// [T, B, Hq] E. Outputs: dgx [T, B, 3H] (every step's gh until the step
// overwrites it), duh [Hq, 3Hq] (gate blocks of Hq; the padding's rows and
// columns are the caller's to drop), dbhn [H], all f32. Needs H % 16 == 0
// (the wrapper pads H). T + 4 launches on `stream`, counted in *launched;
// returns the first CUDA error.
int gru_bwd_wide(const void* gx_t, const void* hseq, const void* lens,
                 const void* uh, const void* bhn, void* dpart, void* dgx,
                 void* g, void* part, void* duh, void* dbhn, void* hbf,
                 int T, int B, int H, int reverse, void* stream,
                 int* launched) {
  using E = KernelElem;
  const wide::Bwd<E> p{static_cast<const float*>(gx_t),
                       static_cast<const float*>(hseq),
                       static_cast<E*>(hbf),
                       static_cast<const int*>(lens),
                       static_cast<const E*>(uh),
                       static_cast<const float*>(bhn),
                       static_cast<float*>(dpart),
                       static_cast<float*>(dgx),
                       static_cast<E*>(g),
                       static_cast<float*>(part),
                       T, B, H, wide::duh_width(H), reverse};
  float* const du = static_cast<float*>(duh);
  float* const db = static_cast<float*>(dbhn);
  return wide::bwd_run<E>({p, p}, {du, du}, {db, db}, 1,
                          static_cast<cudaStream_t>(stream), launched);
}

// Both chains, forward chain first in every stacked buffer: gxf, gxb
// [T, B, 3H], hseqf, hseqb [T, B, H], lens [B], uhf, uhb [H, 3H] E, bhnf,
// bhnb [H]; dpart [2, B, H] holds the final states' cotangents
// (clobbered); scratch g [2, T, B, 3Hq] E, part [2, T, 3 ceil(B/128), H],
// hbf [2, T, B, Hq] E; outputs dgx [2, T, B, 3H], duh [2, Hq, 3Hq], dbhn
// [2, H]. T + 5 launches.
int bigru_bwd_wide(const void* gxf, const void* gxb, const void* hseqf,
                   const void* hseqb, const void* lens, const void* uhf,
                   const void* uhb, const void* bhnf, const void* bhnb,
                   void* dpart, void* dgx, void* g, void* part, void* duh,
                   void* dbhn, void* hbf, int T, int B, int H, void* stream,
                   int* launched) {
  const int Hq = wide::duh_width(H);
  const size_t step_h = static_cast<size_t>(B) * H;
  const size_t seq_h = T * step_h;
  const size_t seq_gx = 3 * seq_h;
  const size_t seq_hq = static_cast<size_t>(T) * B * Hq;
  const size_t seq_part = static_cast<size_t>(T) * 3 * ((B + 127) / 128) * H;
  const int* ln = static_cast<const int*>(lens);
  float* const dpp = static_cast<float*>(dpart);
  float* const dg = static_cast<float*>(dgx);
  using E = KernelElem;
  E* const gs = static_cast<E*>(g);
  float* const pt = static_cast<float*>(part);
  E* const hb = static_cast<E*>(hbf);
  const wide::Bwd<E> f{static_cast<const float*>(gxf),
                       static_cast<const float*>(hseqf), hb, ln,
                       static_cast<const E*>(uhf),
                       static_cast<const float*>(bhnf), dpp, dg, gs, pt,
                       T, B, H, Hq, 0};
  const wide::Bwd<E> b{static_cast<const float*>(gxb),
                       static_cast<const float*>(hseqb), hb + seq_hq, ln,
                       static_cast<const E*>(uhb),
                       static_cast<const float*>(bhnb), dpp + step_h,
                       dg + seq_gx, gs + 3 * seq_hq, pt + seq_part, T, B, H,
                       Hq, 1};
  float* const du = static_cast<float*>(duh);
  float* const db = static_cast<float*>(dbhn);
  return wide::bwd_run<E>({f, b}, {du, du + static_cast<size_t>(Hq) * 3 * Hq},
                          {db, db + H}, 2, static_cast<cudaStream_t>(stream),
                          launched);
}

// The carry launch's clusters of three blocks that the current card holds
// at once at batch B and width H (a multiple of 16) with `dirs` directions
// (cudaOccupancyMaxActiveClusters), into *clusters; returns the CUDA error.
int gru_bwd_wide_clusters(int B, int H, int dirs, int* clusters) {
  return wide::carry_clusters<KernelElem>(B, H, dirs, clusters);
}

}  // extern "C"
