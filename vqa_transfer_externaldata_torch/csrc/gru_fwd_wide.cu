// K1 and K6 in the step form, `gru_fwd_wide` (one direction) and
// `bigru_fwd_wide` (both chains of a bidirectional GRU), for Hopper
// (sm_90a). The same source builds csrc/gru_fwd_wide_f16.cu, the float16
// instance: E = KernelElem (elem16.cuh) is bf16 here and float16 there, U_h's
// type and the exchanged state's.
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_fwd_kernel (B1)
// and ::_bigru_fwd_kernel (B7) at the widths the persistent kernel of
// gru_fwd_step.cuh does not take (above ops/kernels.py::GRU_FWD_STEP_ABOVE,
// where this form is the faster on an H100, or where a block's U_h slice
// or the grid does not fit): ops/kernels.py::gru_fwd_route picks this form
// by shape.
//
// What bounds it on an H100: at B = 256, T = 26, H = 2400 a step does
// 2 x 256 x 2400 x 7200 operations (8.85 GFLOP, 9 us at the 16-bit peak)
// on U_h (34.6 MB of E, kept in the 50 MB L2); the L2's rate into the SMs
// and the 26 dependent launches bound it.
//
// Design: gru_wide_step.cuh's gru_wide_fwd_kernel, one launch a step: a
// 256-row x 40-unit tile a cluster of two blocks on wgmma (the units' r, z
// and n columns of U_h read as they lie, each block half of the sum's K),
// the cell in the epilogue, the direction on blockIdx.z: T launches a call
// whatever the directions, each direction of a bigru_fwd_wide call
// bit-equal to a gru_fwd_wide call with the same `reverse`. No atomics:
// the result is deterministic.

#include "gru_wide_step.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gx_t [T, B, 3H] f32, lens [B] i32, uh [H, 3H] E, bhn [H] f32 -> hseq
// [T, B, H] f32 (the post-step state of actual timestep t), hT [B, H];
// scratch hbf [2, B, H] E. Needs H % 16 == 0 (the wrapper pads H). T
// launches on `stream`, counted in *launched; returns the first CUDA
// error.
int gru_fwd_wide(const void* gx_t, const void* lens, const void* uh,
                 const void* bhn, void* hseq, void* hT, void* hbf, int T,
                 int B, int H, int reverse, void* stream, int* launched) {
  using E = KernelElem;
  const wide::Fwd<E> p{static_cast<const float*>(gx_t),
                       static_cast<const int*>(lens),
                       static_cast<const E*>(uh),
                       static_cast<const float*>(bhn),
                       static_cast<float*>(hseq),
                       static_cast<float*>(hT),
                       static_cast<E*>(hbf),
                       T, B, H, reverse};
  return wide::fwd_run<E>({p, p}, 1, static_cast<cudaStream_t>(stream),
                          launched);
}

// Both chains: gxf, gxb [T, B, 3H] f32, lens [B] i32, uhf, uhb [H, 3H] E,
// bhnf, bhnb [H] f32 -> hseq [2, T, B, H] f32 (forward chain, then the
// backward one), hT [2, B, H]; scratch hbf [2, 2, B, H] E. T launches.
int bigru_fwd_wide(const void* gxf, const void* gxb, const void* lens,
                   const void* uhf, const void* uhb, const void* bhnf,
                   const void* bhnb, void* hseq, void* hT, void* hbf, int T,
                   int B, int H, void* stream, int* launched) {
  const size_t step_h = static_cast<size_t>(B) * H;
  const int* ln = static_cast<const int*>(lens);
  float* const hs = static_cast<float*>(hseq);
  float* const ht = static_cast<float*>(hT);
  using E = KernelElem;
  E* const hb = static_cast<E*>(hbf);
  const wide::Fwd<E> f{static_cast<const float*>(gxf), ln,
                       static_cast<const E*>(uhf),
                       static_cast<const float*>(bhnf), hs, ht, hb,
                       T, B, H, 0};
  const wide::Fwd<E> b{static_cast<const float*>(gxb), ln,
                       static_cast<const E*>(uhb),
                       static_cast<const float*>(bhnb), hs + T * step_h,
                       ht + step_h, hb + 2 * step_h, T, B, H, 1};
  return wide::fwd_run<E>({f, b}, 2, static_cast<cudaStream_t>(stream),
                          launched);
}

}  // extern "C"
