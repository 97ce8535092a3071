// K6 `bigru_fwd`: both recurrences of a bidirectional GRU, advanced
// together, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_bigru_fwd_kernel (the
// Pallas body launched by _bigru_pallas_fwd_call): grid step k advances the
// forward chain at t = k and the backward chain at t = T-1-k, both under the
// prefix mask t < lens[b], so the backward chain walks each row's padded
// tail first and carries the zero state through it (as K1 with `reverse`).
// The cell math is _gru_cell, gru_cell in gru_fwd_step.cuh, which K1's
// persistent kernel applies too: each direction's outputs equal a K1 call
// on its gx half, bit for bit.
//
// What bounds it on an H100: at B=256, T=26, H=512 the two chains do about
// 2 x 2 x sum(lens) x H x 3H operations (~11 GFLOP, 11 us at the bf16
// peak) and must move the live rows of gx in and hseq out for both (~2 x
// 35 MB, ~21 us at 3.35 TB/s): the bytes bound it. The real limit is, as for K1, the latency
// of 26 dependent steps, each too small to fill the card alone.
//
// Design: the step kernel of gru_fwd_step.cuh, one launch per timestep,
// with a direction axis in the grid (blockIdx.z). Launch k holds the
// forward chain's tiles at t = k and the backward chain's at t = T-1-k, so
// one sequence takes T launches. The state of each chain lives in its hseq
// slab (the slot of the previous step). K1's design, one persistent launch
// with U_h's slices resident in shared memory, is not applied here yet.

#include "gru_fwd_step.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gxf, gxb [T, B, 3H] f32, lens [B] i32, uhf, uhb [H, 3H] bf16, bhnf, bhnb
// [H] f32 -> hseq [2, T, B, H] f32 (forward chain, then backward chain; the
// post-step state of actual timestep t), hT [2, B, H]. Needs H % 16 == 0
// (checked by the caller). Launches T step kernels on `stream`, counting
// in *launched those that launched; returns the first error.
int bigru_fwd(const void* gxf, const void* gxb, const void* lens,
              const void* uhf, const void* uhb, const void* bhnf,
              const void* bhnb, void* hseq, void* hT, int T, int B, int H,
              void* stream, int* launched) {
  *launched = 0;
  cudaError_t e = prepare_step_kernel(H);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = smem_bytes(H);
  const dim3 grid(H / kTile, (B + kTile - 1) / kTile, 2);
  const size_t step_gx = static_cast<size_t>(B) * 3 * H;
  const size_t step_h = static_cast<size_t>(B) * H;
  float* hseqf = static_cast<float*>(hseq);
  float* hseqb = hseqf + T * step_h;
  float* hTf = static_cast<float*>(hT);
  float* hTb = hTf + step_h;
  for (int k = 0; k < T; ++k) {
    const int tf = k;
    const int tb = T - 1 - k;
    const bool last = k == T - 1;
    const FwdStep f{static_cast<const float*>(gxf) + tf * step_gx,
                    k == 0 ? nullptr : hseqf + (tf - 1) * step_h,
                    static_cast<const __nv_bfloat16*>(uhf),
                    static_cast<const float*>(bhnf), hseqf + tf * step_h,
                    last ? hTf : nullptr, tf};
    const FwdStep b{static_cast<const float*>(gxb) + tb * step_gx,
                    k == 0 ? nullptr : hseqb + (tb + 1) * step_h,
                    static_cast<const __nv_bfloat16*>(uhb),
                    static_cast<const float*>(bhnb), hseqb + tb * step_h,
                    last ? hTb : nullptr, tb};
    gru_step_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        f, b, static_cast<const int*>(lens), B, H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
  }
  return 0;
}

}  // extern "C"
