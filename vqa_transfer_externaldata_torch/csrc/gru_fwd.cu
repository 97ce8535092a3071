// K1 `gru_fwd`: the fused GRU forward recurrence, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_fwd_kernel (the
// Pallas body launched by _gru_pallas_fwd_call); the step math is that
// file's _gru_cell, in the step kernel of gru_fwd_step.cuh (shared with K6).
// gx = x @ W_x + b is computed once for all steps outside (a plain GEMM).
// `reverse` walks t from T-1 down to 0 under the same prefix mask, so the
// padded tail is processed first and carries the zero state through.
//
// What bounds it on an H100: at B=64, T=26, H=512 the recurrence does
// 2.6 GFLOP and must move about 15 MB (gx in, hseq out, U_h once), which
// the card could do in about 5 us. The real limit is latency: 26 dependent
// steps, each a [B, H] x [H, 3H] product too small to fill the card.
//
// Design: the TPU kernel keeps h in VMEM across a sequential grid and U_h
// (1.5 MB of bf16) resident beside it. No SM holds U_h, and blocks cannot
// carry state between them, so here each timestep is one launch and the
// state lives in device memory (the hseq slot of the previous step, which
// is also the output the backward pass needs). The step kernel stages each
// block's U_h slice and h rows in shared memory and takes gh on WMMA (see
// gru_fwd_step.cuh). A first version that read U_h straight from L2 in its
// inner loop spent 79 us a step waiting on those dependent loads. One
// launch for the whole sequence (a grid-wide barrier per step, U_h resident
// in shared memory across the SMs) is left for later.

#include "gru_fwd_step.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gx_t [T, B, 3H] f32, lens [B] i32, uh [H, 3H] bf16, bhn [H] f32
// -> hseq [T, B, H] f32 (post-step state of actual timestep t), hT [B, H].
// Needs H % 16 == 0 (checked by the caller). Launches T step kernels on
// `stream`, counting in *launched those that launched; returns the first
// error.
int gru_fwd(const void* gx_t, const void* lens, const void* uh,
            const void* bhn, void* hseq, void* hT, int T, int B, int H,
            int reverse, void* stream, int* launched) {
  *launched = 0;
  cudaError_t e = prepare_step_kernel(H);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = smem_bytes(H);
  const dim3 grid(H / kTile, (B + kTile - 1) / kTile, 1);
  const size_t step_gx = static_cast<size_t>(B) * 3 * H;
  const size_t step_h = static_cast<size_t>(B) * H;
  const float* h_prev = nullptr;
  for (int k = 0; k < T; ++k) {
    const int t = reverse ? T - 1 - k : k;
    float* h_out = static_cast<float*>(hseq) + t * step_h;
    const FwdStep s{static_cast<const float*>(gx_t) + t * step_gx, h_prev,
                    static_cast<const __nv_bfloat16*>(uh),
                    static_cast<const float*>(bhn), h_out,
                    k == T - 1 ? static_cast<float*>(hT) : nullptr, t};
    gru_step_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        s, s, static_cast<const int*>(lens), B, H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
    h_prev = h_out;
  }
  return 0;
}

}  // extern "C"
