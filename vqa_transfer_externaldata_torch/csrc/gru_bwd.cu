// K3 `gru_bwd`: backpropagation through time of the fused GRU recurrence,
// for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_bwd_kernel (the
// Pallas body launched by _gru_pallas_bwd_call); the step math is that
// file's _gru_cell_bwd, in the kernels of gru_bwd_step.cuh (shared with K7).
//
// What bounds it on an H100: at B=256, T=26, H=512 the three products of a
// live row-step (gh, the U_h^T product, dU_h) are 6 * H * 3H operations
// each, about 17 GFLOP over the ~3700 live row-steps of a batch (18 us at
// 989 TFLOP/s), while dgx and gx alone are 2 x 41 MB of f32 (25 us at
// 3.35 TB/s): the bytes bound it. As in the forward, the real limit is the
// latency of 26 dependent steps.
//
// Design: the TPU kernel keeps dh in VMEM and accumulates dU_h in a resident
// output block across a sequential grid. Hopper blocks share nothing, and
// dh_prev needs every gate column of the step, so each step is one launch
// and the state between steps lives in device memory: T step launches, then
// one dU_h GEMM over the whole sequence and one fixed-order db_hn sum (see
// gru_bwd_step.cuh). No atomics: the result is deterministic.

#include "gru_bwd_step.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

size_t gru_bwd_smem_bytes(int H) { return step_smem_bytes(H); }

// gx_t [T, B, 3H] f32, hseq [T, B, H] f32 (K1's residual), lens [B] i32,
// uh [H, 3H] bf16, bhn [H] f32; dhe [B, H] f32 holds the cotangent of the
// final state on entry and is clobbered. Scratch: g [T, B, 3H] bf16,
// part [T, ceil(B/16), H] f32. Outputs: dgx [T, B, 3H], duh [H, 3H],
// dbhn [H], all f32. Needs H % 64 == 0 (checked by the caller). Launches
// T step kernels, the dU_h GEMM and the db_hn sum on `stream` (T + 2),
// counting in *launched those that launched; returns the first error.
int gru_bwd(const void* gx_t, const void* hseq, const void* lens,
            const void* uh, const void* bhn, void* dhe, void* dgx, void* g,
            void* part, void* duh, void* dbhn, int T, int B, int H,
            int reverse, void* stream, int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare_bwd_step_kernel(H);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = step_smem_bytes(H);
  const int nbt = (B + kTile - 1) / kTile;
  const dim3 grid(H / kTile, nbt, 1);
  const size_t step_gx = static_cast<size_t>(B) * 3 * H;
  const size_t step_h = static_cast<size_t>(B) * H;
  const float* gxf = static_cast<const float*>(gx_t);
  const float* hs = static_cast<const float*>(hseq);
  __nv_bfloat16* gb = static_cast<__nv_bfloat16*>(g);
  for (int k = 0; k < T; ++k) {
    const int t = reverse ? k : T - 1 - k;
    const bool first = reverse ? t == T - 1 : t == 0;
    const BwdStep s{
        gxf + t * step_gx,
        first ? nullptr : hs + (reverse ? t + 1 : t - 1) * step_h,
        static_cast<const __nv_bfloat16*>(uh),
        static_cast<const float*>(bhn),
        k == 0 ? nullptr : gb + (reverse ? t - 1 : t + 1) * step_gx,
        static_cast<float*>(dhe), static_cast<float*>(dgx) + t * step_gx,
        gb + t * step_gx,
        static_cast<float*>(part) + static_cast<size_t>(k) * nbt * H, t};
    gru_bwd_step_kernel<<<grid, kThreads, smem, st>>>(
        s, s, static_cast<const int*>(lens), B, H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
  }
  // h_prev of step t is hseq[t-1] (forward) or hseq[t+1] (reverse); the
  // first processed step's zero state adds nothing and is left out.
  const int K = (T - 1) * B;
  const DuhGemm d{hs + (reverse ? step_h : 0), gb + (reverse ? 0 : step_gx),
                  static_cast<float*>(duh)};
  gru_duh_kernel<<<dim3(3 * H / kGN, H / kGM, 1), kGThreads, 0, st>>>(
      d, d, K, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  const DbhnSum p{static_cast<const float*>(part), static_cast<float*>(dbhn)};
  gru_dbhn_kernel<<<dim3((H + 255) / 256, 1), 256, 0, st>>>(p, p, T * nbt,
                                                              H);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // extern "C"
