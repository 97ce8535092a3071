// K1f `gru_fwd_f32`: the fused GRU recurrence over T timesteps in float32,
// for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_fwd_kernel (the
// Pallas body launched by _gru_fused_fwd) when the model computes in
// float32 (model.dtype float32): the TPU kernel takes U_h in the model's
// dtype, and K1 (gru_fwd.cu) takes only bf16. The same function as K1's
// plain version gru_reference on float32 U_h: the hoisted gx_t, the
// prefix mask t < lens, hseq[t] the state after actual timestep t, the
// reverse chain walked in descending t.
//
// What bounds it on an H100: at B=256, H=512, T=26 the hidden products
// after each row's first step (whose carry is zero, so the first launch
// takes none) are at most 25 x 2 x 256 x 512 x 1536 = 10.1 GFLOP of f32
// FFMA (0.15 ms at 67 TFLOP/s), against 41 MB of gx, hseq and U_h reads
// and writes: the FP32 pipes, and the T dependent steps.
//
// Design: one launch a step of gru_step_f32.cuh's step kernel (64 rows x
// 16 units a block, the three gate columns of a unit in one thread's
// registers; 4 x 32 = 128 blocks at B=256, H=512). The launch boundary is
// the step's barrier: no cooperative launch and no plan. U_h (3 MB in f32
// at H=512) is read from L2 each step. hseq[t - 1] (hseq[t + 1] in
// reverse) is the step's h_prev, so no other state buffer exists. T
// launches a call.

#include <cuda_runtime.h>

#include "gru_step_f32.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gx [T, B, 3H] f32, lens [B] i32, uh [H, 3H] f32, bhn [H] f32 -> hseq
// [T, B, H] f32 and hT [B, H] f32. One launch a step on `stream`; the
// number launched is added to *launched.
int gru_fwd_f32(const float* gx, const int* lens, const float* uh,
                const float* bhn, float* hseq, float* hT, int T, int B,
                int H, int reverse, cudaStream_t stream, int* launched) {
  const dim3 grid((H + gru_f32::UNITS - 1) / gru_f32::UNITS,
                  (B + gru_f32::BM - 1) / gru_f32::BM);
  const long long BH = (long long)B * H;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* hprev =
        s == 0 ? nullptr : hseq + (reverse ? t + 1 : t - 1) * BH;
    gru_f32::gru_f32_step_kernel<false>
        <<<grid, fp32_tile::THREADS, 0, stream>>>(
        gx + t * 3 * BH, hprev, lens, t, uh, bhn, B, H, hseq + t * BH,
        s == T - 1 ? hT : nullptr, nullptr, nullptr, nullptr, nullptr);
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
