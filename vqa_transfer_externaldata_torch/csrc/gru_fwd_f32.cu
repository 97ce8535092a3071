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
// after each row's first step (whose carry is zero, so the first step
// takes none) are at most 25 x 2 x 256 x 512 x 1536 = 10.1 GFLOP of f32
// FFMA (0.15 ms at 67 TFLOP/s), against 41 MB of gx, hseq and U_h reads
// and writes: the FP32 pipes, the shared-memory loads that feed them, and
// the T dependent steps.
//
// Design: the persistent kernel of gru_seq_f32.cuh (gru_f32_seq_kernel),
// one cooperative launch for all T steps: each block keeps its 16 units'
// 48 U_h columns in shared memory for the call and streams h_prev through
// a cp.async ring, one grid barrier a step; the grid from persist_grid
// (ops/kernels.py::gru_f32_plan). Where it does not fit, the wrapper takes
// the step form, gru_fwd_f32_step: one launch a step of gru_step_f32.cuh's
// step kernel (64 rows x 16 units a block, U_h read from L2 each step),
// the launch boundary the step's barrier. Both forms take the same FFMA
// chains and gate math: their outputs are equal bit for bit. hseq[t - 1]
// (hseq[t + 1] in reverse) is the step's h_prev, so no other state buffer
// exists.

#include <cuda_runtime.h>

#include "gru_seq_f32.cuh"

namespace {

using gru_seq_f32::FwdArgs;

using gru_seq_f32::FwdTile;
using FwdKernel = void (*)(FwdArgs);

// The persistent kernel's instance at width H: 16-byte copies of h_prev
// where its rows are 16-byte aligned.
FwdKernel fwd_kernel(int H) {
  return H % 4 == 0 ? gru_seq_f32::gru_f32_seq_kernel<FwdTile, true>
                    : gru_seq_f32::gru_f32_seq_kernel<FwdTile, false>;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The persistent launch at batch B and width H on the current device: its
// grid[3] (0 x 0 x 0 where a row of ceil(H / 16) unit tiles cannot be
// resident at once, or its shared memory exceeds a block's), the blocks
// resident per SM (0 where the shared memory does not fit) and the
// dynamic shared memory. Returns the CUDA error of the queries.
int gru_fwd_f32_config(int B, int H, int* grid, int* per_sm,
                       long long* smem_bytes) {
  return gru_seq_f32::persist_config<FwdTile>(
      fwd_kernel(H), gru_seq_f32::fwd_smem(H), B, H, 1, grid, per_sm,
      smem_bytes);
}

// gx [T, B, 3H] f32, lens [B] i32, uh [H, 3H] f32, bhn [H] f32 -> hseq
// [T, B, H] f32 and hT [B, H] f32. One cooperative launch of the
// persistent kernel on `stream`, counted in *launched; returns the CUDA
// error, among them cudaErrorCooperativeLaunchTooLarge where its grid
// cannot be resident (ops/kernels.py::gru_f32_route sends such shapes to
// gru_fwd_f32_step).
int gru_fwd_f32(const float* gx, const int* lens, const float* uh,
                const float* bhn, float* hseq, float* hT, int T, int B,
                int H, int reverse, cudaStream_t stream, int* launched) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const gru_seq_f32::FwdChain c{gx, uh, bhn, hseq, hT, reverse};
  const FwdArgs a{{c, c}, lens, T, B, H};
  return gru_seq_f32::persist_launch<FwdTile>(
      fwd_kernel(H), gru_seq_f32::fwd_smem(H), a, B, H, 1, 1, stream,
      launched);
}

// The step form on the same arguments: one launch a step on `stream`; the
// number launched is added to *launched.
int gru_fwd_f32_step(const float* gx, const int* lens, const float* uh,
                     const float* bhn, float* hseq, float* hT, int T, int B,
                     int H, int reverse, cudaStream_t stream,
                     int* launched) {
  const dim3 grid((H + gru_f32::UNITS - 1) / gru_f32::UNITS,
                  (B + gru_f32::BM - 1) / gru_f32::BM);
  const long long BH = (long long)B * H;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* hprev =
        s == 0 ? nullptr : hseq + (reverse ? t + 1 : t - 1) * BH;
    gru_f32::gru_f32_step_kernel<<<grid, fp32_tile::THREADS, 0, stream>>>(
        gx + t * 3 * BH, hprev, lens, t, uh, bhn, B, H, hseq + t * BH,
        s == T - 1 ? hT : nullptr);
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
