// K6f `bigru_fwd_f32`: both recurrences of a bidirectional GRU in float32,
// advanced together, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_bigru_fwd_kernel (the
// Pallas body launched by _bigru_pallas_fwd_call) when the model computes
// in float32 (model.dtype float32): the TPU kernel takes U_h in the model's
// dtype, and K6 (bigru_fwd.cu) takes only bf16. The same function as K6's
// plain version bigru_reference on float32 U_h: step s advances the forward
// chain at t = s and the backward chain at t = T-1-s, both under the prefix
// mask t < lens[b], so the backward chain carries the zero state through
// each row's padded tail first.
//
// What bounds it on an H100: at B=256, H=512, T=26 the hidden products
// after each row's first step are at most 2 x 25 x 2 x 256 x 512 x 1536 =
// 20.1 GFLOP of f32 FFMA for both chains (0.30 ms at 67 TFLOP/s; the bound
// counts the carried row-steps of this run's lengths), against 82 MB of gx,
// hseq and U_h reads and writes: the FP32 pipes, and the T dependent steps.
//
// Design: K1f's step (gru_step_f32.cuh) with the direction on blockIdx.z:
// one launch a step advances both chains (64 rows x 16 units a block, 256
// blocks at B=256, H=512), each with its own gx, U_h, b_hn, hseq and hT.
// The launch boundary is the step's barrier for both. T launches a call,
// against 2T for two K1f calls. Each chain runs K1f's arithmetic on its
// inputs, so each direction equals a K1f call bit for bit.

#include <cuda_runtime.h>

#include "gru_step_f32.cuh"

namespace {

// One direction's operands.
struct Chain {
  const float* gx;  // [T, B, 3H]
  const float* uh;  // [H, 3H]
  const float* bhn;  // [H]
  float* hseq;  // [T, B, H]
  float* hT;  // [B, H]
};

// Step s of both chains: blockIdx.z 0 the forward chain at t = s, 1 the
// backward chain at t = T-1-s.
__global__ void __launch_bounds__(fp32_tile::THREADS)
    bigru_f32_step_kernel(Chain fwd, Chain bwd, const int* __restrict__ lens,
                          int s, int T, int B, int H) {
  __shared__ fp32_tile::Smem<gru_f32::BM, gru_f32::BN, gru_f32::BK> sm;
  const bool rev = blockIdx.z == 1;
  const Chain c = rev ? bwd : fwd;
  const int t = rev ? T - 1 - s : s;
  const long long BH = (long long)B * H;
  const float* hprev =
      s == 0 ? nullptr : c.hseq + (rev ? t + 1 : t - 1) * BH;
  gru_f32::step<false>(c.gx + t * 3 * BH, hprev, lens, t, c.uh, c.bhn, B, H,
                       c.hseq + t * BH, s == T - 1 ? c.hT : nullptr, nullptr,
                       nullptr, nullptr, nullptr, sm);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gxf, gxb [T, B, 3H] f32, lens [B] i32, uhf, uhb [H, 3H] f32, bhnf, bhnb
// [H] f32 -> hseq [2, T, B, H] f32 and hT [2, B, H] f32 (the forward chain
// first). One launch a step on `stream`; the number launched is added to
// *launched.
int bigru_fwd_f32(const float* gxf, const float* gxb, const int* lens,
                  const float* uhf, const float* uhb, const float* bhnf,
                  const float* bhnb, float* hseq, float* hT, int T, int B,
                  int H, cudaStream_t stream, int* launched) {
  const dim3 grid((H + gru_f32::UNITS - 1) / gru_f32::UNITS,
                  (B + gru_f32::BM - 1) / gru_f32::BM, 2);
  const long long BH = (long long)B * H;
  const Chain fwd{gxf, uhf, bhnf, hseq, hT};
  const Chain bwd{gxb, uhb, bhnb, hseq + T * BH, hT + BH};
  for (int s = 0; s < T; ++s) {
    bigru_f32_step_kernel<<<grid, fp32_tile::THREADS, 0, stream>>>(
        fwd, bwd, lens, s, T, B, H);
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
