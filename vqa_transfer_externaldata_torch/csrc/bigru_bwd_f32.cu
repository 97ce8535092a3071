// K7f `bigru_bwd_f32`: the BPTT of both chains of K6f's float32
// bidirectional recurrence, walked together, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_bigru_bwd_kernel (the
// Pallas body launched by _bigru_pallas_bwd_call) when the model computes
// in float32: the TPU kernel takes U_h in the model's dtype, and K7
// (bigru_bwd.cu) takes only bf16. The same function as bigru_bwd_reference
// on float32 U_h: step s walks the forward chain's BPTT down actual time
// (t = T-1-s, pre-step state hseqf[t-1], zero at t = 0) and the backward
// chain's up (t = s, pre-step state hseqb[t+1], zero at t = T-1); then each
// chain's dU_h (over every step's h_prev^T g_t) and db_hn.
//
// What bounds it on an H100: at B=256, H=512, T=26 each chain recomputes
// its hidden products, carries dh through U_h^T and forms dU_h, each at
// most 10.1 GFLOP over the 25 x 256 row-steps whose carry is not the zero
// start: 60.4 GFLOP of f32 FFMA for both (0.90 ms at 67 TFLOP/s; the bound
// counts this run's carried row-steps), against ~200 MB of reads and
// writes: the FP32 pipes, and the T dependent steps.
//
// Design: K3f's launches (csrc/gru_bwd_f32.cu) with the direction on
// blockIdx.z (blockIdx.y for db_hn), in stream order:
//  1. a step: gru_step_f32.cuh's step in its BPTT form for both chains
//     (64 rows x 16 units a block), each writing its dgx_t, g_t and the
//     part of dh_prev that skips U_h;
//  2. then (but after the last step) both chains' dh_prev = that part +
//     g_t @ U_h^T on fp32_tile.cuh's pair_product_kernel, 32 x 32 outputs a
//     block, into the other half of each chain's ping-pong dh;
//  3. after the steps, both chains' dU_h = h_prev^T g over the (T-1) B rows
//     whose h_prev is not the zero start, in one pair_product_kernel
//     launch, 64 x 64 outputs a block;
//  4. both chains' db_hn in one launch of gru_step_f32.cuh's sum.
// 2T + 1 launches a call, against 4T + 2 for two K3f calls. Each chain's
// sums are K3f's, in K3f's order, so each direction equals a K3f call bit
// for bit. No atomics: two calls give the same bits.

#include <cuda_runtime.h>

#include "gru_step_f32.cuh"

namespace {

// One direction's operands and scratch.
struct Chain {
  const float* gx;  // [T, B, 3H]
  const float* hseq;  // [T, B, H], K6f's
  const float* uh;  // [H, 3H]
  const float* bhn;  // [H]
  float* dh;  // [2, B, H] ping-pong, dh[0] the cotangent of hT on entry
  float* dpart;  // [B, H]
  float* gq;  // [T, B, 3H]
  float* dgx;  // [T, B, 3H]
};

// Step s of both chains' BPTT: blockIdx.z 0 the forward chain at
// t = T-1-s, 1 the backward chain at t = s.
__global__ void __launch_bounds__(fp32_tile::THREADS)
    bigru_f32_bptt_kernel(Chain fwd, Chain bwd, const int* __restrict__ lens,
                          int s, int T, int B, int H) {
  __shared__ fp32_tile::Smem<gru_f32::BM, gru_f32::BN, gru_f32::BK> sm;
  const bool rev = blockIdx.z == 1;
  const Chain c = rev ? bwd : fwd;
  const int t = rev ? s : T - 1 - s;
  const bool first = rev ? t == T - 1 : t == 0;
  const long long BH = (long long)B * H, BH3 = 3 * BH;
  const float* hprev =
      first ? nullptr : c.hseq + (rev ? t + 1 : t - 1) * BH;
  gru_f32::step<true>(c.gx + t * BH3, hprev, lens, t, c.uh, c.bhn, B, H,
                      nullptr, nullptr, c.dh + (s % 2) * BH, c.dgx + t * BH3,
                      c.gq + t * BH3, c.dpart, sm);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gxf, gxb [T, B, 3H], hseqf, hseqb [T, B, H] (K6f's), lens [B] i32, uhf,
// uhb [H, 3H], bhnf, bhnb [H] f32; dh [2, 2, B, H] f32 with dh[d][0] = the
// cotangent of chain d's hT (overwritten; the forward chain first); scratch
// dpart [2, B, H], gq [2, T, B, 3H] -> dgx [2, T, B, 3H], duh [2, H, 3H],
// dbhn [2, H], all f32. 2T + 1 launches on `stream`, added to *launched.
int bigru_bwd_f32(const float* gxf, const float* gxb, const float* hseqf,
                  const float* hseqb, const int* lens, const float* uhf,
                  const float* uhb, const float* bhnf, const float* bhnb,
                  float* dh, float* dpart, float* gq, float* dgx, float* duh,
                  float* dbhn, int T, int B, int H, cudaStream_t stream,
                  int* launched) {
  using fp32_tile::Dense;
  using fp32_tile::DenseT;
  const long long BH = (long long)B * H, H3 = 3LL * H, BH3 = 3 * BH;
  const Chain fwd{gxf, hseqf, uhf, bhnf, dh, dpart, gq, dgx};
  const Chain bwd{gxb, hseqb, uhb, bhnb, dh + 2 * BH, dpart + BH,
                  gq + T * BH3, dgx + T * BH3};
  const dim3 step_grid((H + gru_f32::UNITS - 1) / gru_f32::UNITS,
                       (B + gru_f32::BM - 1) / gru_f32::BM, 2);
  constexpr int DH_TILE = 32, DUH_TILE = 64;
  const dim3 dh_grid((H + DH_TILE - 1) / DH_TILE,
                     (B + DH_TILE - 1) / DH_TILE, 2);
  cudaError_t err;
  for (int s = 0; s < T; ++s) {
    bigru_f32_bptt_kernel<<<step_grid, fp32_tile::THREADS, 0, stream>>>(
        fwd, bwd, lens, s, T, B, H);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    if (s == T - 1) break;  // the chains' starts: no dh_prev is read
    const int tf = T - 1 - s, tb = s;
    fp32_tile::pair_product_kernel<DH_TILE, DH_TILE, 32, true, true>
        <<<dh_grid, fp32_tile::THREADS, 0, stream>>>(
            Dense{fwd.gq + tf * BH3, H3}, DenseT{uhf, H3}, fwd.dpart,
            fwd.dh + ((s + 1) % 2) * BH, Dense{bwd.gq + tb * BH3, H3},
            DenseT{uhb, H3}, bwd.dpart, bwd.dh + ((s + 1) % 2) * BH, B, H,
            int(H3), H);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  // Rows of live h_prev: forward, hseqf[0 .. T-2] against g[1 .. T-1];
  // backward, hseqb[1 .. T-1] against g[0 .. T-2].
  const int K = (T - 1) * B;
  const dim3 duh_grid((3 * H + DUH_TILE - 1) / DUH_TILE,
                      (H + DUH_TILE - 1) / DUH_TILE, 2);
  fp32_tile::pair_product_kernel<DUH_TILE, DUH_TILE, 16, false, false>
      <<<duh_grid, fp32_tile::THREADS, 0, stream>>>(
          DenseT{hseqf, H}, Dense{fwd.gq + BH3, H3}, nullptr, duh,
          DenseT{hseqb + BH, H}, Dense{bwd.gq, H3}, nullptr, duh + H * H3, H,
          3 * H, K, H3);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gru_f32::gru_f32_dbhn_kernel<<<dim3((H + 31) / 32, 2),
                                 dim3(32, gru_f32::SUM_ROWS), 0, stream>>>(
      fwd.gq, dbhn, bwd.gq, dbhn + H, T * B, H);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
