// K3f `gru_bwd_f32`: the BPTT of K1f's float32 recurrence, for Hopper
// (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_bwd_kernel (the
// Pallas body launched by _gru_fused_bwd) when the model computes in
// float32: the TPU kernel takes U_h in the model's dtype, and K3
// (gru_bwd.cu) takes only bf16. The same function as gru_bwd_reference on
// float32 U_h: from the carried dh, each step's dgx_t, and the sums dU_h
// (over every step's h_prev^T g_t) and db_hn, which the TPU kernel forms
// in its own body and so does this kernel, not a library call.
//
// What bounds it on an H100: at B=256, H=512, T=26 it recomputes the
// hidden products, carries dh through U_h^T and forms dU_h, each at most
// 10.1 GFLOP over the 25 x 256 row-steps whose carry is not the zero
// start: 30.2 GFLOP of f32 FFMA, 0.45 ms at 67 TFLOP/s, against ~100 MB
// of reads and writes: the FP32 pipes, and the T dependent steps.
//
// Design, all on fp32_tile.cuh's tile loop, launches in stream order (the
// launch boundary is each step's barrier):
//  1. a step (t from the chain's end): gru_step_f32.cuh's step kernel in
//     its BPTT form recomputes gh = h_prev @ U_h for 64 rows x 16 units a
//     block and writes dgx_t, g_t = (da_r, da_z, dgh_n) and the part of
//     dh_prev that skips U_h;
//  2. then (but after the last step) dh_prev = that part + g_t @ U_h^T,
//     32 x 32 outputs a block, into the other half of the ping-pong dh;
//  3. after the steps, dU_h = h_prev^T g over the (T-1) B rows whose h_prev
//     is not the zero start (the rows of the chain's first step add
//     nothing): hseq and g read in place, shifted by one step, 64 x 64
//     outputs a block, each sum over all rows in order;
//  4. db_hn = the column sums of g's n-gate block over the T B rows, eight
//     row strides a unit added in a fixed order (gru_step_f32.cuh).
// 2T + 1 launches a call. No atomics: two calls give the same bits.

#include <cuda_runtime.h>

#include "gru_step_f32.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gx [T, B, 3H], hseq [T, B, H] (K1f's), lens [B] i32, uh [H, 3H], bhn [H]
// f32; dh [2, B, H] f32 with dh[0] = the cotangent of hT (overwritten);
// scratch dpart [B, H], gq [T, B, 3H] -> dgx [T, B, 3H], duh [H, 3H], dbhn
// [H], all f32. 2T + 1 launches on `stream`, added to *launched.
int gru_bwd_f32(const float* gx, const float* hseq, const int* lens,
                const float* uh, const float* bhn, float* dh, float* dpart,
                float* gq, float* dgx, float* duh, float* dbhn, int T, int B,
                int H, int reverse, cudaStream_t stream, int* launched) {
  const long long BH = (long long)B * H, H3 = 3LL * H;
  const dim3 step_grid((H + gru_f32::UNITS - 1) / gru_f32::UNITS,
                       (B + gru_f32::BM - 1) / gru_f32::BM);
  constexpr int DH_TILE = 32, DUH_TILE = 64;
  const dim3 dh_grid((H + DH_TILE - 1) / DH_TILE, (B + DH_TILE - 1) / DH_TILE);
  cudaError_t err;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const bool first = reverse ? t == T - 1 : t == 0;
    const float* hprev =
        first ? nullptr : hseq + (reverse ? t + 1 : t - 1) * BH;
    float* dcur = dh + (s % 2) * BH;
    gru_f32::gru_f32_step_kernel<true><<<step_grid, fp32_tile::THREADS, 0,
                                         stream>>>(
        gx + t * B * H3, hprev, lens, t, uh, bhn, B, H, nullptr, nullptr,
        dcur, dgx + t * B * H3, gq + t * B * H3, dpart);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    if (s == T - 1) break;  // the chain's start: no dh_prev is read
    fp32_tile::product_kernel<DH_TILE, DH_TILE, 32, true, true>
        <<<dh_grid, fp32_tile::THREADS, 0, stream>>>(
            fp32_tile::Dense{gq + t * B * H3, H3},
            fp32_tile::DenseT{uh, H3}, B, H, int(H3), int(H3), dpart,
            dh + ((s + 1) % 2) * BH, H);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  // Rows of live h_prev: forward, hseq[0 .. T-2] against g[1 .. T-1];
  // reverse, hseq[1 .. T-1] against g[0 .. T-2].
  const float* hp = hseq + (reverse ? BH : 0);
  const float* gp = gq + (reverse ? 0 : B * H3);
  const int K = (T - 1) * B;
  const dim3 duh_grid((3 * H + DUH_TILE - 1) / DUH_TILE,
                      (H + DUH_TILE - 1) / DUH_TILE);
  fp32_tile::product_kernel<DUH_TILE, DUH_TILE, 16, false, false>
      <<<duh_grid, fp32_tile::THREADS, 0, stream>>>(
          fp32_tile::DenseT{hp, H}, fp32_tile::Dense{gp, H3}, H, 3 * H, K, K,
          nullptr, duh, H3);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gru_f32::gru_f32_dbhn_kernel<<<(H + 31) / 32, dim3(32, gru_f32::SUM_ROWS),
                                 0, stream>>>(gq, dbhn, nullptr, nullptr,
                                              T * B, H);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
