// K4f `attention_resident_fwd_f32`: the gather-free attention forward with
// G glimpses (1 <= G <= 8) in float32, over a feature store resident in
// device memory, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention_resident.py::
// _make_fwd_kernel_multi (the Pallas body launched by _resident_fwd_multi)
// when the store computes in float32: the TPU kernel runs in the store's
// dtype (float32 in model.dtype float32 and in model.fidelity_mode, where
// the model's other ops run plain), and K4 (attention_resident_fwd.cu)
// takes only bf16 rows. The same function as K4's plain version
// attention_resident_fwd_reference in float32:
//
//   v       = store[rows[b]]                      [Np, C], widened to f32
//   r       = 1 / sqrt(sum_c v^2 + 1e-12)         (1 when !normalize)
//   h       = relu((v @ W_v) * r + qh[b])         [Np, H] f32; saved on ask
//   s_g     = h . ws_g, -1e30 at cells >= n_valid (each glimpse)
//   alpha_g = softmax_Np(s_g)
//   v_att_g = sum_n (alpha_gn r_n) v_n            (concatenated in g order)
//
// on rows of f32, f16 or int8 codes (widened exactly as they load,
// store_rows_f32.cuh), in FFMA with f32 sums: no TF32 or bf16 pass, as the
// path exists to meet a float64 oracle at 1e-4.
//
// What bounds it on an H100: at B=256, n_valid=196 (Np=200), C=2048, H=512
// the score product over the valid cells is 2 x 50176 x 2048 x 512 = 105.2
// GFLOP of f32 FFMA (1.6 ms at 67 TFLOP/s; this kernel also runs it over
// the 4 padded cells of each row, 107.4 GFLOP in all); its reads (420 MB
// of f32 rows, 210 MB of f16) and the 105 MB of saved h take 0.16 ms at
// 3.35 TB/s: the FP32 pipes.
//
// Design, three launches in stream order (two without normalize):
//  1. (normalize only) attn_f32_rnorm_kernel: a warp a cell, r for every
//     cell of the batch;
//  2. attn_f32_score_kernel: the [B*Np, C] x [C, H] score product on
//     fp32_tile.cuh's tile loop, 128 cells x 128 units a block, reading
//     each cell's row straight out of the store (CellRows) in place of the
//     TPU's scalar prefetch, 8-channel chunks, two blocks an SM (128
//     registers a thread; 16-channel chunks ran 1.9x slower on an H100,
//     PERF.md). Its epilogue forms h from the accumulators (saved in f32
//     when asked) and the G partial scores of each cell over
//     the block's 128 units (a fixed xor tree across the 16 threads of a
//     row), written per unit tile: part [H/128, G, B*Np];
//  3. attn_f32_wsum_kernel: a block a (question, 256-channel chunk) sums
//     the partial scores in tile order, takes the G masked softmaxes in
//     shared memory (a warp a glimpse) and forms the G weighted sums in one
//     pass over the question's rows, a thread a channel.
// No atomics and no split sums: two calls give the same bits.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fp32_tile.cuh"
#include "store_rows_f32.cuh"

namespace {

constexpr int TILE = 128;  // cells and units of a score tile
constexpr int CHUNK = 8;  // channels of a k-chunk of the score product
constexpr int MAXG = 8;  // glimpses
constexpr int WSUM_CHANNELS = 256;  // channels of a weighted-sum block

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(256)
    attn_f32_rnorm_kernel(const T* __restrict__ store,
                          const int* __restrict__ rows,
                          float* __restrict__ rnorm, int cells, int Np,
                          int C) {
  const int i = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (i >= cells) return;
  const int b = i / Np;
  const T* v = rows_f32::row(store, rows, b, i - b * Np, Np, C);
  float ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float x = rows_f32::widen(v[c]);
    ss = fmaf(x, x, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) rnorm[i] = 1.f / sqrtf(ss + 1e-12f);
}

template <typename T>
__global__ void __launch_bounds__(fp32_tile::THREADS, 2)
    attn_f32_score_kernel(const T* __restrict__ store,
                          const int* __restrict__ rows,
                          const float* __restrict__ wv,
                          const float* __restrict__ qh,
                          const float* __restrict__ ws,
                          const float* __restrict__ rnorm,
                          float* __restrict__ part, float* __restrict__ hsave,
                          int cells, int Np, int C, int H, int G) {
  __shared__ fp32_tile::Smem<TILE, TILE, CHUNK> s;
  constexpr int T8 = TILE / 16;
  float acc[T8][T8] = {};
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  fp32_tile::mainloop<TILE, TILE, CHUNK, true, false>(
      rows_f32::CellRows<T>{store, rows, Np, C}, fp32_tile::Dense{wv, H}, cells,
      H, m0, n0, 0, C, acc, s);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < T8; ++i) {
    const int m = m0 + ty * T8 + i;
    const bool ok = m < cells;
    const int b = ok ? m / Np : 0;
    const float r = (rnorm != nullptr && ok) ? rnorm[m] : 1.f;
    float sc[MAXG] = {};
#pragma unroll
    for (int j = 0; j < T8; ++j) {
      const int n = n0 + tx * T8 + j;
      if (!ok || n >= H) continue;
      const float h = fmaxf(
          __fadd_rn(__fmul_rn(acc[i][j], r), qh[(long long)b * H + n]), 0.f);
      if (hsave != nullptr) hsave[(long long)m * H + n] = h;
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) sc[g] = fmaf(h, ws[g * H + n], sc[g]);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      for (int off = 8; off; off >>= 1)
        sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], off);
    }
    if (tx == 0 && ok)
      for (int g = 0; g < G; ++g)
        part[((long long)blockIdx.x * G + g) * cells + m] = sc[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(WSUM_CHANNELS)
    attn_f32_wsum_kernel(const T* __restrict__ store,
                         const int* __restrict__ rows,
                         const float* __restrict__ part,
                         const float* __restrict__ rnorm,
                         float* __restrict__ alpha, float* __restrict__ vatt,
                         int B, int Np, int n_valid, int C, int n_tiles,
                         int G) {
  extern __shared__ float w[];  // [Np, G]: scores, then alpha * r
  const int b = blockIdx.y, tid = threadIdx.x;
  const long long cells = (long long)B * Np, base = (long long)b * Np;
  for (int idx = tid; idx < Np * G; idx += WSUM_CHANNELS) {
    const int n = idx / G, g = idx - n * G;
    float sc = 0.f;
    for (int t = 0; t < n_tiles; ++t)
      sc += part[((long long)t * G + g) * cells + base + n];
    w[idx] = n < n_valid ? sc : -1e30f;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  if (warp < G) {
    const int g = warp;
    float mx = -INFINITY;
    for (int n = lane; n < Np; n += 32) mx = fmaxf(mx, w[n * G + g]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int n = lane; n < Np; n += 32) {
      const float p = expf(w[n * G + g] - mx);
      w[n * G + g] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int n = lane; n < Np; n += 32) {
      const float a = w[n * G + g] / sum;
      if (blockIdx.x == 0) alpha[(base + n) * G + g] = a;
      w[n * G + g] = rnorm != nullptr ? __fmul_rn(a, rnorm[base + n]) : a;
    }
  }
  __syncthreads();
  const int c = blockIdx.x * WSUM_CHANNELS + tid;
  if (c >= C) return;
  float acc[MAXG] = {};
  for (int n = 0; n < n_valid; ++n) {  // cells past n_valid weigh 0
    const float x =
        rows_f32::widen(rows_f32::row(store, rows, b, n, Np, C)[c]);
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc[g] = fmaf(w[n * G + g], x, acc[g]);
  }
  for (int g = 0; g < G; ++g) vatt[((long long)b * G + g) * C + c] = acc[g];
}

template <typename T>
int run(const T* store, const int* rows, const float* wv, const float* qh,
        const float* ws, float* part, float* rnorm, float* hsave, float* vatt,
        float* alpha, int B, int Np, int n_valid, int C, int H, int G,
        int normalize, cudaStream_t stream, int* launched) {
  const int cells = B * Np;
  cudaError_t err;
  if (normalize) {
    attn_f32_rnorm_kernel<T><<<(cells + 7) / 8, 256, 0, stream>>>(
        store, rows, rnorm, cells, Np, C);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  const float* rn = normalize ? rnorm : nullptr;
  const int n_tiles = (H + TILE - 1) / TILE;
  attn_f32_score_kernel<T>
      <<<dim3(n_tiles, (cells + TILE - 1) / TILE), fp32_tile::THREADS, 0,
         stream>>>(store, rows, wv, qh, ws, rn, part, hsave, cells, Np, C, H,
                   G);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  attn_f32_wsum_kernel<T>
      <<<dim3((C + WSUM_CHANNELS - 1) / WSUM_CHANNELS, B), WSUM_CHANNELS,
         Np * G * sizeof(float), stream>>>(store, rows, part, rn, alpha, vatt,
                                           B, Np, n_valid, C, n_tiles, G);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// store [M, Np, C] of f32 (row_type 0), f16 (1) or int8 codes (2; then
// normalize must be 0), rows [B] i32 (< M, checked by the caller), wv
// [C, H] f32, qh [B, H] f32, ws [G, H] f32 (1 <= G <= 8) -> vatt [B, G, C]
// f32, alpha [B, Np, G] f32 (0 at cells >= n_valid), and h [B, Np, H] f32
// when hsave is not null. Scratch: part [ceil(H/128), G, B*Np] f32, rnorm
// [B*Np] f32. Np * G * 4 bytes of shared memory (the caller keeps it
// within 48 KB). Two launches (three with normalize) on `stream`, added to
// *launched.
int attention_resident_fwd_f32(const void* store, const int* rows,
                               const float* wv, const float* qh,
                               const float* ws, float* part, float* rnorm,
                               float* hsave, float* vatt, float* alpha, int B,
                               int Np, int n_valid, int C, int H, int G,
                               int normalize, int row_type,
                               cudaStream_t stream, int* launched) {
  if (G < 1 || G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  switch (row_type) {
    case 0:
      return run(static_cast<const float*>(store), rows, wv, qh, ws, part,
                 rnorm, hsave, vatt, alpha, B, Np, n_valid, C, H, G,
                 normalize, stream, launched);
    case 1:
      return run(static_cast<const __half*>(store), rows, wv, qh, ws, part,
                 rnorm, hsave, vatt, alpha, B, Np, n_valid, C, H, G,
                 normalize, stream, launched);
    case 2:
      return run(static_cast<const int8_t*>(store), rows, wv, qh, ws, part,
                 rnorm, hsave, vatt, alpha, B, Np, n_valid, C, H, G,
                 normalize, stream, launched);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
