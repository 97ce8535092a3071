// attention_f32.cuh: the float32 attention forward with G glimpses
// (1 <= G <= 8) over a source of cell rows, the three launches of K4f
// (attention_resident_fwd_f32.cu: a resident store's rows through their
// row index) and of K2f (attention_fwd_f32.cu: a dense gathered grid, one
// glimpse), for Hopper (sm_90a).
//
// For each question b of B, over its Np cells (n_valid of them live):
//
//   r       = 1 / sqrt(sum_c v^2 + 1e-12)         (1 when !normalize)
//   h       = relu((v @ W_v) * r + qh[b])         [Np, H] f32; saved on ask
//   s_g     = h . ws_g, -1e30 at cells >= n_valid (each glimpse)
//   alpha_g = softmax_Np(s_g)
//   v_att_g = sum_n (alpha_gn r_n) v_n            (concatenated in g order)
//
// in FFMA with f32 sums: no TF32 or bf16 pass. The row source `Cells`
// (store_rows_f32.cuh: CellRows over a store, GridCells over a dense grid)
// gives cells.cell(i), the row of cell i of the batch (question i / Np),
// and cells.row(b, n), the row of cell n of question b; f16 rows and int8
// codes are widened to f32 exactly.
//
// Three launches in stream order (two without normalize):
//  1. (normalize only) attn_f32_rnorm_kernel: a warp a cell, r for every
//     cell of the batch;
//  2. attn_f32_score_ring_kernel: the [B*Np, C] x [C, H] score product on
//     fp32_ring.cuh's tile loop, 128 cells x 128 units a block, each
//     cell's row found once and copied into the cp.async ring as it is
//     stored, 16-channel chunks, two blocks an SM; the copy widths come from
//     the wrapper's plan (ops/kernels.py::f32_ring_plan: 16 bytes where a
//     row's pitch allows, else 8, 4 or element by element). The A rows are
//     K-major (a cell's channels contiguous): they land [cell][channel] in
//     the ring and each thread widens and transposes what it copied into
//     the [channel][cell] f32 slot the products read. Its epilogue, in the
//     accumulators (thread (ty, tx) holds cells ty*8 .. and units tx*8 ..),
//     forms h (saved in f32 when asked) and
//     the G partial scores of each cell over the block's 128 units (a
//     thread's 8 units in order, then a fixed xor tree across the 16
//     threads of a row), written per unit tile: part [H/128, G, B*Np];
//  3. attn_f32_wsum_kernel: a block a (question, 256-channel chunk) sums
//     the partial scores in tile order, takes the G masked softmaxes in
//     shared memory (a warp a glimpse) and forms the G weighted sums in one
//     pass over the question's rows, a thread a channel.
// No atomics and no split sums: two calls give the same bits.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fp32_ring.cuh"
#include "store_rows_f32.cuh"

namespace {

constexpr int TILE = fp32_ring::TILE;  // cells and units of a score tile
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

template <class Cells>
__global__ void __launch_bounds__(256)
    attn_f32_rnorm_kernel(Cells cells_in, float* __restrict__ rnorm,
                          int cells, int Np, int C) {
  const int i = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (i >= cells) return;
  const int b = i / Np;
  const auto* v = cells_in.row(b, i - b * Np);
  float ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float x = rows_f32::widen(v[c]);
    ss = fmaf(x, x, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) rnorm[i] = 1.f / sqrtf(ss + 1e-12f);
}

template <class Cells, int WA, int WB>
__global__ void __launch_bounds__(fp32_ring::THREADS, 2)
    attn_f32_score_ring_kernel(Cells cells_in, const float* __restrict__ wv,
                               const float* __restrict__ qh,
                               const float* __restrict__ ws,
                               const float* __restrict__ rnorm,
                               float* __restrict__ part,
                               float* __restrict__ hsave, int cells, int Np,
                               int H, int C, int G, int wa, int wb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int T8 = TILE / 16;
  float acc[T8][T8] = {};
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  fp32_ring::mainloop<typename Cells::elem, true, WA, WB>(
      cells_in, wv, H, cells, H, m0, n0, 0, C, wa, wb, acc, smem);
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

template <class Cells>
__global__ void __launch_bounds__(WSUM_CHANNELS)
    attn_f32_wsum_kernel(Cells cells_in, const float* __restrict__ part,
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
    const float x = rows_f32::widen(cells_in.row(b, n)[c]);
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc[g] = fmaf(w[n * G + g], x, acc[g]);
  }
  for (int g = 0; g < G; ++g) vatt[((long long)b * G + g) * C + c] = acc[g];
}

// The forward over `cells_in`: wv [C, H] f32, qh [B, H] f32, ws [G, H] f32
// -> vatt [B, G, C] f32, alpha [B, Np, G] f32 (0 at cells >= n_valid), and
// h [B, Np, H] f32 when hsave is not null; rnorm [B*Np] f32 holds r when
// normalize. Scratch: part [ceil(H/128), G, B*Np] f32. The score launch's
// plan (copy widths wa and wb in bytes, stages, shared bytes) is the
// wrapper's ops/kernels.py::f32_ring_plan, refused with
// cudaErrorInvalidValue where the rows' or W_v's alignment does not allow
// it. Np * G * 4 bytes of shared memory for the softmaxes, past 48 KB
// opted into (the caller keeps it within the card's limit). Two launches
// (three with normalize) on `stream`, added to *launched.
template <class Cells>
int attn_f32_fwd(const Cells& cells_in, const float* wv, const float* qh,
                 const float* ws, float* part, float* rnorm, float* hsave,
                 float* vatt, float* alpha, int B, int Np, int n_valid, int C,
                 int H, int G, int normalize, int wa, int wb, int stages,
                 int smem_score, cudaStream_t stream, int* launched) {
  using T = typename Cells::elem;
  if (G < 1 || G > MAXG ||
      !fp32_ring::plan_ok<T, true>(wa, wb, stages, smem_score,
                                   cells_in.base(), (long long)C * sizeof(T),
                                   wv, (long long)H * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cells = B * Np;
  cudaError_t err;
  if (normalize) {
    attn_f32_rnorm_kernel<Cells><<<(cells + 7) / 8, 256, 0, stream>>>(
        cells_in, rnorm, cells, Np, C);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  const float* rn = normalize ? rnorm : nullptr;
  const int n_tiles = (H + TILE - 1) / TILE;
  err = fp32_ring::by_plan(wa, wb, [&](auto fa, auto fb) {
    auto* kernel = attn_f32_score_ring_kernel<Cells, decltype(fa)::value,
                                              decltype(fb)::value>;
    cudaError_t e = fp32_ring::opt_in(kernel, smem_score);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(n_tiles, (cells + TILE - 1) / TILE), fp32_ring::THREADS,
             smem_score, stream>>>(cells_in, wv, qh, ws, rn, part, hsave,
                                   cells, Np, H, C, G, wa, wb);
    ++*launched;
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(Np) * G * sizeof(float);
  if (smem > 48 * 1024 &&  // past the default: opt in, up to the card's
      (err = cudaFuncSetAttribute(attn_f32_wsum_kernel<Cells>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  attn_f32_wsum_kernel<Cells>
      <<<dim3((C + WSUM_CHANNELS - 1) / WSUM_CHANNELS, B), WSUM_CHANNELS,
         smem, stream>>>(cells_in, part, rn, alpha, vatt, B, Np, n_valid, C,
                         n_tiles, G);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
