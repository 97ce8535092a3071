// The dW_v stage shared by the two attention backwards, K5
// (attention_resident_bwd.cu) and K8 (attention_bwd.cu):
//
//   dW_v = sum over cells kk of v(kk)^T dzr[kk]      [C, H], f32
//
// where dzr [K, H] holds bf16(dz * r) of each cell, written compactly by the
// kernel's first stage, and v(kk) is the cell's [C] feature row: a row of
// the resident store looked up per cell (K5, StoreCells: bf16 values or
// int8 codes, widened to bf16 as they are staged into shared memory) or a
// row of the gathered bf16 grid (K8, DenseCells).
//
// dwv_kernel: blocks own 128 x 128 tiles of dW_v and a fixed slice of the
// cells (split over K, so that the 64 tiles of C=2048, H=512 fill the
// card); bf16 WMMA with the next k-step's tiles loaded into registers during
// the MMAs. Each block writes its own partial tile. reduce_kernel then sums
// the partials over the splits and the per-question dws partials (one row
// of W values each: H, or G * H for K5's G glimpses) over the questions,
// both in a fixed order: no atomics, so the result does not depend on the
// schedule.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "store_rows.cuh"

namespace {

namespace attn_dwv {

using namespace nvcuda;

constexpr int kTM = 128;  // dW_v rows (channels) per block
constexpr int kTN = 128;  // dW_v columns (hidden units) per block
constexpr int kTK = 32;   // cells per k-step
constexpr int kLd = kTM + 8;
constexpr int kGemmThreads = 256;  // 8 warps: 4 (channels) x 2 (hidden)
constexpr int kReduceThreads = 256;

// Cell kk = b * n_valid + n is cell n of store row rows[b] ([M, Np, C] of
// T: bf16, or int8 codes).
template <class T>
struct StoreCells {
  using value_type = T;
  const T* store;
  const int* rows;
  int n_valid, Np, C;
  __device__ const T* operator()(int kk) const {
    const int b = kk / n_valid;
    const int n = kk - b * n_valid;
    return store + (static_cast<size_t>(rows[b]) * Np + n) * C;
  }
};

// Cell kk is row kk of a gathered [K, C] grid.
struct DenseCells {
  using value_type = __nv_bfloat16;
  const __nv_bfloat16* v;
  int C;
  __device__ const __nv_bfloat16* operator()(int kk) const {
    return v + static_cast<size_t>(kk) * C;
  }
};

// part[s] = sum over cells kk in split s of v(kk)^T dzr[kk], one 128 x 128
// tile of [C, H] per block.
template <class Cells>
__global__ void __launch_bounds__(kGemmThreads)
dwv_kernel(Cells cells, const __nv_bfloat16* __restrict__ dzr,  // [K, H]
           float* __restrict__ part,                            // [S, C, H]
           int K, int C, int H, int per_split) {
  __shared__ __align__(128) __nv_bfloat16 As[kTK * kLd];  // [cell][c]
  __shared__ __align__(128) __nv_bfloat16 Bs[kTK * kLd];  // [cell][h]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // channels wr*32 .. +32
  const int wc = warp & 1;   // hidden units wc*64 .. +64
  const int c0 = blockIdx.x * kTM;
  const int h0 = blockIdx.y * kTN;
  const int k_begin = blockIdx.z * per_split;
  const int k_end = min(K, k_begin + per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // Each thread stages rows lr and lr + 16 of both tiles, 8 values each,
  // the cells' values held as loaded until they are stored.
  const int lr = tid >> 4;
  const int lc = (tid & 15) * 8;
  store_rows::raw8_t<typename Cells::value_type> a4[2];
  uint4 b4[2];
  auto load = [&](int kbase) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kk = kbase + lr + 16 * i;
      a4[i] = {};
      b4[i] = make_uint4(0u, 0u, 0u, 0u);
      if (kk < k_end) {
        a4[i] = store_rows::load_raw8(cells(kk) + c0 + lc);
        b4[i] = *reinterpret_cast<const uint4*>(
            dzr + static_cast<size_t>(kk) * H + h0 + lc);
      }
    }
  };

  if (k_begin < k_end) load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(&As[(lr + 16 * i) * kLd + lc]) =
          store_rows::widen8(a4[i]);
      *reinterpret_cast<uint4*>(&Bs[(lr + 16 * i) * kLd + lc]) = b4[i];
    }
    __syncthreads();
    if (k0 + kTK < k_end) load(k0 + kTK);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> af[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(af[i], &As[kk * kLd + wr * 32 + i * 16], kLd);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, &Bs[kk * kLd + wc * 64 + j * 16], kLd);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bf,
                                                   acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.z) * C * H;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(
          out + static_cast<size_t>(c0 + wr * 32 + i * 16) * H + h0 +
              wc * 64 + j * 16,
          acc[i][j], H, wmma::mem_row_major);
}

__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ part,      // [S, C*H]
              const float* __restrict__ dws_part,  // [B, W]
              float* __restrict__ dwv,             // [C*H]
              float* __restrict__ dws,             // [W]
              int splits, int CH, int B, int W) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i < CH) {
    float s = 0.0f;
    for (int p = 0; p < splits; ++p) s += part[static_cast<size_t>(p) * CH + i];
    dwv[i] = s;
  } else if (i < CH + W) {
    const int k = i - CH;
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += dws_part[static_cast<size_t>(b) * W + k];
    dws[k] = s;
  }
}

// The dW_v GEMM over K cells split `splits` ways (C % 128 == 0 and
// H % 128 == 0, checked by the caller); returns the launch error.
template <class Cells>
cudaError_t launch_dwv(Cells cells, const __nv_bfloat16* dzr, float* part,
                       int K, int C, int H, int splits, cudaStream_t st) {
  const int per_split = ((K + splits - 1) / splits + kTK - 1) / kTK * kTK;
  dwv_kernel<Cells><<<dim3(C / kTM, H / kTN, splits), kGemmThreads, 0, st>>>(
      cells, dzr, part, K, C, H, per_split);
  return cudaGetLastError();
}

// dwv = sum of the split partials, dws [W] = sum of the B question
// partials [B, W]; returns the launch error.
inline cudaError_t launch_reduce(const float* part, const float* dws_part,
                                 float* dwv, float* dws, int splits, int C,
                                 int H, int B, int W, cudaStream_t st) {
  const int CH = C * H;
  reduce_kernel<<<(CH + W + kReduceThreads - 1) / kReduceThreads,
                  kReduceThreads, 0, st>>>(part, dws_part, dwv, dws, splits,
                                           CH, B, W);
  return cudaGetLastError();
}

}  // namespace attn_dwv

}  // namespace
