// The score tile shared by K2's score launch (attention_fwd.cu, rows of a
// gathered grid) and K4's (attention_resident_fwd.cu, rows looked up in a
// resident store): one 128-cell x BN-unit tile of
//
//   z     = v @ W_v[:, col0 .. col0 + BN)     score_gemm.cuh's wgmma mainloop
//   r     = rsqrt(sum_c E(v^2) + 1e-12)       (1 when !normalize)
//   h     = relu((z * r) + qh[question])      two roundings, as the reference
//   s_g   = h . ws_g over the tile's units    G partial scores a cell
//   hsave = E(h)                              only where hsave is not null
//
// E is the 16-bit element type of W_v and of the saved h (bf16 in K2 and
// K4, float16 in K2h and K4h); the rows are E or int8 codes widened to E.
//
// r comes from the squares that the mainloop takes of its own copies, h
// replaces z in the accumulator registers, and only the partial scores (and
// the optional h) reach device memory. The grid runs the unit tiles of one
// cell tile side by side (blockIdx.x), so they share its rows through L2 and
// the rows come from HBM about once; blockIdx.x == 0 writes r.
//
// The row source is a functor of score_gemm.cuh's kind (tile row -> pointer
// to its first channel, or null past the end) with a `row0` member, the
// tile's first cell, which the kernel sets; cell i belongs to question
// i / per_question. No atomics: two calls give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "score_gemm.cuh"

namespace {

namespace score_tile {

using score_gemm::kBM;

// qh [B, H] f32, ws [G, H] f32 -> part [H/BN, G, cells] f32 (slice x of
// unit tile x), rnorm [cells] f32, hsave [cells, H] of E or null.
template <class T, class E, int BN, class Rows>
__global__ void __launch_bounds__(score_gemm::kThreads, 1)
kernel(Rows rows, const E* __restrict__ wvt,  // [H, C]
       const float* __restrict__ qh, const float* __restrict__ ws,
       float* __restrict__ part, float* __restrict__ rnorm,
       E* __restrict__ hsave, int cells, int per_question, int C, int H,
       int G, int normalize) {
  using P = score_gemm::Plan<T, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = score_gemm::align1024(smem_raw);
  float* rs = reinterpret_cast<float*>(ring + P::kRingBytes);
  const int t = threadIdx.x;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * kBM;
  rows.row0 = row0;

  float acc[BN / 2];
  float sq[4];
  score_gemm::mainloop<T, BN>(rows, wvt, C, col0, ring, acc, sq,
                              normalize != 0);

  // r per cell: the 8 threads that copied a row's channel chunks hold its
  // squares (E rows; an int8 store is never normalized here).
  if (!P::kInt8 && normalize) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sq[j] += __shfl_xor_sync(0xffffffffu, sq[j], 1);
      sq[j] += __shfl_xor_sync(0xffffffffu, sq[j], 2);
      sq[j] += __shfl_xor_sync(0xffffffffu, sq[j], 4);
      if ((t & 7) == 0) rs[score_gemm::sq_row(t, j)] = rsqrtf(sq[j] + 1e-12f);
    }
  } else if (t < kBM) {
    rs[t] = 1.0f;
  }
  __syncthreads();  // rs is written, and the ring is free
  if (blockIdx.x == 0 && t < kBM && row0 + t < cells) rnorm[row0 + t] = rs[t];

  // h = relu(z * r + qh) in place of z, for this thread's two rows.
  const int fr = score_gemm::frag_row(t);
  const int fc = score_gemm::frag_col(t);
  int cell[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    cell[hf] = row0 + fr + 8 * hf;
    const float r = rs[fr + 8 * hf];
    const int b = cell[hf] < cells ? cell[hf] / per_question : 0;
    const float* q = qh + static_cast<size_t>(b) * H + col0 + fc;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 qv = *reinterpret_cast<const float2*>(q + 8 * j);
      float* z = acc + 4 * j + 2 * hf;
      // (z * r) + qh rounded as two operations, as the reference does.
      z[0] = fmaxf(__fadd_rn(__fmul_rn(z[0], r), qv.x), 0.0f);
      z[1] = fmaxf(__fadd_rn(__fmul_rn(z[1], r), qv.y), 0.0f);
    }
  }

  // G partial scores per cell over the tile's columns: this thread's
  // columns in order, then the quad that shares its rows.
#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    const float* w = ws + static_cast<size_t>(g) * H + col0 + fc;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 wv2 = *reinterpret_cast<const float2*>(w + 8 * j);
      s0 = fmaf(acc[4 * j], wv2.x, s0);
      s0 = fmaf(acc[4 * j + 1], wv2.y, s0);
      s1 = fmaf(acc[4 * j + 2], wv2.x, s1);
      s1 = fmaf(acc[4 * j + 3], wv2.y, s1);
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if ((t & 3) == 0) {
      float* out = part + (static_cast<size_t>(blockIdx.x) * G + g) * cells;
      if (cell[0] < cells) out[cell[0]] = s0;
      if (cell[1] < cells) out[cell[1]] = s1;
    }
  }

  // Saved h in E, staged through the ring's shared memory so that each
  // row goes out in 16-byte stores.
  if (hsave != nullptr) {
    constexpr int kLd = BN + 8;  // E values a staged row (16 B of padding)
    E* stg = reinterpret_cast<E*>(ring);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      E* dst = stg + (fr + 8 * hf) * kLd + fc;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<typename Elem<E>::pair*>(dst + 8 * j) =
            Elem<E>::from2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
      }
    }
    __syncthreads();
    constexpr int kChunks = BN / 8;  // 16-byte chunks a row
    for (int i = t; i < kBM * kChunks; i += score_gemm::kThreads) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      if (row0 + r < cells) {
        *reinterpret_cast<uint4*>(hsave + static_cast<size_t>(row0 + r) * H +
                                  col0 + c * 8) =
            *reinterpret_cast<const uint4*>(stg + r * kLd + c * 8);
      }
    }
  }
}

// The launch's shape over `cells` cells at width H (kernels.score_plan's
// tile, stages, shared memory and grid, with the int8 codes' share of the
// ring for int8 rows).
struct Shape {
  int tile_m, tile_n, stages, smem_bytes, grid_x, grid_y;
};

template <class T>
Shape shape(int cells, int H) {
  const int BN = score_gemm::tile_n(H);
  Shape s;
  s.tile_m = kBM;
  s.tile_n = BN;
  s.stages = BN == 256 ? score_gemm::Plan<T, 256>::kStages
                       : score_gemm::Plan<T, 128>::kStages;
  s.smem_bytes = BN == 256 ? score_gemm::Plan<T, 256>::kSmemBytes
                           : score_gemm::Plan<T, 128>::kSmemBytes;
  s.grid_x = H / BN;
  s.grid_y = (cells + kBM - 1) / kBM;
  return s;
}

// The launch at BN units a tile, its dynamic shared memory raised past the
// default 48 KB first. E is the element type (T's own for E rows; named for
// int8 codes).
template <class T, class E, int BN, class Rows>
cudaError_t launch_at(const Rows& rows, const void* wvt, const void* qh,
                      const void* ws, void* part, void* rnorm, void* hsave,
                      int cells, int per_question, int C, int H, int G,
                      int normalize, cudaStream_t st) {
  constexpr int smem = score_gemm::Plan<T, BN>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel<T, E, BN, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  const dim3 grid(H / BN, (cells + kBM - 1) / kBM);
  kernel<T, E, BN, Rows><<<grid, score_gemm::kThreads, smem, st>>>(
      rows, static_cast<const E*>(wvt), static_cast<const float*>(qh),
      static_cast<const float*>(ws), static_cast<float*>(part),
      static_cast<float*>(rnorm), static_cast<E*>(hsave), cells,
      per_question, C, H, G, normalize);
  return cudaGetLastError();
}

// The launch at the tile width of `shape` (score_gemm::tile_n(H)); E
// defaults to the row type T (int8 rows name it).
template <class T, class E = T, class Rows>
cudaError_t launch(const Rows& rows, const void* wvt, const void* qh,
                   const void* ws, void* part, void* rnorm, void* hsave,
                   int cells, int per_question, int C, int H, int G,
                   int normalize, cudaStream_t st) {
  return score_gemm::tile_n(H) == 256
             ? launch_at<T, E, 256>(rows, wvt, qh, ws, part, rnorm, hsave,
                                    cells, per_question, C, H, G, normalize,
                                    st)
             : launch_at<T, E, 128>(rows, wvt, qh, ws, part, rnorm, hsave,
                                    cells, per_question, C, H, G, normalize,
                                    st);
}

}  // namespace score_tile

}  // namespace
