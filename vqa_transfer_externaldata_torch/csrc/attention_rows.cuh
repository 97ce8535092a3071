// The per-question rows stage shared by K5 (attention_resident_bwd.cu) and
// the probe P2 (probe_bwd_ceiling.cu): for question b, whose feature grid is
// row rows[b] of a resident store [M, Np, C] (values of the element type E,
// bf16 or float16 in K5h, or int8 codes widened to E as they are loaded:
// store_rows.cuh), each cell n's row is read once and dotted with the
// question's G cotangent rows g_k [C] in E:
//
//   dot_kn = g_k . v_n        (f32 sums of E products; K5 also sums
//                              the E squares of v_n for its norm)
//
// and then a pass over the question's cells in hidden units writes the
// cotangent that the dW_v GEMM of attention_dwv.cuh reads, compactly as
// [B * cells, H] of E.
//
// What bounds it on an H100: bytes. At K5's training shape (B=256, 196
// valid cells, C=2048, H=512) it reads 205 MB of store rows (103 MB of
// int8 codes) and 51 MB of h and writes 51 MB of dzr: ~92 us at 3.35 TB/s,
// less where questions share an image. Its arithmetic is ~0.2 GFLOP a
// glimpse.
//
// Design: one block a question (K5's training batch of 256 gives ~2 blocks
// an SM), whose loads must be in flight, not waited for one by one
// (Little's law at ~3.35 TB/s wants ~25 KB of loads in flight an SM):
//  - cell_dots: a warp takes a cell and each lane issues its loads of the
//    row (up to kRowLoads of 16 bytes, a whole 2048-channel row) before
//    its first FMA. Lane l sums channels l * 8 + 256 j, j in order, then the
//    xor tree 16 .. 1;
//  - the second pass gives each thread kUnits = 8 consecutive hidden units
//    (16-byte loads of h and stores of the cotangent) and keeps
//    kCellsInFlight cells of loads in flight; cell_lanes(H) neighbouring
//    threads of a warp share 8 units and take cells lane, lane +
//    cell_lanes, ..., so that a sum over the cells ends in a fixed xor
//    tree inside the warp (unit_passes > 1 only where H > 2048).
// plan() is the launch; ops/kernels.py::rows_plan computes the same.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "store_rows.cuh"  // and elem16.cuh

namespace {

namespace attn_rows {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowLoads = 8;       // 16-byte loads a lane issues at once
constexpr int kUnits = 8;          // hidden units a thread takes (16 B)
constexpr int kCellsInFlight = 4;  // cells of h a thread loads at once

// The launch of K5's rows stage (P2's takes its grid and threads): grid,
// threads, dynamic shared memory, the threads that take cells side by side
// in the second pass, the groups of them across the units and the passes
// over the hidden units.
struct Shape {
  int grid_x, threads, smem_bytes, cell_lanes, unit_lanes, unit_passes;
};

// Groups of threads, one for each 8 units of a pass. H % 128 == 0.
__host__ __device__ inline int unit_lanes(int H) {
  const int groups = H / kUnits;
  return groups < kThreads ? groups : kThreads;
}

// Threads of a group: the largest power of two that fits the block
// (at most 16, so a group never leaves its warp).
__host__ __device__ inline int cell_lanes(int H) {
  int p = 1;
  while (2 * p * unit_lanes(H) <= kThreads) p *= 2;
  return p;
}

inline Shape plan(int B, int n_valid, int G, int C, int H) {
  Shape s;
  s.grid_x = B;
  s.threads = kThreads;
  s.cell_lanes = cell_lanes(H);
  s.unit_lanes = unit_lanes(H);
  s.unit_passes = (H / kUnits + s.unit_lanes - 1) / s.unit_lanes;
  // E(g) [G][C], then ds [n_valid][G] and r [n_valid] in f32.
  s.smem_bytes = 2 * G * C + 4 * (G + 1) * n_valid;
  return s;
}

// The G dot products of one cell's row [C] with gs [G][C] (E, shared
// memory) by one warp, and with kSq the f32 sum of the row's E squares.
// Every lane ends with the sums. C % 8 == 0.
template <int G, bool kSq, class T, class E>
__device__ __forceinline__ void cell_dots(const T* __restrict__ row,
                                          const E* gs, int C, int lane,
                                          float (&dot)[G], float& sq) {
#pragma unroll
  for (int k = 0; k < G; ++k) dot[k] = 0.0f;
  sq = 0.0f;
  for (int c0 = lane * 8; c0 < C; c0 += kRowLoads * 256) {
    store_rows::raw8_t<T> raw[kRowLoads];
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j) {
      const int c = c0 + 256 * j;
      if (c < C) raw[j] = store_rows::load_raw8(row + c);
    }
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j) {
      const int c = c0 + 256 * j;
      if (c < C) {
        const uint4 x4 = store_rows::widen8<E>(raw[j]);
        const E* e = reinterpret_cast<const E*>(&x4);
        float x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          x[i] = Elem<E>::to(e[i]);
          if constexpr (kSq) sq += round_to<E>(x[i] * x[i]);
        }
#pragma unroll
        for (int k = 0; k < G; ++k) {  // every glimpse from this one read
          const uint4 g4 = *reinterpret_cast<const uint4*>(gs + k * C + c);
          const E* ge = reinterpret_cast<const E*>(&g4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            dot[k] = fmaf(Elem<E>::to(ge[i]), x[i], dot[k]);
          }
        }
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < G; ++k) {
      dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], o);
    }
    if constexpr (kSq) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
}

}  // namespace attn_rows

}  // namespace
