// store_rows_f32.cuh: reading a resident store's rows in float32, for the
// float32 attention kernels K4f (attention_resident_fwd_f32.cu) and K5f
// (attention_resident_bwd_f32.cu), and a dense float32 grid's, for K2f
// (attention_fwd_f32.cu) and K8f (attention_bwd_f32.cu), for Hopper
// (sm_90a).
//
// A float32 model keeps its store in the source's dtype (f32, or the f16
// of a raw store), or as the int8 codes of a quantized one, as the JAX
// package does; the kernels widen each value to f32 (widen), which is exact
// for all three (f16 -> f32 and |code| <= 127), so no f32 copy of the store
// is ever made: the tile products copy the rows into shared memory as they
// are stored and widen them there (fp32_ring.cuh), the other launches as
// they load them. Each kernel is instantiated over the row type T.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rows_f32 {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(int8_t x) { return float(x); }

// A row source yields row pointers, each found once where the tile loop
// needs it (fp32_ring.cuh): cell(i) is the first channel of the i-th cell
// of its operand, base() a valid, aligned address of the operand (the
// source of a zero-filled copy), and row(b, n) the row of cell n of
// question b.

// Cell i of the batch (question i / Np, cell i % Np), read out of the
// store row rows[i / Np]: the A of the score product.
template <typename T>
struct CellRows {
  using elem = T;
  const T* store;
  const int* rows;
  int Np, C;
  __device__ __forceinline__ const T* row(int b, int n) const {
    return store + ((long long)rows[b] * Np + n) * C;
  }
  __device__ __forceinline__ const T* cell(int i) const {
    const int b = i / Np;
    return row(b, i - b * Np);
  }
  __host__ __device__ const T* base() const { return store; }
};

// The same for a dense float32 grid v [B, Np, C] (K2f's gathered grid, K8f's
// grid): cell n of question b is v[b, n, :], read in place.
struct GridCells {
  using elem = float;
  const float* v;
  int Np, C;
  __device__ __forceinline__ const float* row(int b, int n) const {
    return v + ((long long)b * Np + n) * C;
  }
  __device__ __forceinline__ const float* cell(int i) const {
    return v + (long long)i * C;
  }
  __host__ __device__ const float* base() const { return v; }
};

// Valid cell k of the batch (question k / n_valid, cell k % n_valid): the
// cells (k) of the dW_v product, each a row of C channels.
template <typename T>
struct ValidCellsT {
  using elem = T;
  const T* store;
  const int* rows;
  int Np, n_valid, C;
  __device__ __forceinline__ const T* cell(int k) const {
    const int b = k / n_valid;
    return store + ((long long)rows[b] * Np + (k - b * n_valid)) * C;
  }
  __host__ __device__ const T* base() const { return store; }
};

// The row of cell n of question b.
template <typename T>
__device__ __forceinline__ const T* row(const T* store, const int* rows,
                                        int b, int n, int Np, int C) {
  return store + ((long long)rows[b] * Np + n) * C;
}

}  // namespace rows_f32
