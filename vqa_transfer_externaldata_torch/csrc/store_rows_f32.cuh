// store_rows_f32.cuh: reading a resident store's rows in float32, for the
// float32 attention kernels K4f (attention_resident_fwd_f32.cu) and K5f
// (attention_resident_bwd_f32.cu), and a dense float32 grid's, for K2f
// (attention_fwd_f32.cu), for Hopper (sm_90a).
//
// A float32 model keeps its store in the source's dtype (f32, or the f16
// of a raw store), or as the int8 codes of a quantized one, as the JAX
// package does; the kernels widen each value to f32 as they load it, which
// is exact for all three (f16 -> f32 and |code| <= 127), so no f32 copy of
// the store is ever made. Each kernel is instantiated over the row type T.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rows_f32 {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(int8_t x) { return float(x); }

// Cell i of the batch (question i / Np, cell i % Np) at channel k, read
// straight out of the store row rows[i / Np]: the A of the score product;
// row(b, n) is the row of cell n of question b.
template <typename T>
struct CellRows {
  const T* store;
  const int* rows;
  int Np, C;
  __device__ __forceinline__ const T* row(int b, int n) const {
    return store + ((long long)rows[b] * Np + n) * C;
  }
  __device__ __forceinline__ float operator()(int i, int k) const {
    const int b = i / Np;
    return widen(row(b, i - b * Np)[k]);
  }
};

// The same for a dense float32 grid v [B, Np, C] (K2f's gathered grid): cell
// n of question b is v[b, n, :], read in place.
struct GridCells {
  const float* v;
  int Np, C;
  __device__ __forceinline__ const float* row(int b, int n) const {
    return v + ((long long)b * Np + n) * C;
  }
  __device__ __forceinline__ float operator()(int i, int k) const {
    return v[(long long)i * C + k];
  }
};

// Valid cell k of the batch (question k / n_valid, cell k % n_valid) at
// channel c, as the A (channels x cells) of the dW_v product.
template <typename T>
struct ValidCellsT {
  const T* store;
  const int* rows;
  int Np, n_valid, C;
  __device__ __forceinline__ float operator()(int c, int k) const {
    const int b = k / n_valid;
    return widen(
        store[((long long)rows[b] * Np + (k - b * n_valid)) * C + c]);
  }
};

// The row of cell n of question b.
template <typename T>
__device__ __forceinline__ const T* row(const T* store, const int* rows,
                                        int b, int n, int Np, int C) {
  return store + ((long long)rows[b] * Np + n) * C;
}

}  // namespace rows_f32
