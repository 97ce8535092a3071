// P2 `probe_bwd_ceiling`: the ceiling of the resident attention backward's
// matrix products, for Hopper (sm_90a).
//
// Replaces tools/probe_bwd_ceiling.py::make_call.kernel, the TPU probe that
// timed only the two product groups of the resident backward (B4) under its
// row lookup. Here the same work: rows [B] index a store [M, Np, C] bf16,
// with the saved h [B, Np, H] bf16 and a cotangent row g [B, C] bf16:
//
//   dal[b]  = g[b] . store[rows[b]]^T                 [Np] f32
//   dW_v    = sum_b store[rows[b]]^T bf16(h[b] * 0.5)  [C, H] f32
//
// (h * 0.5 is the TPU probe's stand-in cotangent; it is exact in bf16.)
//
// Design: K5's structure (attention_resident_bwd.cu) with its softmax
// backward taken out, so the probe isolates K5's own dW_v GEMM under the
// same lookup: the rows stage of attention_rows.cuh (one block a question:
// a warp a cell with the whole row's 16-byte loads in flight forms dal
// against g staged in shared memory, then the block writes the bf16
// cotangent compactly as [B*Np, H], kCellsInFlight 16-byte vectors a
// thread at a time); the split-K dW_v GEMM of attention_dwv.cuh (wgmma on
// transposed operands from a cp.async ring) with the store rows looked up
// per cell (StoreCells); its fixed-order reduction over the splits. No
// atomics.
//
// What bounds it on an H100: at B=256, Np=200, C=2048, H=512 the products
// are 107.6 GFLOP of bf16 (109 us at 989 TFLOP/s) against 52 MB of store
// (64 rows), 52 MB of h and 4 MB of dW_v (33 us at 3.35 TB/s): the tensor
// cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_dwv.cuh"
#include "attention_rows.cuh"

namespace {

constexpr int kRowThreads = attn_rows::kThreads;

__global__ void __launch_bounds__(kRowThreads)
probe_bwd_rows_kernel(const __nv_bfloat16* __restrict__ store,  // [M,Np,C]
                      const int* __restrict__ rows,             // [B]
                      const __nv_bfloat16* __restrict__ h,      // [B, Np, H]
                      const __nv_bfloat16* __restrict__ g,      // [B, C]
                      float* __restrict__ dal,                  // [B, Np]
                      __nv_bfloat16* __restrict__ dz,           // [B*Np, H]
                      int Np, int C, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem);  // [C]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const __nv_bfloat16* gb = g + static_cast<size_t>(b) * C;
  for (int c = tid * 8; c < C; c += kRowThreads * 8) {
    *reinterpret_cast<uint4*>(gs + c) =
        *reinterpret_cast<const uint4*>(gb + c);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const __nv_bfloat16* v = store + static_cast<size_t>(rows[b]) * Np * C;
  for (int n = warp; n < Np; n += attn_rows::kWarps) {
    float dot[1], sq;
    attn_rows::cell_dots<1, false>(v + static_cast<size_t>(n) * C, gs, C,
                                   lane, dot, sq);
    if (lane == 0) dal[static_cast<size_t>(b) * Np + n] = dot[0];
  }

  // The question's cotangent rows, eight units a thread per 16-byte
  // access, kCellsInFlight accesses a thread at a time.
  const size_t base = static_cast<size_t>(b) * Np * H;
  const size_t units = static_cast<size_t>(Np) * H;
  const __nv_bfloat162 half = __floats2bfloat162_rn(0.5f, 0.5f);
  constexpr int kStep = kRowThreads * attn_rows::kUnits;
  for (size_t i0 = static_cast<size_t>(tid) * attn_rows::kUnits; i0 < units;
       i0 += kStep * attn_rows::kCellsInFlight) {
    uint4 x4[attn_rows::kCellsInFlight];
#pragma unroll
    for (int f = 0; f < attn_rows::kCellsInFlight; ++f) {
      const size_t i = i0 + static_cast<size_t>(f) * kStep;
      if (i < units) x4[f] = *reinterpret_cast<const uint4*>(h + base + i);
    }
#pragma unroll
    for (int f = 0; f < attn_rows::kCellsInFlight; ++f) {
      const size_t i = i0 + static_cast<size_t>(f) * kStep;
      if (i < units) {
        __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&x4[f]);
#pragma unroll
        for (int j = 0; j < 4; ++j) x2[j] = __hmul2(x2[j], half);
        *reinterpret_cast<uint4*>(dz + base + i) = x4[f];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// store [M, Np, C] bf16, rows [B] i32 (< M), h [B, Np, H] bf16, g [B, C]
// bf16 -> dal [B, Np] f32, dwv [C, H] f32. Scratch: dz [B*Np, H] bf16,
// part [splits, C, H] f32. Needs C % 128 == 0 and H % 128 == 0 (checked by
// the caller). Three launches on `stream`, counting in *launched those that
// launched; returns the first launch error.
int probe_bwd_ceiling(const void* store, const void* rows, const void* h,
                      const void* g, void* dal, void* dz, void* part,
                      void* dwv, int B, int Np, int C, int H, int splits,
                      void* stream, int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(__nv_bfloat16) * static_cast<size_t>(C);
  probe_bwd_rows_kernel<<<B, kRowThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(store),
      static_cast<const int*>(rows), static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(g), static_cast<float*>(dal),
      static_cast<__nv_bfloat16*>(dz), Np, C, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  e = attn_dwv::launch_dwv(
      attn_dwv::StoreCells<__nv_bfloat16>{
          static_cast<const __nv_bfloat16*>(store),
          static_cast<const int*>(rows), Np, Np, C},
      static_cast<const __nv_bfloat16*>(dz), static_cast<float*>(part),
      B * Np, C, H, splits, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  e = attn_dwv::launch_reduce(static_cast<const float*>(part), nullptr,
                              static_cast<float*>(dwv), nullptr, splits, C,
                              H, B, 0, st);
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // extern "C"
