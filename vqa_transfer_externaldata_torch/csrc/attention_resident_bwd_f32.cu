// K5f `attention_resident_bwd_f32`: the backward of K4f in float32, from
// its saved h, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention_resident.py::
// _make_bwd_kernel_multi (the Pallas body launched by _resident_bwd_multi)
// when the store computes in float32; K5 (attention_resident_bwd.cu) takes
// only bf16 rows and h. The same function as attention_resident_bwd_reference
// in float32, with g the v_att cotangent [B, G*C] and sga = ga - S:
//
//   dalpha_g = (g_g . v_n) * r_n,   ds_g = alpha_g * (dalpha_g + sga_g)
//   dz       = [h > 0] * sum_g ds_g ws_g           (glimpse order)
//   dqh      = sum_n dz,  dws_g = sum_{b,n} ds_g h,  dW_v = sum v^T (dz r)
//
// on rows of f32, f16 or int8 codes (widened exactly as they load), in FFMA
// with f32 sums: no TF32 or bf16 pass.
//
// What bounds it on an H100: at B=256, n_valid=196, C=2048, H=512 the dW_v
// product is 2 x 50176 x 2048 x 512 = 105.2 GFLOP of f32 FFMA (1.6 ms at 67
// TFLOP/s), the dalpha dots G x 0.2 GFLOP; the reads (the rows twice, h
// once: 0.94 GB with f32 rows) take 0.28 ms at 3.35 TB/s: the FP32 pipes.
//
// Design, three launches in stream order:
//  1. attn_f32_bwd_rows_kernel, a block a question (the TPU's program a
//     question): the G cotangent rows staged in shared memory, a warp a
//     cell for the dalpha dots (and r when normalizing) in a fixed xor
//     tree, ds in shared memory; then a thread a unit walks the cells in
//     order for dz, dqh, the question's dws and dz * r, written for the
//     dW_v product over the B * n_valid valid cells;
//  2. the dW_v product [C, K] x [K, H] on fp32_ring.cuh's product_kernel,
//     128 channels x 128 units a block, the cells split so that the grid
//     fills the card (the split comes from the wrapper, a function of the
//     shapes and the card), each split's sum in cell order. Both operands
//     are MN-major: a cell's channels are contiguous in its store row and
//     its units in dz * r, so each 16-cell chunk's copies land straight in
//     the [cell][channel] and [cell][unit] layouts the products read; each
//     chunk's 16 store rows are found once, a chunk ahead (ValidCellsT:
//     one division a row, none an element); f16 rows and int8 codes are
//     copied as stored and widened in shared memory, f32 rows read where
//     they land. The copy widths (16, 8 or 4 bytes as the rows' pitch C
//     allows) come from the wrapper's ops/kernels.py::f32_ring_plan;
//  3. attn_f32_bwd_reduce_kernel: the splits of dW_v summed in split order
//     and dws summed over the questions in order.
// No atomics: two calls give the same bits.

#include <cuda_runtime.h>

#include <cstdint>

#include "fp32_ring.cuh"
#include "store_rows_f32.cuh"

namespace {

constexpr int MAXG = 8;  // glimpses
constexpr int ROWS_THREADS = 256;  // threads of a rows block
constexpr int SPLIT_ROUND = 8;  // a split's cells: a multiple of 8 but
                                // the last (the wrapper's rule)

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(ROWS_THREADS)
    attn_f32_bwd_rows_kernel(const T* __restrict__ store,
                             const int* __restrict__ rows,
                             const float* __restrict__ h,
                             const float* __restrict__ ws,
                             const float* __restrict__ alpha,
                             const float* __restrict__ g,
                             const float* __restrict__ sga,
                             float* __restrict__ dzr, float* __restrict__ dqh,
                             float* __restrict__ dws_part, int Np,
                             int n_valid, int C, int H, int G,
                             int normalize) {
  extern __shared__ float sm[];
  float* gs = sm;  // [G, C] the cotangent rows
  float* ds = gs + G * C;  // [n_valid, G]
  float* rr = ds + n_valid * G;  // [n_valid]
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int idx = tid; idx < G * C; idx += ROWS_THREADS)
    gs[idx] = g[(long long)b * G * C + idx];
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int n = warp; n < n_valid; n += ROWS_THREADS / 32) {
    const T* v = rows_f32::row(store, rows, b, n, Np, C);
    float dot[MAXG] = {}, ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float x = rows_f32::widen(v[c]);
      ss = fmaf(x, x, ss);
#pragma unroll
      for (int k = 0; k < MAXG; ++k)
        if (k < G) dot[k] = fmaf(gs[k * C + c], x, dot[k]);
    }
    ss = warp_sum(ss);
#pragma unroll
    for (int k = 0; k < MAXG; ++k)
      if (k < G) dot[k] = warp_sum(dot[k]);
    const float r = normalize ? 1.f / sqrtf(ss + 1e-12f) : 1.f;
    if (lane == 0) {
      rr[n] = r;
      for (int k = 0; k < G; ++k) {
        const long long o = ((long long)b * Np + n) * G + k;
        ds[n * G + k] =
            __fmul_rn(alpha[o], __fadd_rn(__fmul_rn(dot[k], r), sga[o]));
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < H; j += ROWS_THREADS) {
    float wsj[MAXG], dw[MAXG] = {};
#pragma unroll
    for (int k = 0; k < MAXG; ++k) wsj[k] = k < G ? ws[k * H + j] : 0.f;
    float dq = 0.f;
    for (int n = 0; n < n_valid; ++n) {
      const float hv = h[((long long)b * Np + n) * H + j];
      float dz = 0.f;
      if (hv > 0.f) {
#pragma unroll
        for (int k = 0; k < MAXG; ++k)
          if (k < G) dz = __fadd_rn(dz, __fmul_rn(ds[n * G + k], wsj[k]));
      }
      dq += dz;
#pragma unroll
      for (int k = 0; k < MAXG; ++k)
        if (k < G) dw[k] = fmaf(ds[n * G + k], hv, dw[k]);
      dzr[((long long)b * n_valid + n) * H + j] = __fmul_rn(dz, rr[n]);
    }
    dqh[(long long)b * H + j] = dq;
    for (int k = 0; k < G; ++k)
      dws_part[((long long)b * G + k) * H + j] = dw[k];
  }
}

// dwv = sum over the splits of part [splits, C*H] (in split order); dws
// [G*H] = sum over the B questions of dws_part [B, G*H] (in order).
__global__ void __launch_bounds__(256)
    attn_f32_bwd_reduce_kernel(const float* __restrict__ part, int splits,
                               const float* __restrict__ dws_part, int B,
                               float* __restrict__ dwv,
                               float* __restrict__ dws, long long CH,
                               int GH) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx < CH) {
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += part[z * CH + idx];
    dwv[idx] = sum;
  } else if (idx < CH + GH) {
    const long long j = idx - CH;
    float sum = 0.f;
    for (int b = 0; b < B; ++b) sum += dws_part[(long long)b * GH + j];
    dws[j] = sum;
  }
}

template <typename T>
int run(const T* store, const int* rows, const float* h, const float* ws,
        const float* alpha, const float* g, const float* sga, float* dzr,
        float* dws_part, float* part, float* dqh, float* dwv, float* dws,
        int B, int Np, int n_valid, int C, int H, int G, int normalize,
        int splits, int wa, int wb, int stages, int smem_dwv,
        cudaStream_t stream, int* launched) {
  if (!fp32_ring::plan_ok<T, false>(wa, wb, stages, smem_dwv, store,
                                    (long long)C * sizeof(T), dzr,
                                    (long long)H * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * ((size_t)G * C + (size_t)(G + 1) * n_valid);
  cudaError_t err = cudaFuncSetAttribute(
      attn_f32_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_f32_bwd_rows_kernel<T><<<B, ROWS_THREADS, smem, stream>>>(
      store, rows, h, ws, alpha, g, sga, dzr, dqh, dws_part, Np, n_valid, C,
      H, G, normalize);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int K = B * n_valid;
  const int per = (K + splits - 1) / splits;
  const int chunk = (per + SPLIT_ROUND - 1) / SPLIT_ROUND * SPLIT_ROUND;
  err = fp32_ring::launch_product<T>(
      rows_f32::ValidCellsT<T>{store, rows, Np, n_valid, C}, dzr, H, C, H, K,
      chunk, splits, part, H, wa, wb, smem_dwv, stream, launched);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long CH = (long long)C * H;
  const int GH = G * H;
  attn_f32_bwd_reduce_kernel<<<(unsigned)((CH + GH + 255) / 256), 256, 0,
                               stream>>>(part, splits, dws_part, B, dwv, dws,
                                         CH, GH);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// store [M, Np, C] of f32 (row_type 0), f16 (1) or int8 codes (2; then
// normalize must be 0), rows [B] i32, h [B, Np, H] f32 (K4f's residual), ws
// [G, H] f32 (1 <= G <= 8), alpha and sga [B, Np, G] f32, g [B, G*C] f32 ->
// dqh [B, H], dwv [C, H], dws [G, H], all f32. Scratch: dzr [B*n_valid, H],
// dws_part [B, G, H], part [splits, C, H], all f32. The rows launch takes
// 4 (G C + (G + 1) n_valid) bytes of shared memory (the caller keeps it
// within a block's). The dW_v launch's plan: copy widths wa (the rows) and
// wb (dz * r) in bytes, stages and shared bytes, ops/kernels.py::
// f32_ring_plan's (refused where the rows' alignment does not allow it).
// Three launches on `stream`, added to *launched.
int attention_resident_bwd_f32(const void* store, const int* rows,
                               const float* h, const float* ws,
                               const float* alpha, const float* g,
                               const float* sga, float* dzr, float* dws_part,
                               float* part, float* dqh, float* dwv,
                               float* dws, int B, int Np, int n_valid, int C,
                               int H, int G, int normalize, int row_type,
                               int splits, int wa, int wb, int stages,
                               int smem, cudaStream_t stream,
                               int* launched) {
  if (G < 1 || G > MAXG || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (row_type) {
    case 0:
      return run(static_cast<const float*>(store), rows, h, ws, alpha, g, sga,
                 dzr, dws_part, part, dqh, dwv, dws, B, Np, n_valid, C, H, G,
                 normalize, splits, wa, wb, stages, smem, stream, launched);
    case 1:
      return run(static_cast<const __half*>(store), rows, h, ws, alpha, g,
                 sga, dzr, dws_part, part, dqh, dwv, dws, B, Np, n_valid, C,
                 H, G, normalize, splits, wa, wb, stages, smem, stream,
                 launched);
    case 2:
      return run(static_cast<const int8_t*>(store), rows, h, ws, alpha, g,
                 sga, dzr, dws_part, part, dqh, dwv, dws, B, Np, n_valid, C,
                 H, G, normalize, splits, wa, wb, stages, smem, stream,
                 launched);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
