// K5 `attention_resident_bwd`: backward of the gather-free attention (K4)
// with G glimpses (1 <= G <= 8) from its saved h, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention_resident.py::
// _make_bwd_kernel_multi (the Pallas body launched by _resident_bwd_multi).
// For question b with v = store[rows[b]], the saved post-ReLU h (shared by
// the glimpses) and, per glimpse g, alpha_g, the v_att_g cotangent g_g and
// sga_g = g_alpha_g - S_g (packed by the caller):
//
//   dalpha_gn = (bf16(g_g) . v_n) * r_n           (r = 1 when !normalize)
//   ds_gn     = alpha_gn (dalpha_gn + sga_gn)
//   dz_nk     = sum_g [h_nk > 0] ds_gn ws_gk      (f32, glimpses in order)
//   dqh_bk    = sum_n dz_nk,   dws_gk += sum_n ds_gn h_nk
//   dW_v      = sum_{b,n} v_n^T bf16(dz_n r_n)    (once, on the summed dz)
//
// The store gets no gradient (it is data). The rounding points are the
// Pallas kernel's: g and dz * r in bf16, every sum in f32.
//
// The store rows are bf16, or the int8 codes of an L2-prenormalized store
// (the Pallas kernel's int8 branch): both stages widen the codes to bf16 as
// they load them, exactly (store_rows.cuh), and the rest runs as on bf16
// rows. The store's scale is applied outside (to g before, to dW_v after),
// and an int8 store is never normalized here.
//
// What bounds it on an H100: dW_v over the B * n_valid = 50176 live cells
// of a batch of 256 is 105 GFLOP of bf16 (106 us at 989 TFLOP/s) whatever
// G is; the bytes (205 MB of grid or 102 MB of int8 codes, 51 MB of h) take
// 77 us at most: the tensor cores.
//
// Design: the TPU kernel runs the questions on a sequential grid and
// accumulates dW_v and dws in resident output blocks. Hopper blocks run in
// parallel with nothing carried between them, and float atomics would make
// the sums depend on the schedule, so the work is split in three launches:
//
//  1. attn_res_bwd_rows_kernel, one block per question: each warp takes
//     cells and reads the store row ONCE with 16-byte loads for all G
//     dalphas (and the sum of squares when normalizing), against the G
//     cotangent rows staged in shared memory in bf16, the type they are
//     rounded to (G * C * 2 bytes: 32 KB at G=8, C=2048); then each thread
//     takes hidden units and walks the cells in order for dqh, its
//     question's G dws partials and bf16(dz * r) of the summed dz, written
//     compactly as [B * n_valid, H].
//  2. the dW_v GEMM, [C, B*n_valid] x [B*n_valid, H], with the store rows
//     looked up per cell as in K4 (attention_dwv.cuh, shared with K8 and
//     P2): wgmma on transposed operands from a cp.async ring, blocks own
//     128 x 256 tiles of dW_v (128 x 128 where 256 does not divide H) and
//     a fixed slice of the cells (split over K so that the grid is one wave
//     of the card), one partial tile per block. It runs once for all
//     glimpses, as on the TPU.
//  3. a reduction that sums the dW_v partials over the splits and the dws
//     partials over the questions, both in a fixed order: the result does
//     not depend on the schedule.
//
// G is a template parameter instantiated for 1..8, so the G=1 code is the
// single-glimpse kernel; the row type T (bf16 or int8) is the second,
// picked by a flag in the C entry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_dwv.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;  // above it: opt in per kernel

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int G, class T>
__global__ void __launch_bounds__(kRowThreads)
attn_res_bwd_rows_kernel(const T* __restrict__ store,  // [M, Np, C]
                         const int* __restrict__ rows,             // [B]
                         const __nv_bfloat16* __restrict__ h,  // [B, Np, H]
                         const float* __restrict__ ws,         // [G, H]
                         const float* __restrict__ alpha,      // [B, Np, G]
                         const float* __restrict__ g,          // [B, G, C]
                         const float* __restrict__ sga,        // [B, Np, G]
                         float* __restrict__ dqh,              // [B, H]
                         float* __restrict__ dws_part,         // [B, G, H]
                         __nv_bfloat16* __restrict__ dzr,  // [B*n_valid, H]
                         int Np, int n_valid, int C, int H, int normalize) {
  // bf16(g) [G][C], then ds [G][Np] and r [Np] in f32 (G * C * 2 bytes is
  // a multiple of 16: C % 128 == 0).
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ds = reinterpret_cast<float*>(smem + sizeof(__nv_bfloat16) * G * C);
  float* rs = ds + G * Np;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* gb = g + static_cast<size_t>(b) * G * C;
  for (int i = tid; i < G * C; i += kRowThreads) {
    gs[i] = __float2bfloat16(gb[i]);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* v = store + static_cast<size_t>(rows[b]) * Np * C;
  for (int n = warp; n < n_valid; n += kRowThreads / 32) {
    const T* row = v + static_cast<size_t>(n) * C;
    float dot[G];
#pragma unroll
    for (int k = 0; k < G; ++k) dot[k] = 0.0f;
    float sq = 0.0f;
    for (int c = lane * 8; c < C; c += 256) {
      const uint4 x4 = store_rows::load8(row + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x4);
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] = __bfloat162float(e[i]);
        if constexpr (!store_rows::kInt8<T>) sq += round_bf16(x[i] * x[i]);
      }
#pragma unroll
      for (int k = 0; k < G; ++k) {  // every glimpse from this one read
        const uint4 g4 = *reinterpret_cast<const uint4*>(gs + k * C + c);
        const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&g4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dot[k] = fmaf(__bfloat162float(ge[i]), x[i], dot[k]);
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], o);
      }
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    if (lane == 0) {
      const float r = normalize ? rsqrtf(sq + 1e-12f) : 1.0f;
      const size_t o = (static_cast<size_t>(b) * Np + n) * G;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        ds[k * Np + n] = alpha[o + k] * (dot[k] * r + sga[o + k]);
      }
      rs[n] = r;
    }
  }
  __syncthreads();

  for (int k = tid; k < H; k += kRowThreads) {
    float wk[G], dw[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      wk[j] = ws[static_cast<size_t>(j) * H + k];
      dw[j] = 0.0f;
    }
    const __nv_bfloat16* hk = h + static_cast<size_t>(b) * Np * H + k;
    __nv_bfloat16* out = dzr + static_cast<size_t>(b) * n_valid * H + k;
    float dq = 0.0f;
    for (int n = 0; n < n_valid; ++n) {
      const float hv = __bfloat162float(hk[static_cast<size_t>(n) * H]);
      float dz = 0.0f;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float d = ds[j * Np + n];
        // The product rounded on its own, as the reference's where(...).
        if (hv > 0.0f) dz += __fmul_rn(d, wk[j]);
        dw[j] = fmaf(d, hv, dw[j]);
      }
      dq += dz;
      out[static_cast<size_t>(n) * H] = __float2bfloat16(dz * rs[n]);
    }
    dqh[static_cast<size_t>(b) * H + k] = dq;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      dws_part[(static_cast<size_t>(b) * G + j) * H + k] = dw[j];
    }
  }
}

template <int G, class T>
int launch_bwd(const void* store, const void* rows, const void* h,
               const void* ws, const void* alpha, const void* g,
               const void* sga, void* dzr, void* dws_part, void* part,
               void* dqh, void* dwv, void* dws, int B, int Np, int n_valid,
               int C, int H, int normalize, int splits, cudaStream_t st,
               int* launched) {
  const size_t smem = sizeof(__nv_bfloat16) * G * static_cast<size_t>(C) +
                      sizeof(float) * (G + 1) * static_cast<size_t>(Np);
  cudaError_t e = cudaSuccess;
  if (smem > kDefaultSmem) {
    e = cudaFuncSetAttribute(attn_res_bwd_rows_kernel<G, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attn_res_bwd_rows_kernel<G, T><<<B, kRowThreads, smem, st>>>(
      static_cast<const T*>(store),
      static_cast<const int*>(rows), static_cast<const __nv_bfloat16*>(h),
      static_cast<const float*>(ws), static_cast<const float*>(alpha),
      static_cast<const float*>(g), static_cast<const float*>(sga),
      static_cast<float*>(dqh), static_cast<float*>(dws_part),
      static_cast<__nv_bfloat16*>(dzr), Np, n_valid, C, H, normalize);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  e = attn_dwv::launch_dwv(
      attn_dwv::StoreCells<T>{static_cast<const T*>(store),
                              static_cast<const int*>(rows), n_valid, Np, C},
      static_cast<const __nv_bfloat16*>(dzr), static_cast<float*>(part),
      B * n_valid, C, H, splits, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  e = attn_dwv::launch_reduce(static_cast<const float*>(part),
                              static_cast<const float*>(dws_part),
                              static_cast<float*>(dwv),
                              static_cast<float*>(dws), splits, C, H, B,
                              G * H, st);
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The dW_v launch's shape over K cells split `splits` ways at C x H on
// bf16 rows or int8 codes: tile (channels x units), ring stages, dynamic
// shared memory in bytes, chunks of 64 cells a split and grid (unit tiles,
// channel tiles, splits).
int attention_resident_bwd_dwv_config(int K, int C, int H, int int8,
                                      int splits, int* out) {
  const attn_dwv::Shape s = attn_dwv::plan(K, C, H, int8 != 0, splits);
  const int v[8] = {s.tile_m, s.tile_n, s.stages, s.smem_bytes,
                    s.chunks_per_split, s.grid_x, s.grid_y, s.grid_z};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// store [M, Np, C] bf16, or int8 codes when int8 != 0 (then normalize must
// be 0), rows [B] i32, h [B, Np, H] bf16 (K4's residual),
// ws [G, H] f32 (1 <= G <= 8), alpha [B, Np, G] f32, g [B, G, C] f32, sga
// [B, Np, G] f32 -> dqh [B, H], dwv [C, H], dws [G, H], all f32. Scratch:
// dzr [B*n_valid, H] bf16, dws_part [B, G, H] f32, part [splits, C, H] f32.
// Needs C % 128 == 0 and H % 128 == 0, and G * C * 2 + (G + 1) * Np * 4
// bytes of shared memory at most 227 KB (checked by the caller). Three
// launches on `stream`, counting in *launched those that launched; returns
// the first launch error.
int attention_resident_bwd(const void* store, const void* rows,
                           const void* h, const void* ws, const void* alpha,
                           const void* g, const void* sga, void* dzr,
                           void* dws_part, void* part, void* dqh, void* dwv,
                           void* dws, int B, int Np, int n_valid, int C,
                           int H, int G, int normalize, int int8,
                           int splits, void* stream, int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8 && normalize) return static_cast<int>(cudaErrorInvalidValue);
#define K5_CASE(k)                                                           \
  case k:                                                                    \
    return int8 ? launch_bwd<k, int8_t>(store, rows, h, ws, alpha, g, sga,   \
                                        dzr, dws_part, part, dqh, dwv, dws,  \
                                        B, Np, n_valid, C, H, 0, splits, st, \
                                        launched)                            \
                : launch_bwd<k, __nv_bfloat16>(                              \
                      store, rows, h, ws, alpha, g, sga, dzr, dws_part, part, \
                      dqh, dwv, dws, B, Np, n_valid, C, H, normalize, splits, \
                      st, launched);
  switch (G) {
    K5_CASE(1) K5_CASE(2) K5_CASE(3) K5_CASE(4)
    K5_CASE(5) K5_CASE(6) K5_CASE(7) K5_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_CASE
}

}  // extern "C"
