// K5 `attention_resident_bwd`: backward of the gather-free attention (K4)
// from its saved h, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention_resident.py::
// _make_bwd_kernel_multi (G=1; the Pallas body launched by
// _resident_bwd_multi). For question b with v = store[rows[b]], the saved
// post-ReLU h, alpha, the v_att cotangent g and sga = g_alpha - S (packed
// by the caller):
//
//   dalpha_n = (bf16(g) . v_n) * r_n              (r = 1 when !normalize)
//   ds_n     = alpha_n (dalpha_n + sga_n)
//   dz_nk    = [h_nk > 0] ds_n ws_k
//   dqh_bk   = sum_n dz_nk,   dws_k += sum_n ds_n h_nk
//   dW_v     = sum_{b,n} v_n^T bf16(dz_n r_n)
//
// The store gets no gradient (it is data). The rounding points are the
// Pallas kernel's: g and dz * r in bf16, every sum in f32.
//
// What bounds it on an H100: dW_v over the B * n_valid = 50176 live cells
// of a batch of 256 is 105 GFLOP of bf16 (106 us at 989 TFLOP/s); the bytes
// (205 MB of grid, 51 MB of h) take 77 us: the tensor cores.
//
// Design: the TPU kernel runs the questions on a sequential grid and
// accumulates dW_v and dws in resident output blocks. Hopper blocks run in
// parallel with nothing carried between them, and float atomics would make
// the sums depend on the schedule, so the work is split in three launches:
//
//  1. attn_res_bwd_rows_kernel, one block per question: each warp takes
//     cells and reads the store row once with 16-byte loads for dalpha
//     (and the sum of squares when normalizing); then each thread takes
//     hidden units and walks the cells in order for dqh, its question's dws
//     partial and bf16(dz * r), written compactly as [B * n_valid, H].
//  2. the dW_v GEMM, [C, B*n_valid] x [B*n_valid, H], with the store rows
//     looked up per cell as in K4 (attention_dwv.cuh, shared with K8):
//     blocks own 128 x 128 tiles of dW_v and a fixed slice of the cells
//     (split over K, so that the 64 tiles fill the card), bf16 WMMA, one
//     partial tile per block;
//  3. a reduction that sums the dW_v partials over the splits and the dws
//     partials over the questions, both in a fixed order: the result does
//     not depend on the schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_dwv.cuh"

namespace {

constexpr int kRowThreads = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__global__ void __launch_bounds__(kRowThreads)
attn_res_bwd_rows_kernel(const __nv_bfloat16* __restrict__ store,  // [M,Np,C]
                         const int* __restrict__ rows,             // [B]
                         const __nv_bfloat16* __restrict__ h,  // [B, Np, H]
                         const float* __restrict__ ws,         // [H]
                         const float* __restrict__ alpha,      // [B, Np]
                         const float* __restrict__ g,          // [B, C]
                         const float* __restrict__ sga,        // [B, Np]
                         float* __restrict__ dqh,              // [B, H]
                         float* __restrict__ dws_part,         // [B, H]
                         __nv_bfloat16* __restrict__ dzr,  // [B*n_valid, H]
                         int Np, int n_valid, int C, int H, int normalize) {
  extern __shared__ float sh[];  // bf16(g) [C], ds [Np], r [Np]
  float* gs = sh;
  float* ds = sh + C;
  float* rs = ds + Np;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int c = tid; c < C; c += kRowThreads) {
    gs[c] = round_bf16(g[static_cast<size_t>(b) * C + c]);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const __nv_bfloat16* v = store + static_cast<size_t>(rows[b]) * Np * C;
  for (int n = warp; n < n_valid; n += kRowThreads / 32) {
    const __nv_bfloat16* row = v + static_cast<size_t>(n) * C;
    float dot = 0.0f, sq = 0.0f;
    for (int c = lane * 8; c < C; c += 256) {
      const uint4 x4 = *reinterpret_cast<const uint4*>(row + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = __bfloat162float(e[i]);
        dot = fmaf(gs[c + i], x, dot);
        sq += round_bf16(x * x);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    if (lane == 0) {
      const float r = normalize ? rsqrtf(sq + 1e-12f) : 1.0f;
      const size_t o = static_cast<size_t>(b) * Np + n;
      ds[n] = alpha[o] * (dot * r + sga[o]);
      rs[n] = r;
    }
  }
  __syncthreads();

  for (int k = tid; k < H; k += kRowThreads) {
    const float wk = ws[k];
    const __nv_bfloat16* hk = h + static_cast<size_t>(b) * Np * H + k;
    __nv_bfloat16* out = dzr + static_cast<size_t>(b) * n_valid * H + k;
    float dq = 0.0f, dw = 0.0f;
    for (int n = 0; n < n_valid; ++n) {
      const float hv = __bfloat162float(hk[static_cast<size_t>(n) * H]);
      const float d = ds[n];
      const float dz = hv > 0.0f ? d * wk : 0.0f;
      dq += dz;
      dw = fmaf(d, hv, dw);
      out[static_cast<size_t>(n) * H] = __float2bfloat16(dz * rs[n]);
    }
    dqh[static_cast<size_t>(b) * H + k] = dq;
    dws_part[static_cast<size_t>(b) * H + k] = dw;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// store [M, Np, C] bf16, rows [B] i32, h [B, Np, H] bf16 (K4's residual),
// ws [H] f32, alpha [B, Np] f32, g [B, C] f32, sga [B, Np] f32
// -> dqh [B, H], dwv [C, H], dws [H], all f32. Scratch: dzr
// [B*n_valid, H] bf16, dws_part [B, H] f32, part [splits, C, H] f32.
// Needs C % 128 == 0 and H % 128 == 0 (checked by the caller). Three
// launches on `stream`, counting in *launched those that launched; returns
// the first launch error.
int attention_resident_bwd(const void* store, const void* rows,
                           const void* h, const void* ws, const void* alpha,
                           const void* g, const void* sga, void* dzr,
                           void* dws_part, void* part, void* dqh, void* dwv,
                           void* dws, int B, int Np, int n_valid, int C,
                           int H, int normalize, int splits, void* stream,
                           int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (static_cast<size_t>(C) + 2 * Np) * sizeof(float);
  attn_res_bwd_rows_kernel<<<B, kRowThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(store),
      static_cast<const int*>(rows), static_cast<const __nv_bfloat16*>(h),
      static_cast<const float*>(ws), static_cast<const float*>(alpha),
      static_cast<const float*>(g), static_cast<const float*>(sga),
      static_cast<float*>(dqh), static_cast<float*>(dws_part),
      static_cast<__nv_bfloat16*>(dzr), Np, n_valid, C, H, normalize);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  e = attn_dwv::launch_dwv(
      attn_dwv::StoreCells{static_cast<const __nv_bfloat16*>(store),
                           static_cast<const int*>(rows), n_valid, Np, C},
      static_cast<const __nv_bfloat16*>(dzr), static_cast<float*>(part),
      B * n_valid, C, H, splits, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  e = attn_dwv::launch_reduce(static_cast<const float*>(part),
                              static_cast<const float*>(dws_part),
                              static_cast<float*>(dwv),
                              static_cast<float*>(dws), splits, C, H, B, st);
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // extern "C"
