// K8 `attention_bwd`: fused backward of the gathered single-glimpse
// attention (the parameter cotangents; the grid gets none), for Hopper
// (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention.py::_make_bwd_kernel
// (the Pallas body launched by _attention_pallas_bwd). The caller forms the
// score cotangent ds = alpha (r (g . v) + g_alpha - S) and hands over the
// forward's per-cell norm r (K2's residual), as the JAX package does in
// XLA. For question b, cell n, hidden unit k:
//
//   z_nk  = (v_n . W_v[:, k]) r_n + qh_bk          (r = 1 when !normalize)
//   dz_nk = [z_nk > 0] ds_n ws_k
//   dqh_bk = sum_n dz_nk,   dws_k = sum_{b,n} ds_n relu(z_nk)
//   dW_v  = sum_{b,n} v_n^T bf16(dz_n r_n)
//
// The rounding points are the Pallas body's: products of bf16 values summed
// in f32, dz * r rounded to bf16 ahead of the dW_v product.
//
// What bounds it on an H100: at B=256, N=196, C=2048, H=512 the recomputed
// z and the dW_v GEMM are 105 GFLOP of bf16 each (0.21 ms at 989 TFLOP/s),
// the grid 205 MB (61 us at 3.35 TB/s): the tensor cores.
//
// Design. The TPU kernel walks an (H chunk, batch tile, cell chunk) grid in
// order and accumulates all three cotangents in VMEM output blocks; its H
// chunks exist for VMEM's sake and re-read v once each. Hopper blocks run
// in parallel with nothing carried between them, and float atomics would
// make the sums depend on the schedule, so the work is three launches:
//
//  1. attn_bwd_dz_kernel, one block per (128 hidden units, question): K2's
//     score-GEMM tile (64 cells x 128 units, bf16 WMMA over 32-channel
//     k-steps) walks the question's cells in chunks of 64, so N=196 needs
//     no padding (the last chunk's rows past N are masked, and its warps
//     with no valid row skip their MMAs). The epilogue turns each z into
//     dz, writes bf16(dz * r) compactly as [B*N, H], and sums dqh and the
//     question's dws partial per unit in a fixed order;
//  2. the dW_v GEMM [C, B*N] x [B*N, H] of attention_dwv.cuh (shared with
//     K5 and P2: wgmma on transposed operands from a cp.async ring), split
//     over the cells, one partial tile per block;
//  3. the fixed-order reduction of the dW_v partials and of the dws
//     partials over the questions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "attention_dwv.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 64;    // cells per chunk
constexpr int kBN = 128;   // hidden units per block
constexpr int kBK = 32;    // channels per k-step
constexpr int kALd = kBK + 8;   // padded smem leading dims (bank spread,
constexpr int kBLd = kBN + 8;   // and 32-byte aligned fragment rows)
constexpr int kCLd = kBN + 4;
constexpr int kThreads = 256;   // 8 warps: 4 row x 2 column groups

__global__ void __launch_bounds__(kThreads)
attn_bwd_dz_kernel(const __nv_bfloat16* __restrict__ v,   // [B*N, C]
                   const __nv_bfloat16* __restrict__ wv,  // [C, H]
                   const float* __restrict__ qh,          // [B, H]
                   const float* __restrict__ ws,          // [H]
                   const float* __restrict__ ds,          // [B*N]
                   const float* __restrict__ r,           // [B*N]
                   float* __restrict__ dqh,               // [B, H]
                   float* __restrict__ dws_part,          // [B, H]
                   __nv_bfloat16* __restrict__ dzr,       // [B*N, H]
                   int N, int C, int H, int normalize) {
  __shared__ __align__(128) __nv_bfloat16 As[kBM * kALd];
  __shared__ __align__(128) __nv_bfloat16 Bs[kBK * kBLd];
  __shared__ __align__(128) float Cs[kBM * kCLd];
  __shared__ float ds_s[kBM];
  __shared__ float r_s[kBM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // rows wr*16 .. +16 of the chunk
  const int wc = warp & 1;   // columns wc*64 .. +64 of the tile
  const int col0 = blockIdx.x * kBN;
  const int b = blockIdx.y;
  const size_t cell0 = static_cast<size_t>(b) * N;
  const __nv_bfloat16* vb = v + cell0 * C;

  // A tile: 64 rows x 32 channels = 256 x 16-byte loads, one per thread.
  const int a_r = tid >> 2;
  const int a_c = (tid & 3) * 8;
  // Epilogue: thread tid takes column ec and rows eh*32 .. +32 of a chunk.
  const int ec = tid & (kBN - 1);
  const int eh = tid >> 7;
  const float q_c = qh[static_cast<size_t>(b) * H + col0 + ec];
  const float w_c = ws[col0 + ec];
  float dq = 0.0f, dw = 0.0f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
  for (int n0 = 0; n0 < N; n0 += kBM) {
    const int rows_here = min(kBM, N - n0);
    const bool warp_live = wr * 16 < rows_here;  // uniform in the warp
    const bool a_ok = a_r < rows_here;
    const __nv_bfloat16* a_src =
        vb + static_cast<size_t>(a_ok ? n0 + a_r : 0) * C + a_c;
    if (tid < kBM) {
      const bool ok = tid < rows_here;
      ds_s[tid] = ok ? ds[cell0 + n0 + tid] : 0.0f;
      r_s[tid] = ok && normalize ? r[cell0 + n0 + tid] : 1.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

    for (int k0 = 0; k0 < C; k0 += kBK) {
      uint4 a4 = make_uint4(0u, 0u, 0u, 0u);
      if (a_ok) a4 = *reinterpret_cast<const uint4*>(a_src + k0);
      *reinterpret_cast<uint4*>(&As[a_r * kALd + a_c]) = a4;
      // B tile: 32 rows x 128 columns = 512 x 16-byte loads, two a thread.
      for (int i = tid; i < kBK * kBN / 8; i += kThreads) {
        const int br = i / (kBN / 8);
        const int bc = (i % (kBN / 8)) * 8;
        *reinterpret_cast<uint4*>(&Bs[br * kBLd + bc]) =
            *reinterpret_cast<const uint4*>(
                wv + static_cast<size_t>(k0 + br) * H + col0 + bc);
      }
      __syncthreads();
      if (warp_live) {
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> af;
          wmma::load_matrix_sync(af, &As[(wr * 16) * kALd + kk], kALd);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> bf;
            wmma::load_matrix_sync(bf, &Bs[kk * kBLd + wc * 64 + j * 16],
                                   kBLd);
            wmma::mma_sync(acc[j], af, bf, acc[j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(&Cs[(wr * 16) * kCLd + wc * 64 + j * 16],
                              acc[j], kCLd, wmma::mem_row_major);
    }
    __syncthreads();

    for (int i = 0; i < 32; ++i) {
      const int row = eh * 32 + i;  // the same row across the warp
      if (row < rows_here) {
        const float rr = r_s[row];
        const float d = ds_s[row];
        const float z = Cs[row * kCLd + ec] * rr + q_c;
        const float dz = z > 0.0f ? d * w_c : 0.0f;
        dq += dz;
        dw = fmaf(d, fmaxf(z, 0.0f), dw);
        dzr[(cell0 + n0 + row) * H + col0 + ec] = __float2bfloat16(dz * rr);
      }
    }
    __syncthreads();  // Cs, ds_s and r_s are refilled by the next chunk
  }
  // Fold the two row halves, in a fixed order.
  if (eh == 1) {
    Cs[ec] = dq;
    Cs[kBN + ec] = dw;
  }
  __syncthreads();
  if (eh == 0) {
    dqh[static_cast<size_t>(b) * H + col0 + ec] = dq + Cs[ec];
    dws_part[static_cast<size_t>(b) * H + col0 + ec] = dw + Cs[kBN + ec];
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// v [B, N, C] bf16, wv [C, H] bf16, qh [B, H] f32, ws [H] f32, ds [B, N]
// f32, r [B, N] f32 (read only when normalize) -> dqh [B, H], dwv [C, H],
// dws [H], all f32. Scratch: dzr [B*N, H] bf16, dws_part [B, H] f32, part
// [splits, C, H] f32. Needs C % 128 == 0 and H % 128 == 0 (checked by the
// caller). Three launches on `stream`, counting in *launched those that
// launched; returns the first launch error.
int attention_bwd(const void* v, const void* wv, const void* qh,
                  const void* ws, const void* ds, const void* r, void* dzr,
                  void* dws_part, void* part, void* dqh, void* dwv, void* dws,
                  int B, int N, int C, int H, int normalize, int splits,
                  void* stream, int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  attn_bwd_dz_kernel<<<dim3(H / kBN, B), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(wv), static_cast<const float*>(qh),
      static_cast<const float*>(ws), static_cast<const float*>(ds),
      static_cast<const float*>(r), static_cast<float*>(dqh),
      static_cast<float*>(dws_part), static_cast<__nv_bfloat16*>(dzr), N, C,
      H, normalize);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  e = attn_dwv::launch_dwv(
      attn_dwv::DenseCells{static_cast<const __nv_bfloat16*>(v), C},
      static_cast<const __nv_bfloat16*>(dzr), static_cast<float*>(part),
      B * N, C, H, splits, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  e = attn_dwv::launch_reduce(static_cast<const float*>(part),
                              static_cast<const float*>(dws_part),
                              static_cast<float*>(dwv),
                              static_cast<float*>(dws), splits, C, H, B, H,
                              st);
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // extern "C"
