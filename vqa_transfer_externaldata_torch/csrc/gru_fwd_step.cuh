// The GRU forward cell (gru_cell), which K1 `gru_fwd` (csrc/gru_fwd.cu, one
// persistent launch for all timesteps) and K6 `bigru_fwd`
// (csrc/bigru_fwd.cu) both apply, and the step kernel that K6 launches once
// per timestep. The step math is
// vqa_transfer_externaldata_tpu/ops/gru.py::_gru_cell:
//
//   gh = bf16(h) @ U_h                      (f32 accumulation)
//   r  = sigmoid(gx_r + gh_r),  z = sigmoid(gx_z + gh_z)
//   n  = tanh(gx_n + r * (gh_n + b_hn))
//   h' = (1 - z) * n + z * h                applied only where t < lens[b]
//
// gru_cell holds the elementwise part; both kernels call it, so their gate
// math is one set of expressions. The step kernel (one launch per timestep,
// K6): a block owns a 16-row x 16-unit tile of h' and so the 48 columns j,
// H+j, 2H+j of U_h that its three gates need. It stages that U_h slice and
// its 16 rows of h_prev (rounded to bf16, as the reference rounds before its
// matmul) in shared memory with 16-byte loads that are all in flight at
// once, then three warps take gh for the r, z and n gates on the tensor
// cores (bf16 WMMA 16x16x16, f32 accumulation), so gh never reaches device
// memory. Every thread then applies the gates and the mask to one element.
// blockIdx.z picks the direction: each launch carries the arguments of one
// or two independent recurrences (`d0`, `d1`), so one launch advances both
// chains of a bidirectional GRU with the same cell math and rounding as two
// one-direction launches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTile = 16;            // batch rows and hidden units per block
constexpr int kCols = 3 * kTile;     // U_h columns per block (r, z, n)
constexpr int kThreads = 256;        // one per element of the output tile
constexpr int kBLd = kCols + 8;      // padded leading dims of the smem
constexpr int kCLd = kCols + 4;      // tiles (32-byte aligned fragments)

__host__ __device__ constexpr int a_ld(int H) { return H + 8; }

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

__host__ __device__ constexpr size_t smem_bytes(int H) {
  // As [16][H+8] bf16 | Bs [H][56] bf16 | Cs [16][52] f32, 128-aligned.
  return align128(static_cast<size_t>(kTile) * a_ld(H) * 2) +
         align128(static_cast<size_t>(H) * kBLd * 2) +
         static_cast<size_t>(kTile) * kCLd * 4;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One element of the step: x* = gx of the gates, gh* = bf16(h_prev) @ U_h
// of the gates, hp = the f32 state before the step, live = t < lens[b].
__device__ __forceinline__ float gru_cell(float xr, float xz, float xn,
                                          float ghr, float ghz, float ghn,
                                          float bhn, float hp, bool live) {
  const float r = sigmoid(xr + ghr);
  const float z = sigmoid(xz + ghz);
  const float n = tanhf(xn + r * (ghn + bhn));
  const float h_new = (1.0f - z) * n + z * hp;
  return live ? h_new : hp;
}

// One direction's timestep. h_prev == nullptr means the zero initial state.
struct FwdStep {
  const float* gx;             // [B, 3H] at step t
  const float* h_prev;         // [B, H] or null
  const __nv_bfloat16* uh;     // [H, 3H]
  const float* bhn;            // [H]
  float* h_out;                // [B, H] (hseq[t])
  float* h_final;              // [B, H] or null
  int t;
};

__global__ void __launch_bounds__(kThreads)
gru_step_kernel(FwdStep d0, FwdStep d1, const int* __restrict__ lens, int B,
                int H) {
  const FwdStep s = blockIdx.z == 0 ? d0 : d1;
  const float* __restrict__ h_prev = s.h_prev;
  const __nv_bfloat16* __restrict__ uh = s.uh;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = a_ld(H);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(
      smem + ((static_cast<size_t>(kTile) * lda * 2 + 127) / 128) * 128);
  float* Cs = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(Bs) +
      ((static_cast<size_t>(H) * kBLd * 2 + 127) / 128) * 128);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const size_t H3 = 3 * static_cast<size_t>(H);

  // h_prev rows b0..b0+15, rounded to bf16: four floats per load.
  const int q4 = H / 4;
  for (int i = tid; i < kTile * q4; i += kThreads) {
    const int row = i / q4;
    const int c = (i - row * q4) * 4;
    const int b = b0 + row;
    float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (h_prev != nullptr && b < B) {
      h = *reinterpret_cast<const float4*>(
          h_prev + static_cast<size_t>(b) * H + c);
    }
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(As + row * lda + c);
    dst[0] = __floats2bfloat162_rn(h.x, h.y);
    dst[1] = __floats2bfloat162_rn(h.z, h.w);
  }
  // U_h columns j0.., H+j0.., 2H+j0.. of every row: six 16-byte loads a row.
  for (int i = tid; i < H * 6; i += kThreads) {
    const int k = i / 6;
    const int sl = i - k * 6;
    const int g = sl >> 1;
    const int half = (sl & 1) * 8;
    *reinterpret_cast<uint4*>(Bs + k * kBLd + g * kTile + half) =
        *reinterpret_cast<const uint4*>(uh + k * H3 + g * H + j0 + half);
  }
  __syncthreads();

  const int warp = tid >> 5;
  if (warp < 3) {  // warp g computes gate g's 16x16 tile of gh
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < H; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf;
      wmma::load_matrix_sync(af, As + kk, lda);
      wmma::load_matrix_sync(bf, Bs + kk * kBLd + warp * kTile, kBLd);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(Cs + warp * kTile, acc, kCLd,
                            wmma::mem_row_major);
  }
  __syncthreads();

  const int bl = tid / kTile;
  const int jl = tid - bl * kTile;
  const int b = b0 + bl;
  const int j = j0 + jl;
  if (b >= B) return;
  const float* gh = Cs + bl * kCLd + jl;
  const float* g = s.gx + b * H3;
  const size_t o = static_cast<size_t>(b) * H + j;
  const float hp = h_prev != nullptr ? h_prev[o] : 0.0f;
  const float h = gru_cell(g[j], g[H + j], g[2 * H + j], gh[0], gh[kTile],
                           gh[2 * kTile], s.bhn[j], hp, s.t < lens[b]);
  s.h_out[o] = h;
  if (s.h_final != nullptr) s.h_final[o] = h;
}

// Grants the step kernel its dynamic shared memory; returns the CUDA error.
inline cudaError_t prepare_step_kernel(int H) {
  return cudaFuncSetAttribute(gru_step_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(H)));
}

}  // namespace
