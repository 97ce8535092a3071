// K2 `attention_fwd`: single-glimpse spatial attention forward over a
// gathered grid, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention.py::_make_kernel
// (the streaming online-softmax Pallas body launched by
// _attention_pallas_fwd), with its optional fused per-cell L2 norm:
//
//   r     = rsqrt(sum_c bf16(v^2) + 1e-12)        (1 when !normalize)
//   h     = relu((v @ W_v) * r + qh)              [B, N, H], f32
//   s     = h . ws                                [B, N]
//   alpha = softmax_N(s)
//   v_att = sum_n bf16(p_n * r_n) v_n / sum_n p_n,   p = exp(s - max s)
//
// The rounding follows the Pallas kernel: f32 accumulation of bf16
// products, h kept in f32 for the score, and p * r rounded to bf16 before
// the weighted sum.
//
// What bounds it on an H100: at B=64, N=196, C=2048, H=512 the score GEMM
// is 26.3 GFLOP of bf16 (26.6 us at 989 TFLOP/s) and the grid is 51 MB
// (16 us at 3.35 TB/s), so the tensor cores bound it at about 27 us.
//
// Design: the TPU kernel streams cell chunks through one core with a
// running max and accumulator in VMEM. Hopper runs blocks in parallel with
// no state carried between them, so the work is split into two launches:
//
//  1. attn_score_kernel: the [B*N, C] x [C, H] score GEMM over all cells
//     of all questions at once (so N=196 needs no padding: only the last
//     row tile is ragged, and it is masked), on bf16 tensor cores through
//     WMMA 16x16x16 fragments. A block owns a 64-cell x 128-column tile,
//     stages v and W_v tiles in shared memory, and reduces its tile
//     against ws in the epilogue, writing one partial score per cell and
//     column tile. The per-cell sum of squares is taken from the same v
//     tiles as they pass through shared memory. h never reaches device
//     memory; only [H/128, B*N] partial scores do (200 KB).
//  2. attn_wsum_kernel: one block per (question, 512-channel chunk) sums
//     the partial scores in a fixed order (deterministic), takes the
//     softmax over the N valid cells in shared memory and accumulates the
//     weighted sum with coalesced bf16x2 loads.
//
// The single-pass online softmax on wgmma with TMA loads is left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kBM = 64;    // cells per score tile
constexpr int kBN = 128;   // hidden columns per score tile
constexpr int kBK = 32;    // channels per k-step
constexpr int kALd = kBK + 8;   // padded smem leading dims (bank spread,
constexpr int kBLd = kBN + 8;   // and 32-byte aligned fragment rows)
constexpr int kCLd = kBN + 4;
constexpr int kScoreThreads = 256;  // 8 warps: 4 row x 2 column groups
constexpr int kWsumThreads = 256;
constexpr int kWsumChannels = 2 * kWsumThreads;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__global__ void __launch_bounds__(kScoreThreads)
attn_score_kernel(const __nv_bfloat16* __restrict__ v,   // [M, C], M = B*N
                  const __nv_bfloat16* __restrict__ wv,  // [C, H]
                  const float* __restrict__ qh,          // [B, H]
                  const float* __restrict__ ws,          // [H]
                  float* __restrict__ part,              // [H/kBN, M]
                  float* __restrict__ rnorm,             // [M]
                  int M, int N, int C, int H, int normalize) {
  __shared__ __align__(128) __nv_bfloat16 As[kBM * kALd];
  __shared__ __align__(128) __nv_bfloat16 Bs[kBK * kBLd];
  __shared__ __align__(128) float Cs[kBM * kCLd];
  __shared__ float rs[kBM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // rows wr*16 .. +16 of the tile
  const int wc = warp & 1;   // columns wc*64 .. +64 of the tile
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

  // A tile: 64 rows x 32 channels = 256 x 16-byte loads, one per thread.
  const int a_r = tid >> 2;
  const int a_c = (tid & 3) * 8;
  const bool a_ok = row0 + a_r < M;
  const __nv_bfloat16* a_src =
      v + static_cast<size_t>(a_ok ? row0 + a_r : 0) * C + a_c;
  float sq = 0.0f;

  for (int k0 = 0; k0 < C; k0 += kBK) {
    uint4 a4 = make_uint4(0u, 0u, 0u, 0u);
    if (a_ok) a4 = *reinterpret_cast<const uint4*>(a_src + k0);
    *reinterpret_cast<uint4*>(&As[a_r * kALd + a_c]) = a4;
    if (normalize) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&a4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = __bfloat162float(e[i]);
        sq += round_bf16(x * x);
      }
    }
    // B tile: 32 rows x 128 columns = 512 x 16-byte loads, two per thread.
    for (int i = tid; i < kBK * kBN / 8; i += kScoreThreads) {
      const int br = i / (kBN / 8);
      const int bc = (i % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[br * kBLd + bc]) =
          *reinterpret_cast<const uint4*>(
              wv + static_cast<size_t>(k0 + br) * H + col0 + bc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::load_matrix_sync(af, &As[(wr * 16) * kALd + kk], kALd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, &Bs[kk * kBLd + wc * 64 + j * 16], kBLd);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(&Cs[(wr * 16) * kCLd + wc * 64 + j * 16], acc[j],
                            kCLd, wmma::mem_row_major);
  }
  // The four threads that loaded a row's channels hold its sum of squares.
  sq += __shfl_xor_sync(0xffffffffu, sq, 1);
  sq += __shfl_xor_sync(0xffffffffu, sq, 2);
  if ((tid & 3) == 0) {
    const float r = normalize ? rsqrtf(sq + 1e-12f) : 1.0f;
    rs[a_r] = r;
    if (blockIdx.y == 0 && a_ok) rnorm[row0 + a_r] = r;
  }
  __syncthreads();

  // Epilogue: four threads per cell, 32 columns each.
  const int er = tid >> 2;
  const int eq = tid & 3;
  const int cell = row0 + er;
  float s = 0.0f;
  if (cell < M) {
    const float r = rs[er];
    const float* q = qh + static_cast<size_t>(cell / N) * H + col0;
    const float* w = ws + col0;
    const float* z = Cs + er * kCLd;
    for (int c = eq * 32; c < eq * 32 + 32; ++c) {
      const float h = fmaxf(z[c] * r + q[c], 0.0f);
      s = fmaf(h, w[c], s);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (eq == 0 && cell < M) {
    part[static_cast<size_t>(blockIdx.y) * M + cell] = s;
  }
}

template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // `red` may still be read from a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i) {
    x = kMax ? fmaxf(x, red[i]) : x + red[i];
  }
  return x;
}

__global__ void __launch_bounds__(kWsumThreads)
attn_wsum_kernel(const __nv_bfloat16* __restrict__ v,  // [B, N, C]
                 const float* __restrict__ part,       // [n_part, B*N]
                 const float* __restrict__ rnorm,      // [B*N]
                 float* __restrict__ vatt,             // [B, C]
                 float* __restrict__ alpha,            // [B, N]
                 int B, int N, int C, int n_part) {
  extern __shared__ float sh[];  // p[N], then the bf16-rounded weights w[N]
  __shared__ float red[32];
  float* p = sh;
  float* w = sh + N;
  const int b = blockIdx.x;
  const size_t M = static_cast<size_t>(B) * N;
  const size_t base = static_cast<size_t>(b) * N;

  float m = -INFINITY;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.0f;
    for (int i = 0; i < n_part; ++i) s += part[i * M + base + n];
    p[n] = s;
    m = fmaxf(m, s);
  }
  m = block_reduce<true>(m, red);
  float d = 0.0f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float e = expf(p[n] - m);
    p[n] = e;
    w[n] = round_bf16(e * rnorm[base + n]);
    d += e;
  }
  d = block_reduce<false>(d, red);  // its barriers also publish p and w
  if (blockIdx.y == 0) {
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      alpha[base + n] = p[n] / d;
    }
  }

  const int c = blockIdx.y * kWsumChannels + 2 * threadIdx.x;
  if (c < C) {
    const __nv_bfloat162* src =
        reinterpret_cast<const __nv_bfloat162*>(v + base * C + c);
    const size_t stride = static_cast<size_t>(C) / 2;
    float a0 = 0.0f, a1 = 0.0f;
    for (int n = 0; n < N; ++n) {
      const float2 x = __bfloat1622float2(src[n * stride]);
      a0 = fmaf(w[n], x.x, a0);
      a1 = fmaf(w[n], x.y, a1);
    }
    vatt[static_cast<size_t>(b) * C + c] = a0 / d;
    vatt[static_cast<size_t>(b) * C + c + 1] = a1 / d;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// v [B, N, C] bf16, wv [C, H] bf16, qh [B, H] f32, ws [H] f32
// -> vatt [B, C] f32, alpha [B, N] f32. Scratch: part [H/128, B*N] f32,
// rnorm [B*N] f32. Needs C % 32 == 0 and H % 128 == 0 (checked by the
// caller). Two launches on `stream`, counting in *launched those that
// launched; returns the first launch error.
int attention_fwd(const void* v, const void* wv, const void* qh,
                  const void* ws, void* part, void* rnorm, void* vatt,
                  void* alpha, int B, int N, int C, int H, int normalize,
                  void* stream, int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const dim3 g1((M + kBM - 1) / kBM, H / kBN);
  attn_score_kernel<<<g1, kScoreThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(wv), static_cast<const float*>(qh),
      static_cast<const float*>(ws), static_cast<float*>(part),
      static_cast<float*>(rnorm), M, N, C, H, normalize);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  const dim3 g2(B, (C + kWsumChannels - 1) / kWsumChannels);
  const size_t smem = 2 * static_cast<size_t>(N) * sizeof(float);
  attn_wsum_kernel<<<g2, kWsumThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(part),
      static_cast<const float*>(rnorm), static_cast<float*>(vatt),
      static_cast<float*>(alpha), B, N, C, H / kBN);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // extern "C"
