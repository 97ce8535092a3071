// K4 `attention_resident_fwd`: gather-free attention forward with G glimpses
// (1 <= G <= 8) over a feature store resident in device memory, for Hopper
// (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention_resident.py::
// _make_fwd_kernel_multi (the Pallas body launched by _resident_fwd_multi).
// Question b reads its grid straight out of the store row rows[b]; no
// [B, Np, C] batch is ever built. The G glimpses share the one score GEMM:
//
//   v       = store[rows[b]]                     [Np, C] (Np padded cells)
//   r       = rsqrt(sum_c bf16(v^2) + 1e-12)     (1 when !normalize)
//   h       = relu((v @ W_v) * r + qh[b])        [Np, H] f32; saved in bf16
//   s_g     = h . ws_g, masked to -1e30 at cells >= n_valid   (each glimpse)
//   alpha_g = softmax_Np(s_g)
//   v_att_g = sum_n bf16(alpha_gn r_n) v_n       (concatenated in g order)
//
// The rounding follows the Pallas kernel: f32 sums of bf16 products, h in
// f32 for the scores, each glimpse's alpha * r rounded to bf16 before its
// weighted sum.
//
// The store rows are bf16, or the int8 codes of an L2-prenormalized store
// (the Pallas kernel's int8 branch, which casts the codes in VMEM): the
// loads widen them to bf16, exactly (store_rows.cuh), and the rest runs as
// on bf16 rows. The store's scale is applied outside the kernel (folded
// into W_v, and to v_att afterwards), and an int8 store is never
// normalized here: it was normalized before it was quantized.
//
// What bounds it on an H100: at B=256, n_valid=196, C=2048, H=512 the score
// GEMM is 105 GFLOP of bf16 (106 us at 989 TFLOP/s; each glimpse adds a
// 0.2 GFLOP weighted sum) against 205 MB of grid reads (102 MB of int8
// codes) and 51 MB of saved h (77 us at 3.35 TB/s): the tensor cores.
//
// Design: the TPU kernel runs one program per question with the row index
// prefetched into scalar memory. Here the structure of K2
// (csrc/attention_fwd.cu) carries over, with the row lookup moved into the
// loads:
//
//  1. attn_res_score_kernel: the [B*Np, C] x [C, H] score GEMM over all
//     cells of all questions at once. Each thread computes the base pointer
//     of the cell it stages (store + (rows[b] * Np + n) * C) in place of
//     the scalar prefetch. Blocks own 64-cell x 128-column tiles on bf16
//     WMMA; the next k-step's tiles are loaded into registers while the
//     tensor cores work on the current one. The epilogue forms h, writes it
//     in bf16 on the grad path, and reduces it against the G columns of ws
//     into G partial scores per cell and column tile. The GEMM runs once
//     whatever G is, as on the TPU.
//  2. attn_res_wsum_kernel: one block per (question, 512-channel chunk) sums
//     the partial scores in a fixed order (deterministic), takes the G
//     masked softmaxes in shared memory, then forms all G weighted sums in
//     ONE pass over the store row (coalesced bf16x2 loads, G accumulator
//     pairs per thread): the row is read once, not G times.
//
// G is a template parameter instantiated for 1..8 (the TPU kernel's limit,
// its ws sublane window), so the G=1 code is the single-glimpse kernel; the
// row type T (bf16 or int8) is the second, picked by a flag in the C entry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

#include "store_rows.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 64;    // cells per score tile
constexpr int kBN = 128;   // hidden columns per score tile
constexpr int kBK = 32;    // channels per k-step
constexpr int kALd = kBK + 8;
constexpr int kBLd = kBN + 8;
constexpr int kCLd = kBN + 4;
constexpr int kScoreThreads = 256;  // 8 warps: 4 row x 2 column groups
constexpr int kWsumThreads = 256;
constexpr int kWsumChannels = 2 * kWsumThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int G, class T>
__global__ void __launch_bounds__(kScoreThreads)
attn_res_score_kernel(const T* __restrict__ store,  // [M, Np, C] bf16 | int8
                      const int* __restrict__ rows,             // [B]
                      const __nv_bfloat16* __restrict__ wv,     // [C, H]
                      const float* __restrict__ qh,             // [B, H]
                      const float* __restrict__ ws,             // [G, H]
                      float* __restrict__ part,       // [H/kBN, G, B*Np]
                      float* __restrict__ rnorm,         // [B*Np]
                      __nv_bfloat16* __restrict__ hsave,  // [B*Np, H] / null
                      int cells, int Np, int C, int H, int normalize) {
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

  // A tile: 64 cells x 32 channels, eight channels a thread (one 16-byte
  // load of bf16, or one 8-byte load of codes widened to bf16), each from
  // the store row of its cell's question.
  const int a_r = tid >> 2;
  const int a_c = (tid & 3) * 8;
  const int a_cell = row0 + a_r;
  const bool a_ok = a_cell < cells;
  const T* a_src = store;
  if (a_ok) {
    const int b = a_cell / Np;
    const int n = a_cell - b * Np;
    a_src = store + (static_cast<size_t>(rows[b]) * Np + n) * C + a_c;
  }
  // B tile: 32 rows x 128 columns = 512 x 16-byte loads, two per thread.
  const int b_r = tid >> 4;
  const int b_c = (tid & 15) * 8;
  const __nv_bfloat16* b_src =
      wv + static_cast<size_t>(b_r) * H + col0 + b_c;
  const size_t b_half = static_cast<size_t>(16) * H;

  store_rows::raw8_t<T> a_raw{};
  if (a_ok) a_raw = store_rows::load_raw8(a_src);
  uint4 b4a = *reinterpret_cast<const uint4*>(b_src);
  uint4 b4b = *reinterpret_cast<const uint4*>(b_src + b_half);
  float sq = 0.0f;

  for (int k0 = 0; k0 < C; k0 += kBK) {
    const uint4 a4 = store_rows::widen8(a_raw);
    *reinterpret_cast<uint4*>(&As[a_r * kALd + a_c]) = a4;
    *reinterpret_cast<uint4*>(&Bs[b_r * kBLd + b_c]) = b4a;
    *reinterpret_cast<uint4*>(&Bs[(b_r + 16) * kBLd + b_c]) = b4b;
    if constexpr (!store_rows::kInt8<T>) {  // int8 stores: prenormalized
      if (normalize) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&a4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = __bfloat162float(e[i]);
          sq += round_bf16(x * x);
        }
      }
    }
    __syncthreads();
    if (k0 + kBK < C) {  // next k-step's tiles in flight during the MMAs
      const size_t kn = k0 + kBK;
      if (a_ok) a_raw = store_rows::load_raw8(a_src + kn);
      b4a = *reinterpret_cast<const uint4*>(b_src + kn * H);
      b4b = *reinterpret_cast<const uint4*>(b_src + kn * H + b_half);
    }
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
  // The four threads that loaded a cell's channels hold its sum of squares.
  sq += __shfl_xor_sync(0xffffffffu, sq, 1);
  sq += __shfl_xor_sync(0xffffffffu, sq, 2);
  if ((tid & 3) == 0) {
    const float r = normalize ? rsqrtf(sq + 1e-12f) : 1.0f;
    rs[a_r] = r;
    if (blockIdx.y == 0 && a_ok) rnorm[a_cell] = r;
  }
  __syncthreads();

  // Epilogue: four threads per cell, 32 columns each, G scores.
  const int er = tid >> 2;
  const int eq = tid & 3;
  const int cell = row0 + er;
  float s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = 0.0f;
  if (cell < cells) {
    const float r = rs[er];
    const int c0 = col0 + eq * 32;
    const float* q = qh + static_cast<size_t>(cell / Np) * H + c0;
    const float* w = ws + c0;
    const float* z = Cs + er * kCLd + eq * 32;
    __align__(16) __nv_bfloat16 hb[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      // (z * r) + qh rounded as two operations, as the reference does.
      const float h = fmaxf(__fadd_rn(__fmul_rn(z[c], r), q[c]), 0.0f);
      hb[c] = __float2bfloat16(h);
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = fmaf(h, w[g * H + c], s[g]);
    }
    if (hsave != nullptr) {
      uint4* dst = reinterpret_cast<uint4*>(
          hsave + static_cast<size_t>(cell) * H + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[i] = reinterpret_cast<uint4*>(hb)[i];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
    s[g] += __shfl_xor_sync(0xffffffffu, s[g], 2);
    if (eq == 0 && cell < cells) {
      part[(static_cast<size_t>(blockIdx.y) * G + g) * cells + cell] = s[g];
    }
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

template <int G, class T>
__global__ void __launch_bounds__(kWsumThreads)
attn_res_wsum_kernel(const T* __restrict__ store,  // [M, Np, C] bf16 | int8
                     const int* __restrict__ rows,             // [B]
                     const float* __restrict__ part,  // [n_part, G, B*Np]
                     const float* __restrict__ rnorm,  // [B*Np]
                     float* __restrict__ vatt,         // [B, G, C]
                     float* __restrict__ alpha,        // [B, Np, G]
                     int B, int Np, int n_valid, int C, int n_part) {
  extern __shared__ float sh[];  // p [G][Np], then the bf16 weights w [G][Np]
  __shared__ float red[32];
  float* p = sh;
  float* w = sh + G * Np;
  const int b = blockIdx.x;
  const size_t cells = static_cast<size_t>(B) * Np;
  const size_t base = static_cast<size_t>(b) * Np;

  for (int g = 0; g < G; ++g) {  // one masked softmax per glimpse
    float* pg = p + g * Np;
    float m = -INFINITY;
    for (int n = threadIdx.x; n < Np; n += blockDim.x) {
      float s = 0.0f;
      for (int i = 0; i < n_part; ++i) {
        s += part[(static_cast<size_t>(i) * G + g) * cells + base + n];
      }
      if (n >= n_valid) s = kNegInf;
      pg[n] = s;
      m = fmaxf(m, s);
    }
    m = block_reduce<true>(m, red);
    float d = 0.0f;
    for (int n = threadIdx.x; n < Np; n += blockDim.x) {
      const float e = expf(pg[n] - m);
      pg[n] = e;
      d += e;
    }
    d = block_reduce<false>(d, red);  // its barriers also publish pg
    for (int n = threadIdx.x; n < Np; n += blockDim.x) {
      const float a = pg[n] / d;
      if (blockIdx.y == 0) alpha[(base + n) * G + g] = a;
      w[g * Np + n] = round_bf16(a * rnorm[base + n]);
    }
  }
  __syncthreads();

  // All G weighted sums from one pass over the store row, two channels a
  // thread (a bf16x2 or a char2 load).
  const int c = blockIdx.y * kWsumChannels + 2 * threadIdx.x;
  if (c < C) {
    const T* src = store + static_cast<size_t>(rows[b]) * Np * C + c;
    float a0[G], a1[G];
#pragma unroll
    for (int g = 0; g < G; ++g) a0[g] = a1[g] = 0.0f;
    for (int n = 0; n < n_valid; ++n) {  // masked cells weigh exactly 0
      const float2 x = store_rows::load2(src + static_cast<size_t>(n) * C);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float wn = w[g * Np + n];
        a0[g] = fmaf(wn, x.x, a0[g]);
        a1[g] = fmaf(wn, x.y, a1[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* out = vatt + (static_cast<size_t>(b) * G + g) * C + c;
      out[0] = a0[g];
      out[1] = a1[g];
    }
  }
}

template <int G, class T>
int launch_fwd(const void* store, const void* rows, const void* wv,
               const void* qh, const void* ws, void* part, void* rnorm,
               void* hsave, void* vatt, void* alpha, int B, int Np,
               int n_valid, int C, int H, int normalize, cudaStream_t st,
               int* launched) {
  const int cells = B * Np;
  const dim3 g1((cells + kBM - 1) / kBM, H / kBN);
  attn_res_score_kernel<G, T><<<g1, kScoreThreads, 0, st>>>(
      static_cast<const T*>(store),
      static_cast<const int*>(rows), static_cast<const __nv_bfloat16*>(wv),
      static_cast<const float*>(qh), static_cast<const float*>(ws),
      static_cast<float*>(part), static_cast<float*>(rnorm),
      static_cast<__nv_bfloat16*>(hsave), cells, Np, C, H, normalize);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  const dim3 g2(B, (C + kWsumChannels - 1) / kWsumChannels);
  const size_t smem = 2 * static_cast<size_t>(G) * Np * sizeof(float);
  attn_res_wsum_kernel<G, T><<<g2, kWsumThreads, smem, st>>>(
      static_cast<const T*>(store),
      static_cast<const int*>(rows), static_cast<const float*>(part),
      static_cast<const float*>(rnorm), static_cast<float*>(vatt),
      static_cast<float*>(alpha), B, Np, n_valid, C, H / kBN);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// store [M, Np, C] bf16, or int8 codes when int8 != 0 (then normalize must
// be 0), rows [B] i32 (< M, checked by the caller),
// wv [C, H] bf16, qh [B, H] f32, ws [G, H] f32 (1 <= G <= 8) -> vatt
// [B, G, C] f32, alpha [B, Np, G] f32 (0 at cells >= n_valid), and h
// [B, Np, H] bf16 when hsave is not null. Scratch: part [H/128, G, B*Np]
// f32, rnorm [B*Np] f32. Needs C % 32 == 0 and H % 128 == 0 (checked by the
// caller). Two launches on `stream`, counting in *launched those that
// launched; returns the first launch error.
int attention_resident_fwd(const void* store, const void* rows,
                           const void* wv, const void* qh, const void* ws,
                           void* part, void* rnorm, void* hsave, void* vatt,
                           void* alpha, int B, int Np, int n_valid, int C,
                           int H, int G, int normalize, int int8,
                           void* stream, int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8 && normalize) return static_cast<int>(cudaErrorInvalidValue);
#define K4_CASE(g)                                                          \
  case g:                                                                   \
    return int8 ? launch_fwd<g, int8_t>(store, rows, wv, qh, ws, part,      \
                                        rnorm, hsave, vatt, alpha, B, Np,   \
                                        n_valid, C, H, 0, st, launched)     \
                : launch_fwd<g, __nv_bfloat16>(                             \
                      store, rows, wv, qh, ws, part, rnorm, hsave, vatt,    \
                      alpha, B, Np, n_valid, C, H, normalize, st, launched);
  switch (G) {
    K4_CASE(1) K4_CASE(2) K4_CASE(3) K4_CASE(4)
    K4_CASE(5) K4_CASE(6) K4_CASE(7) K4_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K4_CASE
}

}  // extern "C"
