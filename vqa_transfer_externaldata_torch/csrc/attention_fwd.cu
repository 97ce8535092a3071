// K2 `attention_fwd`: single-glimpse spatial attention forward over a
// gathered grid, for Hopper (sm_90a). The same source builds K2h
// (csrc/attention_fwd_f16.cu), the float16 instance: E = KernelElem
// (elem16.cuh), the grid's and W_v's type (the Pallas body's dt), is bf16
// here and float16 there.
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention.py::_make_kernel
// (the streaming online-softmax Pallas body launched by
// _attention_pallas_fwd), with its optional fused per-cell L2 norm:
//
//   r     = rsqrt(sum_c E(v^2) + 1e-12)           (1 when !normalize)
//   h     = relu((v @ W_v) * r + qh)              [B, N, H], f32
//   s     = h . ws                                [B, N]
//   alpha = softmax_N(s)
//   v_att = sum_n E(p_n * r_n) v_n / sum_n p_n,   p = exp(s - max s)
//
// The rounding follows the Pallas kernel: f32 accumulation of E products,
// z * r and + qh rounded as two operations, h kept in f32 for the score,
// and p * r rounded to E before the weighted sum. Each square is rounded
// to E before the sum, as JAX's square(v) in dt is: in float16 a cell
// with a value past 256 squares to inf, so its r is 0 in both.
//
// What bounds it on an H100: at B=256, N=196, C=2048, H=512 the score GEMM
// is 105 GFLOP of E (0.106 ms at 989 TFLOP/s, bf16 and f16 alike) and the
// grid is 205 MB (61 us at 3.35 TB/s), so the tensor cores bound it.
//
// Design: the TPU kernel streams cell chunks through one core with a
// running max and accumulator in VMEM. Hopper runs blocks in parallel with
// no state carried between them, so the work is split into two launches:
//
//  1. the score tile of score_tile.cuh (shared with K4's score launch): the
//     [B*N, C] x [C, H] score GEMM over all cells of all questions at once
//     (N=196 needs no padding: only the last cell tile is ragged, and its
//     rows past B*N are zero-filled and masked), on score_gemm.cuh's wgmma
//     mainloop with the dense row source DenseRows: 128-cell x BN-unit tiles
//     (BN 256 where it divides H, else 128), a cp.async ring of 64-channel
//     chunks of v and of W_v^T (the wrapper passes the K-major copy). The
//     unit tiles of one cell tile run side by side on blockIdx.x, so the
//     grid comes from HBM about once. The per-cell sum of squares is taken
//     from the same copies; the epilogue forms h in the accumulator
//     registers and reduces it against ws, writing one partial score per
//     cell and unit tile. h never reaches device memory; only [H/BN, B*N]
//     partial scores do (200 KB at B=256).
//  2. attn_wsum_kernel: one block per (question, 512-channel chunk) sums
//     the H/BN partial scores in a fixed order (deterministic), takes the
//     softmax over the N valid cells in shared memory and accumulates the
//     weighted sum with coalesced E-pair loads.
//
// No atomics and no split-K: two calls on the same inputs give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "score_gemm.cuh"
#include "score_tile.cuh"

namespace {

constexpr int kWsumThreads = 256;
constexpr int kWsumChannels = 2 * kWsumThreads;

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

template <class E>
__global__ void __launch_bounds__(kWsumThreads)
attn_wsum_kernel(const E* __restrict__ v,          // [B, N, C]
                 const float* __restrict__ part,   // [n_part, B*N]
                 const float* __restrict__ rnorm,  // [B*N]
                 float* __restrict__ vatt,         // [B, C]
                 float* __restrict__ alpha,        // [B, N]
                 int B, int N, int C, int n_part) {
  extern __shared__ float sh[];  // p[N], then the E-rounded weights w[N]
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
    w[n] = round_to<E>(e * rnorm[base + n]);
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
    const typename Elem<E>::pair* src =
        reinterpret_cast<const typename Elem<E>::pair*>(v + base * C + c);
    const size_t stride = static_cast<size_t>(C) / 2;
    float a0 = 0.0f, a1 = 0.0f;
    for (int n = 0; n < N; ++n) {
      const float2 x = Elem<E>::to2(src[n * stride]);
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

// The score launch's shape (kernels.score_plan's) for B questions of N
// cells at width H (C does not change it): out = {tile rows, tile units,
// ring stages, dynamic shared memory in bytes, grid x (unit tiles), grid y
// (cell tiles), partial scores a cell (one a unit tile)}.
int attention_fwd_score_config(int B, int N, int H, int* out) {
  const score_tile::Shape s = score_tile::shape<KernelElem>(B * N, H);
  const int vals[] = {s.tile_m, s.tile_n, s.stages, s.smem_bytes,
                      s.grid_x, s.grid_y, s.grid_x};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

// v [B, N, C] E, wvt [H, C] E (W_v transposed, K-major), qh [B, H]
// f32, ws [H] f32 -> vatt [B, C] f32, alpha [B, N] f32. Scratch: part
// [n_part, B*N] f32, rnorm [B*N] f32 (the per-cell norm, which the caller
// keeps). `n_part` must be the plan's (kernels.score_plan): else
// cudaErrorInvalidValue and nothing launched. Needs C % 32 == 0 and
// H % 128 == 0 (checked by the caller). Two launches on `stream`, counting
// in *launched those that launched; returns the first launch error.
int attention_fwd(const void* v, const void* wvt, const void* qh,
                  const void* ws, void* part, void* rnorm, void* vatt,
                  void* alpha, int B, int N, int C, int H, int n_part,
                  int normalize, void* stream, int* launched) {
  using E = KernelElem;
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cells = B * N;
  if (n_part != score_tile::shape<E>(cells, H).grid_x) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = score_tile::launch<E>(
      score_gemm::DenseRows<E>{static_cast<const E*>(v), C, cells, 0}, wvt,
      qh, ws, part, rnorm, nullptr, cells, N, C, H, 1, normalize, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  const dim3 g2(B, (C + kWsumChannels - 1) / kWsumChannels);
  const size_t smem = 2 * static_cast<size_t>(N) * sizeof(float);
  attn_wsum_kernel<E><<<g2, kWsumThreads, smem, st>>>(
      static_cast<const E*>(v), static_cast<const float*>(part),
      static_cast<const float*>(rnorm), static_cast<float*>(vatt),
      static_cast<float*>(alpha), B, N, C, n_part);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // extern "C"
