// K4 `attention_resident_fwd`: gather-free attention forward with G glimpses
// (1 <= G <= 8) over a feature store resident in device memory, for Hopper
// (sm_90a). The same source builds K4h (csrc/attention_resident_fwd_f16.cu),
// the float16 instance: E = KernelElem (elem16.cuh), the compute dtype dt
// of the Pallas body, is bf16 here and float16 there.
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention_resident.py::
// _make_fwd_kernel_multi (the Pallas body launched by _resident_fwd_multi).
// Question b reads its grid straight out of the store row rows[b]; no
// [B, Np, C] batch is ever built. The G glimpses share the one score GEMM:
//
//   v       = store[rows[b]]                     [Np, C] (Np padded cells)
//   r       = rsqrt(sum_c E(v^2) + 1e-12)        (1 when !normalize)
//   h       = relu((v @ W_v) * r + qh[b])        [Np, H] f32; saved in E
//   s_g     = h . ws_g, masked to -1e30 at cells >= n_valid   (each glimpse)
//   alpha_g = softmax_Np(s_g)
//   v_att_g = sum_n E(alpha_gn r_n) v_n          (concatenated in g order)
//
// The rounding follows the Pallas kernel: f32 sums of E products, h in f32
// for the scores, each glimpse's alpha * r rounded to E before its weighted
// sum.
//
// The store rows are E, or the int8 codes of an L2-prenormalized store
// (the Pallas kernel's int8 branch, which casts the codes in VMEM to qh's
// dtype): the score GEMM copies the codes raw and widens them to E in
// shared memory,
// the weighted sum as it loads them, both exactly (store_rows.cuh), and the
// rest runs as on E rows. The store's scale is applied outside the
// kernel (folded into W_v, and to v_att afterwards), and an int8 store is
// never normalized here: it was normalized before it was quantized.
//
// What bounds it on an H100: at B=256, n_valid=196, C=2048, H=512 the score
// GEMM is 105 GFLOP of E (106 us at 989 TFLOP/s; each glimpse adds a
// 0.2 GFLOP weighted sum) against 205 MB of grid reads (102 MB of int8
// codes) and 51 MB of saved h (77 us at 3.35 TB/s): the tensor cores.
//
// Design: the TPU kernel runs one program per question with the row index
// prefetched into scalar memory. Here two launches cover the batch:
//
//  1. the score tile of score_tile.cuh (shared with K2's score launch):
//     the [B*Np, C] x [C, H] score GEMM over all cells of all questions at
//     once, on the wgmma mainloop of score_gemm.cuh (shared with the probe
//     P1): 128-cell x BN-column tiles (BN 256 where it divides H, else 128),
//     a cp.async ring of 64-channel chunks, the row lookup in the copies
//     (CellRows: cell i reads store + (rows[i / Np] * Np + i % Np) * C in
//     place of the scalar prefetch), int8 codes widened in shared memory.
//     The grid runs the column tiles of one cell tile side by side
//     (blockIdx.x), so they share its rows through L2. The epilogue works
//     from the accumulator registers: h, saved in E on the grad path
//     through shared memory (16-byte stores), and G partial scores per cell
//     and column tile against the G columns of ws. The GEMM runs once
//     whatever G is, as on the TPU, and G is a runtime count of the
//     epilogue: the kernel is instantiated over the row type and BN only.
//  2. attn_res_wsum_kernel: one block per (question, 512-channel chunk) sums
//     the partial scores in a fixed order (deterministic), takes the G
//     masked softmaxes in shared memory (2 G Np floats; past the default
//     48 KB the launch opts in, up to the card's limit: G = 8 on a 28 x 28
//     grid takes 50,176 B), then forms all G weighted sums in
//     ONE pass over the store row (coalesced E-pair loads, G accumulator
//     pairs per thread): the row is read once, not G times. G is a template
//     parameter here, 1..8 (the TPU kernel's limit, its ws sublane window).
//
// No atomics and no split-K: two calls on the same inputs give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "score_gemm.cuh"
#include "score_tile.cuh"
#include "store_rows.cuh"

namespace {

constexpr int kWsumThreads = 256;
constexpr int kWsumChannels = 2 * kWsumThreads;
constexpr float kNegInf = -1e30f;

// Tile row r is cell row0 + r: cell n of question b's store row rows[b].
template <class T>
struct CellRows {
  const T* store;
  const int* rows;
  int Np, C, cells, row0;
  __device__ const T* operator()(int r) const {
    const int cell = row0 + r;
    if (cell >= cells) return nullptr;
    const int b = cell / Np;
    return store + (static_cast<size_t>(rows[b]) * Np + (cell - b * Np)) * C;
  }
};

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

template <int G, class T, class E>
__global__ void __launch_bounds__(kWsumThreads)
attn_res_wsum_kernel(const T* __restrict__ store,  // [M, Np, C] E | int8
                     const int* __restrict__ rows,             // [B]
                     const float* __restrict__ part,  // [n_part, G, B*Np]
                     const float* __restrict__ rnorm,  // [B*Np]
                     float* __restrict__ vatt,         // [B, G, C]
                     float* __restrict__ alpha,        // [B, Np, G]
                     int B, int Np, int n_valid, int C, int n_part) {
  extern __shared__ float sh[];  // p [G][Np], then the E weights w [G][Np]
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
      w[g * Np + n] = round_to<E>(a * rnorm[base + n]);
    }
  }
  __syncthreads();

  // All G weighted sums from one pass over the store row, two channels a
  // thread (an E pair or a char2 load).
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

template <int G, class T, class E>
int launch_fwd(const void* store, const void* rows, const void* wvt,
               const void* qh, const void* ws, void* part, void* rnorm,
               void* hsave, void* vatt, void* alpha, int B, int Np,
               int n_valid, int C, int H, int normalize, cudaStream_t st,
               int* launched) {
  const int cells = B * Np;
  const int BN = score_gemm::tile_n(H);
  cudaError_t e = score_tile::launch<T, E>(
      CellRows<T>{static_cast<const T*>(store),
                  static_cast<const int*>(rows), Np, C, cells, 0},
      wvt, qh, ws, part, rnorm, hsave, cells, Np, C, H, G, normalize, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  const dim3 g2(B, (C + kWsumChannels - 1) / kWsumChannels);
  const size_t smem = 2 * static_cast<size_t>(G) * Np * sizeof(float);
  if (smem > 48 * 1024) {  // past the default: opt in, up to the card's
    e = cudaFuncSetAttribute(attn_res_wsum_kernel<G, T, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
  }
  attn_res_wsum_kernel<G, T, E><<<g2, kWsumThreads, smem, st>>>(
      static_cast<const T*>(store),
      static_cast<const int*>(rows), static_cast<const float*>(part),
      static_cast<const float*>(rnorm), static_cast<float*>(vatt),
      static_cast<float*>(alpha), B, Np, n_valid, C, H / BN);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The score launch's shape for `cells` cells at width H: rows and columns
// of a tile, ring stages, dynamic shared memory in bytes and grid.
int attention_resident_score_config(int cells, int H, int int8, int* tile_m,
                                    int* tile_n, int* stages, int* smem_bytes,
                                    int* grid_x, int* grid_y) {
  const score_tile::Shape s =
      int8 ? score_tile::shape<int8_t>(cells, H)
           : score_tile::shape<KernelElem>(cells, H);
  *tile_m = s.tile_m;
  *tile_n = s.tile_n;
  *stages = s.stages;
  *smem_bytes = s.smem_bytes;
  *grid_x = s.grid_x;
  *grid_y = s.grid_y;
  return 0;
}

// store [M, Np, C] of E, or int8 codes when int8 != 0 (then normalize must
// be 0), rows [B] i32 (< M, checked by the caller), wvt [H, C] E (W_v
// transposed, K-major), qh [B, H] f32, ws [G, H] f32 (1 <= G <= 8) -> vatt
// [B, G, C] f32, alpha [B, Np, G] f32 (0 at cells >= n_valid), and h
// [B, Np, H] E when hsave is not null. Scratch: part [H/128, G, B*Np]
// f32 (the score kernel fills the first H/BN slices, BN = 256 when
// H % 256 == 0, else 128), rnorm [B*Np] f32. Needs
// C % 32 == 0 and H % 128 == 0 (checked by the caller). Two launches on
// `stream`, counting in *launched those that launched; returns the first
// launch error.
int attention_resident_fwd(const void* store, const void* rows,
                           const void* wvt, const void* qh, const void* ws,
                           void* part, void* rnorm, void* hsave, void* vatt,
                           void* alpha, int B, int Np, int n_valid, int C,
                           int H, int G, int normalize, int int8,
                           void* stream, int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8 && normalize) return static_cast<int>(cudaErrorInvalidValue);
  using E = KernelElem;
#define K4_CASE(g)                                                          \
  case g:                                                                   \
    return int8 ? launch_fwd<g, int8_t, E>(store, rows, wvt, qh, ws, part,  \
                                           rnorm, hsave, vatt, alpha, B,    \
                                           Np, n_valid, C, H, 0, st,        \
                                           launched)                        \
                : launch_fwd<g, E, E>(store, rows, wvt, qh, ws, part, rnorm, \
                                      hsave, vatt, alpha, B, Np, n_valid, C, \
                                      H, normalize, st, launched);
  switch (G) {
    K4_CASE(1) K4_CASE(2) K4_CASE(3) K4_CASE(4)
    K4_CASE(5) K4_CASE(6) K4_CASE(7) K4_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K4_CASE
}

}  // extern "C"
