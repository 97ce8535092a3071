// K8 `attention_bwd`: fused backward of the gathered single-glimpse
// attention (the parameter cotangents; the grid gets none), for Hopper
// (sm_90a). The same source builds K8h (csrc/attention_bwd_f16.cu), the
// float16 instance: E = KernelElem (elem16.cuh), the type of the grid, of
// W_v and of dz * r (the Pallas body's dt), is bf16 here and float16
// there.
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention.py::_make_bwd_kernel
// (the Pallas body launched by _attention_pallas_bwd). The caller forms the
// score cotangent ds = alpha (r (g . v) + g_alpha - S) and hands over the
// forward's per-cell norm r (K2's residual), as the JAX package does in
// XLA. For question b, cell n, hidden unit k:
//
//   z_nk  = ((v_n . W_v[:, k]) r_n) + qh_bk        (r = 1 when !normalize)
//   dz_nk = [z_nk > 0] ds_n ws_k
//   dqh_bk = sum_n dz_nk,   dws_k = sum_{b,n} ds_n relu(z_nk)
//   dW_v  = sum_{b,n} v_n^T E(dz_n r_n)
//
// The rounding points are the Pallas body's: products of E values summed
// in f32, z * r and + qh rounded as two operations, dz * r rounded to E
// (to nearest, keeping f16's subnormals, as JAX's astype(dt)) ahead of the
// dW_v product.
//
// What bounds it on an H100: at B=256, N=196, C=2048, H=512 the recomputed
// z and the dW_v GEMM are 105 GFLOP of E each (0.106 ms each at 989
// TFLOP/s, bf16 and f16 alike), the grid 205 MB (61 us at 3.35 TB/s): the
// tensor cores.
//
// Design. The TPU kernel walks an (H chunk, batch tile, cell chunk) grid in
// order and accumulates all three cotangents in VMEM output blocks; its H
// chunks exist for VMEM's sake and re-read v once each. Hopper blocks run
// in parallel with nothing carried between them, and float atomics would
// make the sums depend on the schedule, so the work is four launches:
//
//  1. attn_bwd_dz_kernel: the [B*N, C] x [C, H] product that recomputes z,
//     over all cells of all questions at once, on the wgmma mainloop of
//     score_gemm.cuh (K4's score kernel and P1 run it too) with a dense row
//     source: 128-cell x BN-unit tiles (BN 256 where it divides H, else
//     128), a cp.async ring of 64-channel chunks of the grid and of W_v^T
//     (the wrapper passes the K-major copy). The column tiles of one cell
//     tile run side by side on blockIdx.x and share its rows through L2, so
//     the grid comes from HBM about once; cells past B*N are zero-filled
//     and masked, so any N needs no padding. The epilogue stages the tile's
//     f32 products through the ring's shared memory; then thread k (one a
//     column) walks the tile's cells in order, forms z (two roundings), dz,
//     E(dz * r) into dzr [B*N, H] (adjacent threads, adjacent units: one
//     coalesced row a step), and its running dqh and dws sums, which it
//     writes as the partial of (tile, slot) at each question boundary: slot
//     s of a tile is its s-th question. A 128-cell tile spans at most
//     ceil(127 / N) + 1 questions (the plan's slots, kernels.dz_plan);
//  2. attn_bwd_fold_kernel: dqh [B, H] and the per-question dws partials
//     [B, H] from the (tile, slot) partials, each question's tiles in
//     order;
//  3. the dW_v GEMM [C, B*N] x [B*N, H] of attention_dwv.cuh (shared with
//     K5 and P2: wgmma on transposed operands from a cp.async ring), split
//     over the cells, one partial tile per block;
//  4. the fixed-order reduction of the dW_v partials and of the dws
//     partials over the questions.
//
// No atomics: two calls on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_dwv.cuh"
#include "score_gemm.cuh"

namespace {

using score_gemm::kBM;
constexpr int kFoldThreads = 256;

// The dz stage's epilogue in the ring's shared memory: the tile's f32
// products [kBM, BN + 8] (8 floats of padding a row, so the accumulator
// fragments' float2 stores take two wavefronts a warp), then ds and r of
// its cells.
template <int BN>
struct Epilogue {
  static constexpr int kLd = BN + 8;
  static constexpr int kBytes = (kBM * kLd + 2 * kBM) * 4;
  static_assert(kBytes <= score_gemm::Plan<KernelElem, BN>::kRingBytes,
                "the dz epilogue must fit in the ring");
};

template <int BN, class E>
__global__ void __launch_bounds__(score_gemm::kThreads, 1)
attn_bwd_dz_kernel(const E* __restrict__ v,       // [cells, C]
                   const E* __restrict__ wvt,     // [H, C]
                   const float* __restrict__ qh,  // [B, H]
                   const float* __restrict__ ws,  // [H]
                   const float* __restrict__ ds,  // [cells]
                   const float* __restrict__ r,   // [cells]
                   E* __restrict__ dzr,           // [cells, H]
                   float* __restrict__ qpart,     // [tiles, slots, H]
                   float* __restrict__ wpart,     // [tiles, slots, H]
                   int cells, int N, int C, int H, int slots,
                   int normalize) {
  using Ep = Epilogue<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = score_gemm::align1024(smem_raw);
  const int t = threadIdx.x;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * kBM;

  float acc[BN / 2];
  float sq[4];
  score_gemm::mainloop<E, BN>(
      score_gemm::DenseRows<E>{v, C, cells, row0}, wvt, C, col0, ring, acc,
      sq, false);
  __syncthreads();  // every warpgroup is done with the ring

  float* zs = reinterpret_cast<float*>(ring);
  float* ds_s = zs + kBM * Ep::kLd;
  float* r_s = ds_s + kBM;
  const int fr = score_gemm::frag_row(t);
  const int fc = score_gemm::frag_col(t);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float* dst = zs + (fr + 8 * hf) * Ep::kLd + fc;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    }
  }
  if (t < kBM) {
    const bool ok = row0 + t < cells;
    ds_s[t] = ok ? ds[row0 + t] : 0.0f;
    r_s[t] = ok && normalize ? r[row0 + t] : 1.0f;
  }
  __syncthreads();
  if (t >= BN) return;  // at BN = 128 half the threads hold no column

  // Thread t takes unit k of every cell of the tile, in order.
  const int k = col0 + t;
  const float w = ws[k];
  const int rows_here = min(kBM, cells - row0);
  const int b0 = row0 / N;
  int b = b0;
  int next = (b0 + 1) * N - row0;  // the tile row where question b + 1 starts
  float q = qh[static_cast<size_t>(b) * H + k];
  float dq = 0.0f, dw = 0.0f;
  float* qp = qpart + static_cast<size_t>(blockIdx.y) * slots * H + k;
  float* wp = wpart + static_cast<size_t>(blockIdx.y) * slots * H + k;
  for (int i = 0; i < rows_here; ++i) {
    if (i == next) {  // the same row for the whole warp
      qp[static_cast<size_t>(b - b0) * H] = dq;
      wp[static_cast<size_t>(b - b0) * H] = dw;
      ++b;
      next += N;
      q = qh[static_cast<size_t>(b) * H + k];
      dq = 0.0f;
      dw = 0.0f;
    }
    const float rr = r_s[i];
    const float d = ds_s[i];
    // (z * r) + qh rounded as two operations, as the reference does.
    const float z = __fadd_rn(__fmul_rn(zs[i * Ep::kLd + t], rr), q);
    const float dz = z > 0.0f ? __fmul_rn(d, w) : 0.0f;
    dq = __fadd_rn(dq, dz);
    dw = fmaf(d, fmaxf(z, 0.0f), dw);
    dzr[static_cast<size_t>(row0 + i) * H + k] =
        Elem<E>::from(__fmul_rn(dz, rr));
  }
  qp[static_cast<size_t>(b - b0) * H] = dq;
  wp[static_cast<size_t>(b - b0) * H] = dw;
}

// dqh[b] and dws_part[b]: the sums of question b's (tile, slot) partials,
// its tiles in order (tile t's first question is t * kBM / N).
__global__ void __launch_bounds__(kFoldThreads)
attn_bwd_fold_kernel(const float* __restrict__ qpart,  // [tiles, slots, H]
                     const float* __restrict__ wpart,  // [tiles, slots, H]
                     float* __restrict__ dqh,          // [B, H]
                     float* __restrict__ dws_part,     // [B, H]
                     int B, int N, int H, int slots) {
  const int i = blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H;
  const int k = i - b * H;
  const int first = b * N;
  float q = 0.0f, w = 0.0f;
  for (int tile = first / kBM; tile <= (first + N - 1) / kBM; ++tile) {
    const int slot = b - tile * kBM / N;
    const size_t at = (static_cast<size_t>(tile) * slots + slot) * H + k;
    q += qpart[at];
    w += wpart[at];
  }
  dqh[i] = q;
  dws_part[i] = w;
}

// The dz launch's shape (kernels.dz_plan's): tile, ring stages, dynamic
// shared memory, the epilogue's share of the ring, grid and slots a tile.
struct DzShape {
  int tile_m, tile_n, stages, smem_bytes, epilogue_bytes, grid_x, grid_y,
      slots;
};

inline DzShape dz_shape(int B, int N, int H) {
  const int BN = score_gemm::tile_n(H);
  DzShape s;
  s.tile_m = kBM;
  s.tile_n = BN;
  if (BN == 256) {
    s.stages = score_gemm::Plan<KernelElem, 256>::kStages;
    s.smem_bytes = score_gemm::Plan<KernelElem, 256>::kSmemBytes;
    s.epilogue_bytes = Epilogue<256>::kBytes;
  } else {
    s.stages = score_gemm::Plan<KernelElem, 128>::kStages;
    s.smem_bytes = score_gemm::Plan<KernelElem, 128>::kSmemBytes;
    s.epilogue_bytes = Epilogue<128>::kBytes;
  }
  s.grid_x = H / BN;
  s.grid_y = (B * N + kBM - 1) / kBM;
  const int span = (kBM - 1 + N - 1) / N + 1;  // questions a tile can touch
  s.slots = span < B ? span : B;
  return s;
}

template <int BN>
cudaError_t launch_dz(const void* v, const void* wvt, const void* qh,
                      const void* ws, const void* ds, const void* r,
                      void* dzr, void* qpart, void* wpart, int cells, int N,
                      int C, int H, int normalize, const DzShape& s,
                      cudaStream_t st) {
  using E = KernelElem;
  constexpr int smem = score_gemm::Plan<E, BN>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dz_kernel<BN, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  attn_bwd_dz_kernel<BN, E>
      <<<dim3(s.grid_x, s.grid_y), score_gemm::kThreads, smem, st>>>(
          static_cast<const E*>(v), static_cast<const E*>(wvt),
          static_cast<const float*>(qh), static_cast<const float*>(ws),
          static_cast<const float*>(ds), static_cast<const float*>(r),
          static_cast<E*>(dzr), static_cast<float*>(qpart),
          static_cast<float*>(wpart), cells, N, C, H, s.slots, normalize);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The dz launch's shape for B questions of N cells at width H (C does not
// change it): out = {tile rows, tile units, ring stages, dynamic shared
// memory in bytes, the epilogue's bytes, grid x, grid y, slots a tile}.
int attention_bwd_dz_config(int B, int N, int H, int* out) {
  const DzShape s = dz_shape(B, N, H);
  const int vals[] = {s.tile_m,   s.tile_n,  s.stages, s.smem_bytes,
                      s.epilogue_bytes, s.grid_x, s.grid_y, s.slots};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

// v [B, N, C] E, wvt [H, C] E (W_v transposed, K-major), qh [B, H]
// f32, ws [H] f32, ds [B, N] f32, r [B, N] f32 (read only when normalize)
// -> dqh [B, H], dwv [C, H], dws [H], all f32. Scratch: dzr [B*N, H] E,
// qpart and wpart [tiles, slots, H] f32, dws_part [B, H] f32, part
// [splits, C, H] f32. `slots` must be the plan's (kernels.dz_plan): else
// cudaErrorInvalidValue and nothing launched. Needs C % 128 == 0 and
// H % 128 == 0 (checked by the caller). Four launches on `stream`,
// counting in *launched those that launched; returns the first launch
// error.
int attention_bwd(const void* v, const void* wvt, const void* qh,
                  const void* ws, const void* ds, const void* r, void* dzr,
                  void* qpart, void* wpart, void* dws_part, void* part,
                  void* dqh, void* dwv, void* dws, int B, int N, int C,
                  int H, int normalize, int slots, int splits, void* stream,
                  int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DzShape s = dz_shape(B, N, H);
  if (slots != s.slots) return static_cast<int>(cudaErrorInvalidValue);
  const int cells = B * N;
  cudaError_t e =
      s.tile_n == 256
          ? launch_dz<256>(v, wvt, qh, ws, ds, r, dzr, qpart, wpart, cells,
                           N, C, H, normalize, s, st)
          : launch_dz<128>(v, wvt, qh, ws, ds, r, dzr, qpart, wpart, cells,
                           N, C, H, normalize, s, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  attn_bwd_fold_kernel<<<(B * H + kFoldThreads - 1) / kFoldThreads,
                         kFoldThreads, 0, st>>>(
      static_cast<const float*>(qpart), static_cast<const float*>(wpart),
      static_cast<float*>(dqh), static_cast<float*>(dws_part), B, N, H,
      slots);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  e = attn_dwv::launch_dwv(
      attn_dwv::DenseCells<KernelElem>{static_cast<const KernelElem*>(v), C},
      static_cast<const KernelElem*>(dzr), static_cast<float*>(part), cells,
      C, H, splits, st);
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
