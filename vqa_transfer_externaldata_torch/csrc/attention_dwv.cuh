// The dW_v stage shared by the two attention backwards, K5
// (attention_resident_bwd.cu) and K8 (attention_bwd.cu), and the probe P2
// (probe_bwd_ceiling.cu):
//
//   dW_v = sum over cells kk of v(kk)^T dzr[kk]      [C, H], f32
//
// where dzr [K, H] holds E(dz * r) of each cell, written compactly by the
// kernel's first stage, and v(kk) is the cell's [C] feature row: a row of
// the resident store looked up per cell (K5 and P2, StoreCells: E values
// or int8 codes, widened to E in shared memory) or a row of the gathered
// grid of E (K8, DenseCells). E products, f32 sums; E is the 16-bit
// element type, bf16 (K5, K8, P2) or float16 (K5h, K8h).
//
// What bounds it on an H100: at K5's training shape (50,176 cells, C=2048,
// H=512) the product is 105 GFLOP, 0.106 ms at the bf16 peak, against 205
// MB of rows and 51 MB of dzr (77 us at 3.35 TB/s): the tensor cores, if
// they are fed.
//
// Design: the mainloop of score_gemm.cuh (two warpgroups, wgmma from a
// cp.async ring, its primitives reused) on transposed operands. As a GEMM,
// dW_v [C, H] = V^T [C, K] dzr [K, H] reduces over the cells, and both
// operands arrive with the cells as their rows: A = V^T is M-major (a
// cell's row is channel-contiguous), B = dzr is N-major (unit-contiguous).
// wgmma takes both so for bf16 and f16 (its tnsp immediates set to 1):
//  - A tile: 128 channels x BN hidden units (BN = 256 where it divides H,
//    else 128), 64 cells a chunk; warpgroup w owns channels 64w .. 64w + 63
//    and keeps its 64 x BN f32 accumulator in registers.
//  - Stage layout, for A and B alike: "atom columns" of 64 values (128 B)
//    along M (or N), each holding the chunk's 64 cells as 128-byte rows in
//    the 128-byte swizzle: 16-byte chunk c of cell r of atom column j lies
//    at j * 8 KB + r * 128 + ((c ^ (r & 7)) << 4). In the MN-major
//    descriptor the leading offset (LBO) is the step between atom columns
//    (8 KB) and the stride offset (SBO) the step between groups of 8 cells
//    (1024 B), the other way round from what a K-major operand's fields
//    mean; a k16 step moves 2048 B, whole swizzle atoms, so the base
//    offset stays 0.
//  - Every thread copies for one cell of each chunk, 16 bytes a copy, its
//    cell's pointer resolved once a chunk and one chunk ahead (StoreCells
//    divides and reads the row index there, not per copy). Cells past the
//    split's end are zero-filled in both operands (source size 0), so no
//    uninitialised byte meets a zero. int8 codes land raw in a 128 B-a-cell
//    slot and each thread widens the codes it copied itself into the E
//    slot: no second barrier.
//  - Each chunk: cp.async.wait_group; the widening (int8); fence.proxy.async;
//    the barrier; four wgmmas a warpgroup; commit; wgmma.wait_group 1; then
//    the copies of the chunk kStages - 2 ahead (score_gemm.cuh's argument).
//    The accumulators start from the first wgmma (scale_d 0), never from
//    zeroed registers, so ptxas keeps the wgmmas pipelined.
//  - The cells are split so that the grid (column tiles fastest, then
//    channel tiles, then splits) is one wave on the card's SMs; every split
//    but the last is a whole number of chunks. The wrappers take the split
//    from kernels.dwv_plan, and plan() derives the rest of the launch from
//    it as dwv_plan does. Each block writes its f32 partial
//    tile straight from the accumulators. reduce_kernel then sums the
//    partials over the splits and the per-question dws partials (one row of
//    W values each: H, or G * H for K5's G glimpses) over the questions,
//    both in a fixed order: no atomics, so two calls give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "score_gemm.cuh"
#include "store_rows.cuh"

namespace {

namespace attn_dwv {

constexpr int kThreads = score_gemm::kThreads;  // two warpgroups
constexpr int kBM = 128;                 // channels a tile
constexpr int kBK = 64;                  // cells a chunk
constexpr int kColBytes = kBK * 128;     // an atom column of a chunk: 8 KB
constexpr int kReduceThreads = 256;

// The shared memory of a tile: kStages stages of A (128 channels), dzr (BN
// units) and, for int8 rows, the raw codes, with 1024 B of slack to align
// the ring.
template <class T, int BN>
struct Plan {
  static constexpr bool kInt8 = store_rows::kInt8<T>;
  static constexpr int kStages = BN == 256 ? 4 : 5;
  static constexpr int kABytes = (kBM / 64) * kColBytes;
  static constexpr int kBBytes = (BN / 64) * kColBytes;
  static constexpr int kCodeBytes = kInt8 ? kBK * kBM : 0;
  static constexpr int kStageBytes = kABytes + kBBytes + kCodeBytes;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes;
};

// Cell kk = b * n_valid + n is cell n of store row rows[b] ([M, Np, C] of
// T: E values, or int8 codes).
template <class T>
struct StoreCells {
  using value_type = T;
  const T* store;
  const int* rows;
  int n_valid, Np, C;
  __device__ const T* operator()(int kk) const {
    const int b = kk / n_valid;
    const int n = kk - b * n_valid;
    return store + (static_cast<size_t>(rows[b]) * Np + n) * C;
  }
};

// Cell kk is row kk of a gathered [K, C] grid of E.
template <class E>
struct DenseCells {
  using value_type = E;
  const E* v;
  int C;
  __device__ const E* operator()(int kk) const {
    return v + static_cast<size_t>(kk) * C;
  }
};

// Descriptor of an MN-major 16-bit operand in the 128-byte swizzle: start
// address >> 4 (bits 0-13), LBO 8 KB between 64-wide atom columns (bits
// 16-29), SBO 1024 B between groups of 8 cells (bits 32-45), base offset 0
// (every stage and every k16 step is 1024-byte aligned), SWIZZLE_128B
// (bits 62-63).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kColBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Byte offset, in a stage's operand, of the 16-byte chunk q (values 8q ..
// 8q + 7 of its tile width) of chunk cell r.
__device__ __forceinline__ uint32_t mn_off(int r, int q) {
  return static_cast<uint32_t>((q >> 3) * kColBytes) +
         score_gemm::swz(r, q & 7);
}

// part[s] = sum over the cells of split s of v(kk)^T dzr[kk], one 128 x BN
// tile of [C, H] per block.
template <class Cells, int BN, class E>
__global__ void __launch_bounds__(kThreads, 1)
dwv_kernel(Cells cells, const E* __restrict__ dzr,  // [K, H]
           float* __restrict__ part,                // [S, C, H]
           int K, int C, int H, int chunks_per_split) {
  using T = typename Cells::value_type;
  using P = Plan<T, BN>;
  static_assert(P::kInt8 || std::is_same<T, E>::value,
                "float rows are of the element type");
  constexpr int S = P::kStages;
  constexpr int kAhead = S - 2;
  constexpr int kACopies = P::kInt8 ? 2 : 4;  // 16 B of 128 channels each
  constexpr int kBCopies = BN / 32;           // 16 B of BN units each
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = score_gemm::align1024(smem_raw);
  const uint32_t ring_s = score_gemm::smem_u32(ring);
  const int t = threadIdx.x;
  const int h0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * chunks_per_split * kBK;
  const int k_end = min(K, k_begin + chunks_per_split * kBK);
  const int nk = k_begin < k_end ? (k_end - k_begin + kBK - 1) / kBK : 0;

  // Thread t copies for cell cl of every chunk: its 16-byte pieces
  // q0 + 4 i, so four neighbouring threads read 64 contiguous bytes.
  const int cl = t >> 2;
  const int q0 = t & 3;

  // The first wgmma of the first chunk writes acc with scale_d 0: zeroing
  // the registers beforehand makes ptxas serialize the wgmmas (its
  // warning C7515).
  float acc[BN / 2];

  // Cell cl's row in chunk kc from channel c0, or null past the split's
  // end. load() is called for consecutive chunks and looks up the next
  // chunk's row as it copies this one's, so the index read (StoreCells
  // reads rows[b]) lands while the MMAs run, not before the copies.
  auto row_of = [&](int kc) -> const T* {
    const int kk = k_begin + kc * kBK + cl;
    return kk < k_end ? cells(kk) + c0 : nullptr;
  };
  const T* a_next = row_of(0);
  auto load = [&](int kc, int stage) {
    const uint32_t st = ring_s + stage * P::kStageBytes;
    const int kk = k_begin + kc * kBK + cl;
    const bool ok = kk < k_end;
    const T* a = a_next;
    a_next = row_of(kc + 1);
    const E* b = dzr + static_cast<size_t>(ok ? kk : 0) * H + h0;
#pragma unroll
    for (int i = 0; i < kACopies; ++i) {
      const int q = q0 + 4 * i;
      if constexpr (P::kInt8) {
        const uint32_t codes = st + P::kABytes + P::kBBytes;
        score_gemm::cp_async16(codes + cl * 128 + q * 16,
                               ok ? static_cast<const void*>(a + q * 16)
                                  : static_cast<const void*>(dzr),
                               ok);
      } else {
        score_gemm::cp_async16(st + mn_off(cl, q),
                               ok ? static_cast<const void*>(a + q * 8)
                                  : static_cast<const void*>(dzr),
                               ok);
      }
    }
#pragma unroll
    for (int i = 0; i < kBCopies; ++i) {
      const int q = q0 + 4 * i;
      score_gemm::cp_async16(st + P::kABytes + mn_off(cl, q), b + q * 8, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nk) load(s, s);
    score_gemm::cp_async_commit();
  }
  int stage = 0;       // the stage of chunk kc
  int ahead = kAhead;  // the stage of chunk kc + kAhead
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    score_gemm::cp_async_wait<kAhead - 1>();  // this thread's copies of kc
    if constexpr (P::kInt8) {
      unsigned char* sp = ring + stage * P::kStageBytes;
#pragma unroll
      for (int i = 0; i < kACopies; ++i) {
        // Codes 16q .. 16q + 15 of the cell: its E pieces 2q and 2q + 1.
        const int q = q0 + 4 * i;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            sp + P::kABytes + P::kBBytes + cl * 128 + q * 16);
        *reinterpret_cast<uint4*>(sp + mn_off(cl, 2 * q)) =
            store_rows::widen8<E>(make_uint2(raw.x, raw.y));
        *reinterpret_cast<uint4*>(sp + mn_off(cl, 2 * q + 1)) =
            store_rows::widen8<E>(make_uint2(raw.z, raw.w));
      }
    }
    score_gemm::fence_proxy_async();
    __syncthreads();
    const uint32_t st = ring_s + stage * P::kStageBytes;
    const uint32_t a = st + (t >> 7) * kColBytes;  // the warpgroup's channels
    const uint32_t b = st + P::kABytes;
    score_gemm::fence_acc(acc);
    score_gemm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      score_gemm::mma<BN, 1, E>(acc, desc_mn(a + kk * 2048),
                                desc_mn(b + kk * 2048), (kc | kk) != 0);
    }
    score_gemm::wgmma_commit();
    score_gemm::fence_acc(acc);
    score_gemm::wgmma_wait<1>();
    score_gemm::fence_acc(acc);
    if (kc + kAhead < nk) load(kc + kAhead, ahead);
    score_gemm::cp_async_commit();
    stage = stage + 1 == S ? 0 : stage + 1;
    ahead = ahead + 1 == S ? 0 : ahead + 1;
  }
  score_gemm::wgmma_wait<0>();
  score_gemm::fence_acc(acc);
  score_gemm::cp_async_wait<0>();
  if (nk == 0) {  // a split with no cell: a zero partial
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  }

  // The accumulators straight to the split's partial: rows are channels,
  // columns hidden units (score_gemm's frag_row / frag_col).
  float* out = part + static_cast<size_t>(blockIdx.z) * C * H +
               static_cast<size_t>(c0 + score_gemm::frag_row(t)) * H + h0 +
               score_gemm::frag_col(t);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(out + static_cast<size_t>(8 * hf) * H +
                                 8 * j) =
          make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    }
  }
}

__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ part,      // [S, C*H]
              const float* __restrict__ dws_part,  // [B, W]
              float* __restrict__ dwv,             // [C*H]
              float* __restrict__ dws,             // [W]
              int splits, int CH, int B, int W) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i < CH) {
    float s = 0.0f;
    for (int p = 0; p < splits; ++p) s += part[static_cast<size_t>(p) * CH + i];
    dwv[i] = s;
  } else if (i < CH + W) {
    const int k = i - CH;
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += dws_part[static_cast<size_t>(b) * W + k];
    dws[k] = s;
  }
}

// The GEMM's launch shape over K cells split `splits` ways (C % 128 == 0
// and H % 128 == 0), E the element type (its rows, or the type int8 codes
// widen to): tile (channels x units), ring stages, dynamic shared memory,
// chunks a split and grid (unit tiles, channel tiles, splits).
struct Shape {
  int tile_m, tile_n, stages, smem_bytes, chunks_per_split;
  int grid_x, grid_y, grid_z;
};

template <class E>
Shape plan(int K, int C, int H, bool int8, int splits) {
  const int BN = score_gemm::tile_n(H);
  const int chunks = (K + kBK - 1) / kBK;
  Shape s;
  s.tile_m = kBM;
  s.tile_n = BN;
  if (BN == 256) {
    s.stages = Plan<E, 256>::kStages;
    s.smem_bytes = int8 ? Plan<int8_t, 256>::kSmemBytes
                        : Plan<E, 256>::kSmemBytes;
  } else {
    s.stages = Plan<E, 128>::kStages;
    s.smem_bytes = int8 ? Plan<int8_t, 128>::kSmemBytes
                        : Plan<E, 128>::kSmemBytes;
  }
  s.chunks_per_split = (chunks + splits - 1) / splits;
  s.grid_x = H / BN;
  s.grid_y = C / kBM;
  s.grid_z = splits;
  return s;
}

template <class Cells, int BN, class E>
cudaError_t launch_dwv_bn(Cells cells, const E* dzr, float* part, int K,
                          int C, int H, const Shape& s, cudaStream_t st) {
  constexpr int smem = Plan<typename Cells::value_type, BN>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      dwv_kernel<Cells, BN, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  dwv_kernel<Cells, BN, E>
      <<<dim3(s.grid_x, s.grid_y, s.grid_z), kThreads, smem, st>>>(
          cells, dzr, part, K, C, H, s.chunks_per_split);
  return cudaGetLastError();
}

// The dW_v GEMM over K cells split `splits` ways (C % 128 == 0 and
// H % 128 == 0, checked by the caller), dzr [K, H] of E; returns the launch
// error.
template <class Cells, class E>
cudaError_t launch_dwv(Cells cells, const E* dzr, float* part, int K, int C,
                       int H, int splits, cudaStream_t st) {
  const Shape s = plan<E>(K, C, H,
                          store_rows::kInt8<typename Cells::value_type>,
                          splits);
  return s.tile_n == 256
             ? launch_dwv_bn<Cells, 256, E>(cells, dzr, part, K, C, H, s, st)
             : launch_dwv_bn<Cells, 128, E>(cells, dzr, part, K, C, H, s, st);
}

// dwv = sum of the split partials, dws [W] = sum of the B question
// partials [B, W]; returns the launch error.
inline cudaError_t launch_reduce(const float* part, const float* dws_part,
                                 float* dwv, float* dws, int splits, int C,
                                 int H, int B, int W, cudaStream_t st) {
  const int CH = C * H;
  reduce_kernel<<<(CH + W + kReduceThreads - 1) / kReduceThreads,
                  kReduceThreads, 0, st>>>(part, dws_part, dwv, dws, splits,
                                           CH, B, W);
  return cudaGetLastError();
}

}  // namespace attn_dwv

}  // namespace
