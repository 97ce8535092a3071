// fp32_ring.cuh: the float32 tile product of the attention kernels' 128 x 128
// products, on the FP32 pipes (FFMA), for Hopper (sm_90a): K4f's and K2f's
// score launch and K8f's dz launch (attention_f32.cuh, attention_bwd_f32.cu:
// [cells, C] x [C, H] through each cell's row) and K5f's and K8f's dW_v
// launch (attention_resident_bwd_f32.cu, attention_bwd_f32.cu:
// [C, cells] x [cells, H]), and the float32 BPTT's (K3f, K7f) products of
// every step's gh and of dU_h (gru_seq_f32.cuh), whose rows may come
// through a list of the live row-steps. The float32 GRU's forward step form
// keeps fp32_tile.cuh's loop.
//
// The float32 path exists to meet a float64 oracle, so every product is an
// FFMA with an f32 sum: no TF32 or bf16 pass. A block of 256 threads
// (16 x 16) owns a 128 x 128 tile of out = A x B and keeps, in thread
// (ty, tx), the 8 x 8 sums of rows ty*8 .. ty*8+7 and columns tx*8 ..
// tx*8+7 (fp32_tile.cuh's assignment, so the callers' epilogues, which sum
// across a thread's columns and then across the 16 threads of a row, keep
// their order). Each sum takes its k in increasing order from a zero start:
// a product is a fixed function of its inputs, and equals fp32_tile.cuh's
// bit for bit over the same k range.
//
// What bounds it: the FP32 pipes, 67 TFLOP/s on an H100 SXM. An SM issues
// one warp instruction a cycle on each of its four schedulers and one FFMA
// fills a scheduler's cycle, so every other instruction in the loop costs
// an FFMA's slot: the design keeps the inner loop at 64 FFMA and four
// 128-bit shared loads for each k, and everything else per 16-k chunk.
//
// Design:
//  - Each cell's row is found once. A's rows are cells of a store
//    (store_rows_f32.cuh's CellRows, ValidCellsT) or of a dense grid
//    (GridCells); the row source yields a row pointer, cell(i). K-major A
//    (the score products: a cell's channels contiguous, the tile's 128
//    cells fixed) resolves its 128 row pointers into shared memory once, at
//    the start. MN-major A (the dW_v products: the cells are k) resolves
//    the 16 rows of a chunk once, a chunk ahead of its copies, into a slot
//    of a ring of STAGES slots.
//  - A ring of STAGES (4) stages of 16-k chunks in shared memory, filled by
//    cp.async (16-byte cp.async.cg; 8- or 4-byte cp.async.ca where a row's
//    pitch or base is aligned to no more; element by element, synchronous,
//    where it is aligned to less than 4 bytes), committed a group a chunk;
//    zero-filled (source size 0) past the operands' ends. Each chunk: half
//    its products, the copies of the chunk STAGES - 1 ahead (into the stage
//    the last barrier freed), cp.async.wait_group for the next chunk and
//    the thread's preparation of its own copies of it (below), the other
//    half of the products, one block barrier: the copies and the
//    preparation run between a warp's own FFMAs, which hide their latency
//    (placed before the products, they cost more: PERF.md). The copy
//    widths come from the wrapper (ops/kernels.py::f32_ring_plan, from
//    the shapes and the base addresses); the C entries refuse a width that
//    the operands' alignment does not allow. Launches of 16-byte copies of
//    both operands (the main path's) compile their widths in; every other
//    width reads them at run time (one instantiation more).
//  - Rows stay in their stored type (f32, f16 or int8 codes) in the ring.
//    Where A is not f32 laid out [k][m] already (K-major rows of any type,
//    MN-major f16 or int8 rows), each thread widens the elements it copied
//    (rows_f32::widen, exact) into a two-slot f32 buffer laid out [k][m]
//    (pitch 132 floats), which transposes K-major rows on the way. Widening
//    once a block costs 8 conversions a thread a chunk; widening as the
//    products read (each value read by the 16 threads of a row) would cost
//    8 of every 72 issue slots for f16 and three times that for int8 codes.
//    The transposed stores of K-major rows meet at most two to a bank.
//  - B is f32, MN-major [k][n] (W_v [C, H], dz * r [cells, H]; dU_h's g
//    rows, each found once a chunk through its index where B is an
//    IndexedB), so 16-byte copies land in the [k][n] layout the products
//    read, with 16-byte group g of a k row at position g ^ ((g >> 3) & 1).
//    A thread reads its 8 columns as the float4 groups 2tx and 2tx + 1:
//    the 8 threads of a quarter warp then read 8 distinct 4-bank groups,
//    without conflicts. A's 8 rows are two float4s that every thread of a quarter
//    warp shares (one ty): broadcasts. So 64 FFMA take 4 LDS.128.
//  - 256 threads, at most 128 registers, two blocks an SM; dynamic shared
//    memory (Layout::kBytes, up to ~82 KB) opted into per instantiation.
// No atomics: two calls give the same bits.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "store_rows_f32.cuh"

namespace fp32_ring {

constexpr int THREADS = 256;  // 16 x 16 threads a block
constexpr int TILE = 128;     // rows and columns of a tile
constexpr int BK = 16;        // k a chunk
constexpr int STAGES = 4;     // chunks in the ring
constexpr int WPITCH = TILE + 4;  // floats a k row of the widened A

// The dynamic shared memory of one instantiation: the A ring (rows in their
// stored type T), the B ring (f32), the widened A (two slots, unless A is
// f32 [k][m] already), the row pointers (the tile's 128 cells, K-major; a
// slot of 16 a stage, MN-major) and, where B's rows come through an index
// (BLISTED, MN-major only), B's row pointers in slots of their own.
template <typename T, bool KMAJOR, bool BLISTED = false>
struct Layout {
  static_assert(!(KMAJOR && BLISTED), "an indexed B takes MN-major A");
  static constexpr bool kAInPlace = std::is_same<T, float>::value && !KMAJOR;
  static constexpr int kAStage = TILE * BK * static_cast<int>(sizeof(T));
  static constexpr int kBStage = BK * TILE * 4;
  static constexpr int kWide = kAInPlace ? 0 : 2 * BK * WPITCH * 4;
  static constexpr int kPtrs = 8 * (KMAJOR ? TILE : STAGES * BK);
  static constexpr int kB = STAGES * kAStage;
  static constexpr int kW = kB + STAGES * kBStage;
  static constexpr int kP = kW + kWide;
  static constexpr int kBP = kP + kPtrs;
  static constexpr int kBytes = kBP + (BLISTED ? 8 * STAGES * BK : 0);
};

// Whether a copy of w bytes (16, 8, 4, or 0: element by element) may read
// rows of `pitch` bytes from `base`; B (f32) takes 16, 8 or 4 only.
inline bool width_ok(int w, long long pitch, const void* base, bool a) {
  const auto addr = reinterpret_cast<uintptr_t>(base);
  if (w == 0) return a;
  return (w == 16 || w == 8 || w == 4) && pitch % w == 0 && addr % w == 0;
}

// The launch's plan as the wrapper made it: the copy widths that the rows'
// alignment allows, STAGES stages, Layout's bytes. The C entries return
// cudaErrorInvalidValue for another.
template <typename T, bool KMAJOR, bool BLISTED = false>
bool plan_ok(int wa, int wb, int stages, int smem, const void* a_base,
             long long a_pitch, const void* b_base, long long b_pitch) {
  return width_ok(wa, a_pitch, a_base, true) &&
         width_ok(wb, b_pitch, b_base, false) && stages == STAGES &&
         smem == Layout<T, KMAJOR, BLISTED>::kBytes;
}

// B's rows: B(k, n) = row(k)[n]. DenseB reads B [K, ld] in place; IndexedB
// reads row list[k] of b [*, ld] (row k itself where list is null), each
// found once a chunk, beside A's (MN-major A only).
struct DenseB {
  static constexpr bool kListed = false;
  const float* b;
  long long ld;
  __device__ __forceinline__ const float* row(int k) const {
    return b + k * ld;
  }
  __host__ __device__ const float* base() const { return b; }
};
struct IndexedB {
  static constexpr bool kListed = true;
  const float* b;
  const int* list;  // null: row k
  long long ld;
  __device__ __forceinline__ const float* row(int k) const {
    return b + static_cast<long long>(list != nullptr ? __ldg(list + k) : k) *
                   ld;
  }
  __host__ __device__ const float* base() const { return b; }
};

// Opt the kernel into `smem` bytes of dynamic shared memory and the largest
// shared carveout (two blocks an SM).
template <class Kernel>
cudaError_t opt_in(Kernel* kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy W bytes (16, 8 or 4) global -> shared; `ok` false zero-fills the
// destination and reads nothing (`src` must still be a W-aligned address).
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  static_assert(W == 16 || W == 8 || W == 4, "cp.async copies 4, 8, 16 B");
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(W), "r"(ok ? W : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The unsigned type of T's bits (an element-by-element copy moves them).
template <int BYTES>
struct Bits;
template <>
struct Bits<1> {
  using type = uint8_t;
};
template <>
struct Bits<2> {
  using type = uint16_t;
};
template <>
struct Bits<4> {
  using type = uint32_t;
};

// Column n's position in a k row of B: 16-byte group g = n / 4 at
// g ^ ((g >> 3) & 1).
__device__ __forceinline__ int bswz(int n) {
  return ((((n >> 2) ^ ((n >> 5) & 1))) << 2) | (n & 3);
}

// Call f(std::integral_constant<int, w>) for the copy width w (16, 8, 4 or
// 0): a switch that is uniform over the block.
template <class F>
__device__ __forceinline__ void by_width(int w, F&& f) {
  switch (w) {
    case 16:
      f(std::integral_constant<int, 16>{});
      break;
    case 8:
      f(std::integral_constant<int, 8>{});
      break;
    case 4:
      f(std::integral_constant<int, 4>{});
      break;
    default:
      f(std::integral_constant<int, 0>{});
      break;
  }
}

// Element `sub` of the 32-bit word w holding elements of type T, widened
// to f32 (exactly, as rows_f32::widen).
__device__ __forceinline__ float widen_bits(float*, uint32_t w, int) {
  return __uint_as_float(w);
}
__device__ __forceinline__ float widen_bits(__half*, uint32_t w, int sub) {
  return __half2float(
      __ushort_as_half(static_cast<unsigned short>(w >> (16 * sub))));
}
__device__ __forceinline__ float widen_bits(int8_t*, uint32_t w, int sub) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * sub)));
}

// The EPG elements of type T at shared address src, widened to f32: one
// 16-, 8- or 4-byte load where the granule is that wide, else one load an
// element.
template <typename T, int EPG>
__device__ __forceinline__ void widen_granule(const T* src,
                                              float (&out)[EPG]) {
  constexpr int BYTES = EPG * static_cast<int>(sizeof(T));
  constexpr int PER_WORD = 4 / static_cast<int>(sizeof(T));
  uint32_t w[4];
  if constexpr (BYTES == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (BYTES == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x, w[1] = v.y;
  } else if constexpr (BYTES == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(src);
  }
#pragma unroll
  for (int j = 0; j < EPG; ++j)
    out[j] = BYTES >= 4 ? widen_bits(static_cast<T*>(nullptr),
                                     w[j / PER_WORD], j % PER_WORD)
                        : rows_f32::widen(src[j]);
}

// Call f(std::integral_constant<int, W>{}) for a copy width that the launch
// fixed at compile time (W >= 0), else for the width w read at run time.
template <int W, class F>
__device__ __forceinline__ void with_width(int w, F&& f) {
  if constexpr (W >= 0) {
    f(std::integral_constant<int, W>{});
  } else {
    by_width(w, f);
  }
}

// The copy widths a launch compiles in: 16-byte copies of both operands
// (every shape whose rows are 16-byte aligned: the main path's), else the
// widths read at run time (one instantiation for every other width, which
// keeps the loop's registers free of the variants' addresses only where it
// matters). Calls f(std::integral_constant<int, WA>{},
// std::integral_constant<int, WB>{}).
constexpr int RUNTIME = -1;
template <class F>
cudaError_t by_plan(int wa, int wb, F&& f) {
  if (wa == 16 && wb == 16)
    return f(std::integral_constant<int, 16>{},
             std::integral_constant<int, 16>{});
  return f(std::integral_constant<int, RUNTIME>{},
           std::integral_constant<int, RUNTIME>{});
}

// The sums acc (zero on entry) of rows m0 .. m0+127 and columns n0 ..
// n0+127 of sum over k in [k0, k1) of A(m, k) B(k, n), over M x N (rows and
// columns past them, and k past k1, read as 0). A's rows come from `rows`
// (row source, cell(i) -> const T*, null for none): K-major, rows.cell(m)
// holds A(m, k) at k; else rows.cell(k) holds A(m, k) at m. B's f32 rows
// from `brows` (DenseB: B [K, ldb], B(k, n) = b[k * ldb + n]; IndexedB).
// wa, wb: the copy widths (WA, WB where the launch fixed them, RUNTIME for
// wa, wb). smem: Layout's bytes, 16-byte aligned.
template <typename T, bool KMAJOR, int WA, int WB, class Rows, class BRows>
__device__ __forceinline__ void mainloop(const Rows& rows,
                                         const BRows& brows, int M, int N,
                                         int m0, int n0, int k0, int k1,
                                         int wa, int wb,
                                         float (&acc)[8][8],
                                         unsigned char* smem) {
  constexpr bool BLISTED = BRows::kListed;
  using L = Layout<T, KMAJOR, BLISTED>;
  using U = typename Bits<sizeof(T)>::type;
  T* const aring = reinterpret_cast<T*>(smem);
  float* const bring = reinterpret_cast<float*>(smem + L::kB);
  float* const wide = reinterpret_cast<float*>(smem + L::kW);
  const T** const ptrs = reinterpret_cast<const T**>(smem + L::kP);
  const float** const bptrs = reinterpret_cast<const float**>(smem + L::kBP);
  const float* const b = brows.base();
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  if (k1 <= k0) return;  // no k: the sums stay 0 (the whole block)
  const int nk = (k1 - k0 + BK - 1) / BK;
  const T* const a_dummy = rows.base();  // a valid address for zero fills

  // Row pointers: the tile's cells (K-major), or the cells of chunk c in
  // slot c % STAGES (MN-major). MN-major: every thread finds a row (thread
  // tid the (tid % BK)-th of the chunk's, a valid cell's where the chunk
  // runs past k1) and the first BK threads store theirs, so that no branch
  // keeps the row index's load from overlapping the products around it.
  auto find_rows = [&](int c) {
    const int kr = tid % BK, k = k0 + c * BK + kr;
    const bool in = c < nk && k < k1;
    const T* p = rows.cell(min(k, k1 - 1));
    if (tid < BK) ptrs[(c % STAGES) * BK + kr] = in ? p : nullptr;
    if constexpr (BLISTED) {
      const float* q = brows.row(min(k, k1 - 1));
      if (tid < BK) bptrs[(c % STAGES) * BK + kr] = in ? q : nullptr;
    }
  };
  if constexpr (KMAJOR) {
    for (int m = tid; m < TILE; m += THREADS)
      ptrs[m] = m0 + m < M ? rows.cell(m0 + m) : nullptr;
  } else {
    for (int c = 0; c < STAGES; ++c) find_rows(c);
  }
  __syncthreads();

  // Issue chunk c's copies into stage c % STAGES.
  auto issue = [&](int c) {
    const int st = c % STAGES, kc = k0 + c * BK;
    T* const as = aring + st * (TILE * BK);
    with_width<WA>(wa, [&](auto wconst) {
      constexpr int W = decltype(wconst)::value;
      constexpr int EPG = W ? W / static_cast<int>(sizeof(T)) : 1;
      if constexpr (KMAJOR) {  // [TILE][BK]: a cell's channels kc ..
        constexpr int GPR = BK / EPG, NG = TILE * GPR;
#pragma unroll
        for (int g0 = 0; g0 < NG; g0 += THREADS) {
          const int g = g0 + tid;
          if (NG % THREADS != 0 && g >= NG) break;
          const int m = g / GPR, k = kc + (g % GPR) * EPG;
          const T* src = ptrs[m];
          const bool ok = src != nullptr && k < k1;
          T* dst = as + m * BK + (g % GPR) * EPG;
          if constexpr (W == 0) {
            *reinterpret_cast<U*>(dst) =
                ok ? *reinterpret_cast<const U*>(src + k) : U(0);
          } else {
            cp_async<W>(dst, ok ? src + k : a_dummy, ok);
          }
        }
      } else {  // [BK][TILE]: cell kc + kr's channels m0 ..
        constexpr int GPR = TILE / EPG, NG = BK * GPR;
        const T* const* slot = ptrs + st * BK;
#pragma unroll
        for (int g0 = 0; g0 < NG; g0 += THREADS) {
          const int g = g0 + tid;
          if (NG % THREADS != 0 && g >= NG) break;
          const int kr = g / GPR, m = m0 + (g % GPR) * EPG;
          const T* src = slot[kr];
          const bool ok = src != nullptr && m < M;
          T* dst = as + kr * TILE + (g % GPR) * EPG;
          if constexpr (W == 0) {
            *reinterpret_cast<U*>(dst) =
                ok ? *reinterpret_cast<const U*>(src + m) : U(0);
          } else {
            cp_async<W>(dst, ok ? src + m : a_dummy, ok);
          }
        }
      }
    });
    float* const bs = bring + st * (BK * TILE);
    with_width<WB>(wb, [&](auto wconst) {
      constexpr int W = decltype(wconst)::value;
      if constexpr (W != 0) {
        constexpr int EPG = W / 4, GPR = TILE / EPG, NG = BK * GPR;
#pragma unroll
        for (int g0 = 0; g0 < NG; g0 += THREADS) {
          const int g = g0 + tid;
          const int kr = g / GPR, k = kc + kr, n = n0 + (g % GPR) * EPG;
          const float* src;
          bool ok = k < k1 && n < N;
          if constexpr (BLISTED) {
            src = bptrs[st * BK + kr];
            ok = ok && src != nullptr;
          } else {
            src = brows.row(k);
          }
          cp_async<W>(bs + kr * TILE + bswz((g % GPR) * EPG),
                      ok ? src + n : b, ok);
        }
      }
    });
  };

  // Chunk c's preparation by the thread that copied it: A widened into
  // wide's slot c & 1.
  auto prepare = [&](int c) {
    const int st = c % STAGES;
    if constexpr (!L::kAInPlace) {
      const T* const as = aring + st * (TILE * BK);
      float* const w = wide + (c & 1) * (BK * WPITCH);
      with_width<WA>(wa, [&](auto wconst) {
        constexpr int W = decltype(wconst)::value;
        constexpr int EPG = W ? W / static_cast<int>(sizeof(T)) : 1;
        if constexpr (KMAJOR) {  // transposed: [m][k] -> [k][m]
          constexpr int GPR = BK / EPG, NG = TILE * GPR;
#pragma unroll
          for (int g0 = 0; g0 < NG; g0 += THREADS) {
            const int g = g0 + tid;
            if (NG % THREADS != 0 && g >= NG) break;
            const int m = g / GPR, kk = (g % GPR) * EPG;
            float x[EPG];
            widen_granule<T, EPG>(as + m * BK + kk, x);
#pragma unroll
            for (int j = 0; j < EPG; ++j) w[(kk + j) * WPITCH + m] = x[j];
          }
        } else {
          constexpr int GPR = TILE / EPG, NG = BK * GPR;
#pragma unroll
          for (int g0 = 0; g0 < NG; g0 += THREADS) {
            const int g = g0 + tid;
            if (NG % THREADS != 0 && g >= NG) break;
            const int kr = g / GPR, m = (g % GPR) * EPG;
            float x[EPG];
            widen_granule<T, EPG>(as + kr * TILE + m, x);
#pragma unroll
            for (int j = 0; j < EPG; ++j) w[kr * WPITCH + m + j] = x[j];
          }
        }
      });
    }
  };

  // Thread (ty, tx)'s B columns: float4 groups 2tx and 2tx + 1, swizzled.
  const int sw = (tx >> 2) & 1;
  const int blo = (2 * tx + sw) * 4, bhi = (2 * tx + 1 - sw) * 4;
  constexpr int APITCH = L::kAInPlace ? TILE : WPITCH;

  // Chunk c's products over its k in [k_lo, k_hi).
  auto compute = [&](int c, int k_lo, int k_hi) {
    const float* as =
        L::kAInPlace
            ? reinterpret_cast<const float*>(aring + (c % STAGES) * TILE * BK)
            : wide + (c & 1) * (BK * WPITCH);
    const float* bs = bring + (c % STAGES) * (BK * TILE);
#pragma unroll
    for (int kk = k_lo; kk < k_hi; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(as + kk * APITCH + ty * 8);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * APITCH + ty * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * TILE + blo);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * TILE + bhi);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  };

  // Chunks 0 .. STAGES - 2 in flight, chunk 0 prepared. Each chunk c then
  // takes the rows of chunk c + STAGES (MN-major: slot c % STAGES, read by
  // the copies of chunk c, a barrier ago), half its products, the copies
  // of chunk c + STAGES - 1 (into the stage chunk c - 1 held, which every
  // thread finished before the last barrier), this thread's preparation of
  // chunk c + 1 (its copies are the oldest in flight; wide's slot (c + 1)
  // & 1 was last read by chunk c - 1), the other half of its products, and
  // one barrier, after which chunk c + 1 is whole. No branch separates the
  // copies, the preparation and the row lookups from the warp's own
  // products, which hide their latency: chunks past the last are copied
  // as zero fills and prepared into a slot that nothing reads.
#pragma unroll 1
  for (int c = 0; c < STAGES - 1; ++c) {
    issue(c);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  prepare(0);
  __syncthreads();
#pragma unroll 1
  for (int c = 0; c < nk; ++c) {
    if constexpr (!KMAJOR) find_rows(c + STAGES);
    compute(c, 0, BK / 2);
    issue(c + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c + 1
    prepare(c + 1);
    compute(c, BK / 2, BK);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// mainloop with B [K, ldb] f32 read in place (DenseB).
template <typename T, bool KMAJOR, int WA, int WB, class Rows>
__device__ __forceinline__ void mainloop(const Rows& rows,
                                         const float* __restrict__ b,
                                         long long ldb, int M, int N,
                                         int m0, int n0, int k0, int k1,
                                         int wa, int wb,
                                         float (&acc)[8][8],
                                         unsigned char* smem) {
  mainloop<T, KMAJOR, WA, WB>(rows, DenseB{b, ldb}, M, N, m0, n0, k0, k1, wa,
                              wb, acc, smem);
}

// out[m, n] = sum over k of A(m, k) B(k, n) over M x N, A MN-major from
// `rows` (rows.cell(k): the k-th cell's channels), on a grid of (N / 128,
// M / 128, splits) blocks (edges rounded up): split z takes k in
// [z * chunk, min(K, (z + 1) * chunk)) and writes its own M x N slice of
// out (out + z * M * ldo), which a caller sums in a fixed order. The dW_v
// products of K5f and K8f.
template <typename T, int WA, int WB, class Rows>
__global__ void __launch_bounds__(THREADS, 2)
    product_kernel(Rows rows, const float* __restrict__ b, long long ldb,
                   int M, int N, int K,
                   int chunk, float* __restrict__ out, long long ldo, int wa,
                   int wb) {
  extern __shared__ __align__(16) unsigned char smem[];
  float acc[8][8] = {};
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int k0 = blockIdx.z * chunk;
  mainloop<T, false, WA, WB>(rows, b, ldb, M, N, m0, n0, k0,
                             min(K, k0 + chunk), wa, wb, acc, smem);
  out += (long long)blockIdx.z * M * ldo;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (m < M && n < N) out[m * ldo + n] = acc[i][j];
    }
  }
}

// Launch product_kernel on `splits` splits of `chunk` cells each, after the
// shared-memory opt-in, on a plan that plan_ok<T, false> has passed; a
// launch adds one to *launched.
template <typename T, class Rows>
cudaError_t launch_product(const Rows& rows, const float* b, long long ldb,
                           int M, int N, int K,
                           int chunk, int splits, float* out, long long ldo,
                           int wa, int wb, int smem, cudaStream_t stream,
                           int* launched) {
  return by_plan(wa, wb, [&](auto fa, auto fb) {
    auto* kernel =
        product_kernel<T, decltype(fa)::value, decltype(fb)::value, Rows>;
    cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((N + TILE - 1) / TILE, (M + TILE - 1) / TILE, splits),
             THREADS, smem, stream>>>(rows, b, ldb, M, N, K, chunk, out,
                                      ldo, wa, wb);
    ++*launched;
    return cudaGetLastError();
  });
}

}  // namespace fp32_ring
