// The score mainloop shared by K4's score kernel (attention_resident_fwd.cu),
// K8's dz stage (attention_bwd.cu) and the probe P1 (probe_mxu_rows.cu): one
// 128-row x BN-column tile of
//
//   acc = A @ W_v      A [rows, C]: store rows looked up one by one, or the
//                      rows of a dense matrix (DenseRows),
//                      W_v [C, H] of E, f32 sums of E products, E the
//                      16-bit element type: bf16, or float16 in K2h, K4h
//                      and K8h
//
// on Hopper's warpgroup MMA (wgmma, sm_90a). Its primitives (the copies,
// fences, swizzle and wgmma wrappers) also serve the dW_v GEMM of
// attention_dwv.cuh.
//
// What bounds it on an H100: at K4's training shape (51,200 rows x 2048 x
// 512) the product is 105 GFLOP, 0.106 ms at the bf16 peak, against 205 MB
// of rows (61 us at 3.35 TB/s): the tensor cores, if they are fed. A
// 128 x 256 tile needs 48 KB of A and W_v from L2 for every 64 channels,
// about 87 GB/s an SM at the peak rate.
//
// Design:
//  - 256 threads, two warpgroups. Warpgroup w owns rows 64w .. 64w + 63 of
//    the tile and keeps its 64 x BN f32 accumulator in registers (BN / 2 a
//    thread). BN is 256 where it divides H, else 128 (tile_n).
//  - A ring of kStages stages, each one 64-channel K-chunk of the A tile
//    (128 rows x 128 B) and of W_v^T (BN rows x 128 B). Both are K-major in
//    the 128-byte swizzle that the wgmma descriptors name: 16-byte chunk c
//    of row r lies at r * 128 + ((c ^ (r & 7)) << 4), and every stage
//    starts 1024-byte aligned. W_v arrives as the K-major copy W_v^T
//    [H, C] that the wrappers make, so A and B share one layout.
//  - Every thread issues 16-byte cp.async copies for A and W_v^T alike. A
//    row's address comes from a row-source functor (tile row -> pointer to
//    its first channel, or null past the end). Rows past the end, and the
//    channels past C (the upper half of the last chunk when C % 64 == 32),
//    are zero-filled with the copy's source size 0.
//  - int8 rows: the raw codes go to an int8 slot of the stage (64 B a row),
//    and each thread widens the codes it copied into the stage's E slot
//    (exact: |code| <= 127).
//  - Each chunk: cp.async.wait_group for it; the widening (int8 rows) or the
//    squares (normalize) of the thread's own copies; fence.proxy.async
//    (cp.async and the widening write through the generic proxy, wgmma
//    reads through the async proxy); the block barrier; four m64nBNk16
//    wgmmas a warpgroup, the descriptors 32 B further along K each (the
//    very first with scale_d 0, which starts the sums: the accumulators
//    are never zeroed by other instructions); commit; wgmma.wait_group 1. The chunk before may then still be in flight, so
//    the copies run kStages - 2 chunks ahead: the stage they overwrite held
//    the chunk before that one, which both warpgroups had finished when
//    they passed this chunk's barrier.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "store_rows.cuh"  // and elem16.cuh

namespace {

namespace score_gemm {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBM = 128;       // rows per tile
constexpr int kBK = 64;        // channels per K-chunk
constexpr int kRowBytes = kBK * 2;  // one swizzled row of a chunk: 128 B

// Columns per tile at width H (a multiple of 128).
inline int tile_n(int H) { return H % 256 == 0 ? 256 : 128; }

// The shared memory of a tile: the ring (each stage A, W_v^T and, for int8
// rows, the raw codes), then the tile's per-row norms, with 1024 B of slack
// to align the ring.
template <class T, int BN>
struct Plan {
  static constexpr bool kInt8 = store_rows::kInt8<T>;
  static constexpr int kStages = BN == 256 ? 4 : 5;
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kCodeBytes = kInt8 ? kBM * kBK : 0;
  static constexpr int kStageBytes = kABytes + kBBytes + kCodeBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmemBytes = 1024 + kRingBytes + kBM * 4;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((1024 - (s & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled K-chunk.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

// 16-byte copy global -> shared through L2; `full` false zero-fills the
// destination and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous MMAs.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major 16-bit operand in the 128-byte swizzle: start
// address >> 4 (bits 0-13), leading offset 1 (unused by this layout, bits
// 16-29), stride 1024 B between 8-row groups (bits 32-45), layout type 1,
// SWIZZLE_128B (bits 62-63). The base offset (bits 49-51) is 0: every
// stage is 1024-byte aligned.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// D[64 x N] += A[64 x 16] B[16 x N] for the warpgroup, A and B from shared
// memory through their descriptors, E (bf16 or f16) in, f32 accumulators.
// kTnsp 0: both operands K-major (this mainloop); 1: both MN-major (the
// dW_v GEMM of attention_dwv.cuh, whose reduction runs along the rows of
// both). scale_d 0 ignores D's old value (D = A B), which starts a sum
// without any other instruction writing the accumulator registers. The two
// element types take the same descriptors, layouts and operand registers;
// only the instruction's type names differ (TYPE of the macros below).
#define SCORE_GEMM_WGMMA_N256(TYPE) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TYPE "." TYPE " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, " \
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, " \
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, " \
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, " \
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, " \
      "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, " \
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, " \
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, " \
      "%121, %122, %123, %124, %125, %126, %127" \
      "}, %128, %129, p, 1, 1, %131, %131;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTnsp))

#define SCORE_GEMM_WGMMA_N128(TYPE) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, " \
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, " \
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
      "%55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, %67, %67;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTnsp))

template <class E, int kTnsp>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  if constexpr (Elem<E>::kF16) {
    SCORE_GEMM_WGMMA_N256("f16");
  } else {
    SCORE_GEMM_WGMMA_N256("bf16");
  }
}

template <class E, int kTnsp>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  if constexpr (Elem<E>::kF16) {
    SCORE_GEMM_WGMMA_N128("f16");
  } else {
    SCORE_GEMM_WGMMA_N128("bf16");
  }
}

#undef SCORE_GEMM_WGMMA_N256
#undef SCORE_GEMM_WGMMA_N128

template <int BN, int kTnsp, class E>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t a,
                                    uint64_t b, int scale_d) {
  if constexpr (BN == 256) {
    wgmma_m64n256k16<E, kTnsp>(d, a, b, scale_d);
  } else {
    wgmma_m64n128k16<E, kTnsp>(d, a, b, scale_d);
  }
}

// The accumulator layout of m64nNk16: thread t holds, of its warpgroup's 64
// rows, rows 16 * warp + lane / 4 and that + 8, two columns of every 8:
// acc[4 j + 2 h + e] is tile row frag_row(t) + 8 h, column
// 8 j + frag_col(t) + e.
__device__ __forceinline__ int frag_row(int t) {
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2);
}
__device__ __forceinline__ int frag_col(int t) { return 2 * (t & 3); }

// With E rows, thread t copies channel chunk t & 7 of tile rows
// (t >> 3) + 32 j, j < 4: sq[j] holds the sum of E(x^2) over those
// channels of row sq_row(t, j) (when `squares`): JAX's
// sum(square(v), dtype=f32) squares in v's dtype.
__device__ __forceinline__ int sq_row(int t, int j) {
  return (t >> 3) + 32 * j;
}

// Tile row r is row row0 + r of a dense [rows, C] matrix of E (K2's and
// K8's gathered grid, [B*N, C]), or null past its last row.
template <class E>
struct DenseRows {
  const E* x;
  int C, rows, row0;
  __device__ const E* operator()(int r) const {
    const int row = row0 + r;
    return row < rows ? x + static_cast<size_t>(row) * C : nullptr;
  }
};

// acc = rows(0 .. kBM-1) @ W_v[:, col0 .. col0 + BN) for this thread's part
// of the tile (frag_row / frag_col). `rows(r)` gives a const T* to tile row
// r's first channel, or nullptr past the end (T is E, or int8_t for codes
// widened to E); wvt is W_v^T [H, C] of E; C > 0 and C % 32 == 0. `ring`
// is the 1024-byte-aligned ring of Plan<T, BN>. Ends with every copy landed
// and every MMA done, but without a barrier: the caller syncs before it
// reuses the ring.
template <class T, int BN, class Rows, class E>
__device__ __forceinline__ void mainloop(const Rows& rows,
                                         const E* __restrict__ wvt, int C,
                                         int col0, unsigned char* ring,
                                         float (&acc)[BN / 2], float (&sq)[4],
                                         bool squares) {
  using P = Plan<T, BN>;
  static_assert(P::kInt8 || std::is_same<T, E>::value,
                "float rows are of the element type");
  constexpr int S = P::kStages;
  constexpr int kAhead = S - 2;
  constexpr int kACopies = P::kInt8 ? 2 : 4;    // 16 B of A a thread each
  constexpr int kARowStep = P::kInt8 ? 64 : 32;
  constexpr int kAElems = P::kInt8 ? 16 : 8;    // channels per 16 B
  constexpr int kBCopies = BN / 32;
  const int t = threadIdx.x;
  const int nk = (C + kBK - 1) / kBK;

  const int ar = P::kInt8 ? t >> 2 : t >> 3;
  const int ac = P::kInt8 ? t & 3 : t & 7;
  const T* asrc[kACopies];
#pragma unroll
  for (int j = 0; j < kACopies; ++j) asrc[j] = rows(ar + j * kARowStep);
  const int br = t >> 3;
  const int bc = t & 7;
  const E* bsrc =
      wvt + static_cast<size_t>(col0 + br) * C + bc * 8;
  const uint32_t ring_s = smem_u32(ring);

  // acc is not zeroed: the first wgmma writes it with scale_d 0 (zeroed
  // registers make ptxas serialize the wgmmas, its warning C7515).
#pragma unroll
  for (int j = 0; j < 4; ++j) sq[j] = 0.0f;

  auto load = [&](int kc, int stage) {
    const uint32_t st = ring_s + stage * P::kStageBytes;
    const int k0 = kc * kBK;
    const int ae = k0 + ac * kAElems;
#pragma unroll
    for (int j = 0; j < kACopies; ++j) {
      const int r = ar + j * kARowStep;
      const bool ok = asrc[j] != nullptr && ae < C;
      const uint32_t dst =
          P::kInt8 ? st + P::kABytes + P::kBBytes + r * kBK + ac * 16
                   : st + swz(r, ac);
      cp_async16(dst, ok ? static_cast<const void*>(asrc[j] + ae)
                         : static_cast<const void*>(wvt),
                 ok);
    }
    const int be = k0 + bc * 8;
    const bool bok = be < C;
#pragma unroll
    for (int j = 0; j < kBCopies; ++j) {
      cp_async16(st + P::kABytes + swz(br + 32 * j, bc),
                 bok ? bsrc + static_cast<size_t>(32 * j) * C + k0 : wvt,
                 bok);
    }
  };

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  int stage = 0;     // the stage of chunk kc
  int ahead = kAhead;  // the stage of chunk kc + kAhead
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of chunk kc
    unsigned char* sp = ring + stage * P::kStageBytes;
    if constexpr (P::kInt8) {
#pragma unroll
      for (int j = 0; j < kACopies; ++j) {
        const int r = ar + j * kARowStep;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            sp + P::kABytes + P::kBBytes + r * kBK + ac * 16);
        *reinterpret_cast<uint4*>(sp + swz(r, 2 * ac)) =
            store_rows::widen8<E>(make_uint2(raw.x, raw.y));
        *reinterpret_cast<uint4*>(sp + swz(r, 2 * ac + 1)) =
            store_rows::widen8<E>(make_uint2(raw.z, raw.w));
      }
    } else {
      if (squares) {
#pragma unroll
        for (int j = 0; j < kACopies; ++j) {
          const uint4 x = *reinterpret_cast<const uint4*>(
              sp + swz(ar + j * kARowStep, ac));
          const E* e = reinterpret_cast<const E*>(&x);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float v = Elem<E>::to(e[i]);
            sq[j] += round_to<E>(v * v);
          }
        }
      }
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t st = ring_s + stage * P::kStageBytes;
    const uint32_t a = st + (t >> 7) * (64 * kRowBytes);
    const uint32_t b = st + P::kABytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      mma<BN, 0, E>(acc, desc(a + kk * 32), desc(b + kk * 32),
                    (kc | kk) != 0);
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    fence_acc(acc);
    if (kc + kAhead < nk) load(kc + kAhead, ahead);
    cp_async_commit();
    stage = stage + 1 == S ? 0 : stage + 1;
    ahead = ahead + 1 == S ? 0 : ahead + 1;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
}

}  // namespace score_gemm

}  // namespace
