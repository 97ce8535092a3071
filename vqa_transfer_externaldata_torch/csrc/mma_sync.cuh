// The warp-level tensor-core primitives of the persistent GRU kernels, the
// forward of K1 and K6 (csrc/gru_fwd_step.cuh) and the BPTT of K3 and K7
// (csrc/gru_bwd_step.cuh): asynchronous 16-byte copies into shared memory,
// ldmatrix loads and mma.sync m16n8k16 products of 16-bit values (bf16, or
// float16 in K1h and K3h: elem16.cuh) with f32 sums.
//
// WMMA's 16x16x16 bf16 product compiles on sm_90a to two
// HMMA.16816.F32.BF16, one for columns 0..7 and one for 8..15 of the same A
// fragment. These kernels issue that instruction themselves (mma.sync
// m16n8k16), with their operands loaded by ldmatrix, so each 16x16 fragment
// is the same chain of the same products as a WMMA fragment, and each
// m16n8 half of it the same chain on its own. A 16x16 accumulator is two
// m16n8 halves, f[0..3] and f[4..7]: lane l holds rows l/4 and l/4 + 8,
// columns 2(l%4) and 2(l%4) + 1 of each half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "elem16.cuh"

namespace {

// 16-byte asynchronous copy global -> shared through L2 only (state that
// another block wrote before a grid barrier is never stale in L1); `full`
// false zero-fills the destination and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
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

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s)
      : "memory");
}
// d (m16n8, f32) += A B of E values (E picks the instruction's type; the
// operand registers hold two E values each, as ldmatrix loads them).
template <class E>
__device__ __forceinline__ void mma16816(float* d, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  if constexpr (Elem<E>::kF16) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}
// acc (16x16) += A B, with b = {b0 of columns 0-7, b1 of 0-7, b0 of 8-15,
// b1 of 8-15} as ldmatrix gives them below.
template <class E>
__device__ __forceinline__ void mma16(float (&acc)[8], const unsigned (&a)[4],
                                      const unsigned (&b)[4]) {
  mma16816<E>(acc, a, b[0], b[1]);
  mma16816<E>(acc + 4, a, b[2], b[3]);
}
// Lane l's row address for ldmatrix x4 of a 16x16 tile at `base` (leading
// dimension ld): matrix m = l/8 covers rows 8 (m & 1).., columns 8 (m >> 1)..
// (kRowsFirst) or rows 8 (m >> 1).., columns 8 (m & 1).. (otherwise). For
// x2, lanes 0-15 give matrices 0 and 1.
template <bool kRowsFirst, class E>
__device__ __forceinline__ const E* ldsm_addr(const E* base, int ld,
                                              int lane) {
  const int m = lane >> 3;
  const int r = (kRowsFirst ? (m & 1) : (m >> 1)) * 8 + (lane & 7);
  const int c = (kRowsFirst ? (m >> 1) : (m & 1)) * 8;
  return base + r * ld + c;
}
// A fragment (rows x k) from a row-major tile: a0..a3 = (rows 0-7, k 0-7),
// (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15).
template <class E>
__device__ __forceinline__ void load_a(unsigned (&a)[4],
                                       const E* base, int ld,
                                       int lane) {
  ldsm_x4(a, ldsm_addr<true>(base, ld, lane));
}
// A fragment from a tile stored k-major ([k][rows]), through the transpose.
template <class E>
__device__ __forceinline__ void load_a_kmajor(unsigned (&a)[4],
                                              const E* base,
                                              int ld, int lane) {
  ldsm_x4_t(a, ldsm_addr<false>(base, ld, lane));
}
// B fragment (k x 16 columns) from a tile stored k-major ([k][n]).
template <class E>
__device__ __forceinline__ void load_b_kmajor(unsigned (&b)[4],
                                              const E* base,
                                              int ld, int lane) {
  ldsm_x4_t(b, ldsm_addr<true>(base, ld, lane));
}
// B fragment of one n8 half (k x 8 columns at `base`) from a tile stored
// k-major: b0, b1 of those columns, as load_b_kmajor gives them.
template <class E>
__device__ __forceinline__ void load_b_half_kmajor(unsigned (&b)[2],
                                                   const E* base,
                                                   int ld, int lane) {
  ldsm_x2_t(b, ldsm_addr<true>(base, ld, lane));
}
// B fragment from a tile stored n-major ([n][k]).
template <class E>
__device__ __forceinline__ void load_b_nmajor(unsigned (&b)[4],
                                              const E* base,
                                              int ld, int lane) {
  ldsm_x4(b, ldsm_addr<false>(base, ld, lane));
}
// Stores a 16x16 accumulator row-major at `dst` (leading dimension ld).
__device__ __forceinline__ void store_acc(float* dst, size_t ld,
                                          const float (&acc)[8], int lane) {
  const int r = lane >> 2;
  const int c = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    *reinterpret_cast<float2*>(dst + r * ld + h * 8 + c) =
        make_float2(acc[4 * h], acc[4 * h + 1]);
    *reinterpret_cast<float2*>(dst + (r + 8) * ld + h * 8 + c) =
        make_float2(acc[4 * h + 2], acc[4 * h + 3]);
  }
}

}  // namespace
