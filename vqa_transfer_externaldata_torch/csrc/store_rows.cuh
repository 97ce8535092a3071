// Loads of a resident store's rows for the attention kernels K4, K5 (and
// K8's dW_v GEMM, attention_dwv.cuh): a row holds values of the kernel's
// 16-bit element type E (bf16, or float16 in K4h/K5h: elem16.cuh), or the
// int8 codes of an L2-prenormalized store whose one global scale is applied
// outside the kernels (ops/attention_resident.py). Codes are widened to E
// as they are loaded, which is exact (|code| <= 127 < 2^8 for bf16, < 2^11
// for f16), so the shared-memory tiles, the tensor-core products and every
// sum downstream are those of an E row holding the same values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "elem16.cuh"

namespace {

namespace store_rows {

template <class T>
constexpr bool kInt8 = std::is_same<T, int8_t>::value;

// The registers that hold eight consecutive values of a row as loaded: 16
// bytes of 16-bit values or 8 bytes of codes. A kernel that keeps the next
// k-step's tile in flight during its MMAs holds them raw and widens them
// only when it stores them into shared memory, so no conversion waits on
// the load.
template <class T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  using type = uint4;
};
template <>
struct Raw8<__half> {
  using type = uint4;
};
template <>
struct Raw8<int8_t> {
  using type = uint2;
};
template <class T>
using raw8_t = typename Raw8<T>::type;

// One aligned load of eight consecutive values (16 or 8 bytes).
__device__ __forceinline__ uint4 load_raw8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load_raw8(const __half* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint2 load_raw8(const int8_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// Eight values as eight E in a uint4, in address order: E values as they
// are, int8 codes widened.
template <class E>
__device__ __forceinline__ uint4 widen8(uint4 x) {
  return x;
}
template <class E>
__device__ __forceinline__ uint4 widen8(uint2 raw) {
  const uint32_t words[2] = {raw.x, raw.y};
  uint4 out;
  typename Elem<E>::pair* o = reinterpret_cast<typename Elem<E>::pair*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = words[i >> 1] >> (16 * (i & 1));
    o[i] = Elem<E>::from2(
        static_cast<float>(static_cast<int8_t>(w & 0xffu)),
        static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu)));
  }
  return out;
}

// Two consecutive values (aligned to two elements) as floats.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

}  // namespace store_rows

}  // namespace
