// The 16-bit element types of the tensor-core kernels: bf16 (K1-K8, P1,
// P2) and float16 (K1h-K8h). Both feed the same mma.sync and
// wgmma shapes, fragment layouts, ldmatrix loads and shared-memory swizzle
// at the same rate, so a kernel is one body over its element type E, and
// Elem<E> names the conversions that differ: float -> E rounds to nearest
// even (f16 keeps 10 fraction bits and 5 exponent bits, so it overflows to
// inf past 65504 and goes subnormal below 2^-14, as JAX's astype does),
// E -> float is exact.
//
// The eight float16 libraries (csrc/*_f16.cu) build their bf16 twin's
// source again with KERNEL_ELEM_F16 defined: KernelElem is the element type
// of the library being built.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

template <class E>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  using pair = __nv_bfloat162;
  static constexpr bool kF16 = false;
  __device__ __forceinline__ static __nv_bfloat16 from(float x) {
    return __float2bfloat16(x);
  }
  __device__ __forceinline__ static float to(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static pair from2(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  __device__ __forceinline__ static float2 to2(pair x) {
    return __bfloat1622float2(x);
  }
};

template <>
struct Elem<__half> {
  using pair = __half2;
  static constexpr bool kF16 = true;
  __device__ __forceinline__ static __half from(float x) {
    return __float2half_rn(x);
  }
  __device__ __forceinline__ static float to(__half x) {
    return __half2float(x);
  }
  __device__ __forceinline__ static pair from2(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  __device__ __forceinline__ static float2 to2(pair x) {
    return __half22float2(x);
  }
};

// x rounded to E and back: the rounding JAX's astype(E) makes.
template <class E>
__device__ __forceinline__ float round_to(float x) {
  return Elem<E>::to(Elem<E>::from(x));
}

#ifdef KERNEL_ELEM_F16
using KernelElem = __half;
#else
using KernelElem = __nv_bfloat16;
#endif

}  // namespace
