// Shared device helpers of the port's kernels: conversions between the
// storage types (float, bf16, int8) and float, and vector loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the working type T and widened back: the value a cast to
// the model dtype leaves behind.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int BYTES>
struct VecType;
template <>
struct VecType<2> {
  using type = uint16_t;
};
template <>
struct VecType<4> {
  using type = uint32_t;
};
template <>
struct VecType<8> {
  using type = uint2;
};
template <>
struct VecType<16> {
  using type = uint4;
};

// N consecutive elements of type E at p (aligned to N * sizeof(E)) as
// floats, in one load instruction.
template <typename E, int N>
__device__ __forceinline__ void load_vec(const E* __restrict__ p,
                                         float (&out)[N]) {
  using V = typename VecType<N * sizeof(E)>::type;
  const V v = *reinterpret_cast<const V*>(p);
  const E* e = reinterpret_cast<const E*>(&v);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
}

// N floats to N consecutive elements of type E at p (aligned to
// N * sizeof(E)), each rounded to E, in one store instruction.
template <typename E, int N>
__device__ __forceinline__ void store_vec(E* __restrict__ p,
                                          const float (&in)[N]) {
  using V = typename VecType<N * sizeof(E)>::type;
  V v;
  E* e = reinterpret_cast<E*>(&v);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = from_f<E>(in[i]);
  *reinterpret_cast<V*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace ptt

// Every library exports its error text so that the Python wrapper can
// raise with it.
#define PTT_EXPORT_ERROR_STRING                              \
  extern "C" const char* ptt_error_string(int e) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(e));  \
  }
