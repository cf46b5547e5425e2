// Shared device helpers for the float model kernels (sm_90a): element
// conversions between the storage types (f32, bf16) and the f32 the
// kernels compute in, 16-byte vector loads and stores, and warp
// reductions.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <math_constants.h>
#include <cuda_runtime.h>

namespace halcone {

constexpr float kNegInf = -1e30f;   // the reference kernels' NEG_INF mask
constexpr unsigned kAllLanes = 0xffffffffu;

// storage type codes passed by the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Elements per 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_len() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __halves2bfloat162(__float2bfloat16(f[2 * i]),
                              __float2bfloat16(f[2 * i + 1]));
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// A row of D contiguous elements into f32 registers: 16-byte vectors
// when the row start is 16-byte aligned (D * sizeof(T) is a multiple of
// 16 for every D the kernels take), element loads otherwise.
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float* f) {
  constexpr int V = vec_len<T>();
  static_assert(D % V == 0, "D must fill whole 16-byte vectors");
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < D; i += V) load_vec(p + i, f + i);
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) f[i] = to_f32(p[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAllLanes, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kAllLanes, x, o));
  return x;
}

}  // namespace halcone
