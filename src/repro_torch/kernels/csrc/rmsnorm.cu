// RMSNorm on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (pallas_call at rmsnorm.py:31): per row of a flattened [R, D],
// y = x * rsqrt(mean(x^2) + eps) * (1 + w), computed in f32 and cast to
// x's dtype (f32 or bf16); w is f32 [D].
//
// Bound: bytes.  Each element is read once and written once with three
// flops in between, far below the card's 295 flops per byte.  The path
// has two regimes: prefill (R = B*S = 4096 rows of D = 768 .. 4096),
// where the least time is the bytes over HBM's 3.35 TB/s, and decode
// (R = 8), where it is one load round trip and one reduction.
//
// Design: the row lives in registers and is read once.  A row is
// nvec = D / V 16-byte vectors (V = 8 bf16, 4 f32) spread over TPR
// threads with VPT vectors each (template arguments: VPT in {1, 2, 4},
// TPR in {32, 128, 256}).  Every load of the row is issued before the
// first sum, fully unrolled and predicated on nvec; a masked slot holds
// zeros, so the sum of squares is unchanged.  Beside those loads the
// block stages (1 + w) in shared memory once, as float4 loads.  The sum
// of squares is reduced with warp shuffles and, when TPR > 32, across the
// row's warps through shared memory; the row is scaled from registers,
// (f * inv) * (1 + w) as the plain version orders it, and stored as
// 16-byte vectors.  There is no second pass over x.
//
// The host picks (VPT, TPR) and the rows per block for each call
// (kernels/rmsnorm.py::plan): many rows pack 256 / TPR rows into a block
// of 256 threads with the smallest TPR that holds the row in at most
// four vectors a thread, so 16-byte loads keep HBM busy; few rows spread
// one row over a block of 128-256 threads with one or two vectors each,
// so the call is one load round trip plus one block reduction.
//
// A D that does not fill whole vectors, a pointer off a 16-byte
// boundary, or a row wider than 1024 vectors takes the element path: one
// warp per row, scalar loads, a second pass that re-reads the row.
#include "float_io.cuh"

namespace {

constexpr int kBlock = 256;   // threads of a many-rows or element block

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u,
                                                      float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Rows held in registers: blockDim.x / TPR rows a block, TPR threads a
// row.  Dynamic shared memory: (1 + w) [D], then the warp sums
// [rows][TPR / 32].
template <typename T, int VPT, int TPR>
__global__ void __launch_bounds__(kBlock) rmsnorm_reg_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    T* __restrict__ out, int R, int D, float eps) {
  constexpr int V = halcone::vec_len<T>();
  constexpr int kWarps = TPR / 32;
  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4) + D;
  const int rows = blockDim.x / TPR;
  const int t = threadIdx.x % TPR;
  const int r = threadIdx.x / TPR;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * rows + r;
  const bool live = row < R;
  const int nvec = D / V;
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + (live ? row : 0) * D);

  // every load of the row first, then (1 + w) into shared memory
  uint4 v[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = t + k * TPR;
    v[k] = (live && j < nvec) ? xr[j] : make_uint4(0u, 0u, 0u, 0u);
  }
  const float4* w4 = reinterpret_cast<const float4*>(w);
  for (int i = threadIdx.x; i < D / 4; i += blockDim.x) {
    const float4 u = w4[i];
    smem4[i] = make_float4(1.f + u.x, 1.f + u.y, 1.f + u.z, 1.f + u.w);
  }

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    float f[V];
    unpack<T>(v[k], f);
#pragma unroll
    for (int e = 0; e < V; ++e) ss += f[e] * f[e];
  }
  ss = halcone::warp_sum(ss);
  if (kWarps > 1 && (t & 31) == 0) part[r * kWarps + t / 32] = ss;
  __syncthreads();   // (1 + w) staged, the row's warp sums posted
  if (kWarps > 1) {
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) ss += part[r * kWarps + i];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  T* orow = out + row * D;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = t + k * TPR;
    if (j < nvec) {
      float f[V];
      unpack<T>(v[k], f);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 g = smem4[j * (V / 4) + q];
        f[4 * q] = (f[4 * q] * inv) * g.x;
        f[4 * q + 1] = (f[4 * q + 1] * inv) * g.y;
        f[4 * q + 2] = (f[4 * q + 2] * inv) * g.z;
        f[4 * q + 3] = (f[4 * q + 3] * inv) * g.w;
      }
      halcone::store_vec(orow + j * V, f);
    }
  }
}

// The element path: one warp per row, kBlock / 32 rows a block.
template <typename T>
__global__ void __launch_bounds__(kBlock) rmsnorm_elem_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    T* __restrict__ out, int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kBlock / 32) + (threadIdx.x >> 5);
  if (row >= R) return;  // whole warp: row is per warp
  const T* xr = x + row * D;
  T* orow = out + row * D;
  float ss = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float f = halcone::to_f32(xr[i]);
    ss += f * f;
  }
  ss = halcone::warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  for (int i = lane; i < D; i += 32) {
    const float f = halcone::to_f32(xr[i]);
    orow[i] = halcone::from_f32<T>((f * inv) * (1.f + w[i]));
  }
}

struct Args {
  const void* x;
  const void* w;
  void* out;
  int R, D;
  float eps;
  int rows;
  cudaStream_t stream;
};

template <typename T, int VPT, int TPR>
int launch_reg(const Args& a) {
  constexpr int V = halcone::vec_len<T>();
  if (a.rows < 1 || a.rows * TPR > kBlock || a.D % V ||
      a.D / V > VPT * TPR)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (a.R + a.rows - 1) / a.rows;
  const size_t smem = sizeof(float) * (a.D + a.rows * (TPR / 32));
  rmsnorm_reg_kernel<T, VPT, TPR><<<blocks, a.rows * TPR, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.w),
      static_cast<T*>(a.out), a.R, a.D, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VPT>
int by_tpr(int tpr, const Args& a) {
  switch (tpr) {
    case 32: return launch_reg<T, VPT, 32>(a);
    case 128: return launch_reg<T, VPT, 128>(a);
    case 256: return launch_reg<T, VPT, 256>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_vpt(int vpt, int tpr, const Args& a) {
  switch (vpt) {
    case 0: {
      const int blocks = (a.R + kBlock / 32 - 1) / (kBlock / 32);
      rmsnorm_elem_kernel<T><<<blocks, kBlock, 0, a.stream>>>(
          static_cast<const T*>(a.x), static_cast<const float*>(a.w),
          static_cast<T*>(a.out), a.R, a.D, a.eps);
      return static_cast<int>(cudaGetLastError());
    }
    case 1: return by_tpr<T, 1>(tpr, a);
    case 2: return by_tpr<T, 2>(tpr, a);
    case 4: return by_tpr<T, 4>(tpr, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, out: [R, D] contiguous, dtype code `dt` (halcone::kF32 / kBF16);
// w: [D] f32.  vpt in {1, 2, 4} with tpr in {32, 128, 256} and `rows`
// rows a block (rows * tpr <= 256) runs the register kernel: x, out and
// w 16-byte aligned and D / V <= vpt * tpr.  vpt = 0 runs the element
// path (any D, any alignment).
extern "C" int halcone_rmsnorm(const void* x, const void* w, void* out,
                               int R, int D, float eps, int vpt, int tpr,
                               int rows, int dt, void* stream) {
  const Args a{x, w, out, R, D, eps, rows, static_cast<cudaStream_t>(stream)};
  if (dt == halcone::kF32) return by_vpt<float>(vpt, tpr, a);
  if (dt == halcone::kBF16) return by_vpt<__nv_bfloat16>(vpt, tpr, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
