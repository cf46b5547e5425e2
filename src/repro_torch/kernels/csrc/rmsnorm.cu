// RMSNorm on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (pallas_call at rmsnorm.py:31): per row of a flattened [R, D],
// y = x * rsqrt(mean(x^2) + eps) * (1 + w), computed in f32 and cast to
// x's dtype (f32 or bf16); w is f32 [D].
//
// Bound: bytes.  Each element is read once and written once with three
// flops in between, far below the card's 295 flops per byte; at the
// serving path's shapes (R = B*S up to 4096, D = 960) the least time is
// the bytes over HBM's 3.35 TB/s.
//
// Design: one warp per row, four rows per block.  Lanes stride over the
// row in 16-byte vectors (coalesced), accumulate the sum of squares in
// f32 and reduce it with shuffles; the second pass re-reads the row (from
// L1/L2: a row is a few KB) to scale and store it.  D need not be a power
// of two: the lane loop is bounded by the row length, so a lane with no
// vector left in the last round does nothing.  When D does not fill whole
// vectors or a pointer is not 16-byte aligned, the wrapper asks for the
// element path instead.
#include "float_io.cuh"

namespace {

constexpr int kRowsPerBlock = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock) rmsnorm_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    T* __restrict__ out, int R, int D, float eps, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // whole warp: row is per warp
  const T* xr = x + static_cast<int64_t>(row) * D;
  T* orow = out + static_cast<int64_t>(row) * D;
  constexpr int V = halcone::vec_len<T>();

  float ss = 0.f;
  if (vec) {
    for (int i = lane * V; i < D; i += 32 * V) {
      float f[V];
      halcone::load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < V; ++j) ss += f[j] * f[j];
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float f = halcone::to_f32(xr[i]);
      ss += f * f;
    }
  }
  ss = halcone::warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);

  if (vec) {
    for (int i = lane * V; i < D; i += 32 * V) {
      float f[V];
      halcone::load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = (f[j] * inv) * (1.f + w[i + j]);
      halcone::store_vec(orow + i, f);
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float f = halcone::to_f32(xr[i]);
      orow[i] = halcone::from_f32<T>((f * inv) * (1.f + w[i]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int R, int D, float eps,
           int vec, cudaStream_t stream) {
  const int blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), R, D, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [R, D] contiguous, dtype code `dt` (halcone::kF32 / kBF16);
// w: [D] f32.  `vec` = 1 when D fills whole 16-byte vectors and x and
// out are 16-byte aligned.
extern "C" int halcone_rmsnorm(const void* x, const void* w, void* out,
                               int R, int D, float eps, int vec, int dt,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == halcone::kF32) return launch<float>(x, w, out, R, D, eps, vec, s);
  if (dt == halcone::kBF16)
    return launch<__nv_bfloat16>(x, w, out, R, D, eps, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
