// RMSNorm backward on Hopper (sm_90a).
//
// The gradient of rmsnorm.cu's y = x * rstd * (1 + w), rstd =
// rsqrt(mean(x^2) + eps), computed in f32.  The reference trains through
// jnp layers that XLA differentiates and has no backward Pallas kernel;
// this kernel is the backward of the port's forward kernel, which
// replaces repro/kernels/rmsnorm.py::_rmsnorm_kernel (pallas_call at
// rmsnorm.py:31).  Per row of a flattened [R, D], with g = dy * (1 + w)
// and xh = x * rstd:
//   dx = rstd * (g - xh * mean(g * xh))   in x's dtype (f32 or bf16),
//   dw = sum over rows of dy * xh         f32 [D].
// x and dy share a dtype; w is f32.
//
// Bound: bytes.  x and dy are read and dx written once: at R = 4096, D =
// 960 in bf16 that is 23.6 MB, 7.0 us over HBM's 3.35 TB/s; the flops are
// ~10 a element.
//
// Design: pass 1 gives each warp one row at a time (a grid-stride loop
// over rows).  Its lanes read x and dy as 16-byte vectors when D fills
// whole vectors and the rows start on 16 bytes (element loads
// otherwise), sum x^2 and g * x with warp shuffles, and read the row
// again (from L1) to write dx.  Each warp adds dy * xh of its rows into
// its own row of shared memory; at the end the block adds its warps'
// rows in order and writes one partial row to part[block].  Pass 2 sums
// the G partial rows of each column in a fixed order: 32 columns a
// block, 8 strided groups of rows a column, then the 8 groups in order.
// No atomics, so dw is the same from run to run.
#include "float_io.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kBlock) rmsnorm_bwd_rows(
    const T* __restrict__ x, const float* __restrict__ w,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
    int R, int D, float eps) {
  extern __shared__ float sm[];
  float* g1 = sm;                  // 1 + w, [D]
  float* acc = sm + D;             // each warp's dw rows, [kWarps][D]
  for (int i = threadIdx.x; i < D; i += kBlock) g1[i] = 1.f + w[i];
  for (int i = threadIdx.x; i < kWarps * D; i += kBlock) acc[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* mine = acc + warp * D;
  constexpr int V = VEC ? halcone::vec_len<T>() : 1;
  const int nv = D / V;
  const float inv_d = 1.f / static_cast<float>(D);
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       row < R; row += static_cast<int64_t>(gridDim.x) * kWarps) {
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
    float ss = 0.f, sgx = 0.f;
    for (int j = lane; j < nv; j += 32) {
      float xv[V], gv[V];
      if constexpr (VEC) {
        halcone::load_vec(xr + j * V, xv);
        halcone::load_vec(gr + j * V, gv);
      } else {
        xv[0] = halcone::to_f32(xr[j]);
        gv[0] = halcone::to_f32(gr[j]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ss += xv[e] * xv[e];
        sgx += gv[e] * g1[j * V + e] * xv[e];
      }
    }
    ss = halcone::warp_sum(ss);
    sgx = halcone::warp_sum(sgx);
    const float rstd = rsqrtf(ss * inv_d + eps);
    // mean(g * xh) = rstd * sum(g * x) / D
    const float c = rstd * sgx * inv_d;
    T* dr = dx + row * D;
    for (int j = lane; j < nv; j += 32) {
      float xv[V], gv[V], out[V];
      if constexpr (VEC) {
        halcone::load_vec(xr + j * V, xv);
        halcone::load_vec(gr + j * V, gv);
      } else {
        xv[0] = halcone::to_f32(xr[j]);
        gv[0] = halcone::to_f32(gr[j]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xh = xv[e] * rstd;
        out[e] = rstd * (gv[e] * g1[j * V + e] - xh * c);
        mine[j * V + e] += gv[e] * xh;
      }
      if constexpr (VEC) {
        halcone::store_vec(dr + j * V, out);
      } else {
        dr[j] = halcone::from_f32<T>(out[0]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += kBlock) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += acc[k * D + i];
    part[static_cast<int64_t>(blockIdx.x) * D + i] = s;
  }
}

// dw[c] = sum over g of part[g][c], in a fixed order.
__global__ void __launch_bounds__(kBlock) rmsnorm_bwd_dw(
    const float* __restrict__ part, float* __restrict__ dw, int G, int D) {
  __shared__ float s[kWarps][33];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < D)
    for (int g = grp; g < G; g += kWarps)
      acc += part[static_cast<int64_t>(g) * D + c];
  s[grp][lane] = acc;
  __syncthreads();
  if (grp == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += s[k][lane];
    dw[c] = t;
  }
}

template <typename T, bool VEC>
int launch(const void* x, const void* w, const void* dy, void* dx,
           void* dw, void* part, int R, int D, float eps, int G,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(D) * (1 + kWarps);
  auto* k1 = rmsnorm_bwd_rows<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  k1<<<G, kBlock, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(part), R, D, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_bwd_dw<<<(D + 31) / 32, kBlock, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), G, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_vec(int vec, const void* x, const void* w, const void* dy, void* dx,
           void* dw, void* part, int R, int D, float eps, int G,
           cudaStream_t s) {
  if (vec) {
    if (D % halcone::vec_len<T>()) return static_cast<int>(cudaErrorInvalidValue);
    return launch<T, true>(x, w, dy, dx, dw, part, R, D, eps, G, s);
  }
  return launch<T, false>(x, w, dy, dx, dw, part, R, D, eps, G, s);
}

}  // namespace

// x, dy, dx: [R, D] contiguous, dtype code `dt` (halcone::kF32 / kBF16);
// w, dw: [D] f32; part: [G, D] f32 scratch, G >= 1 blocks of pass 1.
// vec = 1 reads and writes 16-byte vectors: D a multiple of 16 bytes'
// elements and x, dy, dx 16-byte aligned.  D * 36 bytes of shared memory
// must fit a block (D <= 6400).
extern "C" int halcone_rmsnorm_bwd(const void* x, const void* w,
                                   const void* dy, void* dx, void* dw,
                                   void* part, int R, int D, float eps,
                                   int G, int vec, int dt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dt == halcone::kF32)
    return by_vec<float>(vec, x, w, dy, dx, dw, part, R, D, eps, G, s);
  if (dt == halcone::kBF16)
    return by_vec<__nv_bfloat16>(vec, x, w, dy, dx, dw, part, R, D, eps, G,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
