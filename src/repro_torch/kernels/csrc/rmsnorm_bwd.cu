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
// Design: the forward's register layout (rmsnorm.cu, chosen on the host
// by kernels/rmsnorm.py::plan).  A row is nvec = D / V 16-byte vectors
// spread over TPR threads with VPT vectors each; a block holds
// blockDim.x / TPR row slots and walks the rows in a grid-stride loop, so
// each thread keeps the same columns for every row it handles.  For each
// row every load of x and dy is issued before the first sum (each read
// once); sum(x^2) and sum(g x) are reduced with warp shuffles and, when
// TPR > 32, across the row's warps through shared memory; dx is written
// from registers.  The thread's (1 + w) and its running sum of dy * xh
// live in registers for its fixed columns, so dw costs no shared-memory
// traffic per element.  At the end the block adds its row slots in order
// through shared memory and writes one partial row to part[block]; a
// second launch sums the G partial rows of each column in a fixed order
// (one launch whose last block summed them would serialize G x D loads
// on one SM).
// No atomics, so dw is the same from run to run.
//
// A D that does not fill whole vectors, a pointer off a 16-byte
// boundary, or a row wider than 1024 vectors takes the element path: one
// warp a row, element loads, a second read of the row (from L1) for dx,
// and each warp's dw sums in its own shared-memory row.
#include "float_io.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

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

// Rows held in registers.  Dynamic shared memory: the warp sums
// [slots][TPR / 32][2] during the loop, the slots' dw rows [slots][D] at
// the end.
template <typename T, int VPT, int TPR>
__global__ void __launch_bounds__(kBlock) rmsnorm_bwd_reg(
    const T* __restrict__ x, const float* __restrict__ w,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
    int R, int D, float eps) {
  constexpr int V = halcone::vec_len<T>();
  constexpr int kRowWarps = TPR / 32;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int slots = blockDim.x / TPR;
  const int t = threadIdx.x % TPR;
  const int r = threadIdx.x / TPR;
  const int nvec = D / V;
  const float inv_d = 1.f / static_cast<float>(D);

  // this thread's columns: vectors j = t + k TPR, the same for every row
  float g1[VPT][V], acc[VPT][V];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = t + k * TPR;
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 u = j < nvec
          ? reinterpret_cast<const float4*>(w)[j * (V / 4) + q]
          : make_float4(-1.f, -1.f, -1.f, -1.f);
      g1[k][4 * q] = 1.f + u.x;
      g1[k][4 * q + 1] = 1.f + u.y;
      g1[k][4 * q + 2] = 1.f + u.z;
      g1[k][4 * q + 3] = 1.f + u.w;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[k][e] = 0.f;
  }

  for (int64_t base = static_cast<int64_t>(blockIdx.x) * slots; base < R;
       base += static_cast<int64_t>(gridDim.x) * slots) {
    const int64_t row = base + r;
    const bool live = row < R;
    const uint4* xr =
        reinterpret_cast<const uint4*>(x + (live ? row : 0) * D);
    const uint4* gr =
        reinterpret_cast<const uint4*>(dy + (live ? row : 0) * D);
    uint4 xv[VPT], gv[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = t + k * TPR;
      const bool in = live && j < nvec;
      xv[k] = in ? xr[j] : make_uint4(0u, 0u, 0u, 0u);
      gv[k] = in ? gr[j] : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      float xf[V], gf[V];
      unpack<T>(xv[k], xf);
      unpack<T>(gv[k], gf);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ss += xf[e] * xf[e];
        sgx += gf[e] * g1[k][e] * xf[e];
      }
    }
    ss = halcone::warp_sum(ss);
    sgx = halcone::warp_sum(sgx);
    if (kRowWarps > 1) {
      float* ws = sm + r * kRowWarps * 2;
      if ((t & 31) == 0) {
        ws[2 * (t / 32)] = ss;
        ws[2 * (t / 32) + 1] = sgx;
      }
      __syncthreads();
      ss = sgx = 0.f;
#pragma unroll
      for (int i = 0; i < kRowWarps; ++i) {
        ss += ws[2 * i];
        sgx += ws[2 * i + 1];
      }
      __syncthreads();             // read before the next row's sums land
    }
    if (!live) continue;
    const float rstd = rsqrtf(ss * inv_d + eps);
    // mean(g * xh) = rstd * sum(g * x) / D
    const float c = rstd * sgx * inv_d;
    T* dr = dx + row * D;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = t + k * TPR;
      if (j >= nvec) continue;
      float xf[V], gf[V], out[V];
      unpack<T>(xv[k], xf);
      unpack<T>(gv[k], gf);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xh = xf[e] * rstd;
        out[e] = rstd * (gf[e] * g1[k][e] - xh * c);
        acc[k][e] += gf[e] * xh;
      }
      halcone::store_vec(dr + j * V, out);
    }
  }

  // the block's slots, added in order, into one partial row
  __syncthreads();
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = t + k * TPR;
    if (j >= nvec) continue;
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      smem4[(static_cast<int64_t>(r) * D + j * V) / 4 + q] = make_float4(
          acc[k][4 * q], acc[k][4 * q + 1], acc[k][4 * q + 2],
          acc[k][4 * q + 3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < slots; ++k) s += sm[k * D + i];
    part[static_cast<int64_t>(blockIdx.x) * D + i] = s;
  }
}

// The element path: one warp a row, kWarps rows a block at a time.
// Dynamic shared memory: (1 + w) [D], each warp's dw row [kWarps][D].
template <typename T>
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
  const float inv_d = 1.f / static_cast<float>(D);
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       row < R; row += static_cast<int64_t>(gridDim.x) * kWarps) {
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
    float ss = 0.f, sgx = 0.f;
    for (int j = lane; j < D; j += 32) {
      const float xv = halcone::to_f32(xr[j]);
      const float gv = halcone::to_f32(gr[j]);
      ss += xv * xv;
      sgx += gv * g1[j] * xv;
    }
    ss = halcone::warp_sum(ss);
    sgx = halcone::warp_sum(sgx);
    const float rstd = rsqrtf(ss * inv_d + eps);
    const float c = rstd * sgx * inv_d;
    T* dr = dx + row * D;
    for (int j = lane; j < D; j += 32) {
      const float xv = halcone::to_f32(xr[j]);
      const float gv = halcone::to_f32(gr[j]);
      const float xh = xv * rstd;
      dr[j] = halcone::from_f32<T>(rstd * (gv * g1[j] - xh * c));
      mine[j] += gv * xh;
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

// dw[c] = sum over g of part[g][c], in a fixed order: 32 columns a
// block, kWarps strided groups of rows a column, then the groups in order.
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

struct Args {
  const void* x;
  const void* w;
  const void* dy;
  void* dx;
  void* dw;
  void* part;
  int R, D;
  float eps;
  int G, slots;
  cudaStream_t stream;
};

template <typename K>
int allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, int VPT, int TPR>
int launch_reg(const Args& a) {
  constexpr int V = halcone::vec_len<T>();
  if (a.slots < 1 || a.slots * TPR > kBlock || a.D % V ||
      a.D / V > VPT * TPR)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(a.slots) *
                      (a.D > 2 * (TPR / 32) ? a.D : 2 * (TPR / 32));
  auto* k = rmsnorm_bwd_reg<T, VPT, TPR>;
  const int e = allow_smem(k, smem);
  if (e) return e;
  k<<<a.G, a.slots * TPR, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.w),
      static_cast<const T*>(a.dy), static_cast<T*>(a.dx),
      static_cast<float*>(a.part), a.R, a.D, a.eps);
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
int rows_pass(int vpt, int tpr, const Args& a) {
  switch (vpt) {
    case 0: {
      const size_t smem =
          sizeof(float) * static_cast<size_t>(a.D) * (1 + kWarps);
      auto* k = rmsnorm_bwd_rows<T>;
      const int e = allow_smem(k, smem);
      if (e) return e;
      k<<<a.G, kBlock, smem, a.stream>>>(
          static_cast<const T*>(a.x), static_cast<const float*>(a.w),
          static_cast<const T*>(a.dy), static_cast<T*>(a.dx),
          static_cast<float*>(a.part), a.R, a.D, a.eps);
      return static_cast<int>(cudaGetLastError());
    }
    case 1: return by_tpr<T, 1>(tpr, a);
    case 2: return by_tpr<T, 2>(tpr, a);
    case 4: return by_tpr<T, 4>(tpr, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, dy, dx: [R, D] contiguous, dtype code `dt` (halcone::kF32 / kBF16);
// w, dw: [D] f32; part: [G, D] f32 scratch, G >= 1 blocks of pass 1.
// vpt in {1, 2, 4} with tpr in {32, 128, 256} and `slots` rows a block
// (slots * tpr <= 256) runs the register kernel: x, dy, dx and w 16-byte
// aligned and D / V <= vpt * tpr.  vpt = 0 runs the element path (any
// alignment; D * 36 bytes of shared memory must fit a block, D <= 6400).
extern "C" int halcone_rmsnorm_bwd(const void* x, const void* w,
                                   const void* dy, void* dx, void* dw,
                                   void* part, int R, int D, float eps,
                                   int G, int vpt, int tpr, int slots,
                                   int dt, void* stream) {
  if (G < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, dy, dx, dw, part, R, D, eps, G, slots,
               static_cast<cudaStream_t>(stream)};
  int e = static_cast<int>(cudaErrorInvalidValue);
  if (dt == halcone::kF32) e = rows_pass<float>(vpt, tpr, a);
  if (dt == halcone::kBF16) e = rows_pass<__nv_bfloat16>(vpt, tpr, a);
  if (e) return e;
  rmsnorm_bwd_dw<<<(D + 31) / 32, kBlock, 0, a.stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), G, D);
  return static_cast<int>(cudaGetLastError());
}
