// Flash attention (forward, prefill) on Hopper's CUDA cores (sm_90a): the
// f32 route (MLA's q and k of 192 columns with v of 128 among it), and the
// bf16 route at head dims 16 and 32.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:79) where
// kernels/flash_attention.py::route picks "simt": f32 at D in {16, 32, 64,
// 80, 128, 256}, which the card tests hold to 1e-5 (TF32 tensor cores would
// not meet that), and bf16 at D in {16, 32}.  bf16 at D = 64, 80, 128 and
// 256, the models' prefill, takes flash_attention_wgmma.cu; this library
// keeps bf16 code at D = 80 only for the wrapper's _route="simt" (its
// route before the tensor-core kernel took hubert-xlarge's head dim, timed
// beside it on the card), builds none at 64, 128 and 256 and returns
// cudaErrorInvalidValue if asked.
// At (D, Dv) = (192, 128) (deepseek-v2's MLA prefill; f32 only here, bf16
// takes the tensor-core kernel) v and the output are Dv wide.
// Causal / sliding-window GQA softmax attention with an online softmax
// over KV tiles and f32 accumulation.  q: [B, Sq, Hq, D], k and v: [B, Sk,
// Hkv, D] (any strides over B, S and H, the head dim contiguous); out:
// [B, Sq, Hq, D] contiguous, in q's dtype.  Query head h reads kv head
// h / (Hq / Hkv).  Masked scores get NEG_INF = -1e30 added, as in the
// reference, and the final denominator is max(l, 1e-30).
//
// Bound: 4 * D flops per (query, visible key) pair over the f32 CUDA
// cores, and q/k/v/out read and written once; this kernel computes with
// scalar f32 math and synchronous tile loads, so it runs far from either.
// chip_smoke.py times its rows beside their bound.
//
// Design (D in {16, 32, 64, 128}): one block per (b, q-head, tile of 64 query
// rows), one thread per query row holding its q row and its output accumulator
// in registers.  The block walks the KV tiles (64 keys, 32 for D > 64) held in
// shared memory as f32, and stops at the causal limit: keys past the tile's
// last query row are masked for every row of the tile, so skipping them
// changes nothing (each such score would add exp(-1e30 - m) = 0).  Scores are
// taken 16 keys at a time into the thread's own row of a shared score buffer
// (padded against bank conflicts), with one rescale of the accumulator per 16
// keys; only the loops over the head dim are unrolled, which keeps the code
// (and its build) small.  Any Sq and Sk work: rows past Sq only help load
// tiles, and keys past Sk are never scored.  The tensors are read with their
// strides, so the [B, S, H, D] layout needs no transposes.
//
// Design (D = 80 and 256): at 256 a row's q and accumulator would take
// 512 registers a thread and 32 keys of K and V 64 KB, past the 48 KB of
// static shared memory; at 80 the one-thread-a-row kernel needs 234
// registers, 4 blocks of 64 threads an SM.  So each query row is split
// over 4 neighbouring threads of a warp (256 threads a block), each
// holding every fourth 16-byte chunk of the row (D / 16 values of q and
// of the accumulator; the four threads of a row read four neighbouring
// chunks of a K or V row, a broadcast over the warp's eight rows), and a
// score is the sum of the four partial dots by two shuffles (ptxas: 95
// registers at D = 80, 213 at f32 D = 256, no spills).  The K/V tiles of
// 32 keys live in dynamic shared memory, loaded 8 elements a thread at a
// time; the rest is the one-thread-a-row design.  At hubert-xlarge's
// encoder shape (B = 8, S = 512, 16 heads, bf16) an H100 took 942 us one
// thread a row and 847 us split, about the plain version's time and far
// from the f32 CUDA cores' 160 us; scoring two keys a step in eight
// independent partial sums changed nothing (853 us), so the chains of
// dependent FMAs are not what holds it back.  MLA's (192, 128) (f32) takes
// the split kernel with V's tile and each thread's accumulator DV wide:
// D / 16 values of q and DV / 16 of the accumulator a thread, K and V
// tiles 24 + 16 KB.
#include <type_traits>

#include "float_io.cuh"

namespace {

constexpr int kRows = 64;    // query rows per block = threads per block
constexpr int kChunk = 16;   // keys scored per accumulator rescale

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kRows) flash_kernel(
    const T* __restrict__ q, long long qsb, long long qss, long long qsh,
    const T* __restrict__ k, long long ksb, long long kss, long long ksh,
    const T* __restrict__ v, long long vsb, long long vss, long long vsh,
    T* __restrict__ out, int Sq, int Sk, int Hq, int qpk, float scale,
    int causal, int window) {
  __shared__ float Ks[BK][D];
  __shared__ float Vs[BK][D];
  __shared__ float Ss[kRows][kChunk + 1];      // each thread's chunk scores
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int hk = h / qpk;
  const int tid = threadIdx.x;
  const int i = q0 + tid;                      // this thread's query row
  const bool active = i < Sq;

  float qr[D], acc[D];
  if (active) {
    halcone::load_row<T, D>(q + b * qsb + i * qss + h * qsh, qr);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (!active) qr[d] = 0.f;
    acc[d] = 0.f;
  }
  float m = halcone::kNegInf, l = 0.f;

  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(q0 + kRows, Sq));
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    const int n = min(BK, kv_end - k0);
    __syncthreads();                           // the last tile is consumed
    for (int e = tid; e < BK * D; e += kRows) {
      const int r = e / D, c = e % D;
      float kk = 0.f, vv = 0.f;
      if (r < n) {
        kk = halcone::to_f32(kb[(k0 + r) * kss + c]);
        vv = halcone::to_f32(vb[(k0 + r) * vss + c]);
      }
      Ks[r][c] = kk;
      Vs[r][c] = vv;
    }
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < n; j0 += kChunk) {
      const int cn = min(kChunk, n - j0);
      float mx = m;
#pragma unroll 1
      for (int c = 0; c < cn; ++c) {
        const int j = j0 + c;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot += qr[d] * Ks[j][d];
        float sc = dot * scale;
        const int kp = k0 + j;
        if (causal && kp > i) sc += halcone::kNegInf;
        if (window && i - kp >= window) sc += halcone::kNegInf;
        Ss[tid][c] = sc;
        mx = fmaxf(mx, sc);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll 1
      for (int c = 0; c < cn; ++c) {
        const float p = expf(Ss[tid][c] - mx);
        l += p;
        const float* vr = Vs[j0 + c];
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] += p * vr[d];
      }
      m = mx;
    }
  }
  if (active) {
    const float denom = fmaxf(l, 1e-30f);
    T* o = out + ((static_cast<int64_t>(b) * Sq + i) * Hq + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = halcone::from_f32<T>(acc[d] / denom);
  }
}

// D = 80 and 256, and (D, DV) = (192, 128): a query row over kSplit
// threads, the K/V tiles in dynamic shared memory (see the header).
constexpr int kSplit = 4;                      // threads per query row
constexpr int kSplitThreads = kRows * kSplit;
constexpr int kLoads = 8;                      // tile loads a thread in flight

template <typename T, int D, int DV, int BK>
__global__ void __launch_bounds__(kSplitThreads) flash_split_kernel(
    const T* __restrict__ q, long long qsb, long long qss, long long qsh,
    const T* __restrict__ k, long long ksb, long long kss, long long ksh,
    const T* __restrict__ v, long long vsb, long long vss, long long vsh,
    T* __restrict__ out, int Sq, int Sk, int Hq, int qpk, float scale,
    int causal, int window) {
  static_assert(DV <= D, "v no wider than q and k");
  constexpr int kOwn = D / 4 / kSplit;         // 16-byte chunks a thread
  constexpr int kOwnV = DV / 4 / kSplit;       // of the accumulator
  extern __shared__ __align__(16) float kv_smem[];
  float* Ks = kv_smem;                         // [BK][D]
  float* Vs = kv_smem + BK * D;                // [BK][DV]
  __shared__ float Ss[kRows][kChunk + 1];      // each row's chunk scores
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int hk = h / qpk;
  const int tid = threadIdx.x;
  const int rl = tid / kSplit, part = tid % kSplit;
  const int i = q0 + rl;                       // this thread's query row
  const bool active = i < Sq;

  // chunk jj of this thread is the row's chunk jj * kSplit + part
  float qr[kOwn][4], acc[kOwnV][4];
#pragma unroll
  for (int jj = 0; jj < kOwn; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (jj * kSplit + part) * 4 + e;
      qr[jj][e] = active ? halcone::to_f32(q[b * qsb + i * qss + h * qsh + d])
                         : 0.f;
    }
  }
#pragma unroll
  for (int jj = 0; jj < kOwnV; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
  }
  float m = halcone::kNegInf, l = 0.f;

  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(q0 + kRows, Sq));
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    const int n = min(BK, kv_end - k0);
    __syncthreads();                           // the last tile is consumed
    // kLoads elements of K and of V a thread in flight at once, then
    // stored: a rolled loop would wait out one load's latency each.  V's
    // element (r, c) rides with K's for c < DV.
    for (int e0 = tid; e0 < BK * D; e0 += kLoads * kSplitThreads) {
      float kk[kLoads], vv[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kSplitThreads, r = e / D, c = e % D;
        const bool live = e < BK * D && r < n;
        kk[u] = live ? halcone::to_f32(kb[(k0 + r) * kss + c]) : 0.f;
        vv[u] = live && c < DV ? halcone::to_f32(vb[(k0 + r) * vss + c])
                               : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kSplitThreads, r = e / D, c = e % D;
        if (e < BK * D) {
          Ks[e] = kk[u];
          if (c < DV) Vs[r * DV + c] = vv[u];
        }
      }
    }
    __syncthreads();
    // every thread runs every chunk (the shuffles need the whole warp);
    // rows past Sq score zeros and store nothing
    for (int j0 = 0; j0 < n; j0 += kChunk) {
      const int cn = min(kChunk, n - j0);
      float mx = m;
#pragma unroll 1
      for (int c = 0; c < cn; ++c) {
        const int j = j0 + c;
        const float4* kr = reinterpret_cast<const float4*>(Ks + j * D);
        float dot = 0.f;
#pragma unroll
        for (int jj = 0; jj < kOwn; ++jj) {
          const float4 kk = kr[jj * kSplit + part];
          dot += qr[jj][0] * kk.x + qr[jj][1] * kk.y + qr[jj][2] * kk.z
                 + qr[jj][3] * kk.w;
        }
        dot += __shfl_xor_sync(halcone::kAllLanes, dot, 1);
        dot += __shfl_xor_sync(halcone::kAllLanes, dot, 2);
        float sc = dot * scale;
        const int kp = k0 + j;
        if (causal && kp > i) sc += halcone::kNegInf;
        if (window && i - kp >= window) sc += halcone::kNegInf;
        if (part == 0) Ss[rl][c] = sc;
        mx = fmaxf(mx, sc);
      }
      __syncwarp();
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int jj = 0; jj < kOwnV; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj][e] *= alpha;
      }
#pragma unroll 1
      for (int c = 0; c < cn; ++c) {
        const float p = expf(Ss[rl][c] - mx);
        l += p;
        const float4* vr =
            reinterpret_cast<const float4*>(Vs + (j0 + c) * DV);
#pragma unroll
        for (int jj = 0; jj < kOwnV; ++jj) {
          const float4 vv = vr[jj * kSplit + part];
          acc[jj][0] += p * vv.x;
          acc[jj][1] += p * vv.y;
          acc[jj][2] += p * vv.z;
          acc[jj][3] += p * vv.w;
        }
      }
      __syncwarp();                            // Ss is rewritten next
      m = mx;
    }
  }
  if (active) {
    const float denom = fmaxf(l, 1e-30f);
    T* o = out + ((static_cast<int64_t>(b) * Sq + i) * Hq + h) * DV;
#pragma unroll
    for (int jj = 0; jj < kOwnV; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[(jj * kSplit + part) * 4 + e] =
            halcone::from_f32<T>(acc[jj][e] / denom);
    }
  }
}

template <typename T, int D, int DV = D>
int launch(const void* q, const long long* qs, const void* k,
           const long long* ks, const void* v, const long long* vs, void* out,
           int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
           int window, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  if constexpr (D == 80 || D == 256 || DV != D) {
    constexpr int BK = 32;
    constexpr int kBytes = BK * (D + DV) * static_cast<int>(sizeof(float));
    static bool attr = false;
    if (!attr) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_split_kernel<T, D, DV, BK>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      attr = true;
    }
    flash_split_kernel<T, D, DV, BK>
        <<<grid, kSplitThreads, kBytes, stream>>>(
        static_cast<const T*>(q), qs[0], qs[1], qs[2],
        static_cast<const T*>(k), ks[0], ks[1], ks[2],
        static_cast<const T*>(v), vs[0], vs[1], vs[2], static_cast<T*>(out),
        Sq, Sk, Hq, Hq / Hkv, scale, causal, window);
  } else {
    constexpr int BK = D > 64 ? 32 : 64;
    flash_kernel<T, D, BK><<<grid, kRows, 0, stream>>>(
        static_cast<const T*>(q), qs[0], qs[1], qs[2],
        static_cast<const T*>(k), ks[0], ks[1], ks[2],
        static_cast<const T*>(v), vs[0], vs[1], vs[2], static_cast<T*>(out),
        Sq, Sk, Hq, Hq / Hkv, scale, causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

// f32 at every head dim and at (192, 128); bf16 only at D = 16, 32 and 80
// (the others take the tensor-core kernel)
template <typename T>
int dispatch_d(int D, int Dv, const void* q, const long long* qs,
               const void* k, const long long* ks, const void* v,
               const long long* vs, void* out, int B, int Sq, int Sk, int Hq,
               int Hkv, float scale, int causal, int window,
               cudaStream_t s) {
  if constexpr (std::is_same_v<T, float>) {
    if (D == 192 && Dv == 128)
      return launch<T, 192, 128>(q, qs, k, ks, v, vs, out, B, Sq, Sk, Hq,
                                 Hkv, scale, causal, window, s);
  }
  if (Dv != D) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch<T, 16>(q, qs, k, ks, v, vs, out, B, Sq, Sk, Hq,
                                  Hkv, scale, causal, window, s);
    case 32: return launch<T, 32>(q, qs, k, ks, v, vs, out, B, Sq, Sk, Hq,
                                  Hkv, scale, causal, window, s);
    case 80: return launch<T, 80>(q, qs, k, ks, v, vs, out, B, Sq, Sk, Hq,
                                  Hkv, scale, causal, window, s);
  }
  if constexpr (std::is_same_v<T, float>) {
    switch (D) {
      case 64: return launch<T, 64>(q, qs, k, ks, v, vs, out, B, Sq, Sk, Hq,
                                    Hkv, scale, causal, window, s);
      case 128: return launch<T, 128>(q, qs, k, ks, v, vs, out, B, Sq, Sk,
                                      Hq, Hkv, scale, causal, window, s);
      case 256: return launch<T, 256>(q, qs, k, ks, v, vs, out, B, Sq, Sk,
                                      Hq, Hkv, scale, causal, window, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q/k/v strides are in elements, over (B, S, H); the head dim is
// contiguous.  dt: halcone::kF32 with D = Dv in {16, 32, 64, 80, 128, 256}
// or (D, Dv) = (192, 128), or halcone::kBF16 with D = Dv in {16, 32, 80};
// scale: the softmax scale D^-0.5 as an f32.
extern "C" int halcone_flash_attention(
    const void* q, long long qsb, long long qss, long long qsh,
    const void* k, long long ksb, long long kss, long long ksh,
    const void* v, long long vsb, long long vss, long long vsh, void* out,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, int Dv, float scale,
    int causal, int window, int dt, void* stream) {
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh},
                  vs[3] = {vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == halcone::kF32)
    return dispatch_d<float>(D, Dv, q, qs, k, ks, v, vs, out, B, Sq, Sk, Hq,
                             Hkv, scale, causal, window, s);
  if (dt == halcone::kBF16)
    return dispatch_d<__nv_bfloat16>(D, Dv, q, qs, k, ks, v, vs, out, B, Sq,
                                     Sk, Hq, Hkv, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
