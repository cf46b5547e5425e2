// Flash attention (forward, prefill) on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:79): causal / sliding-window GQA
// softmax attention with an online softmax over KV tiles and f32
// accumulation.  q: [B, Sq, Hq, D], k and v: [B, Sk, Hkv, D] (f32 or bf16,
// any strides over B, S and H, the head dim contiguous); out: [B, Sq, Hq,
// D] contiguous, in q's dtype.  Query head h reads kv head h / (Hq / Hkv).
// Masked scores get NEG_INF = -1e30 added, as in the reference, and the
// final denominator is max(l, 1e-30).
//
// Bound: at the serving path's prefill (B = 8, S = 512, Hq = 15, Hkv = 5,
// D = 64, causal) the work is 4 * D flops per (query, visible key) pair,
// about 4 GFLOP a layer, over 0.3 MB of q/k/v/out per (batch, head):
// bytes over 3.35 TB/s and flops over the tensor cores' 989 TF/s are
// close (chip_smoke.py prints both).  This first kernel computes on the
// f32 cores without wgmma, so it runs far from either bound; wgmma tiles
// and TMA loads are the later step.
//
// Design: one block per (b, q-head, tile of 64 query rows), one thread
// per query row holding its q row and its output accumulator in
// registers.  The block walks the KV tiles (64 keys, 32 for D = 128)
// held in shared memory as f32, and stops at the causal limit: keys past
// the tile's last query row are masked for every row of the tile, so
// skipping them changes nothing (each such score would add exp(-1e30 -
// m) = 0).  Scores are taken 16 keys at a time into the thread's own row
// of a shared score buffer (padded against bank conflicts), with one
// rescale of the accumulator per 16 keys; only the loops over the head
// dim are unrolled, which keeps the code (and its build) small.  Any Sq
// and Sk work: rows past Sq only help load tiles, and keys past Sk are
// never scored.  The tensors are read with their strides, so the
// [B, S, H, D] layout needs no transposes.
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

template <typename T, int D>
int launch(const void* q, const long long* qs, const void* k,
           const long long* ks, const void* v, const long long* vs, void* out,
           int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr int BK = D > 64 ? 32 : 64;
  const dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  flash_kernel<T, D, BK><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), qs[0], qs[1], qs[2],
      static_cast<const T*>(k), ks[0], ks[1], ks[2],
      static_cast<const T*>(v), vs[0], vs[1], vs[2], static_cast<T*>(out),
      Sq, Sk, Hq, Hq / Hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const long long* qs, const void* k,
               const long long* ks, const void* v, const long long* vs,
               void* out, int B, int Sq, int Sk, int Hq, int Hkv, float scale,
               int causal, int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, qs, k, ks, v, vs, out, B, Sq, Sk, Hq,
                                  Hkv, scale, causal, window, s);
    case 32: return launch<T, 32>(q, qs, k, ks, v, vs, out, B, Sq, Sk, Hq,
                                  Hkv, scale, causal, window, s);
    case 64: return launch<T, 64>(q, qs, k, ks, v, vs, out, B, Sq, Sk, Hq,
                                  Hkv, scale, causal, window, s);
    case 128: return launch<T, 128>(q, qs, k, ks, v, vs, out, B, Sq, Sk, Hq,
                                    Hkv, scale, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q/k/v strides are in elements, over (B, S, H); the head dim is
// contiguous.  dt: halcone::kF32 or kBF16; D in {16, 32, 64, 128};
// scale: the softmax scale D^-0.5 as an f32.
extern "C" int halcone_flash_attention(
    const void* q, long long qsb, long long qss, long long qsh,
    const void* k, long long ksb, long long kss, long long ksh,
    const void* v, long long vsb, long long vss, long long vsh, void* out,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, float scale, int causal,
    int window, int dt, void* stream) {
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh},
                  vs[3] = {vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == halcone::kF32)
    return dispatch_d<float>(D, q, qs, k, ks, v, vs, out, B, Sq, Sk, Hq, Hkv,
                             scale, causal, window, s);
  if (dt == halcone::kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, qs, k, ks, v, vs, out, B, Sq, Sk,
                                     Hq, Hkv, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
