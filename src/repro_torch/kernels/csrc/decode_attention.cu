// Flash-decode on Hopper (sm_90a): one query token over a KV cache.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::_decode_kernel
// (pallas_call at decode_attention.py:63): softmax attention of q [B, 1,
// Hq, D] over the first kv_len rows of k and v [B, Sk, Hkv, D] (f32 or
// bf16, any strides over B, S and H, the head dim contiguous), with f32
// accumulation; out: [B, 1, Hq, D] contiguous, in q's dtype.  Query head
// h reads kv head h / (Hq / Hkv).  The reference masks cache rows at or
// past kv_len with NEG_INF, so they weigh exp(-1e30 - m) = 0; this kernel
// never reads them, which gives the same 0.  kv_len is a host int.
//
// Bound: bytes.  Each visible cache row is read once (2 * Hkv * D
// elements per batch row and position) for 4 * D flops per query head,
// about 2 * q_per_kv flops per byte in bf16, far below the card's 295: the
// least time is the cache bytes over HBM's 3.35 TB/s.
//
// Design: split-K.  Pass 1 runs one block of 128 threads per (b, kv head,
// split of 128 cache rows): it loads the q rows of the kv head's q_per_kv
// query heads into shared memory, so the block reads each K and V row
// once for the whole group.  Thread t scores cache row t against every
// query head of the group (K row in registers, 16-byte loads); one warp
// per head takes the split's max and the sum of exp(s - max); then the
// threads, one per (head dim, key group), accumulate p * V over the
// split's rows (V rows read coalesced) and write the split's partial
// (max, sum, accumulator).  Pass 2 combines the splits per (b, q head):
// out = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-30).
#include "float_io.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKeys = kThreads;     // cache rows per split: one per thread
constexpr int kMaxQpk = 16;         // query heads per kv head

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, long long qsb, long long qsh,
    const T* __restrict__ k, long long ksb, long long kss, long long ksh,
    const T* __restrict__ v, long long vsb, long long vss, long long vsh,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int Hq, int qpk, int kv_len, int nsplit,
    float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [qpk][D]
  float* S = Qs + qpk * D;                // [qpk][kKeys]: scores, then p
  float* red = S + qpk * kKeys;           // [kThreads / D][qpk][D]
  const int b = blockIdx.z, hk = blockIdx.y, sp = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = sp * kKeys;
  const int n = min(kKeys, kv_len - s0);
  const int h0 = hk * qpk;                // first query head of the group

  for (int e = tid; e < qpk * D; e += kThreads) {
    const int g = e / D, d = e % D;
    Qs[e] = halcone::to_f32(q[b * qsb + (h0 + g) * qsh + d]);
  }
  __syncthreads();

  if (tid < n) {
    float kr[D];
    halcone::load_row<T, D>(k + b * ksb + (s0 + tid) * kss + hk * ksh, kr);
    for (int g = 0; g < qpk; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += Qs[g * D + d] * kr[d];
      S[g * kKeys + tid] = dot * scale;
    }
  }
  __syncthreads();

  for (int g = warp; g < qpk; g += kThreads / 32) {
    float* sg = S + g * kKeys;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sg[j]);
    mx = halcone::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sg[j] - mx);
      sg[j] = p;
      sum += p;
    }
    sum = halcone::warp_sum(sum);
    if (lane == 0) {
      const int64_t idx = (static_cast<int64_t>(b) * Hq + h0 + g) * nsplit + sp;
      part_m[idx] = mx;
      part_l[idx] = sum;
    }
  }
  __syncthreads();

  constexpr int G = kThreads / D;         // key groups
  const int d = tid % D, gi = tid / D;
  float acc[kMaxQpk];
#pragma unroll
  for (int g = 0; g < kMaxQpk; ++g) acc[g] = 0.f;
  const T* vb = v + b * vsb + hk * vsh + d;
  for (int j = gi; j < n; j += G) {
    const float vv = halcone::to_f32(vb[(s0 + j) * vss]);
#pragma unroll
    for (int g = 0; g < kMaxQpk; ++g) {
      if (g < qpk) acc[g] += S[g * kKeys + j] * vv;
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxQpk; ++g) {
    if (g < qpk) red[(gi * qpk + g) * D + d] = acc[g];
  }
  __syncthreads();
  if (gi == 0) {
    for (int g = 0; g < qpk; ++g) {
      float a = 0.f;
      for (int r = 0; r < G; ++r) a += red[(r * qpk + g) * D + d];
      const int64_t idx = (static_cast<int64_t>(b) * Hq + h0 + g) * nsplit + sp;
      part_acc[idx * D + d] = a;
    }
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int nsplit, int D) {
  const int64_t bh = blockIdx.x;          // b * Hq + h
  const int d = threadIdx.x;
  const float* pm = part_m + bh * nsplit;
  const float* pl = part_l + bh * nsplit;
  float M = -CUDART_INF_F;
  for (int i = 0; i < nsplit; ++i) M = fmaxf(M, pm[i]);
  float L = 0.f, a = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const float c = expf(pm[i] - M);
    L += c * pl[i];
    a += c * part_acc[(bh * nsplit + i) * D + d];
  }
  out[bh * D + d] = halcone::from_f32<T>(a / fmaxf(L, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const long long* qs, const void* k,
           const long long* ks, const void* v, const long long* vs,
           float* pm, float* pl, float* pacc, void* out, int B, int Hq,
           int Hkv, int kv_len, float scale, cudaStream_t stream) {
  const int qpk = Hq / Hkv;
  const int nsplit = (kv_len + kKeys - 1) / kKeys;
  const size_t smem = sizeof(float) * (qpk * D + qpk * kKeys + kThreads * qpk);
  decode_split_kernel<T, D><<<dim3(nsplit, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), qs[0], qs[1], static_cast<const T*>(k),
      ks[0], ks[1], ks[2], static_cast<const T*>(v), vs[0], vs[1], vs[2], pm,
      pl, pacc, Hq, qpk, kv_len, nsplit, scale);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  decode_combine_kernel<T><<<B * Hq, D, 0, stream>>>(
      pm, pl, pacc, static_cast<T*>(out), nsplit, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const long long* qs, const void* k,
               const long long* ks, const void* v, const long long* vs,
               float* pm, float* pl, float* pacc, void* out, int B, int Hq,
               int Hkv, int kv_len, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, qs, k, ks, v, vs, pm, pl, pacc, out, B,
                                  Hq, Hkv, kv_len, scale, s);
    case 32: return launch<T, 32>(q, qs, k, ks, v, vs, pm, pl, pacc, out, B,
                                  Hq, Hkv, kv_len, scale, s);
    case 64: return launch<T, 64>(q, qs, k, ks, v, vs, pm, pl, pacc, out, B,
                                  Hq, Hkv, kv_len, scale, s);
    case 128: return launch<T, 128>(q, qs, k, ks, v, vs, pm, pl, pacc, out,
                                    B, Hq, Hkv, kv_len, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q strides over (B, H), k/v strides over (B, S, H), in elements; the
// head dim is contiguous.  part_m/part_l: [B, Hq, nsplit] f32 and
// part_acc: [B, Hq, nsplit, D] f32 scratch, nsplit = ceil(kv_len / 128);
// 1 <= kv_len <= Sk, Hq / Hkv <= 16, D in {16, 32, 64, 128}; dt:
// halcone::kF32 or kBF16; scale: D^-0.5 as an f32.
extern "C" int halcone_decode_attention(
    const void* q, long long qsb, long long qsh, const void* k,
    long long ksb, long long kss, long long ksh, const void* v,
    long long vsb, long long vss, long long vsh, void* part_m, void* part_l,
    void* part_acc, void* out, int B, int Hq, int Hkv, int D, int kv_len,
    float scale, int dt, void* stream) {
  const long long qs[2] = {qsb, qsh}, ks[3] = {ksb, kss, ksh},
                  vs[3] = {vsb, vss, vsh};
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == halcone::kF32)
    return dispatch_d<float>(D, q, qs, k, ks, v, vs, pm, pl, pa, out, B, Hq,
                             Hkv, kv_len, scale, s);
  if (dt == halcone::kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, qs, k, ks, v, vs, pm, pl, pa, out,
                                     B, Hq, Hkv, kv_len, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
