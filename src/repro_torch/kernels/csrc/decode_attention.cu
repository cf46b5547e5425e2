// Flash-decode on Hopper (sm_90a): one query token over a KV cache, in one
// launch of thread-block clusters.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::_decode_kernel
// (pallas_call at decode_attention.py:63): softmax attention of q [B, 1,
// Hq, D] over the first kv_len rows of k and v [B, Sk, Hkv, D] (f32 or
// bf16, any strides over B, S and H that keep rows 16-byte aligned, the
// head dim contiguous), with f32 accumulation; out: [B, 1, Hq, D]
// contiguous, in q's dtype.  Query head h reads kv head h / (Hq / Hkv).
// The reference masks cache rows at or past kv_len with NEG_INF, so they
// weigh exp(-1e30 - m) = 0; this kernel never reads them, which gives the
// same 0.  kv_len is a host int.
//
// Bound: bytes.  Each visible cache row is read once (2 * Hkv * D
// elements per batch row and position) for 4 * D flops per query head,
// about 2 * q_per_kv flops per byte in bf16, far below the card's 295: the
// least time is the cache bytes over HBM's 3.35 TB/s.
//
// Design: one cluster of up to 8 blocks of 128 threads per (b, kv head),
// the cluster size chosen by the host for about three blocks an SM (8 at
// smollm-360m's 40 pairs, 2 at zamba2-1.2b's 256).  Block r of a cluster
// of n walks cache tiles r, r + n, ... of 64 rows (32 at D = 256, where
// two stages of 64-row K and V tiles would take 256 KB in f32).
// - Loads: K and V tiles come into shared memory with 16-byte cp.async
//   copies, double-buffered, so the next tile's K and V are in flight
//   while this one is scored.  A row at or past kv_len is copied with the
//   zero-size source form: nothing is read from it and its slot is zeros
//   (the card tests fill those rows with NaN).  K's 16-byte chunks are
//   XOR-swizzled by row, so the threads of a quarter warp, one row each,
//   read distinct banks.
// - Per tile: the block holds the group's q_per_kv query rows in f32
//   shared memory, padded with zero rows to G in {1, 4, 16} (a template
//   argument), so no loop over heads tests its bound and the shared-memory
//   reads of a step issue together (the tile is latency-bound, not
//   bandwidth-bound).  Thread t scores row t % kTile against the heads of
//   its part (128 / kTile parts, at most G), once for the whole group;
//   one warp per head
//   keeps the online softmax (m, l) and writes p over the scores; then
//   thread t owns two head-dim columns and a stride of rows and
//   accumulates p * V from shared memory with 4- or 8-byte vector reads.
// - Combine: each block sums its row groups in a fixed order and stores
//   (m, l, acc) into block 0's slot for it through distributed shared
//   memory (stores only: no remote load waits); after one cluster barrier
//   block 0 writes
//   out = sum_r e^(m_r - M) acc_r / max(sum_r e^(m_r - M) l_r, 1e-30).
//   A block with no rows would keep m = -inf and l = 0 and weigh
//   e^(-inf) = 0.  No scratch in device memory and no second kernel.
//   At D = 256 block 0's eight slots (132 KB for G = 16) do not fit beside
//   the stages, so they share the stages' region, after the row groups'
//   sums: every block arrives at the cluster barrier only once its own
//   stages are free (block 0's included), and stores into block 0 only
//   after the wait, so no store lands on a stage block 0 still reads.
//   gemma3-4b decodes at D = 256 with 2 query heads a kv head (G = 4),
//   llava-next-34b at D = 128 with 7 (G = 16).
#include <cooperative_groups.h>

#include "float_io.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;     // blocks per (b, kv head), at most
constexpr int kThreads = 128;
constexpr int kMaxQpk = 16;        // query heads per kv head

// G: the group's query heads rounded up to 1, 4 or 16; the rows past
// q_per_kv are zeros, so every loop over heads runs G times with no test
// inside, and its shared-memory reads issue back to back.  Three sizes
// keep the build short (each is one instantiation per dtype and head
// dim): G = 1 and 4 are zamba2-1.2b's and smollm-360m's groups (1 and 3
// query heads per kv head), 16 takes every other group.
template <typename T, int D, int G>
struct Layout {
  static constexpr int kTile = D > 128 ? 32 : 64;         // cache rows a tile
  static constexpr int kVec = halcone::vec_len<T>();      // per 16 bytes
  static constexpr int kChunks = D / kVec;               // per row
  static constexpr int kSwizzle = kChunks < 8 ? kChunks : 8;
  static constexpr int kPairs = D / 2;                    // p.V columns
  static constexpr int kGroups = kThreads / kPairs;       // p.V row groups
  // scoring threads: row t % kTile, heads of part t / kTile
  static constexpr int kParts =
      kThreads / kTile < G ? kThreads / kTile : G;
  static constexpr int kTileElems = kTile * D;
  // K, V x 2 stages; after the last tile, the row groups' partial sums
  // (and at D = 256 block 0's slots after them: kLate)
  static constexpr bool kLate = D > 128;
  static constexpr size_t kStageBytes = 4 * kTileElems * sizeof(T);
  static constexpr size_t kPartBytes = sizeof(float) * kGroups * G * D;
  static constexpr size_t kSlotBytes =
      sizeof(float) * kMaxCluster * G * (D + 2);
  static constexpr size_t kAfter = kPartBytes + (kLate ? kSlotBytes : 0);
  static constexpr size_t kRegion =
      kStageBytes > kAfter ? kStageBytes : kAfter;
  static constexpr size_t kBytes =
      kRegion + sizeof(float) * (G * D                    // q rows
                                 + G * kTile)             // scores, then p
      + (kLate ? 0 : kSlotBytes)                          // slots
      + sizeof(float) * 3 * G;                            // m, l, alpha
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(live ? 16 : 0) : "memory");
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_cluster_kernel(const T* __restrict__ q, long long qsb, long long qsh,
                      const T* __restrict__ k, long long ksb, long long kss,
                      long long ksh, const T* __restrict__ v, long long vsb,
                      long long vss, long long vsh, T* __restrict__ out,
                      int Hq, int qpk, int kv_len, float scale) {
  using L = Layout<T, D, G>;
  constexpr int kTile = L::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kbuf = reinterpret_cast<T*>(smem);                   // [2][kTile][D]
  T* vbuf = kbuf + 2 * L::kTileElems;                     // [2][kTile][D]
  float* part = reinterpret_cast<float*>(smem);           // [groups][G][D]
  float* Qs = reinterpret_cast<float*>(smem + L::kRegion);   // [G][D]
  float* S = Qs + G * D;                                  // [G][kTile]
  // block 0: [8][G][D + 2]; at D = 256 in the region, after the sums
  float* slot = L::kLate ? part + L::kGroups * G * D : S + G * kTile;
  float* m_b = S + G * kTile
               + (L::kLate ? 0 : kMaxCluster * G * (D + 2));
  float* l_b = m_b + G;
  float* a_b = l_b + G;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nclu = static_cast<int>(cluster.num_blocks());
  const int hk = blockIdx.y, b = blockIdx.z, h0 = hk * qpk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (kv_len + kTile - 1) / kTile;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  // block 0's shared memory takes the others' stores only once every
  // block of the cluster runs: arrive now, wait before the first store
  // (at D = 256 once the stages are free: see the header)
  if constexpr (!L::kLate)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  auto load_tile = [&](int tile, int stage) {
    const int s0 = tile * kTile;
    T* kd = kbuf + stage * L::kTileElems;
    T* vd = vbuf + stage * L::kTileElems;
#pragma unroll 4
    for (int e = tid; e < kTile * L::kChunks; e += kThreads) {
      const int r = e / L::kChunks, c = e % L::kChunks;
      const bool live = s0 + r < kv_len;
      const long long row = live ? s0 + r : 0;
      cp_async16(kd + r * D + (c ^ (r % L::kSwizzle)) * L::kVec,
                 kb + row * kss + c * L::kVec, live);
      cp_async16(vd + r * D + c * L::kVec, vb + row * vss + c * L::kVec,
                 live);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (rank < ntiles) load_tile(rank, 0);
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    Qs[e] = g < qpk ? halcone::to_f32(q[b * qsb + (h0 + g) * qsh + d]) : 0.f;
  }
  if (tid < G) {
    m_b[tid] = -CUDART_INF_F;
    l_b[tid] = 0.f;
  }

  const int cp = tid % L::kPairs, rg = tid / L::kPairs;   // p.V role
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

  int stage = 0;
#pragma unroll 1
  for (int tile = rank; tile < ntiles; tile += nclu, stage ^= 1) {
    if (tile + nclu < ntiles) {
      load_tile(tile + nclu, stage ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int n = min(kTile, kv_len - tile * kTile);
    const T* kt = kbuf + stage * L::kTileElems;
    const T* vt = vbuf + stage * L::kTileElems;

    {  // scores: thread t takes row t % kTile and the heads of its part
      const int j = tid % kTile, half = tid / kTile;
      if (j < n && half < L::kParts) {
        constexpr int GH = G / L::kParts;
        float dot[GH];
#pragma unroll
        for (int i = 0; i < GH; ++i) dot[i] = 0.f;
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          float kf[L::kVec];
          halcone::load_vec(kt + j * D + (c ^ (j % L::kSwizzle)) * L::kVec, kf);
#pragma unroll
          for (int i = 0; i < GH; ++i) {
            const float* qr = Qs + (half + L::kParts * i) * D + c * L::kVec;
#pragma unroll
            for (int e = 0; e < L::kVec; ++e) dot[i] += qr[e] * kf[e];
          }
        }
#pragma unroll
        for (int i = 0; i < GH; ++i)
          S[(half + L::kParts * i) * kTile + j] = dot[i] * scale;
      }
    }
    __syncthreads();

    for (int g = warp; g < qpk; g += kThreads / 32) {   // online softmax
      float* sg = S + g * kTile;
      const bool in0 = lane < n, in1 = kTile > 32 && lane + 32 < n;
      const float s0 = in0 ? sg[lane] : -CUDART_INF_F;
      const float s1 = in1 ? sg[lane + 32] : -CUDART_INF_F;
      const float m_old = m_b[g];
      const float mx = fmaxf(m_old, halcone::warp_max(fmaxf(s0, s1)));
      const float p0 = in0 ? expf(s0 - mx) : 0.f;
      const float p1 = in1 ? expf(s1 - mx) : 0.f;
      if (in0) sg[lane] = p0;
      if (in1) sg[lane + 32] = p1;
      const float sum = halcone::warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - mx);   // 0 on the first tile
        a_b[g] = alpha;
        l_b[g] = l_b[g] * alpha + sum;
        m_b[g] = mx;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g) {                         // p . V
      const float alpha = g < qpk ? a_b[g] : 0.f;
      acc[g][0] *= alpha;
      acc[g][1] *= alpha;
    }
#pragma unroll 4
    for (int j = rg; j < n; j += L::kGroups) {
      const float2 vv = load_pair(vt + j * D + 2 * cp);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = S[g * kTile + j];
        acc[g][0] += p * vv.x;
        acc[g][1] += p * vv.y;
      }
    }
    __syncthreads();                          // this stage is refilled next
  }

  // the block's (m, l, acc) into block 0's slot for this rank: the row
  // groups summed in a fixed order (the stages are free now)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* pr = part + (rg * G + g) * D + 2 * cp;
    pr[0] = acc[g][0];
    pr[1] = acc[g][1];
  }
  __syncthreads();
  if constexpr (L::kLate)        // this block's stages are free now
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* dst = cluster.map_shared_rank(slot, 0) + rank * G * (D + 2);
  for (int e = tid; e < qpk * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < L::kGroups; ++r) a += part[(r * G + g) * D + d];
    dst[g * (D + 2) + d] = a;
  }
  if (tid < qpk) {
    dst[tid * (D + 2) + D] = m_b[tid];
    dst[tid * (D + 2) + D + 1] = l_b[tid];
  }
  cluster.sync();                 // every slot of block 0 is written

  if (rank == 0) {                // combine the cluster's blocks
    for (int e = tid; e < qpk * D; e += kThreads) {
      const int g = e / D, d = e % D;
      float M = -CUDART_INF_F;
      for (int r = 0; r < nclu; ++r)
        M = fmaxf(M, slot[(r * G + g) * (D + 2) + D]);
      float den = 0.f, a = 0.f;
      for (int r = 0; r < nclu; ++r) {
        const float* sr = slot + (r * G + g) * (D + 2);
        const float c = expf(sr[D] - M);      // a block with no rows: 0
        den += c * sr[D + 1];
        a += c * sr[d];
      }
      out[(static_cast<int64_t>(b) * Hq + h0 + g) * D + d] =
          halcone::from_f32<T>(a / fmaxf(den, 1e-30f));
    }
  }
}

// Blocks per cluster: enough clusters x blocks for about three blocks an
// SM, at most 8 and at most one per tile.
int cluster_size(int B, int Hkv, int ntiles) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const int pairs = B * Hkv;
  const int want = (3 * n_sm + pairs - 1) / pairs;
  return max(1, min(kMaxCluster, min(ntiles, want)));
}

template <typename T, int D, int G>
int launch(const void* q, const long long* qs, const void* k,
           const long long* ks, const void* v, const long long* vs, void* out,
           int B, int Hq, int Hkv, int kv_len, float scale,
           cudaStream_t stream) {
  using L = Layout<T, D, G>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_cluster_kernel<T, D, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int nclu = cluster_size(B, Hkv,
                                (kv_len + L::kTile - 1) / L::kTile);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nclu, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = nclu;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_cluster_kernel<T, D, G>, static_cast<const T*>(q), qs[0],
      qs[1], static_cast<const T*>(k), ks[0], ks[1], ks[2],
      static_cast<const T*>(v), vs[0], vs[1], vs[2], static_cast<T*>(out),
      Hq, Hq / Hkv, kv_len, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_g(int qpk, const void* q, const long long* qs, const void* k,
               const long long* ks, const void* v, const long long* vs,
               void* out, int B, int Hq, int Hkv, int kv_len, float scale,
               cudaStream_t s) {
  if (qpk <= 1) return launch<T, D, 1>(q, qs, k, ks, v, vs, out, B, Hq, Hkv,
                                       kv_len, scale, s);
  if (qpk <= 4) return launch<T, D, 4>(q, qs, k, ks, v, vs, out, B, Hq, Hkv,
                                       kv_len, scale, s);
  if (qpk <= kMaxQpk)
    return launch<T, D, kMaxQpk>(q, qs, k, ks, v, vs, out, B, Hq, Hkv,
                                 kv_len, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_d(int D, const void* q, const long long* qs, const void* k,
               const long long* ks, const void* v, const long long* vs,
               void* out, int B, int Hq, int Hkv, int kv_len, float scale,
               cudaStream_t s) {
  const int qpk = Hq / Hkv;
  switch (D) {
    case 16: return dispatch_g<T, 16>(qpk, q, qs, k, ks, v, vs, out, B, Hq,
                                      Hkv, kv_len, scale, s);
    case 32: return dispatch_g<T, 32>(qpk, q, qs, k, ks, v, vs, out, B, Hq,
                                      Hkv, kv_len, scale, s);
    case 64: return dispatch_g<T, 64>(qpk, q, qs, k, ks, v, vs, out, B, Hq,
                                      Hkv, kv_len, scale, s);
    case 128: return dispatch_g<T, 128>(qpk, q, qs, k, ks, v, vs, out, B, Hq,
                                        Hkv, kv_len, scale, s);
    case 256: return dispatch_g<T, 256>(qpk, q, qs, k, ks, v, vs, out, B, Hq,
                                        Hkv, kv_len, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q strides over (B, H), k/v strides over (B, S, H), in elements; the
// head dim is contiguous, k and v rows 16-byte aligned.  1 <= kv_len <=
// Sk, Hq / Hkv <= 16, D in {16, 32, 64, 128, 256}; dt: halcone::kF32 or
// kBF16; scale: D^-0.5 as an f32.  Returns a cudaError_t.
extern "C" int halcone_decode_attention(
    const void* q, long long qsb, long long qsh, const void* k,
    long long ksb, long long kss, long long ksh, const void* v,
    long long vsb, long long vss, long long vsh, void* out, int B, int Hq,
    int Hkv, int D, int kv_len, float scale, int dt, void* stream) {
  const long long qs[2] = {qsb, qsh}, ks[3] = {ksb, kss, ksh},
                  vs[3] = {vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == halcone::kF32)
    return dispatch_d<float>(D, q, qs, k, ks, v, vs, out, B, Hq, Hkv, kv_len,
                             scale, s);
  if (dt == halcone::kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, qs, k, ks, v, vs, out, B, Hq, Hkv,
                                     kv_len, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
