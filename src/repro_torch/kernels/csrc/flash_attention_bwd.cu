// Flash attention backward on Hopper's CUDA cores (sm_90a).
//
// The gradient of the port's forward flash kernels (flash_attention.cu,
// flash_attention_wgmma.cu), which replace the Pallas kernel
// repro/kernels/flash_attention.py::_flash_kernel (pallas_call at
// flash_attention.py:79).  The reference trains through jnp attention
// that XLA differentiates and has no backward Pallas kernel.  Same
// contract as the forward: q [B, Sq, Hq, D], k [B, Sk, Hkv, D] and v
// [B, Sk, Hkv, Dv] with Dv = D, or MLA's (D, Dv) = (192, 128) (o, do and
// dv are v's width), query head h on kv head h / (Hq / Hkv), causal
// and / or windowed masks that ADD NEG_INF = -1e30 to a score (so a
// row whose every key is masked weighs its keys evenly, as the forward
// and the plain version do), scale D^-0.5 on the f32 products.  Here
// every tensor is contiguous; o is the forward's output and do its
// gradient, both in q's dtype.  Outputs dq, dk, dv in q's dtype,
// computed in f32 and rounded once.
//
// Bound: a causal call has 2.5x the forward's products (S = QK^T and dP =
// dO V^T once each, and dV = P^T dO, dK = dS^T Q, dQ = dS K): 10 D flops
// a visible (query, key) pair, and q, k, v, o, do read and dq, dk, dv
// written once.  At smollm-360m's training shape (B = 8, S = 512, Hq =
// 15, Hkv = 5, D = 64, bf16) the bytes take 11 us at 3.35 TB/s and the
// 10.1 GFLOP 10 us at the bf16 tensor cores' 989 TF/s.  This first
// kernel computes on the CUDA cores in f32 and recomputes S in each of
// its three passes, so it runs far from that bound (chip_smoke.py times
// it beside the bound and SDPA's backward).
//
// Design: three launches, no atomics, so every output is the same from
// run to run.
//  1. The row pass, one block per (b, q head, 64 query rows): the
//     softmax's row max m and 1 / l over the keys the forward reads
//     (stopping at the causal limit as it does), and Di = sum(dO * O).
//     Each weight is then P = exp(s - m) / l with the difference taken
//     first, so a score equal to the row's max weighs exactly 1 / l even
//     where both are the masked -1e30.
//  2. The dK / dV pass, one block per (b, kv head, 64 keys): the block
//     keeps its K and V tiles in shared memory, walks the group's query
//     heads and, from the causal start, the query tiles; for each it
//     recomputes S and dP as a 64 x 64 tile (each thread a 4 x 4 part,
//     rows and columns 16 apart so that shared-memory reads do not
//     conflict), writes P and dS = P (dP - Di) to shared memory, and
//     adds P^T dO and dS^T Q into registers (each thread 4 keys x D / 16
//     dims).
//  3. The dQ pass, one block per (b, q head, 64 query rows): Q and dO
//     stay in shared memory while the block walks the key tiles to the
//     causal limit, recomputes the tile's dS and adds dS K into
//     registers.
// All tiles are f32 in shared memory with rows padded by one word.  At
// D = 256 (gemma3-4b) tiles are 32 rows, not 64: four f32 tiles of 64
// rows would take 257 KB of shared memory (dK/dV's pass takes 140 KB at
// 32); each thread then holds a 2 x 2 part of a score tile instead of
// 4 x 4, and 8 threads, not 4, share a row's Di.  At MLA's (192, 128)
// (deepseek-v2's f32 policy) the tiles are 32 rows too; Q and K are 192
// columns, V, dO and O 128: S runs over 192 dims, dP and Di over 128.
// Loops over tiles and over D stay rolled where unrolling would only
// grow the build.
#include "float_io.cuh"

namespace {

constexpr int kThreads = 256;

// Query rows and keys of a tile: 64, and 32 at D = 256 (and at MLA's
// 192), where four f32 tiles of 64 rows (257 KB with their padding) would
// not fit shared memory.
// Each thread of the 16 x 16 grid computes an R x R part of a score tile,
// R = T / 16.
template <int D>
struct Tile {
  static constexpr int T = D > 128 ? 32 : 64;
  static constexpr int R = T / 16;
  static constexpr int LP = T + 1;          // row stride of the P / dS tiles
};

// Row offset of element (b, s, h, 0) in a contiguous [B, S, H, D] tensor.
__device__ __forceinline__ int64_t at(int b, int s, int h, int S, int H,
                                      int D) {
  return ((static_cast<int64_t>(b) * S + s) * H + h) * D;
}

// rows [r0, r0 + TR) of head h of a [B, S, H, D] tensor into a TR x
// (D + 1) f32 tile; rows at or past S read as 0.  TR: the kernel's tile
// rows (at MLA's pair those of q's width, also for v's 128 columns).
template <typename T, int D, int TR = Tile<D>::T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ g,
                                          int b, int r0, int h, int S,
                                          int H) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < TR * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int s = r0 + r;
    tile[r * LD + c] =
        s < S ? halcone::to_f32(g[at(b, s, h, S, H, D) + c]) : 0.f;
  }
}

// The R x R part of S = A B^T (and of dP = A2 B2^T when TWO) this thread
// computes: rows ti + 16 r of A, columns tj + 16 c of B; A and B are D
// wide, A2 and B2 DP (v's width).
template <int D, bool TWO, int DP = D, int R = Tile<D>::R>
__device__ __forceinline__ void tile_products(
    const float* A, const float* Bt, const float* A2, const float* B2,
    int ti, int tj, float (&s)[R][R], float (&p)[R][R]) {
  constexpr int LD = D + 1, LDP = DP + 1;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) s[r][c] = p[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[R], bb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = A[(ti + 16 * r) * LD + d];
#pragma unroll
    for (int c = 0; c < R; ++c) bb[c] = Bt[(tj + 16 * c) * LD + d];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) s[r][c] += a[r] * bb[c];
    if (TWO && d < DP) {
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = A2[(ti + 16 * r) * LDP + d];
#pragma unroll
      for (int c = 0; c < R; ++c) bb[c] = B2[(tj + 16 * c) * LDP + d];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) p[r][c] += a[r] * bb[c];
    }
  }
}

// The scaled, masked score of query qi and key kj from the f32 product;
// -inf for a key at or past Sk (it weighs exactly 0).
__device__ __forceinline__ float score(float dot, int qi, int kj, int Sk,
                                       float scale, int causal, int window) {
  if (kj >= Sk) return -CUDART_INF_F;
  float sc = dot * scale;
  if (causal && kj > qi) sc += halcone::kNegInf;
  if (window && qi - kj >= window) sc += halcone::kNegInf;
  return sc;
}

// ---------------------------------------------------------------- pass 1
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_rows(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ row_m, float* __restrict__ row_il,
    float* __restrict__ row_d, int Sq, int Sk, int Hq, int Hkv, float scale,
    int causal, int window) {
  constexpr int LD = D + 1, TQ = Tile<D>::T, R = Tile<D>::R;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TQ * LD;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  load_tile<T, D>(Qs, q, b, q0, h, Sq, Hq);

  // Di = dO . O over v's DV columns: kThreads / TQ neighbouring threads
  // a row (4 or 8), every such column each
  {
    constexpr int kPer = kThreads / TQ;
    const int r = tid / kPer, part = tid % kPer, i = q0 + r;
    float acc = 0.f;
    if (i < Sq) {
      const int64_t base = at(b, i, h, Sq, Hq, DV);
      for (int d = part; d < DV; d += kPer)
        acc += halcone::to_f32(dout[base + d]) * halcone::to_f32(o[base + d]);
    }
#pragma unroll
    for (int off = 1; off < kPer; off <<= 1)
      acc += __shfl_xor_sync(halcone::kAllLanes, acc, off);
    if (part == 0 && i < Sq)
      row_d[(static_cast<int64_t>(b) * Hq + h) * Sq + i] = acc;
  }

  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = -CUDART_INF_F, l[r] = 0.f;
  const int kv_end = causal ? min(Sk, min(q0 + TQ, Sq)) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += TQ) {
    __syncthreads();                        // the last K tile is consumed
    load_tile<T, D>(Ks, k, b, k0, hk, Sk, Hkv);
    __syncthreads();
    float s[R][R], unused[R][R];
    tile_products<D, false>(Qs, Ks, nullptr, nullptr, ti, tj, s, unused);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = q0 + ti + 16 * r;
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < R; ++c) {
        s[r][c] = score(s[r][c], qi, k0 + tj + 16 * c, Sk, scale, causal,
                        window);
        mx = fmaxf(mx, s[r][c]);
      }
      // the row's 16 threads are one half of the warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(halcone::kAllLanes, mx, off));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) sum += expf(s[r][c] - mx);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(halcone::kAllLanes, sum, off);
      l[r] = l[r] * expf(m[r] - mx) + sum;
      m[r] = mx;
    }
  }
  if (tj == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = q0 + ti + 16 * r;
      if (qi < Sq) {
        const int64_t idx = (static_cast<int64_t>(b) * Hq + h) * Sq + qi;
        row_m[idx] = m[r];
        row_il[idx] = 1.f / fmaxf(l[r], 1e-30f);
      }
    }
  }
}

// P and dS of one (query tile, key tile) pair into shared memory (rows
// of LP floats), from the tiles' S and dP parts; rows at or past Sq weigh
// 0 (their stats read as m = 0, 1 / l = 0, Di = 0).
template <int R, int LP>
__device__ __forceinline__ void write_p_ds(
    float (&s)[R][R], float (&dp)[R][R], const float* mS, const float* ilS,
    const float* dS_, float* Ps, float* dSs, int q0, int k0, int ti, int tj,
    int Sk, float scale, int causal, int window) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ti + 16 * r;
    const float mr = mS[i], il = ilS[i], di = dS_[i];
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int j = tj + 16 * c;
      const float sc = score(s[r][c], q0 + i, k0 + j, Sk, scale, causal,
                             window);
      const float p = il == 0.f ? 0.f : expf(sc - mr) * il;
      if (Ps) Ps[i * LP + j] = p;
      dSs[i * LP + j] = p * (dp[r][c] - di);
    }
  }
}

// stats of rows [q0, q0 + n) of head h into shared memory
__device__ __forceinline__ void load_stats(
    float* mS, float* ilS, float* dS_, const float* __restrict__ row_m,
    const float* __restrict__ row_il, const float* __restrict__ row_d,
    int b, int h, int q0, int n, int Sq, int Hq) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const int i = q0 + r;
    const int64_t idx = (static_cast<int64_t>(b) * Hq + h) * Sq + i;
    const bool live = i < Sq;
    mS[r] = live ? row_m[idx] : 0.f;
    ilS[r] = live ? row_il[idx] : 0.f;
    dS_[r] = live ? row_d[idx] : 0.f;
  }
}

// ---------------------------------------------------------------- pass 2
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ row_m, const float* __restrict__ row_il,
    const float* __restrict__ row_d, T* __restrict__ dk,
    T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, float scale,
    int causal, int window) {
  constexpr int LD = D + 1, DC = D / 16, LDV = DV + 1, DCV = DV / 16;
  constexpr int TQ = Tile<D>::T, R = Tile<D>::R, LP = Tile<D>::LP;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TQ * LD;
  float* Qs = Vs + TQ * LDV;
  float* dOs = Qs + TQ * LD;
  float* Ps = dOs + TQ * LDV;
  float* dSs = Ps + TQ * LP;
  float* mS = dSs + TQ * LP;
  float* ilS = mS + TQ;
  float* dS_ = ilS + TQ;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * TQ;
  const int qpk = Hq / Hkv;
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  load_tile<T, D>(Ks, k, b, k0, hk, Sk, Hkv);
  load_tile<T, DV, TQ>(Vs, v, b, k0, hk, Sk, Hkv);

  // this thread's dK / dV part: keys tk + 16 r, dims td + 16 c
  const int tk = tid / 16, td = tid % 16;
  float adk[R][DC], adv[R][DCV];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < DC; ++c) adk[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < DCV; ++c) adv[r][c] = 0.f;
  }

  // query rows before k0 see none of this block's keys under the causal
  // mask (a row with no visible key at all lies at or past Sk > k0)
  const int i_begin = causal ? k0 : 0;
  for (int h = hk * qpk; h < (hk + 1) * qpk; ++h) {
    for (int q0 = i_begin; q0 < Sq; q0 += TQ) {
      __syncthreads();                      // the last tiles are consumed
      load_tile<T, D>(Qs, q, b, q0, h, Sq, Hq);
      load_tile<T, DV, TQ>(dOs, dout, b, q0, h, Sq, Hq);
      load_stats(mS, ilS, dS_, row_m, row_il, row_d, b, h, q0, TQ, Sq, Hq);
      __syncthreads();
      float s[R][R], dp[R][R];
      tile_products<D, true, DV>(Qs, Ks, dOs, Vs, ti, tj, s, dp);
      write_p_ds<R, LP>(s, dp, mS, ilS, dS_, Ps, dSs, q0, k0, ti, tj, Sk,
                        scale, causal, window);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < TQ; ++i) {
        float pv[R], dsv[R], ov[DCV], qv[DC];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          pv[r] = Ps[i * LP + tk + 16 * r];
          dsv[r] = dSs[i * LP + tk + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          if (c < DCV) ov[c] = dOs[i * LDV + td + 16 * c];
          qv[c] = Qs[i * LD + td + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            if (c < DCV) adv[r][c] += pv[r] * ov[c];
            adk[r][c] += dsv[r] * qv[c];
          }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kj = k0 + tk + 16 * r;
    if (kj >= Sk) continue;
    const int64_t base = at(b, kj, hk, Sk, Hkv, D);
    const int64_t vbase = at(b, kj, hk, Sk, Hkv, DV);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[base + td + 16 * c] = halcone::from_f32<T>(adk[r][c] * scale);
      if (c < DCV)
        dv[vbase + td + 16 * c] = halcone::from_f32<T>(adv[r][c]);
    }
  }
}

// ---------------------------------------------------------------- pass 3
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ row_m, const float* __restrict__ row_il,
    const float* __restrict__ row_d, T* __restrict__ dq, int Sq, int Sk,
    int Hq, int Hkv, float scale, int causal, int window) {
  constexpr int LD = D + 1, DC = D / 16, LDV = DV + 1;
  constexpr int TQ = Tile<D>::T, R = Tile<D>::R, LP = Tile<D>::LP;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TQ * LD;
  float* Ks = dOs + TQ * LDV;
  float* Vs = Ks + TQ * LD;
  float* dSs = Vs + TQ * LDV;
  float* mS = dSs + TQ * LP;
  float* ilS = mS + TQ;
  float* dS_ = ilS + TQ;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  load_tile<T, D>(Qs, q, b, q0, h, Sq, Hq);
  load_tile<T, DV, TQ>(dOs, dout, b, q0, h, Sq, Hq);
  load_stats(mS, ilS, dS_, row_m, row_il, row_d, b, h, q0, TQ, Sq, Hq);

  // this thread's dQ part: rows tq + 16 r, dims td + 16 c
  const int tq = tid / 16, td = tid % 16;
  float adq[R][DC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) adq[r][c] = 0.f;

  const int kv_end = causal ? min(Sk, min(q0 + TQ, Sq)) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += TQ) {
    __syncthreads();                        // the last tiles are consumed
    load_tile<T, D>(Ks, k, b, k0, hk, Sk, Hkv);
    load_tile<T, DV, TQ>(Vs, v, b, k0, hk, Sk, Hkv);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_products<D, true, DV>(Qs, Ks, dOs, Vs, ti, tj, s, dp);
    write_p_ds<R, LP>(s, dp, mS, ilS, dS_, nullptr, dSs, q0, k0, ti, tj, Sk,
                      scale, causal, window);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < TQ; ++j) {
      float dsv[R], kv[DC];
#pragma unroll
      for (int r = 0; r < R; ++r) dsv[r] = dSs[(tq + 16 * r) * LP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[j * LD + td + 16 * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) adq[r][c] += dsv[r] * kv[c];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + tq + 16 * r;
    if (qi >= Sq) continue;
    const int64_t base = at(b, qi, h, Sq, Hq, D);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[base + td + 16 * c] = halcone::from_f32<T>(adq[r][c] * scale);
  }
}

template <typename K>
int allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *row_m, *row_il, *row_d;
  int B, Sq, Sk, Hq, Hkv;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int D, int DV = D>
int launch(const Args& a) {
  constexpr int LD = D + 1, LDV = DV + 1, TQ = Tile<D>::T, LP = Tile<D>::LP;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  const int nq = (a.Sq + TQ - 1) / TQ, nk = (a.Sk + TQ - 1) / TQ;

  const size_t s1 = sizeof(float) * 2 * TQ * LD;
  int e = allow_smem(flash_bwd_rows<T, D, DV>, s1);
  if (e) return e;
  flash_bwd_rows<T, D, DV><<<dim3(nq, a.Hq, a.B), kThreads, s1, a.stream>>>(
      q, k, o, dout, a.row_m, a.row_il, a.row_d, a.Sq, a.Sk, a.Hq, a.Hkv,
      a.scale, a.causal, a.window);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;

  const size_t s2 =
      sizeof(float) * (2 * TQ * (LD + LDV) + 2 * TQ * LP + 3 * TQ);
  if ((e = allow_smem(flash_bwd_dkdv<T, D, DV>, s2))) return e;
  flash_bwd_dkdv<T, D, DV><<<dim3(nk, a.Hkv, a.B), kThreads, s2, a.stream>>>(
      q, k, v, dout, a.row_m, a.row_il, a.row_d, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Sq, a.Sk, a.Hq, a.Hkv, a.scale, a.causal,
      a.window);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;

  const size_t s3 =
      sizeof(float) * (2 * TQ * (LD + LDV) + TQ * LP + 3 * TQ);
  if ((e = allow_smem(flash_bwd_dq<T, D, DV>, s3))) return e;
  flash_bwd_dq<T, D, DV><<<dim3(nq, a.Hq, a.B), kThreads, s3, a.stream>>>(
      q, k, v, dout, a.row_m, a.row_il, a.row_d, static_cast<T*>(a.dq),
      a.Sq, a.Sk, a.Hq, a.Hkv, a.scale, a.causal, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_d(int D, int Dv, const Args& a) {
  if (D == 192 && Dv == 128) return launch<T, 192, 128>(a);
  if (Dv != D) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 80: return launch<T, 80>(a);
    case 128: return launch<T, 128>(a);
    case 256: return launch<T, 256>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, dq: [B, Sq, Hq, D], o, do: [B, Sq, Hq, Dv], k, dk: [B, Sk, Hkv, D]
// and v, dv: [B, Sk, Hkv, Dv], all contiguous and of dtype code `dt`
// (halcone::kF32 / kBF16); D = Dv in {16, 32, 64, 80, 128, 256}, or (D, Dv)
// = (192, 128); Hq a multiple of Hkv, Sk >= 1.  row_m, row_il, row_d:
// [B, Hq, Sq] f32 scratch (the row pass's max, 1 / sum and dO . O).
// scale: D^-0.5 as an f32.
extern "C" int halcone_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* row_m,
    void* row_il, void* row_d, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    int Dv, float scale, int causal, int window, int dt, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, dq, dk, dv,
               static_cast<float*>(row_m), static_cast<float*>(row_il),
               static_cast<float*>(row_d), B, Sq, Sk, Hq, Hkv, scale, causal,
               window, static_cast<cudaStream_t>(stream)};
  if (dt == halcone::kF32) return by_d<float>(D, Dv, a);
  if (dt == halcone::kBF16) return by_d<__nv_bfloat16>(D, Dv, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
