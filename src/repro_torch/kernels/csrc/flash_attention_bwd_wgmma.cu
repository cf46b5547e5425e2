// Flash attention backward on Hopper's tensor cores (sm_90a): the bf16
// route for head dims 64, 80, 128 and 256.
//
// The gradient of flash_attention_wgmma.cu, which replaces the Pallas
// kernel repro/kernels/flash_attention.py::_flash_kernel (pallas_call at
// flash_attention.py:79).  The reference trains through jnp attention that
// XLA differentiates and has no backward Pallas kernel.  f32, and bf16 at
// D in {16, 32}, stay on the CUDA-core flash_attention_bwd.cu.  Same
// contract as the forward: q, o, do [B, Sq, Hq, D] and k, v [B, Sk, Hkv,
// D], all contiguous bf16; query head h on kv head h / (Hq / Hkv); masks
// ADD NEG_INF = -1e30 to the unscaled f32 product, keys at or past Sk weigh
// exactly 0.  Outputs dq, dk, dv in bf16, each summed in f32 and rounded
// once.
//
// Row statistics come from the forward: m, the row's max of the unscaled
// masked products, and 1 / max(l, 1e-30), written by the forward kernel
// under grad.  A weight is P = 2^((s - m) sl) / l with sl = D^-0.5 log2(e)
// and the difference taken first, as in the forward, so it is the
// forward's P (a fully masked row weighs its keys evenly, as there).
//
// Bound: a causal call has 2.5x the forward's products (S and dP once
// each, dV = P^T dO, dK = dS^T Q, dQ = dS K): 10 D flops a visible
// (query, key) pair.  At smollm-360m's training shape (B = 8, S = 512, Hq
// = 15, Hkv = 5, D = 64) the 10.1 GFLOP take 10 us at the tensor cores'
// 989 TF/s and the bytes (q, k, v, o, do read, dq, dk, dv written) 11 us
// over HBM's 3.35 TB/s.  P and dS are split into two bf16 halves, so the
// three products they feed cost twice: 16 D flops of tensor work a pair.
//
// Design (FA2/FA3's backward with the forward's conventions): two
// launches, no atomics, so every output is the same from run to run.  Each
// block is one consumer warpgroup (64 rows) and one producer warp that
// streams tiles through a ring of stages with TMA (rank-4 maps over (D, H,
// S, B), 128-byte swizzle, 64-column boxes; rows past S read as zeros) and
// mbarriers, as the forward does.  At D = 64 dQ commits S, dP and its
// product as separate wgmma groups and waits for one at a time, so P
// forms while dP runs and the dQ product overlaps the next tile; dK/dV
// waits for each group at once, which measured faster than any overlap
// its registers allow (scripts/flash_bwd_breakdown.py).
//  1. dQ, one block per (q head, b, 64 query rows), longest causal rows
//     first: Q and dO stay in shared memory; the thread reads m and 1 / l
//     of its two rows and computes Di = dO . O for them (the quad's four
//     lanes a quarter of the row each, two shuffles), writing Di out for
//     pass 2.  Per key tile up to the causal limit: S = Q K^T and dP = dO
//     V^T by wgmma (both operands K-major), P and dS = P (dP - Di) in the
//     accumulator registers, and dQ += dS K by wgmma with dS from
//     registers and K as the MN-major B operand through the transpose
//     bit, exactly as the forward adds P V.
//  2. dK / dV, one block per (kv head, b, 64 keys), longest first: K and
//     V stay in shared memory; the producer streams Q, dO and the tile's
//     m, 1 / l and Di (copied by its lanes into the stage, completing on
//     the stage's barrier beside the TMA bytes) for the group's query
//     heads and, from the causal start, the query tiles.  Per tile: S^T =
//     K Q^T and dP^T = V dO^T by wgmma, P^T and dS^T in registers, dV +=
//     P^T dO and dK += dS^T Q with A from registers and dO, Q as MN-major
//     B operands.
// Head dims 80 and 256.  At D = 80 (hubert-xlarge) the tiles are two
// 64-column boxes, TMA's zeros past column 80; S and dP take the 5 live
// k-steps, and dQ, dK and dV run at wgmma's N = 80 (N = 128 over the zeros
// measured 211.0 against 193.1 us at hubert's training shape, NVIDIA H100
// 80GB HBM3, 700 W).  At D = 256 (gemma3-4b) a 64 x 256 f32
// accumulator of dK and one of dV would not fit one warpgroup's registers
// beside S, dP and the split P and dS, as a whole O did not in the
// forward; so two blocks share each tile, each computing all of S and dP
// over the 256 dims and its 128-column half of dQ (pass 1) or of dK and
// dV (pass 2), at D = 128's register profile (254 registers in pass 2, no
// spills).  Shared memory there: the resident pair 64 KB, two stages of
// 64 KB, the stats, 195 KB of the 227, one block an SM.
// Precision: the plain version computes P and dS in f32.  Each is split
// in registers into hi = bf16(x) and lo = bf16(x - hi), and both halves'
// products add into the one f32 accumulator (~16 bits where one bf16
// rounding keeps 8).  dK and dQ are scaled by D^-0.5 once, in f32, in the
// epilogue.  Only tiles that cross the diagonal, a window or Sk are
// masked, with selects.  Rows past Sq have 1 / l = 0 and weigh 0; keys
// past Sk get -inf.  Only the loops over one tile's registers are
// unrolled.  A wait on an mbarrier that lasts ~10 s traps.
#include "float_io.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;          // query rows or keys of every tile
constexpr int kThreads = 128 + 32; // one consumer warpgroup + a producer warp
constexpr int kStages = 2;         // ring depth

template <int D>
struct Shape {
  // tiles take whole 64-column boxes: at D = 80 TMA zero-fills columns
  // 80-127, which S and dP never read (D / 16 k-steps)
  static constexpr int DT = (D + kBox - 1) / kBox * kBox;
  // at D = 256 an output tile's 64 x 256 f32 accumulator does not fit one
  // warpgroup's registers beside S, dP and the split P and dS: two blocks
  // share each tile, each with half of the output columns (and all of S
  // and dP), at D = 128's register profile
  static constexpr int kSplit = DT > 128 ? 2 : 1;
  static constexpr int kCols = DT / kSplit;       // tile columns a block
  static constexpr int kStore = D / kSplit;       // output columns a block
  static constexpr int N = D == 80 ? 80 : kCols;  // product width
  // dQ at D = 64 overlaps a tile's arithmetic with its products; at D =
  // 128 the registers that needs are not there, and dK/dV, whose P^T and
  // dS^T would have to stay live beside both accumulators, is faster
  // waiting for each group at once (scripts/flash_bwd_breakdown.py)
  static constexpr bool kOverlapDq = D == 64;
  static constexpr int kTileBytes = kTile * DT * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;  // Q+dO, or K+V
  static constexpr int kStatFloats = 3 * kTile;       // m, 1 / l, Di
  // resident pair, ring, stats of each stage (dK/dV only), barriers
  static constexpr int kSmem = kSwizzleAtom + kStageBytes
                               + kStages * kStageBytes
                               + kStages * kStatFloats * 4
                               + 8 * (1 + 2 * kStages);
  static constexpr int kBlocksPerSM = D == 64 ? 2 : 1;
};

// one 64-row tile of head h at rows r0, as DT / 64 boxes
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int h, int r0,
                                          int b) {
#pragma unroll
  for (int x = 0; x < Shape<D>::DT / kBox; ++x)
    tma_load(dst + x * kTile * 128, map, bar, x * kBox, h, r0, b);
}

// acc (+)= A B^T over D, A and B 64-row tiles with D contiguous (K-major);
// only the D live columns are read
template <int D>
__device__ __forceinline__ void product_ss(float* acc, const uint8_t* a,
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {        // 16 head dims a step
    const int off = (kk / 4) * kTile * 128 + (kk % 4) * 32;
    wgmma_ss_n64(acc, desc_sw128(a + off, 16, kSwizzleAtom),
                 desc_sw128(b + off, 16, kSwizzleAtom), kk > 0);
  }
}

// acc += (hi + lo) T, hi and lo A fragments over the tile's 64 rows of
// T's N columns from its box ``box`` (T a 64 x DT tile with DT contiguous:
// the MN-major B operand)
template <int N>
__device__ __forceinline__ void product_rs(float* acc,
                                           const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4],
                                           const uint8_t* t, int box) {
  t += box * kTile * 128;
#pragma unroll
  for (int kt = 0; kt < kTile / 16; ++kt)
    wgmma_rs<N>(acc, hi[kt], desc_sw128(t + kt * 16 * 128, kTile * 128,
                                        kSwizzleAtom));
#pragma unroll
  for (int kt = 0; kt < kTile / 16; ++kt)
    wgmma_rs<N>(acc, lo[kt], desc_sw128(t + kt * 16 * 128, kTile * 128,
                                        kSwizzleAtom));
}

// Commit the products issued since the last commit as one group; without
// the overlap, wait for it at once.
template <bool kOverlap>
__device__ __forceinline__ void commit() {
  wgmma_commit();
  if constexpr (!kOverlap) wgmma_wait<0>();
}

// x0, x1 (accumulator entries i, i + 1) split into bf16 hi and lo halves,
// stored as the A fragment registers of entry i (see the forward)
__device__ __forceinline__ void split(float x0, float x1, int i,
                                      uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi[i / 8][(i / 2) % 4] = bf16x2_bits(h);
  lo[i / 8][(i / 2) % 4] =
      bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// the forward's masked score of query qi and key kj from the product
__device__ __forceinline__ float masked(float sc, int qi, int kj, int Sk,
                                        int causal, int window) {
  sc += (causal && kj > qi) ? halcone::kNegInf : 0.f;
  sc += (window && qi - kj >= window) ? halcone::kNegInf : 0.f;
  return kj < Sk ? sc : -CUDART_INF_F;         // zero-filled: weighs 0
}

// the first C columns of rows r and r + 8 of a 64-row accumulator (this
// thread's pair of every 8 columns), times `mul`, rounded to bf16 at `dst`
// (row r) and `dst + step` (row r + 8); a row is stored only where its
// `live` flag is set
template <int C>
__device__ __forceinline__ void store_rows(const float* acc, float mul,
                                           bf16* dst, int64_t step,
                                           const bool (&live)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live[r]) continue;
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + r * step + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul,
                                acc[4 * j + 2 * r + 1] * mul);
  }
}

struct Smem {
  uint8_t* pair;    // the resident tiles: Q, dO (pass 1) or K, V (pass 2)
  uint8_t* ring;    // stage s at ring + s * kStageBytes
  float* stats;     // stage s at stats + s * kStatFloats (pass 2)
  uint64_t* pbar;   // the resident pair landed
  uint64_t* full;
  uint64_t* empty;
};

template <int D>
__device__ __forceinline__ Smem carve(uint8_t* raw_p, int full_count) {
  using Sh = Shape<D>;
  // TMA's 128-byte swizzle and the wgmma descriptors want 1024-byte tiles
  const uint32_t raw = smem_u32(raw_p);
  Smem s;
  s.pair = raw_p + (((raw + kSwizzleAtom - 1) & ~(kSwizzleAtom - 1u)) - raw);
  s.ring = s.pair + Sh::kStageBytes;
  s.stats = reinterpret_cast<float*>(s.ring + kStages * Sh::kStageBytes);
  s.pbar = reinterpret_cast<uint64_t*>(s.stats
                                       + kStages * Sh::kStatFloats);
  s.full = s.pbar + 1;
  s.empty = s.full + kStages;
  if (threadIdx.x == 0) {
    mbar_init(s.pbar, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], full_count);
      mbar_init(&s.empty[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------- pass 1
template <int D>
__global__ void __launch_bounds__(kThreads, Shape<D>::kBlocksPerSM)
flash_bwd_wgmma_dq(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap, const bf16* __restrict__ o,
    const bf16* __restrict__ dout, const float* __restrict__ stats,
    float* __restrict__ di, bf16* __restrict__ dq, int Sq, int Sk, int Hq,
    int qpk, float scale, int causal, int window) {
  using Sh = Shape<D>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<D>(smem_raw, 1);
  const uint8_t* qs = sm.pair;
  const uint8_t* dos = sm.pair + Sh::kTileBytes;

  // blockIdx.x: the query head, then which column half (vpart)
  const int h = blockIdx.x / Sh::kSplit, vpart = blockIdx.x % Sh::kSplit;
  const int b = blockIdx.y, hk = h / qpk;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * kTile;
  const int kv_end = causal ? min(Sk, min(q0 + kTile, Sq)) : Sk;
  const int ntiles = (kv_end + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == 4) {                               // the producer warp
    if (lane == 0) {
      mbar_expect_tx(sm.pbar, Sh::kStageBytes);
      load_tile<D>(sm.pair, &qmap, sm.pbar, h, q0, b);
      load_tile<D>(sm.pair + Sh::kTileBytes, &domap, sm.pbar, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], Sh::kStageBytes);
        uint8_t* ks = sm.ring + s * Sh::kStageBytes;
        load_tile<D>(ks, &kmap, &sm.full[s], hk, t * kTile, b);
        load_tile<D>(ks + Sh::kTileBytes, &vmap, &sm.full[s], hk, t * kTile,
                     b);
      }
    }
    return;
  }

  // this thread holds rows row_a and row_a + 8 of the tile, and in each
  // group of 8 accumulator columns the pair at cq
  const int row_a = q0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int64_t nstat = static_cast<int64_t>(gridDim.y) * Hq * Sq;
  float m[2], il[2], dd[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    live[r] = row < Sq;
    const int64_t idx = (static_cast<int64_t>(b) * Hq + h) * Sq + row;
    m[r] = live[r] ? stats[idx] : 0.f;
    il[r] = live[r] ? stats[nstat + idx] : 0.f;   // a dead row weighs 0
    // Di = dO . O over the row's 16-byte chunks: the quad's four lanes a
    // quarter of the row each, or at D = 80 (ten chunks) every fourth
    float acc = 0.f;
    if (live[r]) {
      const int64_t at = ((static_cast<int64_t>(b) * Sq + row) * Hq + h) * D;
      constexpr int kChunks = D / 8;
#pragma unroll
      for (int j = 0; j < (kChunks + 3) / 4; ++j) {
        const int c = kChunks % 4 == 0 ? (lane % 4) * (kChunks / 4) + j
                                       : 4 * j + lane % 4;
        if (c >= kChunks) break;
        float of[8], gf[8];
        halcone::load_vec(o + at + 8 * c, of);
        halcone::load_vec(dout + at + 8 * c, gf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += of[e] * gf[e];
      }
    }
    acc += __shfl_xor_sync(halcone::kAllLanes, acc, 1);
    acc += __shfl_xor_sync(halcone::kAllLanes, acc, 2);
    dd[r] = acc;
    if (live[r] && lane % 4 == 0 && vpart == 0) di[idx] = acc;
  }

  constexpr int N = Sh::N;
  const int box = vpart * (Sh::kCols / kBox);    // the half's first box
  float dqa[N / 2], sacc[kTile / 2], pacc[kTile / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) sacc[i] = pacc[i] = 0.f;
  uint32_t hi[4][4], lo[4][4];
  const float sl = scale * kLog2e;
  mbar_wait(sm.pbar, 0);

  // Per tile, three groups of products: S, dP, then dQ += dS K.  With
  // the overlap (Shape::kOverlapDq), P forms while dP runs and the dQ
  // product's wait moves into the next tile.
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kTile;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    const uint8_t* ks = sm.ring + s * Sh::kStageBytes;
    const uint8_t* vs = ks + Sh::kTileBytes;
    wgmma_fence();
    product_ss<D>(sacc, qs, ks);                 // S = Q K^T
    commit<Sh::kOverlapDq>();
    product_ss<D>(pacc, dos, vs);                // dP = dO V^T
    commit<Sh::kOverlapDq>();
    wgmma_wait<1>();                 // S, and the last tile's dQ product
    fence_operands(sacc);
    if (t > 0) mbar_arrive(&sm.empty[(t - 1) % kStages]);

    const bool mask = (causal && k0 + kTile - 1 > q0) || window > 0
                      || k0 + kTile > Sk;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      const int r = (i / 2) & 1;
      float sc = sacc[i];
      if (mask)
        sc = masked(sc, row_a + 8 * r, k0 + 8 * (i / 4) + cq + (i & 1), Sk,
                    causal, window);
      sacc[i] = ex2((sc - m[r]) * sl) * il[r];   // P
    }
    wgmma_wait<0>();                             // dP
    fence_operands(pacc);
#pragma unroll
    for (int i = 0; i < kTile / 2; i += 2) {
      const int r = (i / 2) & 1;
      split(sacc[i] * (pacc[i] - dd[r]), sacc[i + 1] * (pacc[i + 1] - dd[r]),
            i, hi, lo);                          // dS
    }
    wgmma_fence();
    product_rs<N>(dqa, hi, lo, ks, box);         // dQ += dS K
    commit<Sh::kOverlapDq>();
  }
  wgmma_wait<0>();
  fence_operands(dqa);

  store_rows<Sh::kStore>(
      dqa, scale,
      dq + ((static_cast<int64_t>(b) * Sq + row_a) * Hq + h) * D
          + vpart * Sh::kCols + cq,
      static_cast<int64_t>(8) * Hq * D, live);
}

// ---------------------------------------------------------------- pass 2
template <int D>
__global__ void __launch_bounds__(kThreads, Shape<D>::kBlocksPerSM)
flash_bwd_wgmma_dkdv(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ stats, const float* __restrict__ di,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int Hq,
    int qpk, float scale, int causal, int window) {
  using Sh = Shape<D>;
  extern __shared__ uint8_t smem_raw[];
  // a stage is full when its TMA bytes landed and the producer's 32
  // lanes (plus lane 0's expect_tx) arrived with its statistics
  const Smem sm = carve<D>(smem_raw, 1 + 32);
  const uint8_t* ks = sm.pair;
  const uint8_t* vs = sm.pair + Sh::kTileBytes;

  // blockIdx.x: the kv head, then which column half (vpart)
  const int hk = blockIdx.x / Sh::kSplit, vpart = blockIdx.x % Sh::kSplit;
  const int b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * kTile;
  const int nq = (Sq + kTile - 1) / kTile;
  // query tiles before the key tile's see none of its keys under the
  // causal mask (a row with no visible key at all lies at or past Sk)
  const int qt0 = causal ? kt : 0;
  const int per_head = max(nq - qt0, 0);
  const int ntiles = per_head * qpk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == 4) {                               // the producer warp
    if (lane == 0) {
      mbar_expect_tx(sm.pbar, Sh::kStageBytes);
      load_tile<D>(sm.pair, &kmap, sm.pbar, hk, k0, b);
      load_tile<D>(sm.pair + Sh::kTileBytes, &vmap, sm.pbar, hk, k0, b);
    }
    const int64_t nstat = static_cast<int64_t>(gridDim.y) * Hq * Sq;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      const int h = hk * qpk + t / per_head;
      const int q0 = (qt0 + t % per_head) * kTile;
      mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], Sh::kStageBytes);
        uint8_t* qs = sm.ring + s * Sh::kStageBytes;
        load_tile<D>(qs, &qmap, &sm.full[s], h, q0, b);
        load_tile<D>(qs + Sh::kTileBytes, &domap, &sm.full[s], h, q0, b);
      }
      float* sv = sm.stats + s * Sh::kStatFloats;
      const int64_t row0 = (static_cast<int64_t>(b) * Hq + h) * Sq;
      for (int r = lane; r < kTile; r += 32) {
        const int i = q0 + r;
        const bool ok = i < Sq;                  // a dead row weighs 0
        sv[r] = ok ? stats[row0 + i] : 0.f;
        sv[kTile + r] = ok ? stats[nstat + row0 + i] : 0.f;
        sv[2 * kTile + r] = ok ? di[row0 + i] : 0.f;
      }
      mbar_arrive(&sm.full[s]);
    }
    return;
  }

  // this thread holds keys row_k and row_k + 8 of the tile, and in each
  // group of 8 accumulator columns (queries, then head dims) the pair at cq
  const int row_k = k0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  constexpr int N = Sh::N;
  const int box = vpart * (Sh::kCols / kBox);    // the half's first box
  float dka[N / 2], dva[N / 2], sacc[kTile / 2], pacc[kTile / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) sacc[i] = pacc[i] = 0.f;
  const float sl = scale * kLog2e;
  mbar_wait(sm.pbar, 0);

  // Per tile: S^T and dP^T, P^T in a pass of its own, dS^T and the
  // splits, then dV += P^T dO with dK += dS^T Q; each group is waited
  // for at once (see Shape).
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const int q0 = (qt0 + t % per_head) * kTile;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    const uint8_t* qs = sm.ring + s * Sh::kStageBytes;
    const uint8_t* dos = qs + Sh::kTileBytes;
    const float* sv = sm.stats + s * Sh::kStatFloats;
    wgmma_fence();
    product_ss<D>(sacc, ks, qs);                 // S^T = K Q^T
    product_ss<D>(pacc, vs, dos);                // dP^T = V dO^T
    commit<false>();
    fence_operands(sacc);
    fence_operands(pacc);

    const bool mask = (causal && k0 + kTile - 1 > q0) || window > 0
                      || k0 + kTile > Sk;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      const int c = 8 * (i / 4) + cq + (i & 1);  // query column in the tile
      float sc = sacc[i];
      if (mask)
        sc = masked(sc, q0 + c, row_k + 8 * ((i / 2) & 1), Sk, causal,
                    window);
      sacc[i] = ex2((sc - sv[c]) * sl) * sv[kTile + c];   // P^T
    }
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
#pragma unroll
    for (int i = 0; i < kTile / 2; i += 2) {
      const int c = 8 * (i / 4) + cq;
      split(sacc[i], sacc[i + 1], i, phi, plo);
      split(sacc[i] * (pacc[i] - sv[2 * kTile + c]),
            sacc[i + 1] * (pacc[i + 1] - sv[2 * kTile + c + 1]), i, dhi,
            dlo);                                // dS^T
    }
    wgmma_fence();
    product_rs<N>(dva, phi, plo, dos, box);      // dV += P^T dO
    product_rs<N>(dka, dhi, dlo, qs, box);       // dK += dS^T Q
    commit<false>();
    fence_operands(dka);
    fence_operands(dva);
    mbar_arrive(&sm.empty[s]);
  }

  const int Hkv = gridDim.x / Sh::kSplit;
  const bool live[2] = {row_k < Sk, row_k + 8 < Sk};
  const int64_t at = ((static_cast<int64_t>(b) * Sk + row_k) * Hkv + hk) * D
                     + vpart * Sh::kCols + cq;
  const int64_t step = static_cast<int64_t>(8) * Hkv * D;
  store_rows<Sh::kStore>(dka, scale, dk + at, step, live);
  store_rows<Sh::kStore>(dva, 1.f, dv + at, step, live);
}

// A contiguous [B, S, H, D] bf16 tensor's rank-4 map, 64-row boxes.
bool map_of(CUtensorMap* m, const void* p, int B, int S, int H, int D) {
  const long long st[3] = {static_cast<long long>(S) * H * D,
                           static_cast<long long>(H) * D, D};
  return make_map(m, p, st, B, S, H, D, kTile);
}

template <typename K>
int allow_smem(K* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* stats, void* dq, void* dk,
           void* dv, float* di, int B, int Sq, int Sk, int Hq, int Hkv,
           float scale, int causal, int window, cudaStream_t stream) {
  using Sh = Shape<D>;
  CUtensorMap qm, km, vm, dom;
  if (!map_of(&qm, q, B, Sq, Hq, D) || !map_of(&km, k, B, Sk, Hkv, D) ||
      !map_of(&vm, v, B, Sk, Hkv, D) || !map_of(&dom, dout, B, Sq, Hq, D))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    int e = allow_smem(flash_bwd_wgmma_dq<D>, Sh::kSmem);
    if (!e) e = allow_smem(flash_bwd_wgmma_dkdv<D>, Sh::kSmem);
    if (e) return e;
    attr = true;
  }
  const int nq = (Sq + kTile - 1) / kTile, nk = (Sk + kTile - 1) / kTile;
  const int qpk = Hq / Hkv;
  flash_bwd_wgmma_dq<D><<<dim3(Hq * Sh::kSplit, B, nq), kThreads, Sh::kSmem,
                          stream>>>(
      qm, km, vm, dom, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), stats, di, static_cast<bf16*>(dq), Sq,
      Sk, Hq, qpk, scale, causal, window);
  const int e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  flash_bwd_wgmma_dkdv<D><<<dim3(Hkv * Sh::kSplit, B, nk), kThreads,
                            Sh::kSmem, stream>>>(
      qm, km, vm, dom, stats, di, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, Hq, qpk, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, do, dq: [B, Sq, Hq, D] and k, v, dk, dv: [B, Sk, Hkv, D], all
// contiguous bf16 starting on 16 bytes; D in {64, 80, 128, 256}, Hq a
// multiple of Hkv, Sk >= 1.  stats: [2, B, Hq, Sq] f32, the forward's m
// and 1 / max(l, 1e-30); di: [B, Hq, Sq] f32 scratch (dO . O, written by
// pass 1, read by pass 2).  scale: D^-0.5 as an f32.  Returns a cudaError_t.
extern "C" int halcone_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* stats, void* dq, void* dk, void* dv,
    void* di, int B, int Sq, int Sk, int Hq, int Hkv, int D, float scale,
    int causal, int window, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv || B > 65535 ||
      Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  float* d = static_cast<float*>(di);
  if (D == 64)
    return launch<64>(q, k, v, o, dout, st, dq, dk, dv, d, B, Sq, Sk, Hq,
                      Hkv, scale, causal, window, s);
  if (D == 80)
    return launch<80>(q, k, v, o, dout, st, dq, dk, dv, d, B, Sq, Sk, Hq,
                      Hkv, scale, causal, window, s);
  if (D == 128)
    return launch<128>(q, k, v, o, dout, st, dq, dk, dv, d, B, Sq, Sk, Hq,
                       Hkv, scale, causal, window, s);
  if (D == 256)
    return launch<256>(q, k, v, o, dout, st, dq, dk, dv, d, B, Sq, Sk, Hq,
                       Hkv, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
