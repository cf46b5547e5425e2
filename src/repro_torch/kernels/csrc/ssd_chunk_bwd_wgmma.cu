// The backward of the Mamba2 SSD intra-chunk step on Hopper's tensor cores
// (sm_90a): the bf16 route for P in {64, 128} and N in {64, 128}.
//
// The gradient of ssd_chunk_wgmma.cu's forward, which replaces the Pallas
// kernel repro/kernels/ssd_chunk.py::_ssd_kernel (pallas_call at
// ssd_chunk.py:45).  The reference has no backward kernel: XLA
// differentiates its jnp ssd_chunked.  f32, and bf16 at the other shapes,
// stay on the CUDA-core ssd_chunk_bwd.cu, whose closed form this kernel
// computes (see its header): per (batch b, chunk c, head h), from the
// forward's saved cum, with L_ij = exp(cum_i - cum_j) for j <= i only,
//   s_ij = (C_i . B_j) L_ij dt_j,  G_ij = (dy_i . x_j) L_ij dt_j,
//   T_ij = (dy_i . x_j)(C_i . B_j) L_ij,  S_ij = G_ij (C_i . B_j),
//   w_j = dt_j exp(cum_{Q-1} - cum_j),  dw_j = B_j . (dstate x_j),
//   dx_j = sum_{i>=j} s_ij dy_i + w_j (B_j dstate),
//   dB_j = sum_{i>=j} G_ij C_i + w_j (dstate x_j),  dC_i = sum_{j<=i} G_ij B_j,
// then ddt and dA from rowsum(S), colsum(T) and dw by a reverse cumsum.
// x, B, C: [B, nc, Q, H, *] bf16, any strides over the first four dims
// that are whole 16 bytes (for TMA), a head stride of 0 included (a
// group's B/C broadcast to its heads is read through a map head of size 1
// and gets its per-head gradient, which the caller's expand sums); dt:
// [B, nc, Q, H] f32, any strides; A: [H] f32; dy [B, nc, Q, H, P], dstate
// [B, nc, H, N, P], dcum and cum [B, nc, Q, H]: contiguous f32.  Outputs,
// contiguous: dx, dB, dC bf16, ddt f32, dA [H] f32.
//
// Bound: bytes.  At mamba2-130m's training shape (B = 8, nc = 2, Q = 256,
// H = 24, P = 64, N = 128, one B/C group) the function moves ~117 MB (x,
// dx; dy and dstate in f32; the per-head dB and dC): ~35 us at 3.35 TB/s.
// Its ~16 GFLOP over the visible pairs take ~16 us on the bf16 tensor
// cores; with the f32 operands split into bf16 halves (below) and whole
// 64 x 64 tiles the tensor cores do ~45 GFLOP, ~45 us at 989 TF/s.  The
// CUDA-core kernel spends ~1.9 ms there in f32 dots; this one puts every
// product on wgmma and reads each tile through TMA.
//
// Design: flash_attention_bwd_wgmma.cu's shape, with C for Q, B for K, x
// for V, dy for dO and the decay weights for P.  Four launches, no
// atomics, every sum in a fixed order (a rerun is equal bit for bit, so a
// resumed training step repeats):
//  1. the query pass, one block per (b, c, h, 64 query rows i), longest
//     first: one consumer warpgroup and a producer warp that keeps a
//     two-stage ring of B_j and x_j tiles full (TMA, rank-5 maps over
//     (last dim, H, Q, nc, B), 128-byte swizzle, 64-column boxes, rows
//     past Q zero-filled; one mbarrier a stage) for j <= i, beside C_i,
//     loaded once.  The consumers split dy_i (f32) into bf16 hi =
//     bf16(dy) and lo = bf16(dy - hi), written into shared memory in
//     TMA's swizzled layout and to a global scratch pair that the key pass
//     reads through TMA, so every dy row is split once.  Per key tile: C
//     B^T (exact: bf16 x bf16 in f32) and dy x^T = hi x^T + lo x^T on
//     wgmma with both operands K-major; G in the accumulator registers;
//     rowsum(S) in registers; dC += G B with G split into hi and lo A
//     fragments and B_j the MN-major B operand through the transpose bit.
//  2. the key pass, one block per (b, c, h, 64 key rows j), longest first:
//     B_j and x_j loaded once, the ring streams C_i and dy_i's hi and lo
//     tiles for i >= j.  The consumers first split dstate (f32 [N, P])
//     into hi and lo tiles in shared memory and form the state terms on
//     wgmma: B_j dstate (dstate the MN-major B operand) and x_j dstate^T
//     (K-major), dw from the latter and B_j's tile, both scaled by w_j.
//     Per query tile the transposed tiles, B C^T and x dy^T, so that s^T
//     and G^T sit in the accumulator registers as the A operand of dx +=
//     s^T dy (hi.hi + lo.hi + hi.lo: both operands split) and dB += G^T C
//     (hi and lo against the exact C); colsum(T) in registers.
//  3. the chunk pass and 4. the dA pass: ssd_chunk_bwd.cu's, copied as
//     they are (dcum_total, its reverse cumsum in row order, ddt's last
//     term, and dA by a fixed tree).
// Precision: the reference differentiates in f32 after upcasting x, B and
// C.  Here x, B and C are exact as operands; dy, dstate, s and G are f32
// and never rounded once to bf16: each is split into two bf16 halves
// whose products add in the f32 accumulator (~16 bits where one rounding
// keeps 8).  ddt and dA, reverse cumsums of terms that cancel ~1000x, come
// out within ~3e-6 of their scale on the CPU emulation
// (tests/ssd_bwd_wgmma_emulation.py), against the 1e-4 they are held to.
// L_ij is 2^((cum_i - cum_j) log2 e) on ex2.approx, the difference taken
// first, as the forward weighs its pairs (expf cost 21-52 us a pass,
// scripts/ssd_bwd_breakdown.py --variants).  Masks: a pair with j > i, a
// row past Q and a key past Q are set to exactly 0 by a select before
// their exp is used (exp(cum_i - cum_j) overflows there); only the
// diagonal tile and a ragged last tile are masked; tiles wholly past the
// diagonal are never visited.
// Registers: the key pass at N = 128 holds dx (32 a thread), dB (64), the
// two score tiles (32 each) and their split fragments (32 + 32, built as
// the score tiles die): ~210 registers, one block an SM; at P = N = 64 two
// blocks an SM, and the query pass two or three, so that one block's
// loads, splits and epilogue overlap another's products.
// Only the loops over one tile's registers are unrolled.  A wait on an
// mbarrier that lasts ~10 s traps.
#include "float_io.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;           // query rows, key rows of every tile
constexpr int kThreads = 128 + 32;  // one consumer warpgroup + a producer warp
constexpr int kStages = 2;          // ring depth
constexpr int kMaxChunk = 1024;     // Q: cum and dt of a chunk in smem
constexpr int kConsumerBar = 1;     // named barrier of the consumers
constexpr int kTileRowBytes = 128;  // one 64-column box row

struct Strides {
  long long b, c, q, h;
};

// the bytes of a [rows, width] bf16 tile as width / 64 boxes of 128 B rows
template <int W>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * W * 2;
}

template <int N, int P>
struct QueryShape {            // the query pass
  static constexpr int kC = tile_bytes<N>(kTile);
  static constexpr int kDy = tile_bytes<P>(kTile);        // hi, then lo
  static constexpr int kStage = tile_bytes<N>(kTile) + tile_bytes<P>(kTile);
  // 126 registers a thread: three blocks an SM where their shared memory
  // fits (N = 64), two at N = 128
  static constexpr int kBlocksPerSM = P == 64 ? (N == 64 ? 3 : 2) : 1;
  static constexpr int smem(int qpad) {
    return kSwizzleAtom + kC + 2 * kDy + kStages * kStage + 8 * qpad
           + 8 * (1 + 2 * kStages);
  }
};

template <int N, int P>
struct KeyShape {              // the key pass
  static constexpr int kB = tile_bytes<N>(kTile);
  static constexpr int kX = tile_bytes<P>(kTile);
  static constexpr int kDs = tile_bytes<P>(N);            // hi, then lo
  static constexpr int kCi = tile_bytes<N>(kTile);
  static constexpr int kDy = tile_bytes<P>(kTile);        // hi, then lo
  static constexpr int kStage = kCi + 2 * kDy;
  // two blocks an SM at P = N = 64 (163 registers); at N = 128 one block
  // with ~210 registers unspilled beat two capped at 204 with spills
  // (scripts/ssd_bwd_breakdown.py --variants)
  static constexpr int kBlocksPerSM = P == 64 && N == 64 ? 2 : 1;
  static constexpr int smem(int qpad) {
    return kSwizzleAtom + kB + kX + 2 * kDs + kStages * kStage + 8 * qpad
           + 8 * (1 + 2 * kStages);
  }
};

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A K-major, B MN-major (the
// transpose bit), both in shared memory
__device__ __forceinline__ void wgmma_st_n64(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int rows,
                                           int kk) {
  // 16 columns kk of a K-major tile of `rows` rows a box
  return desc_sw128(tile + (kk / 4) * rows * kTileRowBytes + (kk % 4) * 32,
                    16, kSwizzleAtom);
}

__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int rows,
                                            int kt) {
  // 16 rows kt of an MN-major tile of `rows` rows a box (boxes of 64
  // columns `rows * 128` bytes apart)
  return desc_sw128(tile + kt * 16 * kTileRowBytes, rows * kTileRowBytes,
                    kSwizzleAtom);
}

// acc (+)= A B^T over K = 16 KK columns, A and B 64-row K-major tiles
template <int KK>
__device__ __forceinline__ void product_kk(float* acc, const uint8_t* a,
                                           const uint8_t* b, bool first) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    wgmma_ss_n64(acc, kmajor(a, kTile, kk), kmajor(b, kTile, kk),
                 first ? kk > 0 : 1);
}

// acc += hi T + lo T over the tile's 64 rows of T (MN-major, W columns)
template <int W>
__device__ __forceinline__ void product_rs(float* acc,
                                           const uint32_t (&f)[4][4],
                                           const uint8_t* t) {
#pragma unroll
  for (int kt = 0; kt < kTile / 16; ++kt)
    wgmma_rs<W>(acc, f[kt], mnmajor(t, kTile, kt));
}

// x0, x1 (accumulator entries i, i + 1) split into bf16 hi and lo halves,
// stored as the A fragment registers of entry i (ssd_chunk_wgmma.cu's)
__device__ __forceinline__ void split(float x0, float x1, int i,
                                      uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi[i / 8][(i / 2) % 4] = bf16x2_bits(h);
  lo[i / 8][(i / 2) % 4] =
      bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// 8 f32 values as bf16 hi and lo 16-byte chunks
__device__ __forceinline__ void split8(const float* v, uint4& hi, uint4& lo) {
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&hi);
  __nv_bfloat162* l2 = reinterpret_cast<__nv_bfloat162*>(&lo);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    const float2 hf = __bfloat1622float2(h2[k]);
    l2[k] = __floats2bfloat162_rn(v[2 * k] - hf.x, v[2 * k + 1] - hf.y);
  }
}

// the byte offset of 16-byte chunk `ch` (8 columns) of row r in a tile of
// `rows` rows a box, 128-byte swizzle
__device__ __forceinline__ int swz(int r, int ch, int rows) {
  return (ch / 8) * rows * kTileRowBytes + r * kTileRowBytes
         + (((ch % 8) ^ (r % 8)) << 4);
}

// rows r and r + 8 of a 64 x W accumulator (this thread's pair of every 8
// columns) rounded to bf16 at `dst` (row r) and `dst + step` (row r + 8),
// each row where its `live` flag is set
template <int W>
__device__ __forceinline__ void store_rows(const float* acc, bf16* dst,
                                           long long step,
                                           const bool (&live)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live[r]) continue;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + r * step + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// a quad's four lanes' sum, in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(halcone::kAllLanes, v, 1);
  return v + __shfl_xor_sync(halcone::kAllLanes, v, 2);
}

struct Ring {
  uint8_t* ring;
  float* cums;      // [qpad] the chunk's cum
  float* dts;       // [qpad] the chunk's dt
  uint64_t* once;   // the resident tiles landed
  uint64_t* full;
  uint64_t* empty;
};

// the 1024-aligned base, then the ring, cum, dt and the barriers
__device__ __forceinline__ uint8_t* aligned_base(uint8_t* raw_p) {
  const uint32_t raw = smem_u32(raw_p);
  return raw_p + (((raw + kSwizzleAtom - 1) & ~(kSwizzleAtom - 1u)) - raw);
}

__device__ __forceinline__ Ring carve(uint8_t* ring, int stage_bytes,
                                      int qpad) {
  Ring s;
  s.ring = ring;
  s.cums = reinterpret_cast<float*>(ring + kStages * stage_bytes);
  s.dts = s.cums + qpad;
  s.once = reinterpret_cast<uint64_t*>(s.dts + qpad);
  s.full = s.once + 1;
  s.empty = s.full + kStages;
  if (threadIdx.x == 0) {
    mbar_init(s.once, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return s;
}

// the chunk's cum and dt into shared memory (rows past Q: 0), by the
// consumers
__device__ __forceinline__ void stage_rows(const Ring& s, const float* cum,
                                           const float* dt, long long chunk,
                                           int b, int c, int h,
                                           const Strides& ds, int Q, int H,
                                           int qpad) {
  const float* cumc = cum + chunk * Q * H + h;
  const float* dtc = dt + b * ds.b + c * ds.c + h * ds.h;
  for (int j = threadIdx.x; j < qpad; j += 128) {
    s.cums[j] = j < Q ? cumc[static_cast<long long>(j) * H] : 0.f;
    s.dts[j] = j < Q ? dtc[j * ds.q] : 0.f;
  }
}

// one 64-row tile of a rank-5 map (W / 64 boxes) at head `hd`, row r0
template <int W>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int hd, int r0,
                                          int c, int b) {
#pragma unroll
  for (int xb = 0; xb < W / kBox; ++xb)
    tma_load(dst + xb * kTile * kTileRowBytes, map, bar, xb * kBox, hd, r0, c,
             b);
}

// ---------------------------------------------------------------- pass 1
template <int N, int P>
__global__ void __launch_bounds__(kThreads, QueryShape<N, P>::kBlocksPerSM)
ssd_bwd_wgmma_query_kernel(
    const __grid_constant__ CUtensorMap cmap,
    const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap xmap, const float* __restrict__ dt,
    Strides ds, const float* __restrict__ cum, const float* __restrict__ dy,
    bf16* __restrict__ dyhi, bf16* __restrict__ dylo, bf16* __restrict__ dC,
    float* __restrict__ rowS, int nc, int Q, int H, int bhead, int chead) {
  using Sh = QueryShape<N, P>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* cs = aligned_base(smem_raw);
  uint8_t* dyh = cs + Sh::kC;
  uint8_t* dyl = dyh + Sh::kDy;
  const int qpad = (Q + kTile - 1) / kTile * kTile;
  const Ring sm = carve(dyl + Sh::kDy, Sh::kStage, qpad);

  const int qt = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z - b * nc;
  const int i0 = qt * kTile;
  const int ntiles = qt + 1;                     // key tiles j0 <= i0
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long chunk = static_cast<long long>(b) * nc + c;

  if (warp == 4) {                               // the producer warp
    if (lane == 0) {
      mbar_expect_tx(sm.once, Sh::kC);
      load_tile<N>(cs, &cmap, sm.once, h * chead, i0, c, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], Sh::kStage);
        uint8_t* bs = sm.ring + s * Sh::kStage;
        load_tile<N>(bs, &bmap, &sm.full[s], h * bhead, t * kTile, c, b);
        load_tile<P>(bs + tile_bytes<N>(kTile), &xmap, &sm.full[s], h,
                     t * kTile, c, b);
      }
    }
    return;
  }

  // dy_i split into hi and lo: into the swizzled tiles and to the scratch
  // pair the key pass loads (rows past Q: zeros, not stored).  Its loads
  // are issued before cum and dt are staged, so both wait on one round
  // trip.
  {
    constexpr int kIt = kTile * P / 8 / 128;     // 16-byte chunks a thread
    const long long row0 = (chunk * Q + i0) * H + h;   // dy[b, c, i0, h]
    float v[kIt][8];
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int e = threadIdx.x + 128 * k;
      const int r = e / (P / 8), ch = e % (P / 8);
      const long long at = (row0 + static_cast<long long>(r) * H) * P
                           + ch * 8;
      if (i0 + r < Q) {
        halcone::load_vec(dy + at, v[k]);
        halcone::load_vec(dy + at + 4, v[k] + 4);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) v[k][q] = 0.f;
      }
    }
    stage_rows(sm, cum, dt, chunk, b, c, h, ds, Q, H, qpad);
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int e = threadIdx.x + 128 * k;
      const int r = e / (P / 8), ch = e % (P / 8);
      const long long at = (row0 + static_cast<long long>(r) * H) * P
                           + ch * 8;
      uint4 hv, lv;
      split8(v[k], hv, lv);
      *reinterpret_cast<uint4*>(dyh + swz(r, ch, kTile)) = hv;
      *reinterpret_cast<uint4*>(dyl + swz(r, ch, kTile)) = lv;
      if (i0 + r < Q) {
        *reinterpret_cast<uint4*>(dyhi + at) = hv;
        *reinterpret_cast<uint4*>(dylo + at) = lv;
      }
    }
  }
  fence_proxy_async();
  bar_sync(kConsumerBar, 128);

  // this thread holds query rows row_a and row_a + 8, and in each group of
  // 8 accumulator columns the pair at cq
  const int row_a = i0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float ci[2] = {sm.cums[row_a], sm.cums[row_a + 8]};
  const bool masked_rows = i0 + kTile > Q;
  float dca[N / 2], cb[kTile / 2], dd[kTile / 2];
  float srow[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dca[i] = 0.f;
  mbar_wait(sm.once, 0);

#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const int j0 = t * kTile;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    const uint8_t* bs = sm.ring + s * Sh::kStage;
    const uint8_t* xs = bs + tile_bytes<N>(kTile);
    wgmma_fence();
    product_kk<N / 16>(cb, cs, bs, true);        // C B^T
    product_kk<P / 16>(dd, dyh, xs, true);       // dy x^T: hi, then lo
    product_kk<P / 16>(dd, dyl, xs, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(cb);
    fence_operands(dd);

    const bool masked = j0 == i0 || masked_rows;
    uint32_t ghi[4][4], glo[4][4];
#pragma unroll
    for (int i = 0; i < kTile / 2; i += 2) {
      const int r = (i / 2) & 1;
      const int col = j0 + 8 * (i / 4) + cq;
      const float2 cj = *reinterpret_cast<const float2*>(sm.cums + col);
      const float2 dj = *reinterpret_cast<const float2*>(sm.dts + col);
      const int row = row_a + 8 * r;
      const bool v0 = !masked || (col <= row && row < Q);
      const bool v1 = !masked || (col + 1 <= row && row < Q);
      const float e0 = v0 ? ex2((ci[r] - cj.x) * kLog2e) * dj.x : 0.f;
      const float e1 = v1 ? ex2((ci[r] - cj.y) * kLog2e) * dj.y : 0.f;
      const float g0 = v0 ? dd[i] * e0 : 0.f;
      const float g1 = v1 ? dd[i + 1] * e1 : 0.f;
      srow[r] += g0 * cb[i];
      srow[r] += g1 * cb[i + 1];
      split(g0, g1, i, ghi, glo);
    }
    wgmma_fence();
    product_rs<N>(dca, ghi, bs);                 // dC += G B
    product_rs<N>(dca, glo, bs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dca);
    mbar_arrive(&sm.empty[s]);
  }

  const bool live[2] = {row_a < Q, row_a + 8 < Q};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float v = quad_sum(srow[r]);
    if (live[r] && lane % 4 == 0)
      rowS[(chunk * Q + row_a + 8 * r) * H + h] = v;
  }
  store_rows<N>(dca, dC + ((chunk * Q + row_a) * H + h) * N + cq,
                8LL * H * N, live);
}

// ---------------------------------------------------------------- pass 2
template <int N, int P>
__global__ void __launch_bounds__(kThreads, KeyShape<N, P>::kBlocksPerSM)
ssd_bwd_wgmma_key_kernel(
    const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap cmap,
    const __grid_constant__ CUtensorMap dyhmap,
    const __grid_constant__ CUtensorMap dylmap, const float* __restrict__ dt,
    Strides ds, const float* __restrict__ cum,
    const float* __restrict__ dstate, bf16* __restrict__ dx,
    bf16* __restrict__ dB, float* __restrict__ ddt, float* __restrict__ kcol,
    float* __restrict__ dww, int nc, int Q, int H, int bhead, int chead) {
  using Sh = KeyShape<N, P>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* bsj = aligned_base(smem_raw);
  uint8_t* xsj = bsj + Sh::kB;
  uint8_t* dsh = xsj + Sh::kX;
  uint8_t* dsl = dsh + Sh::kDs;
  const int qpad = (Q + kTile - 1) / kTile * kTile;
  const Ring sm = carve(dsl + Sh::kDs, Sh::kStage, qpad);

  const int jt = blockIdx.x, h = blockIdx.y;     // tile 0 is the longest
  const int b = blockIdx.z / nc, c = blockIdx.z - b * nc;
  const int j0 = jt * kTile;
  const int nq = (Q + kTile - 1) / kTile;
  const int ntiles = nq - jt;                    // query tiles i0 >= j0
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long chunk = static_cast<long long>(b) * nc + c;

  if (warp == 4) {                               // the producer warp
    if (lane == 0) {
      mbar_expect_tx(sm.once, Sh::kB + Sh::kX);
      load_tile<N>(bsj, &bmap, sm.once, h * bhead, j0, c, b);
      load_tile<P>(xsj, &xmap, sm.once, h, j0, c, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        const int i0 = (jt + t) * kTile;
        mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], Sh::kStage);
        uint8_t* st = sm.ring + s * Sh::kStage;
        load_tile<N>(st, &cmap, &sm.full[s], h * chead, i0, c, b);
        load_tile<P>(st + Sh::kCi, &dyhmap, &sm.full[s], h, i0, c, b);
        load_tile<P>(st + Sh::kCi + Sh::kDy, &dylmap, &sm.full[s], h, i0, c,
                     b);
      }
    }
    return;
  }

  // dstate [N, P] split into hi and lo tiles of N rows a box, its loads
  // issued before cum and dt are staged (one round trip for both)
  {
    constexpr int kIt = N * P / 8 / 128;         // 16-byte chunks a thread
    const float* dsc = dstate + (chunk * H + h) * N * P;
    float v[kIt][8];
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int e = threadIdx.x + 128 * k;
      halcone::load_vec(dsc + e * 8, v[k]);
      halcone::load_vec(dsc + e * 8 + 4, v[k] + 4);
    }
    stage_rows(sm, cum, dt, chunk, b, c, h, ds, Q, H, qpad);
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int e = threadIdx.x + 128 * k;
      const int n = e / (P / 8), ch = e % (P / 8);
      uint4 hv, lv;
      split8(v[k], hv, lv);
      *reinterpret_cast<uint4*>(dsh + swz(n, ch, N)) = hv;
      *reinterpret_cast<uint4*>(dsl + swz(n, ch, N)) = lv;
    }
  }
  fence_proxy_async();
  bar_sync(kConsumerBar, 128);

  // this thread holds key rows row_a and row_a + 8 (tile rows rl and rl +
  // 8), and in each group of 8 accumulator columns the pair at cq
  const int rl = 16 * warp + lane / 4;
  const int row_a = j0 + rl;
  const int cq = 2 * (lane % 4);
  const float last = sm.cums[Q - 1];
  const float cj[2] = {sm.cums[row_a], sm.cums[row_a + 8]};
  const float dj[2] = {sm.dts[row_a], sm.dts[row_a + 8]};
  const bool live[2] = {row_a < Q, row_a + 8 < Q};
  float dxa[P / 2], dba[N / 2];
  mbar_wait(sm.once, 0);

  // the state terms: dx = B_j dstate (dstate the MN-major B operand, one
  // 64-column box a product), raw = x_j dstate^T (64 state rows a product)
  wgmma_fence();
#pragma unroll
  for (int pb = 0; pb < P / 64; ++pb)
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      wgmma_st_n64(dxa + 32 * pb, kmajor(bsj, kTile, kk),
                   mnmajor(dsh + pb * N * kTileRowBytes, N, kk), kk > 0);
      wgmma_st_n64(dxa + 32 * pb, kmajor(bsj, kTile, kk),
                   mnmajor(dsl + pb * N * kTileRowBytes, N, kk), 1);
    }
#pragma unroll
  for (int nb = 0; nb < N / 64; ++nb)
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      wgmma_ss_n64(dba + 32 * nb, kmajor(xsj, kTile, kk),
                   kmajor(dsh + nb * kTile * kTileRowBytes, N, kk), kk > 0);
      wgmma_ss_n64(dba + 32 * nb, kmajor(xsj, kTile, kk),
                   kmajor(dsl + nb * kTile * kTileRowBytes, N, kk), 1);
    }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(dxa);
  fence_operands(dba);
  // dw = B_j . raw (B_j's row from its swizzled tile), then both terms
  // times w_j
  float dw[2], decay[2], w[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = rl + 8 * r;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(
          bsj + swz(rr, j, kTile) + cq * 2);
      const float2 f = __bfloat1622float2(bv);
      part += f.x * dba[4 * j + 2 * r];
      part += f.y * dba[4 * j + 2 * r + 1];
    }
    dw[r] = quad_sum(part);
    decay[r] = live[r] ? expf(last - cj[r]) : 0.f;
    w[r] = dj[r] * decay[r];
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      dxa[4 * j + 2 * r] *= w[r];
      dxa[4 * j + 2 * r + 1] *= w[r];
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      dba[4 * j + 2 * r] *= w[r];
      dba[4 * j + 2 * r + 1] *= w[r];
    }
  }

  // the pairs: query tiles i0 >= j0, transposed (rows j, columns i)
  float tcol[2] = {0.f, 0.f}, cb[kTile / 2], dd[kTile / 2];
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const int i0 = (jt + t) * kTile;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    const uint8_t* cst = sm.ring + s * Sh::kStage;
    const uint8_t* yh = cst + Sh::kCi;
    const uint8_t* yl = yh + Sh::kDy;
    wgmma_fence();
    product_kk<N / 16>(cb, bsj, cst, true);      // B C^T
    product_kk<P / 16>(dd, xsj, yh, true);       // x dy^T: hi, then lo
    product_kk<P / 16>(dd, xsj, yl, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(cb);
    fence_operands(dd);

    const bool masked = i0 == j0 || i0 + kTile > Q;
    uint32_t shi[4][4], slo[4][4], ghi[4][4], glo[4][4];
#pragma unroll
    for (int i = 0; i < kTile / 2; i += 2) {
      const int r = (i / 2) & 1;
      const int col = i0 + 8 * (i / 4) + cq;     // query rows i
      const float2 ci = *reinterpret_cast<const float2*>(sm.cums + col);
      const int row = row_a + 8 * r;
      const bool v0 = !masked || (row <= col && col < Q && row < Q);
      const bool v1 = !masked || (row <= col + 1 && col + 1 < Q && row < Q);
      const float L0 = v0 ? ex2((ci.x - cj[r]) * kLog2e) : 0.f;
      const float L1 = v1 ? ex2((ci.y - cj[r]) * kLog2e) : 0.f;
      const float e0 = L0 * dj[r], e1 = L1 * dj[r];
      tcol[r] += v0 ? dd[i] * cb[i] * L0 : 0.f;
      tcol[r] += v1 ? dd[i + 1] * cb[i + 1] * L1 : 0.f;
      split(v0 ? cb[i] * e0 : 0.f, v1 ? cb[i + 1] * e1 : 0.f, i, shi, slo);
      split(v0 ? dd[i] * e0 : 0.f, v1 ? dd[i + 1] * e1 : 0.f, i, ghi, glo);
    }
    wgmma_fence();
    product_rs<P>(dxa, shi, yh);                 // dx += s^T dy: hi.hi,
    product_rs<P>(dxa, slo, yh);                 //   lo.hi,
    product_rs<P>(dxa, shi, yl);                 //   hi.lo
    product_rs<N>(dba, ghi, cst);                // dB += G^T C
    product_rs<N>(dba, glo, cst);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dxa);
    fence_operands(dba);
    mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float colT = quad_sum(tcol[r]);
    if (live[r] && lane % 4 == 0) {
      const long long o = (chunk * Q + row_a + 8 * r) * H + h;
      ddt[o] = colT + dw[r] * decay[r];
      kcol[o] = -dj[r] * colT - dw[r] * w[r];
      dww[o] = dw[r] * w[r];
    }
  }
  const long long o = (chunk * Q + row_a) * H + h;
  store_rows<P>(dxa, dx + o * P + cq, 8LL * H * P, live);
  store_rows<N>(dba, dB + o * N + cq, 8LL * H * N, live);
}

// ------------------------------------------------ passes 3 and 4 (copied)
// ssd_chunk_bwd.cu's chunk and dA passes, as they are there.
constexpr int kTailThreads = 256;

// One block per (b, c, h): dcum_total, its reverse cumsum r, ddt += A r,
// and the partial sum_j dt_j r_j, each sum by one thread in row order.
__global__ void __launch_bounds__(kTailThreads) ssd_bwd_wgmma_chunk_kernel(
    const float* __restrict__ dt, Strides ds, const float* __restrict__ A,
    const float* __restrict__ dcum, const float* __restrict__ rowS,
    const float* __restrict__ kcol, const float* __restrict__ dww,
    float* __restrict__ ddt, float* __restrict__ part, int nc, int Q,
    int H) {
  extern __shared__ float tail_smem[];
  float* v = tail_smem;              // [Q] dcum_total, then r
  float* u = v + Q;                  // [Q] dw w, then dt
  const int bc = blockIdx.x, h = blockIdx.y;
  const int b = bc / nc, c = bc - b * nc;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(bc) * Q * H + h;
  const float* dtc = dt + b * ds.b + c * ds.c + h * ds.h;
  for (int i = tid; i < Q; i += kTailThreads) {
    const long long o = base + static_cast<long long>(i) * H;
    v[i] = dcum[o] + rowS[o] + kcol[o];
    u[i] = dww[o];
  }
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int j = 0; j < Q; ++j) tot += u[j];
    v[Q - 1] += tot;
    float acc = 0.f;
    for (int i = Q - 1; i >= 0; --i) {
      acc += v[i];
      v[i] = acc;
    }
  }
  __syncthreads();
  const float a = A[h];
  for (int i = tid; i < Q; i += kTailThreads) {
    const long long o = base + static_cast<long long>(i) * H;
    ddt[o] += a * v[i];
    u[i] = dtc[i * ds.q];
  }
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int i = 0; i < Q; ++i) acc += u[i] * v[i];
    part[static_cast<long long>(bc) * H + h] = acc;
  }
}

// One block per head: dA_h = the partials of the R = B nc chunks, thread
// t adding rows t, t + 256, ... in order, then a halving tree.
__global__ void __launch_bounds__(kTailThreads) ssd_bwd_wgmma_da_kernel(
    const float* __restrict__ part, float* __restrict__ dA, int R, int H) {
  __shared__ float red[kTailThreads];
  const int h = blockIdx.x, tid = threadIdx.x;
  float acc = 0.f;
  for (int r = tid; r < R; r += kTailThreads)
    acc += part[static_cast<long long>(r) * H + h];
  red[tid] = acc;
  __syncthreads();
  for (int s = kTailThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) dA[h] = red[0];
}

// ------------------------------------------------------------------ host
// Strides in elements over (b, c, q, h); ``heads`` is the map's head
// count: H, or 1 for B/C broadcast over the heads (stride 0).
struct View {
  const void* p;
  long long sb, sc, sq, sh;
  int heads;
};

bool map_of(CUtensorMap* map, const View& v, int Bsz, int nc, int Q,
            int width) {
  const long long dims[5] = {width, v.heads, Q, nc, Bsz};
  const long long st[4] = {v.sh, v.sq, v.sc, v.sb};
  return make_map(map, v.p, 5, dims, st, kTile);
}

struct Args {
  View x, B, C;
  const float *dt, *A, *dy, *dstate, *dcum, *cum;
  Strides ds;
  bf16 *dyhi, *dylo, *dx, *dB, *dC;
  float *ddt, *dA, *scratch;
  int Bsz, nc, Q, H;
};

template <typename K>
int allow_smem(K* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int N, int P>
int launch(const Args& a, cudaStream_t stream) {
  using QS = QueryShape<N, P>;
  using KS = KeyShape<N, P>;
  const int Bsz = a.Bsz, nc = a.nc, Q = a.Q, H = a.H;
  const long long hp = static_cast<long long>(H) * P;
  const View dyh{a.dyhi, nc * Q * hp, Q * hp, hp, P, H};
  const View dyl{a.dylo, nc * Q * hp, Q * hp, hp, P, H};
  CUtensorMap xm, bm, cm, yhm, ylm;
  if (Q < 1 || Q > kMaxChunk || !map_of(&xm, a.x, Bsz, nc, Q, P) ||
      !map_of(&bm, a.B, Bsz, nc, Q, N) || !map_of(&cm, a.C, Bsz, nc, Q, N) ||
      !map_of(&yhm, dyh, Bsz, nc, Q, P) || !map_of(&ylm, dyl, Bsz, nc, Q, P))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    int e = allow_smem(ssd_bwd_wgmma_query_kernel<N, P>, QS::smem(kMaxChunk));
    if (!e) e = allow_smem(ssd_bwd_wgmma_key_kernel<N, P>,
                           KS::smem(kMaxChunk));
    if (e) return e;
    attr = true;
  }
  const int qpad = (Q + kTile - 1) / kTile * kTile;
  const dim3 grid(qpad / kTile, H, Bsz * nc);
  const int bhead = a.B.heads == H ? 1 : 0, chead = a.C.heads == H ? 1 : 0;
  const long long rows = static_cast<long long>(Bsz) * nc * Q * H;
  float* kcol = a.scratch;
  float* dww = kcol + rows;
  float* rowS = dww + rows;
  float* part = kcol + 3 * rows;
  ssd_bwd_wgmma_query_kernel<N, P><<<grid, kThreads, QS::smem(qpad),
                                     stream>>>(
      cm, bm, xm, a.dt, a.ds, a.cum, a.dy, a.dyhi, a.dylo, a.dC, rowS, nc, Q,
      H, bhead, chead);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_wgmma_key_kernel<N, P><<<grid, kThreads, KS::smem(qpad), stream>>>(
      bm, xm, cm, yhm, ylm, a.dt, a.ds, a.cum, a.dstate, a.dx, a.dB, a.ddt,
      kcol, dww, nc, Q, H, bhead, chead);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_wgmma_chunk_kernel<<<dim3(Bsz * nc, H), kTailThreads,
                               2 * Q * sizeof(float), stream>>>(
      a.dt, a.ds, a.A, a.dcum, rowS, kcol, dww, a.ddt, part, nc, Q, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_wgmma_da_kernel<<<H, kTailThreads, 0, stream>>>(part, a.dA,
                                                         Bsz * nc, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [Bsz, nc, Q, H, P] bf16 with element strides xs*; dt: [Bsz, nc, Q, H]
// f32 with strides ds*; A: [H] f32; Bm, Cm: [Bsz, nc, Q, H, N] bf16 with
// strides bs*, cs* and ``bheads``/``cheads`` heads in their maps (H, or 1
// for a broadcast read at head 0).  x, Bm and Cm start on 16 bytes and each
// stride of theirs is a whole 16 bytes; their last dim is contiguous.  dy
// [Bsz, nc, Q, H, P], dstate [Bsz, nc, H, N, P], dcum and cum [Bsz, nc, Q,
// H]: contiguous f32.  dyhl: [2, Bsz, nc, Q, H, P] bf16 scratch (dy's hi
// and lo halves, written by the query pass).  dx [Bsz, nc, Q, H, P], dB
// and dC [Bsz, nc, Q, H, N]: contiguous bf16; ddt [Bsz, nc, Q, H] and dA
// [H]: f32; scratch: 3 Bsz nc Q H + Bsz nc H floats.  P, N in {64, 128};
// Q <= 1024.  Returns a cudaError_t.
extern "C" int halcone_ssd_chunk_bwd_wgmma(
    const void* x, long long xsb, long long xsc, long long xsq,
    long long xsh, const void* dt, long long dsb, long long dsc,
    long long dsq, long long dsh, const void* A, const void* Bm,
    long long bsb, long long bsc, long long bsq, long long bsh, int bheads,
    const void* Cm, long long csb, long long csc, long long csq,
    long long csh, int cheads, const void* dy, const void* dstate,
    const void* dcum, const void* cum, void* dyhl, void* dx, void* dB,
    void* dC, void* ddt, void* dA, void* scratch, int Bsz, int nc, int Q,
    int H, int P, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bsz < 1 || nc < 1 || H < 1 || H > 65535 ||
      static_cast<long long>(Bsz) * nc > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long half = static_cast<long long>(Bsz) * nc * Q * H * P;
  const Args a{{x, xsb, xsc, xsq, xsh, H},
               {Bm, bsb, bsc, bsq, bsh, bheads},
               {Cm, csb, csc, csq, csh, cheads},
               static_cast<const float*>(dt),
               static_cast<const float*>(A),
               static_cast<const float*>(dy),
               static_cast<const float*>(dstate),
               static_cast<const float*>(dcum),
               static_cast<const float*>(cum),
               {dsb, dsc, dsq, dsh},
               static_cast<bf16*>(dyhl),
               static_cast<bf16*>(dyhl) + half,
               static_cast<bf16*>(dx),
               static_cast<bf16*>(dB),
               static_cast<bf16*>(dC),
               static_cast<float*>(ddt),
               static_cast<float*>(dA),
               static_cast<float*>(scratch),
               Bsz, nc, Q, H};
  if (N == 64 && P == 64) return launch<64, 64>(a, s);
  if (N == 128 && P == 64) return launch<128, 64>(a, s);
  if (N == 64 && P == 128) return launch<64, 128>(a, s);
  if (N == 128 && P == 128) return launch<128, 128>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
