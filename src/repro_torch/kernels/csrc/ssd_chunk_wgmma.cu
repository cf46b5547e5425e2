// The Mamba2 SSD intra-chunk step on Hopper's tensor cores (sm_90a): the
// bf16 route for P in {64, 128} and N in {64, 128}.
//
// Replaces the Pallas kernel repro/kernels/ssd_chunk.py::_ssd_kernel
// (pallas_call at ssd_chunk.py:45) for bf16 x, B and C at those shapes;
// f32, and the other shapes, stay on ssd_chunk.cu.  Same contract, per
// (batch b, chunk c, head h), in f32:
//   cum_i   = sum_{j <= i} dt_j * A_h
//   y_i     = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//   state   = sum_j (B_j * (dt_j * exp(cum_{Q-1} - cum_j)))^T x_j
// x: [B, nc, Q, H, P]; B and C: [B, nc, Q, H, N] bf16, any strides over
// the first four dims that are whole 16 bytes (for TMA), the last dim
// contiguous; a group's B/C broadcast to its heads (head stride 0) is
// read through a map whose head dim has size 1, never copied.  dt:
// [B, nc, Q, H] f32, any strides; A: [H] f32.  Outputs, contiguous: y in
// the requested type (f32 or bf16), state [B, nc, H, N, P] f32, cum
// [B, nc, Q, H] f32.
//
// Bound: bytes.  At the mamba2-130m prefill (B = 8, nc = 2, Q = 256,
// H = 24, P = 64, N = 128) with y in f32 the function moves ~52 MB (x
// 12.6, y 25.2, the state 12.6, B and C 1 each, dt and cum 0.8): ~15.5 us
// at 3.35 TB/s.  The products, with the weights split in two bf16 halves
// as the tensor cores see them, are ~9.7 GFLOP: ~10 us at 989 TF/s.
//
// Design: flash attention's shape (flash_attention_wgmma.cu), with C for
// Q, B for K, x for V and the decay weights for the softmax.  One block
// per (b, c, h, 128 query rows): two consumer warpgroups of 64 rows and
// one producer warp; key tiles of 64.
// - The producer TMA-loads the block's C rows once, then keeps a ring of
//   two B/x stages full (rank-5 maps over (last dim, H, Q, nc, B),
//   128-byte swizzle, boxes of 64 columns), each stage completing on an
//   mbarrier.  Rows past Q are zero-filled.
// - cum is computed once per block: the consumers stage dt in shared
//   memory, and one thread sums the products dt_j A (each rounded on its
//   own) in row order from row 0, one add a row on a register chain with
//   the next 16 rows' loads in flight, while the first tiles load.  That
//   is torch's cumsum of dt * A bit for bit, as ssd_chunk.cu's; a scan
//   in parallel would change the order of the sums.
// - S = C B^T is wgmma m64n64k16 with both operands K-major in shared
//   memory: bf16 x bf16 is exact in the f32 accumulator, as in the
//   reference, which upcasts first.
// - On the accumulator fragments W_ij = S_ij * 2^((cum_i - cum_j) log2 e)
//   * dt_j, the difference taken first.  Tiles wholly above a
//   warpgroup's rows are skipped; on tiles that cross the diagonal or
//   hold rows past Q, pairs j > i and those rows are set to exactly 0 by
//   a select, so an exp that overflows there is discarded, never
//   multiplied by 0.
// - y += W x: W is split in registers into W_hi = bf16(W) and W_lo =
//   bf16(W - W_hi), and two wgmma (A from registers, x as the MN-major B
//   operand through the transpose bit) add both into one f32
//   accumulator, so each weight keeps ~16 bits where one bf16 rounding
//   would keep 8.  y is stored once, in the requested type.
// - The state: the block of the first query rows also walks every key
//   tile a second time (the producer reloads them; they are in L2) after
//   its y is stored, so its accumulator reuses y's registers: fusing the
//   state into the output loop would hold both accumulators and the
//   weight fragments at once, past the 112 registers a thread that two
//   blocks an SM allow.  For each tile, (w x)_jp with w_j = dt_j
//   exp(cum_{Q-1} - cum_j) is split into bf16 hi and lo tiles written to
//   shared memory in TMA's swizzled layout (each 16-byte chunk keeps the
//   place of the x chunk it came from), and state[n, p] += B^T (w x) is
//   two wgmma with B^T read through the transpose bit.  N = 128 is two
//   64-row tiles, one a warpgroup, from one (w x) tile; at N = 64 each
//   warpgroup takes every other key tile into a sum of its own, from a
//   (w x) tile of its own, and the two sums are added through shared
//   memory.  This block also writes cum.
// Only the loops over one tile's registers are unrolled; the loops over
// key tiles stay rolled.  A wait on an mbarrier that lasts ~10 s traps: a
// load that never lands is a launch error, not a hung card.
#include "float_io.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kWarpgroups = 2;                   // consumer warpgroups
constexpr int kRows = 64 * kWarpgroups;          // query rows per block
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 32;        // + one producer warp
constexpr int kStages = 2;                       // B/x ring depth
constexpr int BK = 64;                           // key rows per tile
constexpr int kMaxChunk = 1024;                  // Q: dt, cum, w in smem
constexpr int kConsumerBar = 1;                  // named barriers
constexpr int kStateBar = 2;

template <int N, int P>
struct Shape {
  // two blocks an SM at P = 64 (the y and state accumulators take 32
  // registers a thread), one at P = 128
  static constexpr int kBlocksPerSM = P == 64 ? 2 : 1;
  static constexpr int kCBytes = kRows * N * 2;
  static constexpr int kBBytes = BK * N * 2;
  static constexpr int kXBytes = BK * P * 2;
  static constexpr int kStageBytes = kBBytes + kXBytes;
  static constexpr int kHalfBytes = BK * P * 2;  // one of the (w x) halves
  // the state: at N = 128 warpgroup wg forms rows 64 wg .. + 63 over every
  // key tile, from one (w x) tile both write; at N = 64 each forms all
  // rows over every other key tile, from a (w x) tile of its own, and the
  // two sums are added at the end
  static constexpr bool kSplitKeys = N == 64;
  static constexpr int kHiLoBytes = (kSplitKeys ? 2 : 1) * 2 * kHalfBytes;
  // dt, cum and w: 12 bytes a row of the chunk padded to kRows
  static constexpr int smem(int qpad) {
    return kSwizzleAtom + kCBytes + kStages * kStageBytes + kHiLoBytes
           + 12 * qpad + 8 * (1 + 2 * kStages);
  }
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int N, int P, typename OT>
__global__ void __launch_bounds__(kThreads, Shape<N, P>::kBlocksPerSM)
ssd_wgmma_kernel(
    const __grid_constant__ CUtensorMap cmap,
    const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap xmap, const float* __restrict__ dt,
    long long dsb, long long dsc, long long dsq, long long dsh,
    const float* __restrict__ A, OT* __restrict__ y,
    float* __restrict__ state, float* __restrict__ cum_out, int nc, int Q,
    int H, int bhead, int chead) {
  using Sh = Shape<N, P>;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors want 1024-byte tiles
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* cs = smem_raw + (((raw + kSwizzleAtom - 1) & ~(kSwizzleAtom - 1u))
                            - raw);
  uint8_t* ring = cs + Sh::kCBytes;              // stage s: B, then x
  uint8_t* hilo = ring + kStages * Sh::kStageBytes;
  const int qpad = (Q + kRows - 1) / kRows * kRows;
  float* dts = reinterpret_cast<float*>(hilo + Sh::kHiLoBytes);
  float* cums = dts + qpad;
  float* ws = cums + qpad;
  uint64_t* cbar = reinterpret_cast<uint64_t*>(ws + qpad);
  uint64_t* full = cbar + 1;
  uint64_t* empty = full + kStages;

  const int qt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z - b * nc;
  const int q0 = qt * kRows;
  const int kv_end = min(Q, q0 + kRows);         // keys y reads
  const int n_out = (kv_end + BK - 1) / BK;
  // the block of the first rows also forms the state and writes cum
  const int n_state = qt == 0 ? (Q + BK - 1) / BK : 0;
  const int scan_end = qt == 0 ? Q : kv_end;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(cbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWarpgroups) {                 // the producer warp
    if (lane == 0) {
      mbar_expect_tx(cbar, Sh::kCBytes);
      for (int xb = 0; xb < N / kBox; ++xb)
        tma_load(cs + xb * kRows * 128, &cmap, cbar, xb * kBox, h * chead,
                 q0, c, b);
      for (int t = 0; t < n_out + n_state; ++t) {
        const int s = t % kStages;
        const int k0 = (t < n_out ? t : t - n_out) * BK;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], Sh::kStageBytes);
        uint8_t* bs = ring + s * Sh::kStageBytes;
        for (int xb = 0; xb < N / kBox; ++xb)
          tma_load(bs + xb * BK * 128, &bmap, &full[s], xb * kBox,
                   h * bhead, k0, c, b);
        for (int xb = 0; xb < P / kBox; ++xb)
          tma_load(bs + Sh::kBBytes + xb * BK * 128, &xmap, &full[s],
                   xb * kBox, h, k0, c, b);
      }
    }
    return;
  }

  // ---- cum: dt staged by every consumer, summed by one thread in row
  // order, 16 rows a batch with the next batch's loads in flight: the
  // chain is one add a row (rows past scan_end get sums no one reads)
  const float a = A[h];
  const float* dtb = dt + b * dsb + c * dsc + h * dsh;
  for (int j = threadIdx.x; j < qpad; j += kConsumers) {
    dts[j] = j < Q ? dtb[j * dsq] : 0.f;
    cums[j] = 0.f;
  }
  bar_sync(kConsumerBar, kConsumers);
  if (threadIdx.x == 0) {
    const float4* d4 = reinterpret_cast<const float4*>(dts);
    float4* c4 = reinterpret_cast<float4*>(cums);
    float acc = 0.f;
    float4 next[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) next[k] = d4[k];
#pragma unroll 1
    for (int j0 = 0; j0 < scan_end; j0 += 16) {
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = next[k];
      if (j0 + 16 < qpad) {
#pragma unroll
        for (int k = 0; k < 4; ++k) next[k] = d4[(j0 + 16) / 4 + k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc = __fadd_rn(acc, __fmul_rn(v[k].x, a));
        v[k].x = acc;
        acc = __fadd_rn(acc, __fmul_rn(v[k].y, a));
        v[k].y = acc;
        acc = __fadd_rn(acc, __fmul_rn(v[k].z, a));
        v[k].z = acc;
        acc = __fadd_rn(acc, __fmul_rn(v[k].w, a));
        v[k].w = acc;
        c4[j0 / 4 + k] = v[k];
      }
    }
  }
  bar_sync(kConsumerBar, kConsumers);
  const long long chunk = static_cast<long long>(b) * nc + c;
  if (n_state) {                                 // cum out; the state weights
    const float last = cums[Q - 1];
    float* cb = cum_out + chunk * Q * H + h;
    for (int j = threadIdx.x; j < qpad; j += kConsumers) {
      ws[j] = j < Q ? dts[j] * expf(last - cums[j]) : 0.f;
      if (j < Q) cb[static_cast<long long>(j) * H] = cums[j];
    }
    bar_sync(kConsumerBar, kConsumers);
  }

  // ---- y: warpgroup wg owns query rows r0 .. r0 + 63; this thread holds
  // rows row_a and row_a + 8 of its warp's 16, and in each group of 8
  // accumulator columns the pair at cq
  const int wg = warp / 4;
  const int r0 = q0 + 64 * wg;
  const int row_a = r0 + 16 * (warp % 4) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int last_row = min(r0 + 63, Q - 1);
  const uint8_t* cw = cs + 64 * wg * 128;
  const float ci[2] = {cums[row_a], cums[row_a + 8]};

  float o[P / 2], sacc[BK / 2];
#pragma unroll
  for (int i = 0; i < P / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
  mbar_wait(cbar, 0);

  int taken = 0;                                 // tiles taken from the ring
#pragma unroll 1
  for (int t = 0; t < n_out; ++t, ++taken) {
    const int s = taken % kStages;
    const int k0 = t * BK;
    mbar_wait(&full[s], (taken / kStages) & 1);
    if (r0 < Q && k0 <= last_row) {
      const uint8_t* bs = ring + s * Sh::kStageBytes;
      const uint8_t* xs = bs + Sh::kBBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {      // 16 state dims a step
        const int off = (kk % 4) * 32;           // inside a 128-byte row
        wgmma_ss_n64(sacc,
                     desc_sw128(cw + (kk / 4) * kRows * 128 + off, 16,
                                kSwizzleAtom),
                     desc_sw128(bs + (kk / 4) * BK * 128 + off, 16,
                                kSwizzleAtom),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();

      // W, split into bf16 hi and lo halves as wgmma A fragments: for 16
      // keys kt, registers {row, k 0-1}, {row+8, k 0-1}, {row, k 8-9},
      // {row+8, k 8-9} are accumulator entries 8kt + 0..7 in pairs
      const bool masked = k0 + BK - 1 > r0 || r0 + 63 >= Q;
      uint32_t whi[BK / 16][4], wlo[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int r = (i / 2) & 1;
        const int col = k0 + 8 * (i / 4) + cq;
        const float2 cj = *reinterpret_cast<const float2*>(cums + col);
        const float2 dj = *reinterpret_cast<const float2*>(dts + col);
        float w0 = sacc[i] * ex2((ci[r] - cj.x) * kLog2e) * dj.x;
        float w1 = sacc[i + 1] * ex2((ci[r] - cj.y) * kLog2e) * dj.y;
        if (masked) {
          const int row = row_a + 8 * r;
          w0 = col <= row && row < Q ? w0 : 0.f;
          w1 = col + 1 <= row && row < Q ? w1 : 0.f;
        }
        const __nv_bfloat162 whf = __floats2bfloat162_rn(w0, w1);
        const float2 hf = __bfloat1622float2(whf);
        whi[i / 8][(i / 2) % 4] = bf16x2_bits(whf);
        wlo[i / 8][(i / 2) % 4] =
            bf16x2_bits(__floats2bfloat162_rn(w0 - hf.x, w1 - hf.y));
      }
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)       // 16 keys a step
        wgmma_rs<P>(o, whi[kt], desc_sw128(xs + kt * 16 * 128, BK * 128,
                                           kSwizzleAtom));
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
        wgmma_rs<P>(o, wlo[kt], desc_sw128(xs + kt * 16 * 128, BK * 128,
                                           kSwizzleAtom));
      wgmma_commit();
      wgmma_wait_all();
    }
    mbar_arrive(&empty[s]);
  }

  if (r0 < Q) {
    OT* yb = y + (chunk * Q * H + h) * P + cq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row >= Q) continue;
      OT* yr = yb + static_cast<long long>(row) * H * P;
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
        store2(yr + 8 * j, o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
    }
  }
  if (!n_state) return;

  // ---- the state (see Shape::kSplitKeys)
  constexpr bool kSplit = Sh::kSplitKeys;
  constexpr int kWriters = kSplit ? 128 : kConsumers;
  const int bar_id = kStateBar + (kSplit ? wg : 0);
  const int writer = kSplit ? threadIdx.x % 128 : threadIdx.x;
  uint8_t* hi = hilo + (kSplit ? wg * 2 * Sh::kHalfBytes : 0);
  uint8_t* lo = hi + Sh::kHalfBytes;
  float st[P / 2];
#pragma unroll
  for (int i = 0; i < P / 2; ++i) st[i] = 0.f;
#pragma unroll 1
  for (int t = 0; t < n_state; ++t, ++taken) {
    const int s = taken % kStages;
    mbar_wait(&full[s], (taken / kStages) & 1);
    if (!kSplit || t % 2 == wg) {
      const uint8_t* bs = ring + s * Sh::kStageBytes;
      const uint4* xs = reinterpret_cast<const uint4*>(bs + Sh::kBBytes);
      bar_sync(bar_id, kWriters);                // the last tile's products
      // (w x) in bf16 hi and lo: a 16-byte chunk keeps its x chunk's place
      // in the swizzled tile, and its key row is its offset in a box / 128
#pragma unroll 1
      for (int e = writer; e < Sh::kHalfBytes / 16; e += kWriters) {
        const float wj = ws[t * BK + (e % (BK * 8)) / 8];
        uint4 xv = xs[e], hv, lv;
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&hv);
        __nv_bfloat162* l2 = reinterpret_cast<__nv_bfloat162*>(&lv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(x2[k]);
          const float v0 = f.x * wj, v1 = f.y * wj;
          h2[k] = __floats2bfloat162_rn(v0, v1);
          const float2 hf = __bfloat1622float2(h2[k]);
          l2[k] = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
        }
        reinterpret_cast<uint4*>(hi)[e] = hv;
        reinterpret_cast<uint4*>(lo)[e] = lv;
      }
      fence_proxy_async();
      bar_sync(bar_id, kWriters);
      // B's box of this warpgroup's state rows
      const uint8_t* bt = bs + (kSplit ? 0 : wg) * BK * 128;
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
        wgmma_tt<P>(st, desc_sw128(bt + kt * 16 * 128, BK * 128,
                                   kSwizzleAtom),
                    desc_sw128(hi + kt * 16 * 128, BK * 128, kSwizzleAtom),
                    1);
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
        wgmma_tt<P>(st, desc_sw128(bt + kt * 16 * 128, BK * 128,
                                   kSwizzleAtom),
                    desc_sw128(lo + kt * 16 * 128, BK * 128, kSwizzleAtom),
                    1);
      wgmma_commit();
      wgmma_wait_all();
    }
    mbar_arrive(&empty[s]);
  }
  if (kSplit) {
    // the second warpgroup's sum joins the first's through the C tile's
    // and the ring's shared memory, which no one reads or loads any more
    static_assert(P / 2 * 128 * 4 <= Sh::kCBytes + kStages * Sh::kStageBytes,
                  "the partial state fits the C tile and the ring");
    float* part = reinterpret_cast<float*>(cs);
    const int t128 = threadIdx.x % 128;
    bar_sync(kConsumerBar, kConsumers);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < P / 2; ++i) part[i * 128 + t128] = st[i];
    }
    bar_sync(kConsumerBar, kConsumers);
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < P / 2; ++i) st[i] += part[i * 128 + t128];
  }
  float* sb = state + (chunk * H + h) * N * P + cq;
  const int n_a = (kSplit ? 0 : 64 * wg) + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* sr = sb + static_cast<long long>(n_a + 8 * r) * P;
#pragma unroll
    for (int j = 0; j < P / 8; ++j)
      store2(sr + 8 * j, st[4 * j + 2 * r], st[4 * j + 2 * r + 1]);
  }
}

// Strides in elements over (b, c, q, h); ``heads`` is the map's head
// count: H, or 1 for B/C broadcast over the heads (stride 0).
struct View {
  const void* p;
  long long sb, sc, sq, sh;
  int heads;
};

bool map_of(CUtensorMap* map, const View& v, int Bsz, int nc, int Q,
            int width, int rows) {
  const long long dims[5] = {width, v.heads, Q, nc, Bsz};
  const long long st[4] = {v.sh, v.sq, v.sc, v.sb};
  return make_map(map, v.p, 5, dims, st, rows);
}

template <int N, int P, typename OT>
int launch(const View& x, const View& Bv, const View& Cv, const void* dt,
           const long long* ds, const void* A, void* y, void* state,
           void* cum, int Bsz, int nc, int Q, int H, cudaStream_t stream) {
  using Sh = Shape<N, P>;
  CUtensorMap xm, bm, cm;
  if (Q < 1 || Q > kMaxChunk || !map_of(&xm, x, Bsz, nc, Q, P, BK) ||
      !map_of(&bm, Bv, Bsz, nc, Q, N, BK) ||
      !map_of(&cm, Cv, Bsz, nc, Q, N, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_wgmma_kernel<N, P, OT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::smem(kMaxChunk));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int qpad = (Q + kRows - 1) / kRows * kRows;
  const dim3 grid(qpad / kRows, H, Bsz * nc);
  ssd_wgmma_kernel<N, P, OT><<<grid, kThreads, Sh::smem(qpad), stream>>>(
      cm, bm, xm, static_cast<const float*>(dt), ds[0], ds[1], ds[2], ds[3],
      static_cast<const float*>(A), static_cast<OT*>(y),
      static_cast<float*>(state), static_cast<float*>(cum), nc, Q, H,
      Bv.heads == H ? 1 : 0, Cv.heads == H ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename OT>
int launch_np(int N, int P, const View& x, const View& Bv, const View& Cv,
              const void* dt, const long long* ds, const void* A, void* y,
              void* state, void* cum, int Bsz, int nc, int Q, int H,
              cudaStream_t s) {
  if (N == 64 && P == 64)
    return launch<64, 64, OT>(x, Bv, Cv, dt, ds, A, y, state, cum, Bsz, nc,
                              Q, H, s);
  if (N == 128 && P == 64)
    return launch<128, 64, OT>(x, Bv, Cv, dt, ds, A, y, state, cum, Bsz, nc,
                               Q, H, s);
  if (N == 64 && P == 128)
    return launch<64, 128, OT>(x, Bv, Cv, dt, ds, A, y, state, cum, Bsz, nc,
                               Q, H, s);
  if (N == 128 && P == 128)
    return launch<128, 128, OT>(x, Bv, Cv, dt, ds, A, y, state, cum, Bsz,
                                nc, Q, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [Bsz, nc, Q, H, P] bf16 with element strides xs*; dt: [Bsz, nc, Q,
// H] f32 with strides ds*; A: [H] f32; Bm, Cm: [Bsz, nc, Q, H, N] bf16
// with strides bs*, cs* and ``bheads``/``cheads`` heads in their maps (H,
// or 1 for a broadcast read at head 0).  x, Bm and Cm start on 16 bytes
// and each stride of theirs is a whole 16 bytes; their last dim is
// contiguous.  y: [Bsz, nc, Q, H, P] contiguous, f32 or bf16 by
// ``out_code`` (halcone::kF32 / kBF16); state: [Bsz, nc, H, N, P] and
// cum: [Bsz, nc, Q, H] contiguous f32.  P, N in {64, 128}; Q <= 1024.
// Returns a cudaError_t.
extern "C" int halcone_ssd_chunk_wgmma(
    const void* x, long long xsb, long long xsc, long long xsq,
    long long xsh, const void* dt, long long dsb, long long dsc,
    long long dsq, long long dsh, const void* A, const void* Bm,
    long long bsb, long long bsc, long long bsq, long long bsh, int bheads,
    const void* Cm, long long csb, long long csc, long long csq,
    long long csh, int cheads, void* y, void* state, void* cum, int Bsz,
    int nc, int Q, int H, int P, int N, int out_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View xv{x, xsb, xsc, xsq, xsh, H}, bv{Bm, bsb, bsc, bsq, bsh, bheads},
      cv{Cm, csb, csc, csq, csh, cheads};
  const long long ds[4] = {dsb, dsc, dsq, dsh};
  if (out_code == halcone::kF32)
    return launch_np<float>(N, P, xv, bv, cv, dt, ds, A, y, state, cum, Bsz,
                            nc, Q, H, s);
  if (out_code == halcone::kBF16)
    return launch_np<__nv_bfloat16>(N, P, xv, bv, cv, dt, ds, A, y, state,
                                    cum, Bsz, nc, Q, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
