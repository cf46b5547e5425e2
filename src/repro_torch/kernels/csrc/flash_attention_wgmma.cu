// Flash attention (forward, prefill) on Hopper's tensor cores (sm_90a):
// the bf16 route for head dims 64, 80, 128 and 256, and for MLA's q and k
// of 192 columns with v of 128 (deepseek-v2).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:79) for bf16 q, k, v with (D, Dv) in
// {(64, 64), (80, 80), (128, 128), (256, 256), (192, 128)}; f32, and bf16
// at D in {16, 32}, stay on flash_attention.cu.  Same contract: q [B, Sq, Hq,
// D], k [B, Sk, Hkv, D] and v [B, Sk, Hkv, Dv] with any strides over B, S
// and H (each a multiple of 16 bytes, for TMA) and the head dim
// contiguous; out [B, Sq, Hq, Dv] contiguous bf16.  Query head h reads kv
// head h / (Hq / Hkv).  Masked scores get NEG_INF = -1e30 added, keys at or
// past Sk weigh exactly 0, and the denominator is max(l, 1e-30).
//
// Bound: at the smollm prefill (B = 8, S = 512, Hq = 15, Hkv = 5, D = 64,
// causal) the least time is the 21 MB of q, k, v and out over HBM's
// 3.35 TB/s (6.3 us); the 4.0 GFLOP of the causal products take 4.1 us at
// the tensor cores' 989 TF/s.  The kernel feeds the tensor cores from
// shared memory and keeps each block's K/V loads in flight behind its
// math.
//
// At gemma3-4b's prefill (B = 4, S = 1536, Hq = 8, Hkv = 4, D = 256,
// window 1024 on five layers of six) the products bound it: ~34 GFLOP a
// local layer (x1.25 for the split P) against 75.5 MB.
//
// Design (FA3's shape, simplified): one block per (b, q head, 128 query
// rows, DV output columns); two consumer warpgroups of 64 rows each and
// one producer warp; key tiles of 64.  At D = 64 a thread needs 96
// registers, so two blocks share an SM and one block's loads and softmax
// hide behind the other's tensor work.  DV = D up to 128.  At D = 256 a
// whole O would take 128 f32 registers a consumer thread, and ptxas
// gives a block of 288 threads (register-allocated as 384) 168 a thread:
// with S and P's halves that spilled 384 bytes a thread (first build).
// So DV = 128: two blocks share each row tile, each computing all of
// S = Q K^T (256 dims) and O for its half of the columns, with the
// register profile of D = 128 (ptxas: 163 registers at D = 256, 165 at
// 128, 96 at 64, no spills; the build's .log).  That
// costs S and the softmax twice, 4/3 of the tensor work of one block.
// Shared memory at D = 256: Q 64 KB and two stages of K (32 KB) and V's
// half (16 KB), 161 KB, one block an SM.
// At D = 80 (hubert-xlarge) the 160-byte rows are whole 16 bytes, so TMA
// takes them with the tensors' own strides: each row loads as two
// 64-column boxes, and TMA fills columns 80-127 of the second with zeros
// (as it fills rows past S).  S = Q K^T takes the 5 k-steps of the live
// columns; O = P V runs at wgmma's N = 80 (ten 8-column groups, the last
// two in V's second box) and stores 80 columns.  N = 128 over the zeros
// (D = 128's register profile) measured 66.3 against 62.2 us at hubert's
// prefill (NVIDIA H100 80GB HBM3, 700 W); both 165 registers or fewer,
// no spills.  Shared memory as at D = 128,
// 97 KB, one block an SM.
// At MLA's (192, 128) S = Q K^T takes 12 k-steps of 16 (three 64-column
// boxes of Q and K a row) and O keeps D = 128's register profile (128 f32
// columns over the two warpgroups), so no column split: Q 48 KB and two
// stages of K (24 KB) and V (16 KB), 129 KB with the 64-key stages.
// - The producer loads the Q tile once and then keeps a ring of two K/V
//   stages full with TMA (rank-4 maps over (D, H, S, B) with the tensors'
//   own strides, 128-byte swizzle, 64-column boxes: D / 64 of Q and K,
//   DV / 64 of V); each load completes on a stage's "full" mbarrier, and
//   the consumers release a stage on its "empty" mbarrier.  TMA
//   zero-fills rows past Sq and Sk.
// - S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//   memory: bf16 x bf16 is exact in the f32 accumulator, as in the
//   reference, which upcasts before its dot; the scale D^-0.5 multiplies
//   the f32 scores after the product, as there.
// - The online softmax runs on the accumulator fragments: each row lives
//   in 4 threads of a quad, so its max and sum take two shuffles.  The
//   max is taken on the f32 products (the positive scale keeps their
//   order) and each weight is 2^((s - m) c) with c = D^-0.5 log2(e),
//   within ~1e-6 relative of exp((s - m) D^-0.5), below the 2^-17 that P
//   keeps.  The difference comes first, so a score equal to the row's max
//   weighs exactly 1 even where both are the masked -1e30 (2^(s c - m c)
//   by one fma would weigh it by the rounding error of 1e30 c: inf at
//   D = 64).  O is rescaled only when a row's max moved.  Causal blocks
//   stop at their last row's key, a warpgroup skips tiles wholly above
//   its rows, and only tiles that cross the diagonal, a window's edge or
//   Sk are masked, with selects, not branches.  With a window and Sq <= Sk (so
//   every row sees its own key), key tiles wholly behind the window of a
//   block's first row are not loaded, and a warpgroup skips those behind
//   its first row's: each of their weights would be 2^(-1e30 c) = 0 next
//   to that key's.
//   Keys at or past Sk get -inf, so their weight is exactly 0.
// - O += P V: the reference computes p @ v in f32.  P is split in registers
//   into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and two wgmma (A from
//   registers, V as the MN-major B operand through the transpose bit) add
//   both into the one f32 accumulator, so P keeps ~16 bits where a single
//   bf16 rounding would keep 8.  The split costs 1.5x the tensor work.
// - The epilogue multiplies by 1 / max(l, 1e-30), rounds to bf16 once and
//   stores the rows below Sq.  Under grad it also writes each row's m and
//   1 / max(l, 1e-30) to stats (null: no write), from which the
//   tensor-core backward (flash_attention_bwd_wgmma.cu) recomputes P.
// Longest causal tiles are scheduled first (blockIdx.x counts down).  Only
// the loops over one tile's registers are unrolled; the loop over key
// tiles stays rolled, which keeps the build short.  A wait on an mbarrier
// that lasts ~10 s traps: a load that never lands is a launch error, not
// a hung card.
#include "float_io.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kWarpgroups = 2;                   // consumer warpgroups
constexpr int kRows = 64 * kWarpgroups;          // query rows per block
constexpr int kThreads = 128 * kWarpgroups + 32; // + one producer warp
constexpr int kStages = 2;                       // K/V ring depth

// 64 keys a tile: S takes 32 f32 registers a thread and O N / 2.  D: q
// and k's head dim; DO: v's and the output's.  A head dim that is not a
// multiple of 64 (80) takes whole 64-column boxes, zero-filled past it.
template <int D, int DO>
struct Shape {
  static constexpr int BK = 64;
  static constexpr int DT = (D + kBox - 1) / kBox * kBox;    // Q, K tiles
  static constexpr int DOT = (DO + kBox - 1) / kBox * kBox;  // V tiles
  static constexpr int DV = DOT < 128 ? DOT : 128;  // V columns a block
  static constexpr int kVSplit = DOT / DV;         // blocks a row tile
  static constexpr int kStore = DO / kVSplit;      // O columns a block
  static constexpr int N = DO == 80 ? 80 : DV;   // P V's width
  // two blocks an SM at D = 64 (96 registers a thread), one at D >= 80
  static constexpr int kBlocksPerSM = D == 64 ? 2 : 1;
  static constexpr int kBoxes = DT / kBox;         // of Q and K
  static constexpr int kVBoxes = DV / kBox;
  static constexpr int kQBytes = kRows * DT * 2;
  static constexpr int kKBytes = BK * DT * 2;      // K per stage
  static constexpr int kStageBytes = kKBytes + BK * DV * 2;
  static constexpr int kSmem = kSwizzleAtom + kQBytes + kStages * kStageBytes
                               + 8 * (1 + 2 * kStages);
};

template <int D, int DO>
__global__ void __launch_bounds__(kThreads, Shape<D, DO>::kBlocksPerSM)
flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
    float* __restrict__ stats, int Sq, int Sk, int Hq, int qpk, float scale,
    int causal, int window) {
  using Sh = Shape<D, DO>;
  constexpr int BK = Sh::BK, DV = Sh::DV, N = Sh::N;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors want 1024-byte tiles
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* qs = smem_raw + (((raw + kSwizzleAtom - 1) & ~(kSwizzleAtom - 1u))
                            - raw);
  uint8_t* kv = qs + Sh::kQBytes;  // stage s: K, then V
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kv + kStages * Sh::kStageBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  // blockIdx.y: the query head, then which DV columns of O (vpart)
  const int h = blockIdx.y / Sh::kVSplit, vpart = blockIdx.y % Sh::kVSplit;
  const int q0 = qt * kRows, b = blockIdx.z, hk = h / qpk;
  const int kv_end = causal ? min(Sk, min(q0 + kRows, Sq)) : Sk;
  const int ntiles = (kv_end + BK - 1) / BK;
  // tiles wholly behind the block's first row's window (see the header)
  const bool skip_back = window > 0 && Sq <= Sk;
  const int t0 = skip_back ? max(0, q0 - window + 1) / BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kWarpgroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWarpgroups) {                 // the producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, Sh::kQBytes);
      for (int x = 0; x < Sh::kBoxes; ++x)
        tma_load(qs + x * kRows * 128, &qmap, qbar, x * kBox, h, q0, b);
      for (int t = t0; t < ntiles; ++t) {
        const int s = (t - t0) % kStages;
        mbar_wait(&empty[s], (((t - t0) / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], Sh::kStageBytes);
        uint8_t* ks = kv + s * Sh::kStageBytes;
        for (int x = 0; x < Sh::kBoxes; ++x)
          tma_load(ks + x * BK * 128, &kmap, &full[s], x * kBox, hk, t * BK, b);
        for (int x = 0; x < Sh::kVBoxes; ++x)
          tma_load(ks + Sh::kKBytes + x * BK * 128, &vmap, &full[s],
                   vpart * DV + x * kBox, hk, t * BK, b);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns query rows r0 .. r0 + 63; this thread
  // holds rows row_a and row_a + 8 of its warp's 16, and in each group of
  // 8 accumulator columns the pair at cq
  const int wg = warp / 4;
  const int r0 = q0 + 64 * wg;
  const int row_a = r0 + 16 * (warp % 4) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int last_row = min(r0 + 63, Sq - 1);
  const uint8_t* qw = qs + 64 * wg * 128;

  float o[N / 2], sacc[BK / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
  float m[2] = {halcone::kNegInf, halcone::kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  // p = 2^((s - m) sl): the scale, in log2 units
  const float sl = scale * kLog2e;

#pragma unroll 1
  for (int t = t0; t < ntiles; ++t) {
    const int s = (t - t0) % kStages;
    const int k0 = t * BK;
    mbar_wait(&full[s], ((t - t0) / kStages) & 1);
    if (r0 < Sq && (!causal || k0 <= last_row)
        && (!skip_back || k0 + BK - 1 > r0 - window)) {
      const uint8_t* ks = kv + s * Sh::kStageBytes;
      const uint8_t* vs = ks + Sh::kKBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {      // 16 live head dims a step
        const int off = (kk % 4) * 32;           // inside a 128-byte row
        wgmma_ss_n64(sacc,
                     desc_sw128(qw + (kk / 4) * kRows * 128 + off, 16,
                                kSwizzleAtom),
                     desc_sw128(ks + (kk / 4) * BK * 128 + off, 16,
                                kSwizzleAtom),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();

      const bool masked = (causal && k0 + BK - 1 > r0)
                          || (window > 0 && r0 + 63 - k0 >= window)
                          || k0 + BK > Sk;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float sc = sacc[i];
        if (masked) {
          const int col = k0 + 8 * (i / 4) + cq + (i & 1);
          const int row = row_a + 8 * ((i / 2) & 1);
          sc += (causal && col > row) ? halcone::kNegInf : 0.f;
          sc += (window && row - col >= window) ? halcone::kNegInf : 0.f;
          sc = col < Sk ? sc : -CUDART_INF_F;    // zero-filled: weighs 0
        }
        sacc[i] = sc;
        mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc);
      }
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(halcone::kAllLanes, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(halcone::kAllLanes, mx[r], 2));
        alpha[r] = ex2((m[r] - mx[r]) * sl);
        m[r] = mx[r];
      }
      // P, split into bf16 hi and lo halves as wgmma A fragments: for 16
      // keys kt, registers {row, k 0-1}, {row+8, k 0-1}, {row, k 8-9},
      // {row+8, k 8-9} are accumulator entries 8kt + 0..7 in pairs
      uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int r = (i / 2) & 1;
        const float p0 = ex2((sacc[i] - m[r]) * sl),
                    p1 = ex2((sacc[i + 1] - m[r]) * sl);
        rsum[r] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        phi[i / 8][(i / 2) % 4] = bf16x2_bits(hi);
        plo[i / 8][(i / 2) % 4] =
            bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
      // O needs rescaling only where a row's max moved (alpha < 1)
      if (__any_sync(halcone::kAllLanes, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) o[i] *= alpha[(i / 2) & 1];
      }

      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)       // 16 keys a step
        wgmma_rs<N>(o, phi[kt], desc_sw128(vs + kt * 16 * 128, BK * 128,
                                           kSwizzleAtom));
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
        wgmma_rs<N>(o, plo[kt], desc_sw128(vs + kt * 16 * 128, BK * 128,
                                           kSwizzleAtom));
      wgmma_commit();
      wgmma_wait_all();
    }
    mbar_arrive(&empty[s]);
  }

  // each thread summed its own columns of l: add the quad's four
  float inv[2];                               // 1 / max(l, 1e-30)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l[r];
    x += __shfl_xor_sync(halcone::kAllLanes, x, 1);
    x += __shfl_xor_sync(halcone::kAllLanes, x, 2);
    inv[r] = 1.f / fmaxf(x, 1e-30f);
  }
  // the row statistics: stats[0] = m, stats[1] = 1 / max(l, 1e-30), each
  // [B, Hq, Sq]; the quad's four lanes hold the same values, and so do
  // the row tile's blocks: the first writes them
  if (stats != nullptr && lane % 4 == 0 && vpart == 0) {
    const int64_t n = static_cast<int64_t>(gridDim.z) * Hq * Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row >= Sq) continue;
      const int64_t idx = (static_cast<int64_t>(b) * Hq + h) * Sq + row;
      stats[idx] = m[r];
      stats[n + idx] = inv[r];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(b) * Sq + row) * Hq + h) * DO
        + vpart * DV + cq;
#pragma unroll
    for (int j = 0; j < Sh::kStore / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r],
                                o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int D, int DO>
int launch(const void* q, const long long* qs, const void* k,
           const long long* ks, const void* v, const long long* vs, void* out,
           float* stats, int B, int Sq, int Sk, int Hq, int Hkv, float scale,
           int causal, int window, cudaStream_t stream) {
  using Sh = Shape<D, DO>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, qs, B, Sq, Hq, D, kRows) ||
      !make_map(&km, k, ks, B, Sk, Hkv, D, Sh::BK) ||
      !make_map(&vm, v, vs, B, Sk, Hkv, DO, Sh::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<D, DO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((Sq + kRows - 1) / kRows, Hq * Sh::kVSplit, B);
  flash_wgmma_kernel<D, DO><<<grid, kThreads, Sh::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), stats, Sq, Sk, Hq,
      Hq / Hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q/k/v with strides in elements over (B, S, H), each a multiple of 8
// (16 bytes) and 16-byte-aligned base pointers; the head dim contiguous.
// (D, Dv) in {(64, 64), (128, 128), (256, 256), (192, 128)}; scale: D^-0.5
// as an f32.  stats: null, or [2, B, Hq, Sq] f32 that receives each row's m
// and 1 / max(l, 1e-30).  Returns a cudaError_t.
extern "C" int halcone_flash_attention_wgmma(
    const void* q, long long qsb, long long qss, long long qsh,
    const void* k, long long ksb, long long kss, long long ksh,
    const void* v, long long vsb, long long vss, long long vsh, void* out,
    void* stats, int B, int Sq, int Sk, int Hq, int Hkv, int D, int Dv,
    float scale, int causal, int window, void* stream) {
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh},
                  vs[3] = {vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (D == 80 && Dv == 80)
    return launch<80, 80>(q, qs, k, ks, v, vs, out, st, B, Sq, Sk, Hq, Hkv,
                          scale, causal, window, s);
  if (D == 64 && Dv == 64)
    return launch<64, 64>(q, qs, k, ks, v, vs, out, st, B, Sq, Sk, Hq, Hkv,
                          scale, causal, window, s);
  if (D == 128 && Dv == 128)
    return launch<128, 128>(q, qs, k, ks, v, vs, out, st, B, Sq, Sk, Hq,
                            Hkv, scale, causal, window, s);
  if (D == 256 && Dv == 256)
    return launch<256, 256>(q, qs, k, ks, v, vs, out, st, B, Sq, Sk, Hq,
                            Hkv, scale, causal, window, s);
  if (D == 192 && Dv == 128)
    return launch<192, 128>(q, qs, k, ks, v, vs, out, st, B, Sq, Sk, Hq,
                            Hkv, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
