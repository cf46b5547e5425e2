// The Mamba2 SSD intra-chunk step on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/ssd_chunk.py::_ssd_kernel
// (pallas_call at ssd_chunk.py:45).  For each (batch b, chunk c, head h),
// in f32:
//   cum_i   = sum_{j <= i} dt_j * A_h
//   y_i     = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//   state   = sum_j (B_j * (dt_j * exp(cum_{Q-1} - cum_j)))^T x_j
// x: [B, nc, Q, H, P]; B and C: [B, nc, Q, H, N] (f32 or bf16, one dtype;
// any strides over the first four dims, a head stride of 0 included, so a
// group's B/C broadcast to its heads is never copied; the last dim
// contiguous); dt: [B, nc, Q, H] f32, any strides; A: [H] f32.  Outputs,
// contiguous: y in x's dtype or in f32 (the caller's choice), state
// [B, nc, H, N, P] f32, cum [B, nc, Q, H] f32.  bf16 at P, N in {64, 128}
// takes the tensor-core kernel (ssd_chunk_wgmma.cu) instead.
//
// Bound: bytes.  At the mamba2-130m prefill (B = 8, S = 512 -> nc = 2,
// Q = 256, H = 24, P = 64, N = 128, bf16) the function moves ~41 MB (x, y
// and the f32 state ~12.6 MB each) and does ~6.5 GFLOP over the visible
// causal pairs: ~12 us at 3.35 TB/s against ~6.5 us on the bf16 tensor
// cores.  This kernel computes on the f32 CUDA cores (~96 us for those
// flops at 67 TF/s), so it is far from the byte bound; it serves f32
// (held to 1e-5, which bf16 tensor cores would miss) and the shapes the
// tensor-core kernel does not take.
//
// Design.  The Pallas kernel keeps a whole [Q, Q] score and decay tile in
// VMEM; at Q = 256 an f32 [Q, Q] tile alone is 256 KB, above the 227 KB a
// Hopper block can hold.  So the work is split in two kernels:
// - the output pass, one block of 256 threads per (b, c, h, tile of 64
//   query rows).  Each block recomputes the chunk's cum up to its last row
//   in shared memory (summed in row order, as torch sums it), stages its
//   C rows, and walks the key tiles j0 <= i0 only, staging B_j and x_j as
//   f32.  Each thread takes a 4 x 4 tile of scores (rows tr + 16 r, keys
//   tc + 16 c, so the 16 key rows a half-warp reads sit in 16 banks: the
//   B rows are padded to N + 1), and then a 4 x P/16 tile of y.  Pairs
//   with j > i are never computed: their score is set to 0 without
//   evaluating exp(cum_i - cum_j), which can overflow to inf there (inf *
//   0 would be NaN); the reference's exp(-inf) = 0 is reproduced exactly.
//   The block of the last query tile writes cum.
// - the state pass, one block of 256 threads per (b, c, h, tile of 64
//   state rows n).  It scans cum over the whole chunk, forms the weights
//   w_j = dt_j * exp(cum_{Q-1} - cum_j), stages (B_j * w_j) and x_j per
//   tile of 64 rows, and each thread accumulates a 4 x P/16 tile of the
//   [N, P] state.
// The loops over keys and over N stay rolled; only the 4 x 4 and
// 4 x P/16 register tiles unroll, which keeps the build short.
#include "float_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // query rows, key rows and state rows per tile
constexpr int kSub = 16;     // threads along each side of a tile

// cum_j = dt_0 A + ... + dt_j A over rows [0, n), and dt kept in dts;
// called by the whole block, and the caller syncs before reading cum.
// The products are rounded on their own (no FMA) and summed in order
// from row 0, as torch's cumsum of the tensor dt * A does along a dim
// that is not the innermost: the plain version's cum, bit for bit, so the
// exp(cum_i - cum_j) factors of the two agree too.  One thread sums
// (~1 us for Q = 256); the loads are spread over the block.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt,
                                             long long dsq, float A, int n,
                                             float* dts, float* cum,
                                             int tid) {
  for (int j = tid; j < n; j += kThreads) {
    const float d = dt[j * dsq];
    dts[j] = d;
    cum[j] = __fmul_rn(d, A);
  }
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) {
      acc = __fadd_rn(acc, cum[j]);
      cum[j] = acc;
    }
  }
}

// rows [r0, r0 + rows) of a [Q, width] slice (row stride rs, contiguous
// columns) into a shared [kTile][ld] f32 tile; rows past Q are left as
// they are and never read.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src,
                                      long long rs, int r0, int rows,
                                      int width, float* dst, int ld,
                                      int tid) {
  for (int e = tid; e < rows * width; e += kThreads) {
    const int r = e / width, col = e - r * width;
    dst[r * ld + col] = halcone::to_f32(src[(r0 + r) * rs + col]);
  }
}

struct Strides {
  long long b, c, q, h;
};

template <typename T, typename OT, int P>
__global__ void __launch_bounds__(kThreads) ssd_output_kernel(
    const T* __restrict__ x, Strides xs, const float* __restrict__ dt,
    Strides ds, const float* __restrict__ A, const T* __restrict__ Bm,
    Strides bs, const T* __restrict__ Cm, Strides cs, OT* __restrict__ y,
    float* __restrict__ cum_out, int nc, int Q, int H, int N) {
  constexpr int PC = P / kSub;
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* cum = smem;                       // [Q]
  float* dts = cum + Q;                    // [Q]
  float* Cs = dts + Q;                     // [kTile][N + 1]
  float* Bs = Cs + kTile * ldn;            // [kTile][N + 1]
  float* Xs = Bs + kTile * ldn;            // [kTile][P]
  float* Ss = Xs + kTile * P;              // [kTile][kTile + 1]

  const int b = blockIdx.z / nc, c = blockIdx.z - b * nc, h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int qend = min(Q, q0 + kTile);
  const int tid = threadIdx.x, tr = tid / kSub, tc = tid % kSub;
  const T* xb = x + b * xs.b + c * xs.c + h * xs.h;
  const T* Bb = Bm + b * bs.b + c * bs.c + h * bs.h;
  const T* Cb = Cm + b * cs.b + c * cs.c + h * cs.h;

  chunk_cumsum(dt + b * ds.b + c * ds.c + h * ds.h, ds.q, A[h], qend, dts,
               cum, tid);
  stage(Cb, cs.q, q0, qend - q0, N, Cs, ldn, tid);

  float acc[4][PC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < PC; ++k) acc[r][k] = 0.f;

  for (int j0 = 0; j0 < qend; j0 += kTile) {
    const int jn = min(kTile, Q - j0);
    __syncthreads();                       // previous tile fully consumed
    stage(Bb, bs.q, j0, jn, N, Bs, ldn, tid);
    stage(xb, xs.q, j0, jn, P, Xs, P, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[r][k] = 0.f;
    for (int n = 0; n < N; ++n) {
      float a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Cs[(tr + kSub * r) * ldn + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) bb[k] = Bs[(tc + kSub * k) * ldn + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[r][k] += a[r] * bb[k];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + tr + kSub * r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + tc + kSub * k;
        // j > i (and rows past Q) are skipped, not masked: exp is never
        // taken where it could overflow
        Ss[(tr + kSub * r) * (kTile + 1) + tc + kSub * k] =
            (j <= i && i < Q) ? s[r][k] * expf(cum[i] - cum[j]) * dts[j]
                              : 0.f;
      }
    }
    __syncthreads();

    for (int jj = 0; jj < jn; ++jj) {
      float sv[4], xv[PC];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = Ss[(tr + kSub * r) * (kTile + 1) + jj];
#pragma unroll
      for (int k = 0; k < PC; ++k) xv[k] = Xs[jj * P + tc + kSub * k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[r][k] += sv[r] * xv[k];
    }
  }

  const long long row0 = (static_cast<long long>(b) * nc + c) * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + tr + kSub * r;
    if (i >= Q) continue;
    OT* yr = y + ((row0 + i) * H + h) * P;
#pragma unroll
    for (int k = 0; k < PC; ++k)
      yr[tc + kSub * k] = halcone::from_f32<OT>(acc[r][k]);
  }
  if (qend == Q) {                          // the last query tile: cum
    for (int j = tid; j < Q; j += kThreads)
      cum_out[(row0 + j) * H + h] = cum[j];
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(
    const T* __restrict__ x, Strides xs, const float* __restrict__ dt,
    Strides ds, const float* __restrict__ A, const T* __restrict__ Bm,
    Strides bs, float* __restrict__ state, int nc, int Q, int H, int N) {
  constexpr int PC = P / kSub;
  extern __shared__ float smem[];
  float* cum = smem;                       // [Q]
  float* w = cum + Q;                      // [Q]: dt, then the weights
  float* Bw = w + Q;                       // [kTile][kTile]
  float* Xs = Bw + kTile * kTile;          // [kTile][P]

  const int b = blockIdx.z / nc, c = blockIdx.z - b * nc, h = blockIdx.y;
  const int n0 = blockIdx.x * kTile;
  const int nn = min(kTile, N - n0);
  const int tid = threadIdx.x, tr = tid / kSub, tc = tid % kSub;
  const T* xb = x + b * xs.b + c * xs.c + h * xs.h;
  const T* Bb = Bm + b * bs.b + c * bs.c + h * bs.h + n0;

  chunk_cumsum(dt + b * ds.b + c * ds.c + h * ds.h, ds.q, A[h], Q, w, cum,
               tid);
  __syncthreads();
  const float last = cum[Q - 1];
  for (int j = tid; j < Q; j += kThreads) w[j] = w[j] * expf(last - cum[j]);

  float acc[4][PC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < PC; ++k) acc[r][k] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += kTile) {
    const int jn = min(kTile, Q - j0);
    __syncthreads();                       // weights ready / tile consumed
    for (int e = tid; e < jn * nn; e += kThreads) {
      const int r = e / nn, col = e - r * nn;
      Bw[r * kTile + col] =
          halcone::to_f32(Bb[(j0 + r) * bs.q + col]) * w[j0 + r];
    }
    stage(xb, xs.q, j0, jn, P, Xs, P, tid);
    __syncthreads();
    for (int jj = 0; jj < jn; ++jj) {
      float bv[4], xv[PC];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = Bw[jj * kTile + tr + kSub * r];
#pragma unroll
      for (int k = 0; k < PC; ++k) xv[k] = Xs[jj * P + tc + kSub * k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[r][k] += bv[r] * xv[k];
    }
  }

  float* sb = state + ((static_cast<long long>(b) * nc + c) * H + h) * N * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = tr + kSub * r;
    if (n >= nn) continue;
#pragma unroll
    for (int k = 0; k < PC; ++k) sb[(n0 + n) * P + tc + kSub * k] = acc[r][k];
  }
}

size_t output_smem(int Q, int N, int P) {
  return sizeof(float) * (2 * Q + 2 * kTile * (N + 1) + kTile * P +
                          kTile * (kTile + 1));
}

size_t state_smem(int Q, int P) {
  return sizeof(float) * (2 * Q + kTile * kTile + kTile * P);
}

template <typename T, typename OT, int P>
int launch(const void* x, Strides xs, const void* dt, Strides ds,
           const void* A, const void* Bm, Strides bs, const void* Cm,
           Strides cs, void* y, void* state, void* cum, int Bsz, int nc,
           int Q, int H, int N, cudaStream_t stream) {
  const size_t out_bytes = output_smem(Q, N, P);
  const size_t st_bytes = state_smem(Q, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_output_kernel<T, OT, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(out_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_state_kernel<T, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(st_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 out_grid((Q + kTile - 1) / kTile, H, Bsz * nc);
  ssd_output_kernel<T, OT, P><<<out_grid, kThreads, out_bytes, stream>>>(
      static_cast<const T*>(x), xs, static_cast<const float*>(dt), ds,
      static_cast<const float*>(A), static_cast<const T*>(Bm), bs,
      static_cast<const T*>(Cm), cs, static_cast<OT*>(y),
      static_cast<float*>(cum), nc, Q, H, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 st_grid((N + kTile - 1) / kTile, H, Bsz * nc);
  ssd_state_kernel<T, P><<<st_grid, kThreads, st_bytes, stream>>>(
      static_cast<const T*>(x), xs, static_cast<const float*>(dt), ds,
      static_cast<const float*>(A), static_cast<const T*>(Bm), bs,
      static_cast<float*>(state), nc, Q, H, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OT>
int launch_p(int P, const void* x, Strides xs, const void* dt, Strides ds,
             const void* A, const void* Bm, Strides bs, const void* Cm,
             Strides cs, void* y, void* state, void* cum, int Bsz, int nc,
             int Q, int H, int N, cudaStream_t s) {
  switch (P) {
    case 16:
      return launch<T, OT, 16>(x, xs, dt, ds, A, Bm, bs, Cm, cs, y,
                               state, cum, Bsz, nc, Q, H, N, s);
    case 32:
      return launch<T, OT, 32>(x, xs, dt, ds, A, Bm, bs, Cm, cs, y,
                               state, cum, Bsz, nc, Q, H, N, s);
    case 64:
      return launch<T, OT, 64>(x, xs, dt, ds, A, Bm, bs, Cm, cs, y,
                               state, cum, Bsz, nc, Q, H, N, s);
    case 128:
      return launch<T, OT, 128>(x, xs, dt, ds, A, Bm, bs, Cm, cs, y,
                                state, cum, Bsz, nc, Q, H, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: [Bsz, nc, Q, H, P] with element strides xs*; dt: [Bsz, nc, Q, H] f32
// with strides ds*; A: [H] f32; Bm, Cm: [Bsz, nc, Q, H, N] with strides
// bs*, cs* (the last dim of x, Bm and Cm contiguous).  y: [Bsz, nc, Q, H,
// P] contiguous; state: [Bsz, nc, H, N, P] and cum: [Bsz, nc, Q, H]
// contiguous f32.  `dt_code` is the storage type of x, Bm and Cm and
// `out_code` y's (halcone::kF32 / kBF16; y in x's type or in f32).  P in
// {16, 32, 64, 128}; the wrapper bounds Q and N so that the shared memory
// fits.
extern "C" int halcone_ssd_chunk(
    const void* x, long long xsb, long long xsc, long long xsq,
    long long xsh, const void* dt, long long dsb, long long dsc,
    long long dsq, long long dsh, const void* A, const void* Bm,
    long long bsb, long long bsc, long long bsq, long long bsh,
    const void* Cm, long long csb, long long csc, long long csq,
    long long csh, void* y, void* state, void* cum, int Bsz, int nc, int Q,
    int H, int P, int N, int dt_code, int out_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides xs{xsb, xsc, xsq, xsh}, ds{dsb, dsc, dsq, dsh},
      bs{bsb, bsc, bsq, bsh}, cs{csb, csc, csq, csh};
  if (dt_code == halcone::kF32 && out_code == halcone::kF32)
    return launch_p<float, float>(P, x, xs, dt, ds, A, Bm, bs, Cm, cs, y,
                                  state, cum, Bsz, nc, Q, H, N, s);
  if (dt_code == halcone::kBF16 && out_code == halcone::kBF16)
    return launch_p<__nv_bfloat16, __nv_bfloat16>(
        P, x, xs, dt, ds, A, Bm, bs, Cm, cs, y, state, cum, Bsz, nc, Q, H, N,
        s);
  if (dt_code == halcone::kBF16 && out_code == halcone::kF32)
    return launch_p<__nv_bfloat16, float>(P, x, xs, dt, ds, A, Bm, bs, Cm,
                                          cs, y, state, cum, Bsz, nc, Q, H,
                                          N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
