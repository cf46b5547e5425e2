// The backward of the Mamba2 SSD intra-chunk step on Hopper (sm_90a).
//
// The gradient of what ssd_chunk.cu and ssd_chunk_wgmma.cu compute, which
// replace the Pallas kernel repro/kernels/ssd_chunk.py::_ssd_kernel
// (pallas_call at ssd_chunk.py:45).  The reference has no backward
// kernel: XLA differentiates its jnp ssd_chunked.  For each (batch b,
// chunk c, head h), in f32, from the forward's saved cum (exact, never
// re-summed), with L_ij = exp(cum_i - cum_j) for j <= i only:
//   s_ij = (C_i . B_j) L_ij dt_j          the forward's scores
//   G_ij = (dy_i . x_j) L_ij dt_j         the cotangent of C_i . B_j
//   T_ij = (dy_i . x_j) (C_i . B_j) L_ij  so S_ij = T_ij dt_j = G_ij (C.B)
//   w_j  = dt_j exp(cum_{Q-1} - cum_j),   dw_j = B_j . (dstate x_j)
//   dx_j = sum_{i>=j} s_ij dy_i + w_j (B_j . dstate)
//   dB_j = sum_{i>=j} G_ij C_i  + w_j (dstate x_j)
//   dC_i = sum_{j<=i} G_ij B_j
//   dcum_total = dcum + rowsum(S) - dt colsum(T) - dw w
//                (+ sum_j dw_j w_j at row Q - 1)
//   r    = reverse cumsum of dcum_total
//   ddt  = colsum(T) + dw exp(cum_{Q-1} - cum) + A_h r
//   dA_h = sum over (b, c, j) of dt_j r_j
// x, B, C: [B, nc, Q, H, *] (f32 or bf16, one dtype; any strides over the
// first four dims, a head stride of 0 included: a group's B/C broadcast to
// its heads is read in place and gets its per-head gradient, which the
// caller's expand sums); dt: [B, nc, Q, H] f32, any strides; A: [H] f32;
// dy [B, nc, Q, H, P], dstate [B, nc, H, N, P], dcum and cum [B, nc, Q, H]:
// contiguous f32.  Outputs, contiguous: dx, dB, dC in x's dtype, ddt f32,
// dA [H] f32.
//
// Bound: bytes.  At mamba2-130m's training shape (B = 8, S = 512 -> nc =
// 2, Q = 256, H = 24, P = 64, N = 128, bf16, one B/C group) the function
// moves ~115 MB (x, dx; dy and dstate in f32; per-head dB and dC): ~35 us
// at 3.35 TB/s.  It does ~16 GFLOP over the visible pairs (6N + 4P a pair,
// 4NP a row for the state terms): ~16 us on the bf16 tensor cores, ~0.24
// ms on the f32 CUDA cores this kernel uses, so it is far from its bound.
// f32 arithmetic serves both dtypes; a tensor-core route is later work.
//
// Design.  At Q = 256 an f32 [Q, Q] tile is 256 KB, more than a block
// holds, so, like the forward's CUDA-core kernel, the work is cut into
// 64-row tiles and only the causal tiles are visited.  Four launches:
// - the key pass, one block of 256 threads per (b, c, h, tile of 64 key
//   rows j).  It stages B_j and x_j, adds the state terms (dstate staged
//   64 rows of N at a time), then walks the query tiles i >= j: stages C_i
//   and dy_i, forms C.B and dy.x for the 64 x 64 pairs in 4 x 4 register
//   tiles (rows tr + 16 r, keys tc + 16 k; tile rows padded to an odd
//   length, so 16 threads reading 16 rows hit 16 banks), and through a
//   shared tile of s (then G) accumulates dx_j and dB_j in registers (each
//   thread 4 rows x P/16 and 4 rows x N/16 columns, tc + 16 k) and
//   colsum(T) per thread.  It writes dx, dB, ddt's first two terms and two
//   rows of scratch (-dt colsum(T) - dw w, and dw w);
// - the query pass, one block per (b, c, h, tile of 64 query rows i),
//   walking the key tiles j <= i: dC_i and rowsum(S), one scratch row;
// - the chunk pass, one block per (b, c, h): dcum_total, its reverse
//   cumsum and ddt's last term, summed by one thread in row order, and a
//   partial dt . r per (b, c, h);
// - the dA pass, one block per head: the partials over (b, c), each
//   thread a stride of rows in order, then a halving tree.
// Every sum has a fixed order and nothing uses atomics, so the gradient is
// the same from run to run (a resumed training step repeats bit for bit).
// A pair with j > i is skipped, never masked after the fact: exp(cum_i -
// cum_j) there can reach exp(+100) = inf and inf * 0 is NaN.  Rows past Q
// and columns past N are staged as zeros.  The N and P loops of the
// register tiles unroll over NC = N/16 (N rounded up to 16, 32, 64, 128 or
// 256, the padding staged as zeros) and PC = P/16; the loops over rows stay
// rolled.  Staging maps a thread to one column of a tile (the widths are
// powers of two), so no element needs a division.
#include "float_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // key rows, query rows and dstate rows a tile
constexpr int kSub = 16;     // threads along each side of a tile
constexpr int kLdS = kTile + 1;

struct Strides {
  long long b, c, q, h;
};

__device__ __forceinline__ float load(const void* p, long long i,
                                      bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, long long i, float v,
                                      bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// rows [r0, r0 + rows) of a [.., width] slice at element offset `base`
// (row stride rs, contiguous columns) into a shared [kTile][ld] f32 tile
// of `cols` columns (a power of two up to kThreads: each thread keeps one
// column); rows past `rows` and columns past `width` are 0.
__device__ __forceinline__ void stage(const void* src, bool bf16,
                                      long long base, long long rs, int r0,
                                      int rows, int width, int cols,
                                      float* dst, int ld, int tid) {
  const int col = tid & (cols - 1), step = kThreads / cols;
  for (int r = tid / cols; r < kTile; r += step)
    dst[r * ld + col] = (r < rows && col < width)
                            ? load(src, base + (r0 + r) * rs + col, bf16)
                            : 0.f;
}

// The 4 x 4 pair tile of a thread: rows i = tr + 16 r of A (C or dy),
// keys j = tc + 16 k of Bt (B or x), summed over `len` columns.
__device__ __forceinline__ void pair_dots(const float* A, const float* Bt,
                                          int ld, int len, int tr, int tc,
                                          float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
  for (int n = 0; n < len; ++n) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(tr + kSub * r) * ld + n];
#pragma unroll
    for (int k = 0; k < 4; ++k) b[k] = Bt[(tc + kSub * k) * ld + n];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] += a[r] * b[k];
  }
}

// A sum over the 16 threads of a half-warp that share a tile row, in a
// fixed order.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(halcone::kAllLanes, v, o);
  return v;
}

template <int PC, int NC>
__global__ void __launch_bounds__(kThreads) ssd_bwd_key_kernel(
    const void* __restrict__ x, Strides xs, const float* __restrict__ dt,
    Strides ds, const void* __restrict__ Bm, Strides bs,
    const void* __restrict__ Cm, Strides cs, const float* __restrict__ dy,
    const float* __restrict__ dstate, const float* __restrict__ cum,
    void* __restrict__ dx, void* __restrict__ dB, float* __restrict__ ddt,
    float* __restrict__ kcol, float* __restrict__ dww, int nc, int Q, int H,
    int N, bool bf16) {
  constexpr int P = PC * kSub, NP = NC * kSub;
  constexpr int ldp = P + 1, ldn = NP + 1;
  extern __shared__ float smem[];
  float* Bs = smem;                  // [kTile][ldn]  B of the key rows
  float* Xs = Bs + kTile * ldn;      // [kTile][ldp]  x of the key rows
  float* Cs = Xs + kTile * ldp;      // [kTile][ldn]  C of the query rows
  float* Ys = Cs + kTile * ldn;      // [kTile][ldp]  dy of the query rows,
                                     //   64 rows of dstate before the loop
  float* Ws = Ys + kTile * ldp;      // [kTile][kLdS] s, then G, as [i][j]
  float* cj = Ws + kTile * kLdS;     // [kTile] cum of the key rows
  float* dj = cj + kTile;            // [kTile] dt of the key rows
  float* ci = dj + kTile;            // [kTile] cum of the query rows
  float* dwv = ci + kTile;           // [kTile] dw of the key rows

  const int b = blockIdx.z / nc, c = blockIdx.z - b * nc, h = blockIdx.y;
  const int j0 = blockIdx.x * kTile;
  const int jn = min(kTile, Q - j0);
  const int tid = threadIdx.x, tr = tid / kSub, tc = tid % kSub;
  const long long xo = b * xs.b + c * xs.c + h * xs.h;
  const long long bo = b * bs.b + c * bs.c + h * bs.h;
  const long long co = b * cs.b + c * cs.c + h * cs.h;
  const long long row0 = static_cast<long long>(b) * nc + c;  // chunk
  const long long yo = (row0 * Q * H + h) * P;  // dy[b, c, 0, h, 0]
  const float* cumc = cum + row0 * Q * H + h;   // stride H over rows
  const float* dtc = dt + b * ds.b + c * ds.c + h * ds.h;
  const float last = cumc[static_cast<long long>(Q - 1) * H];

  if (tid < kTile) {
    cj[tid] = tid < jn ? cumc[static_cast<long long>(j0 + tid) * H] : 0.f;
    dj[tid] = tid < jn ? dtc[(j0 + tid) * ds.q] : 0.f;
  }
  stage(Bm, bf16, bo, bs.q, j0, jn, N, NP, Bs, ldn, tid);
  stage(x, bf16, xo, xs.q, j0, jn, P, P, Xs, ldp, tid);

  // the state terms: dx_j = B_j . dstate, dB_j = dstate x_j (both times
  // w_j below), over dstate staged 64 rows of n at a time
  float adx[4][PC], adb[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < PC; ++k) adx[r][k] = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) adb[r][k] = 0.f;
  }
  const float* dsc = dstate + (row0 * H + h) * N * P;
  for (int n0 = 0; n0 < N; n0 += kTile) {
    const int nn = min(kTile, N - n0);
    __syncthreads();                     // staged tiles ready / consumed
    stage(dsc, false, 0, P, n0, nn, P, P, Ys, ldp, tid);
    __syncthreads();
    for (int m = 0; m < nn; ++m) {
      float bv[4], sv[PC];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = Bs[(tr + kSub * r) * ldn + n0 + m];
#pragma unroll
      for (int k = 0; k < PC; ++k) sv[k] = Ys[m * ldp + tc + kSub * k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) adx[r][k] += bv[r] * sv[k];
    }
    const int kc = n0 / kSub;            // this tile's columns k: kc..kc+3
    for (int p = 0; p < P; ++p) {
      float xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = Xs[(tr + kSub * r) * ldp + p];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if (k < kc || k >= kc + 4) continue;
        const float sv = Ys[(tc + kSub * k - n0) * ldp + p];
#pragma unroll
        for (int r = 0; r < 4; ++r) adb[r][k] += xv[r] * sv;
      }
    }
  }
  // dw_j = B_j . (dstate x_j), then both state terms times w_j
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int jl = tr + kSub * r;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) part += Bs[jl * ldn + tc + kSub * k] * adb[r][k];
    const float dw = row_sum16(part);
    if (tc == 0) dwv[jl] = dw;
    const float w = jl < jn ? dj[jl] * expf(last - cj[jl]) : 0.f;
#pragma unroll
    for (int k = 0; k < PC; ++k) adx[r][k] *= w;
#pragma unroll
    for (int k = 0; k < NC; ++k) adb[r][k] *= w;
  }

  // the pairs: query tiles i0 >= j0
  float tcol[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i0 = j0; i0 < Q; i0 += kTile) {
    const int in = min(kTile, Q - i0);
    __syncthreads();                     // previous tiles consumed
    stage(Cm, bf16, co, cs.q, i0, in, N, NP, Cs, ldn, tid);
    stage(dy, false, yo, static_cast<long long>(H) * P, i0, in, P, P, Ys,
          ldp, tid);
    if (tid < kTile)
      ci[tid] = tid < in ? cumc[static_cast<long long>(i0 + tid) * H] : 0.f;
    __syncthreads();
    float cb[4][4], dd[4][4];
    pair_dots(Cs, Bs, ldn, N, tr, tc, cb);
    pair_dots(Ys, Xs, ldp, P, tr, tc, dd);
    float g[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = tr + kSub * r, i = i0 + il;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int jl = tc + kSub * k, j = j0 + jl;
        float s = 0.f;
        g[r][k] = 0.f;
        if (j <= i && i < Q && j < Q) {  // skipped, never masked
          const float L = expf(ci[il] - cj[jl]);
          const float e = L * dj[jl];
          s = cb[r][k] * e;
          g[r][k] = dd[r][k] * e;
          tcol[k] += dd[r][k] * cb[r][k] * L;
        }
        Ws[il * kLdS + jl] = s;
      }
    }
    __syncthreads();
    // dx_j += sum_i s_ij dy_i: this thread's key rows tr + 16 r
    for (int ii = 0; ii < in; ++ii) {
      float sv[4], yv[PC];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = Ws[ii * kLdS + tr + kSub * r];
#pragma unroll
      for (int k = 0; k < PC; ++k) yv[k] = Ys[ii * ldp + tc + kSub * k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) adx[r][k] += sv[r] * yv[k];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        Ws[(tr + kSub * r) * kLdS + tc + kSub * k] = g[r][k];
    __syncthreads();
    // dB_j += sum_i G_ij C_i
    for (int ii = 0; ii < in; ++ii) {
      float gv[4], cv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) gv[r] = Ws[ii * kLdS + tr + kSub * r];
#pragma unroll
      for (int k = 0; k < NC; ++k) cv[k] = Cs[ii * ldn + tc + kSub * k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < NC; ++k) adb[r][k] += gv[r] * cv[k];
    }
  }

  // colsum(T): the 16 row groups' partials in order
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) Ws[tr * kLdS + tc + kSub * k] = tcol[k];
  __syncthreads();
  const long long rows = row0 * Q;       // [b, c, 0] of a [B, nc, Q, H]
  if (tid < jn) {
    float colT = 0.f;
    for (int t = 0; t < kSub; ++t) colT += Ws[t * kLdS + tid];
    const float decay = expf(last - cj[tid]);
    const float dw = dwv[tid], w = dj[tid] * decay;
    const long long o = (rows + j0 + tid) * H + h;
    ddt[o] = colT + dw * decay;
    kcol[o] = -dj[tid] * colT - dw * w;
    dww[o] = dw * w;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + tr + kSub * r;
    if (j >= Q) continue;
    const long long o = (rows + j) * H + h;
#pragma unroll
    for (int k = 0; k < PC; ++k) store(dx, o * P + tc + kSub * k, adx[r][k], bf16);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int n = tc + kSub * k;
      if (n < N) store(dB, o * N + n, adb[r][k], bf16);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads) ssd_bwd_query_kernel(
    const void* __restrict__ x, Strides xs, const float* __restrict__ dt,
    Strides ds, const void* __restrict__ Bm, Strides bs,
    const void* __restrict__ Cm, Strides cs, const float* __restrict__ dy,
    const float* __restrict__ cum, void* __restrict__ dC,
    float* __restrict__ rowS, int nc, int Q, int H, int P, int N,
    bool bf16) {
  constexpr int NP = NC * kSub, ldn = NP + 1;
  const int ldp = P + 1;
  extern __shared__ float smem[];
  float* Cs = smem;                  // [kTile][ldn]  C of the query rows
  float* Ys = Cs + kTile * ldn;      // [kTile][ldp]  dy of the query rows
  float* Bs = Ys + kTile * ldp;      // [kTile][ldn]  B of the key rows
  float* Xs = Bs + kTile * ldn;      // [kTile][ldp]  x of the key rows
  float* Ws = Xs + kTile * ldp;      // [kTile][kLdS] G as [i][j]
  float* ci = Ws + kTile * kLdS;     // [kTile]
  float* cj = ci + kTile;            // [kTile]
  float* dj = cj + kTile;            // [kTile]

  const int b = blockIdx.z / nc, c = blockIdx.z - b * nc, h = blockIdx.y;
  const int i0 = blockIdx.x * kTile;
  const int in = min(kTile, Q - i0);
  const int tid = threadIdx.x, tr = tid / kSub, tc = tid % kSub;
  const long long xo = b * xs.b + c * xs.c + h * xs.h;
  const long long bo = b * bs.b + c * bs.c + h * bs.h;
  const long long co = b * cs.b + c * cs.c + h * cs.h;
  const long long row0 = static_cast<long long>(b) * nc + c;
  const long long yo = (row0 * Q * H + h) * P;
  const float* cumc = cum + row0 * Q * H + h;
  const float* dtc = dt + b * ds.b + c * ds.c + h * ds.h;

  stage(Cm, bf16, co, cs.q, i0, in, N, NP, Cs, ldn, tid);
  stage(dy, false, yo, static_cast<long long>(H) * P, i0, in, P, P, Ys, ldp,
        tid);
  if (tid < kTile)
    ci[tid] = tid < in ? cumc[static_cast<long long>(i0 + tid) * H] : 0.f;

  float adc[4][NC], srow[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < NC; ++k) adc[r][k] = 0.f;

  for (int j0 = 0; j0 < i0 + in; j0 += kTile) {
    const int jn = min(kTile, Q - j0);
    __syncthreads();                     // previous tiles consumed
    stage(Bm, bf16, bo, bs.q, j0, jn, N, NP, Bs, ldn, tid);
    stage(x, bf16, xo, xs.q, j0, jn, P, P, Xs, ldp, tid);
    if (tid < kTile) {
      cj[tid] = tid < jn ? cumc[static_cast<long long>(j0 + tid) * H] : 0.f;
      dj[tid] = tid < jn ? dtc[(j0 + tid) * ds.q] : 0.f;
    }
    __syncthreads();
    float cb[4][4], dd[4][4];
    pair_dots(Cs, Bs, ldn, N, tr, tc, cb);
    pair_dots(Ys, Xs, ldp, P, tr, tc, dd);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = tr + kSub * r, i = i0 + il;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int jl = tc + kSub * k, j = j0 + jl;
        float g = 0.f;
        if (j <= i && i < Q) {           // skipped, never masked
          g = dd[r][k] * expf(ci[il] - cj[jl]) * dj[jl];
          srow[r] += g * cb[r][k];
        }
        Ws[il * kLdS + jl] = g;
      }
    }
    __syncthreads();
    // dC_i += sum_j G_ij B_j: this thread's query rows tr + 16 r
    for (int jj = 0; jj < jn; ++jj) {
      float gv[4], bv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) gv[r] = Ws[(tr + kSub * r) * kLdS + jj];
#pragma unroll
      for (int k = 0; k < NC; ++k) bv[k] = Bs[jj * ldn + tc + kSub * k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < NC; ++k) adc[r][k] += gv[r] * bv[k];
    }
  }

  const long long rows = row0 * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + tr + kSub * r;
    const float s = row_sum16(srow[r]);
    if (i >= Q) continue;
    const long long o = (rows + i) * H + h;
    if (tc == 0) rowS[o] = s;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int n = tc + kSub * k;
      if (n < N) store(dC, o * N + n, adc[r][k], bf16);
    }
  }
}

// One block per (b, c, h): dcum_total, its reverse cumsum r, ddt += A r,
// and the partial sum_j dt_j r_j, each sum by one thread in row order.
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_kernel(
    const float* __restrict__ dt, Strides ds, const float* __restrict__ A,
    const float* __restrict__ dcum, const float* __restrict__ rowS,
    const float* __restrict__ kcol, const float* __restrict__ dww,
    float* __restrict__ ddt, float* __restrict__ part, int nc, int Q,
    int H) {
  extern __shared__ float smem[];
  float* v = smem;                   // [Q] dcum_total, then r
  float* u = v + Q;                  // [Q] dw w, then dt
  const int bc = blockIdx.x, h = blockIdx.y;
  const int b = bc / nc, c = bc - b * nc;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(bc) * Q * H + h;
  const float* dtc = dt + b * ds.b + c * ds.c + h * ds.h;
  for (int i = tid; i < Q; i += kThreads) {
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
  for (int i = tid; i < Q; i += kThreads) {
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
__global__ void __launch_bounds__(kThreads) ssd_bwd_da_kernel(
    const float* __restrict__ part, float* __restrict__ dA, int R, int H) {
  __shared__ float red[kThreads];
  const int h = blockIdx.x, tid = threadIdx.x;
  float acc = 0.f;
  for (int r = tid; r < R; r += kThreads)
    acc += part[static_cast<long long>(r) * H + h];
  red[tid] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) dA[h] = red[0];
}

size_t key_smem(int P, int NP) {
  return sizeof(float) * (2 * kTile * (NP + 1) + 2 * kTile * (P + 1) +
                          kTile * kLdS + 4 * kTile);
}

size_t query_smem(int P, int NP) {
  return sizeof(float) * (2 * kTile * (NP + 1) + 2 * kTile * (P + 1) +
                          kTile * kLdS + 3 * kTile);
}

struct Args {
  const void *x, *dt, *A, *Bm, *Cm, *dy, *dstate, *dcum, *cum;
  Strides xs, ds, bs, cs;
  void *dx, *dB, *dC, *ddt, *dA, *scratch;
  int Bsz, nc, Q, H, P, N;
  bool bf16;
};

template <int PC, int NC>
int launch_pairs(const Args& a, cudaStream_t s) {
  constexpr int P = PC * kSub, NP = NC * kSub;
  const size_t kb = key_smem(P, NP), qb = query_smem(P, NP);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_key_kernel<PC, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kb));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_query_kernel<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(qb));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.Bsz) * a.nc * a.Q * a.H;
  float* kcol = static_cast<float*>(a.scratch);
  float* dww = kcol + rows;
  float* rowS = dww + rows;
  const dim3 grid((a.Q + kTile - 1) / kTile, a.H, a.Bsz * a.nc);
  ssd_bwd_key_kernel<PC, NC><<<grid, kThreads, kb, s>>>(
      a.x, a.xs, static_cast<const float*>(a.dt), a.ds, a.Bm, a.bs, a.Cm,
      a.cs, static_cast<const float*>(a.dy),
      static_cast<const float*>(a.dstate), static_cast<const float*>(a.cum),
      a.dx, a.dB, static_cast<float*>(a.ddt), kcol, dww, a.nc, a.Q, a.H, a.N,
      a.bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_query_kernel<NC><<<grid, kThreads, qb, s>>>(
      a.x, a.xs, static_cast<const float*>(a.dt), a.ds, a.Bm, a.bs, a.Cm,
      a.cs, static_cast<const float*>(a.dy), static_cast<const float*>(a.cum),
      a.dC, rowS, a.nc, a.Q, a.H, a.P, a.N, a.bf16);
  return static_cast<int>(cudaGetLastError());
}

template <int PC>
int launch_n(const Args& a, cudaStream_t s) {
  if (a.N <= 16) return launch_pairs<PC, 1>(a, s);
  if (a.N <= 32) return launch_pairs<PC, 2>(a, s);
  if (a.N <= 64) return launch_pairs<PC, 4>(a, s);
  if (a.N <= 128) return launch_pairs<PC, 8>(a, s);
  if (a.N <= 256) return launch_pairs<PC, 16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [Bsz, nc, Q, H, P] with element strides xs*; dt: [Bsz, nc, Q, H] f32
// with strides ds*; A: [H] f32; Bm, Cm: [Bsz, nc, Q, H, N] with strides
// bs*, cs* (the last dim of x, Bm and Cm contiguous); dy [Bsz, nc, Q, H,
// P], dstate [Bsz, nc, H, N, P], dcum and cum [Bsz, nc, Q, H]: contiguous
// f32.  dx [Bsz, nc, Q, H, P], dB and dC [Bsz, nc, Q, H, N]: contiguous in
// x's storage type (`dt_code`, halcone::kF32 / kBF16); ddt [Bsz, nc, Q, H]
// and dA [H]: f32; scratch: 3 Bsz nc Q H + Bsz nc H floats.  P in {16,
// 32, 64, 128}, N in [1, 256]; the wrapper bounds Q to 1024 and Bsz nc to
// 65535.
extern "C" int halcone_ssd_chunk_bwd(
    const void* x, long long xsb, long long xsc, long long xsq,
    long long xsh, const void* dt, long long dsb, long long dsc,
    long long dsq, long long dsh, const void* A, const void* Bm,
    long long bsb, long long bsc, long long bsq, long long bsh,
    const void* Cm, long long csb, long long csc, long long csq,
    long long csh, const void* dy, const void* dstate, const void* dcum,
    const void* cum, void* dx, void* dB, void* dC, void* ddt, void* dA,
    void* scratch, int Bsz, int nc, int Q, int H, int P, int N, int dt_code,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt_code != halcone::kF32 && dt_code != halcone::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,   dt, A,  Bm, Cm, dy, dstate, dcum, cum,
               {xsb, xsc, xsq, xsh}, {dsb, dsc, dsq, dsh},
               {bsb, bsc, bsq, bsh}, {csb, csc, csq, csh},
               dx,  dB, dC, ddt, dA, scratch,
               Bsz, nc, Q,  H,  P,  N,  dt_code == halcone::kBF16};
  int rc;
  switch (P) {
    case 16: rc = launch_n<1>(a, s); break;
    case 32: rc = launch_n<2>(a, s); break;
    case 64: rc = launch_n<4>(a, s); break;
    case 128: rc = launch_n<8>(a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  const long long rows = static_cast<long long>(Bsz) * nc * Q * H;
  float* kcol = static_cast<float*>(scratch);
  float* part = kcol + 3 * rows;
  ssd_bwd_chunk_kernel<<<dim3(Bsz * nc, H), kThreads,
                         2 * Q * sizeof(float), s>>>(
      static_cast<const float*>(dt), a.ds, static_cast<const float*>(A),
      static_cast<const float*>(dcum), kcol + 2 * rows, kcol, kcol + rows,
      static_cast<float*>(ddt), part, nc, Q, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_da_kernel<<<H, kThreads, 0, s>>>(part, static_cast<float*>(dA),
                                            Bsz * nc, H);
  return static_cast<int>(cudaGetLastError());
}
