// HALCONE fused miss/write round kernels on Hopper (sm_90a).
//
// miss_round replaces repro/kernels/tier_pass.py::_miss_round_kernel
// (pallas_call at tier_pass.py:204): replica probe -> shared probe -> TSU
// read grant (Algorithm 3 + the 16-bit reinit at TS_MAX) -> install at the
// shared tier -> install at the replica, per request lane.
//
// write_grant replaces repro/kernels/tier_pass.py::_write_grant_kernel
// (pallas_call at tier_pass.py:241): TSU probe, the lexicographic victim
// (empty ways first, else min memts, then min allocation seq, then first
// index), `full`, and the mm_write grant + reinit.
//
// Bound: bytes.  Each lane scans its gathered TSU row of C ways (C = 1024
// by default) once, so the work is a streaming read of 8*C (miss_round:
// tag + memts) or 12*C (write_grant: tag + memts + seq) bytes per lane
// against HBM's 3.35 TB/s; the few compares per way are far below the
// card's integer rate.
//
// Design: one warp per lane, 8 lanes per 256-thread block, masked tail.
// The 32 threads stride over the ways with coalesced loads; the first
// match is the warp minimum of matching indices (__reduce_min_sync).  The
// write_grant victim is argmin(where(p == pmin, seq, 2^30)) with
// p = (empty ? -2^30 : memts), taken as the warp-lexicographic minimum of
// (key, index) in a second pass over the row (the row is then in L1/L2),
// which keeps the reference's first-index tie rule even when every way is
// empty.  Rows are gathered [N, W] views with explicit row strides.
#include "halcone.cuh"

namespace {

using halcone::add32;
using halcone::kFull;
using halcone::warp_first_match;

constexpr int kThreads = 256;
constexpr int kLanesPerBlock = kThreads / 32;

__global__ void miss_round_kernel(
    const int* __restrict__ rp_tag, int64_t rp_tag_ld,
    const int* __restrict__ rp_rts, int64_t rp_rts_ld,
    const int* __restrict__ sh_tag, int64_t sh_tag_ld,
    const int* __restrict__ sh_rts, int64_t sh_rts_ld,
    const int* __restrict__ sh_wts, int64_t sh_wts_ld,
    const int* __restrict__ ts_tag, int64_t ts_tag_ld,
    const int* __restrict__ ts_mem, int64_t ts_mem_ld,
    const int* __restrict__ cts1, const int* __restrict__ cts2,
    const int* __restrict__ addr, const int* __restrict__ act,
    const int* __restrict__ rd,
    bool* __restrict__ th1_o, bool* __restrict__ h1_o,
    int* __restrict__ way1_o, bool* __restrict__ th2_o,
    bool* __restrict__ h2_o, int* __restrict__ way2_o,
    bool* __restrict__ fnd_o, int* __restrict__ tway_o,
    int* __restrict__ mwts_o, int* __restrict__ mrts_o,
    int* __restrict__ nmem_o, bool* __restrict__ ovf_o,
    int* __restrict__ nwa_o, int* __restrict__ nra_o,
    int* __restrict__ nw1_o, int* __restrict__ nr1_o,
    int N, int W1, int W2, int C) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kLanesPerBlock + (threadIdx.x >> 5);
  if (i >= N) return;  // warp-uniform
  const int a = addr[i];
  const int m1 = warp_first_match(rp_tag + i * rp_tag_ld, W1, a, lane);
  const int m2 = warp_first_match(sh_tag + i * sh_tag_ld, W2, a, lane);
  const int mt = warp_first_match(ts_tag + i * ts_tag_ld, C, a, lane);
  if (lane != 0) return;

  // replica probe (first-match way + protocol.valid), act-masked
  const bool act_i = act[i] != 0;
  bool th1 = m1 != INT_MAX;
  const int rts1 = th1 ? rp_rts[i * rp_rts_ld + m1] : 0;
  bool h1 = th1 && (cts1[i] <= rts1);
  th1 = th1 && act_i;
  h1 = h1 && act_i;
  const bool miss = act_i && !h1;

  // shared probe, meaningful only on a replica miss
  bool th2 = m2 != INT_MAX;
  const int rts2 = th2 ? sh_rts[i * sh_rts_ld + m2] : 0;
  const int wts2 = th2 ? sh_wts[i * sh_wts_ld + m2] : 0;
  const int c2 = cts2[i];
  bool h2 = th2 && (c2 <= rts2);
  th2 = th2 && miss;
  h2 = h2 && miss;
  const bool need = miss && !h2;

  // TSU read grant: protocol.mm_read + 16-bit overflow reinit
  const bool tht = mt != INT_MAX;
  const int memts = tht ? ts_mem[i * ts_mem_ld + mt] : 0;
  const int r = rd[i];
  int mwts = memts;
  int mrts = add32(memts, r);
  int nmem = mrts;
  const bool ovf = nmem > halcone::kTsMax;
  if (ovf) {
    mwts = 0;
    mrts = r;
    nmem = r;
  }
  const bool fnd = need && tht;

  // response chain: install at the shared tier, then at the replica
  const int nwa = max(c2, mwts);
  const int nra = max(add32(nwa, 1), mrts);
  const int rwts = h2 ? wts2 : nwa;
  const int rrts = h2 ? rts2 : nra;
  const int nw1 = max(cts1[i], rwts);
  const int nr1 = max(add32(nw1, 1), rrts);

  th1_o[i] = th1;
  h1_o[i] = h1;
  way1_o[i] = m1 != INT_MAX ? m1 : 0;
  th2_o[i] = th2;
  h2_o[i] = h2;
  way2_o[i] = m2 != INT_MAX ? m2 : 0;
  fnd_o[i] = fnd;
  tway_o[i] = tht ? mt : 0;
  mwts_o[i] = mwts;
  mrts_o[i] = mrts;
  nmem_o[i] = nmem;
  ovf_o[i] = fnd && ovf;
  nwa_o[i] = nwa;
  nra_o[i] = nra;
  nw1_o[i] = nw1;
  nr1_o[i] = nr1;
}

__global__ void write_grant_kernel(
    const int* __restrict__ ts_tag, int64_t ts_tag_ld,
    const int* __restrict__ ts_mem, int64_t ts_mem_ld,
    const int* __restrict__ ts_seq, int64_t ts_seq_ld,
    const int* __restrict__ addr, const int* __restrict__ wl,
    bool* __restrict__ th_o, int* __restrict__ way_o,
    bool* __restrict__ full_o, int* __restrict__ wts_o,
    int* __restrict__ rts_o, int* __restrict__ nmem_o,
    bool* __restrict__ ovf_o, int N, int C) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kLanesPerBlock + (threadIdx.x >> 5);
  if (i >= N) return;  // warp-uniform
  const int a = addr[i];
  const int* tag = ts_tag + i * ts_tag_ld;
  const int* mem = ts_mem + i * ts_mem_ld;
  const int* seq = ts_seq + i * ts_seq_ld;

  // pass 1: first match, every way allocated, min victim score p
  int m = INT_MAX;
  int pmin = INT_MAX;
  bool all_valid = true;
  for (int j = lane; j < C; j += 32) {
    const int t = tag[j];
    if (t == a && m == INT_MAX) m = j;
    const bool empty = t == halcone::kInvalid;
    all_valid = all_valid && !empty;
    pmin = min(pmin, empty ? halcone::kNeg : mem[j]);
  }
  m = __reduce_min_sync(kFull, m);
  pmin = __reduce_min_sync(kFull, pmin);
  const bool full = __all_sync(kFull, all_valid);

  // pass 2: victim = first index of the min key where(p == pmin, seq, 2^30)
  int bs = INT_MAX;
  int bi = INT_MAX;
  for (int j = lane; j < C; j += 32) {
    const int t = tag[j];
    const int p = t == halcone::kInvalid ? halcone::kNeg : mem[j];
    const int s = p == pmin ? seq[j] : halcone::kSeqCap;
    if (bi == INT_MAX || s < bs) {
      bs = s;
      bi = j;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int os = __shfl_xor_sync(kFull, bs, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    if (os < bs || (os == bs && oi < bi)) {
      bs = os;
      bi = oi;
    }
  }
  if (lane != 0) return;

  // mm_write grant + 16-bit overflow reinit
  const bool th = m != INT_MAX;
  const int memts = th ? mem[m] : 0;
  const int w = wl[i];
  int wts = add32(memts, 1);
  int rts = add32(memts, w);
  int nmem = rts;
  const bool ovf = nmem > halcone::kTsMax;
  if (ovf) {
    wts = 0;
    rts = w;
    nmem = w;
  }
  th_o[i] = th;
  way_o[i] = th ? m : bi;
  full_o[i] = full;
  wts_o[i] = wts;
  rts_o[i] = rts;
  nmem_o[i] = nmem;
  ovf_o[i] = ovf;
}

inline int blocks_for(int N) {
  return (N + kLanesPerBlock - 1) / kLanesPerBlock;
}

}  // namespace

extern "C" int halcone_miss_round(
    const void* rp_tag, long long rp_tag_ld, const void* rp_rts,
    long long rp_rts_ld, const void* sh_tag, long long sh_tag_ld,
    const void* sh_rts, long long sh_rts_ld, const void* sh_wts,
    long long sh_wts_ld, const void* ts_tag, long long ts_tag_ld,
    const void* ts_mem, long long ts_mem_ld, const void* cts1,
    const void* cts2, const void* addr, const void* act, const void* rd,
    void* th1, void* h1, void* way1, void* th2, void* h2, void* way2,
    void* fnd, void* tway, void* mwts, void* mrts, void* nmem, void* ovf,
    void* nwa, void* nra, void* nw1, void* nr1, int N, int W1, int W2,
    int C, void* stream) {
  using I = const int*;
  miss_round_kernel<<<blocks_for(N), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<I>(rp_tag), rp_tag_ld, static_cast<I>(rp_rts), rp_rts_ld,
      static_cast<I>(sh_tag), sh_tag_ld, static_cast<I>(sh_rts), sh_rts_ld,
      static_cast<I>(sh_wts), sh_wts_ld, static_cast<I>(ts_tag), ts_tag_ld,
      static_cast<I>(ts_mem), ts_mem_ld, static_cast<I>(cts1),
      static_cast<I>(cts2), static_cast<I>(addr), static_cast<I>(act),
      static_cast<I>(rd), static_cast<bool*>(th1), static_cast<bool*>(h1),
      static_cast<int*>(way1), static_cast<bool*>(th2),
      static_cast<bool*>(h2), static_cast<int*>(way2),
      static_cast<bool*>(fnd), static_cast<int*>(tway),
      static_cast<int*>(mwts), static_cast<int*>(mrts),
      static_cast<int*>(nmem), static_cast<bool*>(ovf),
      static_cast<int*>(nwa), static_cast<int*>(nra),
      static_cast<int*>(nw1), static_cast<int*>(nr1), N, W1, W2, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int halcone_write_grant(
    const void* ts_tag, long long ts_tag_ld, const void* ts_mem,
    long long ts_mem_ld, const void* ts_seq, long long ts_seq_ld,
    const void* addr, const void* wl, void* th, void* way, void* full,
    void* wts, void* rts, void* nmem, void* ovf, int N, int C,
    void* stream) {
  using I = const int*;
  write_grant_kernel<<<blocks_for(N), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<I>(ts_tag), ts_tag_ld, static_cast<I>(ts_mem), ts_mem_ld,
      static_cast<I>(ts_seq), ts_seq_ld, static_cast<I>(addr),
      static_cast<I>(wl), static_cast<bool*>(th), static_cast<int*>(way),
      static_cast<bool*>(full), static_cast<int*>(wts),
      static_cast<int*>(rts), static_cast<int*>(nmem),
      static_cast<bool*>(ovf), N, C);
  return static_cast<int>(cudaGetLastError());
}
