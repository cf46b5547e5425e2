// HALCONE lease probe on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/lease_probe.py::_probe_kernel
// (pallas_call at lease_probe.py:81): first-match tag compare over a set
// row, lease validity cts <= rts, and the Algorithm 1/2 install
// bwts = max(cts, mwts), brts = max(bwts + 1, mrts), new_cts = max(cts, bwts).
//
// Bound: bytes.  A lane reads its set row's tags up to the first match
// (all W on a miss), one rts on a hit and its address, clock and grant,
// and writes 5 int32 and 2 bools, with no reuse; at the serving path's
// lane counts (1 .. a few thousand) the launch itself costs more.
//
// Design: one thread per lane, blocks of 256 threads and a masked tail
// (N may be 1 on the op scan).  The tier's tables are read in place:
// `tag` and `rts` are [K, W] with a row stride (a tier's sets with the
// trailing trash way sliced off: a stride of W + 1 ints, not a whole 16
// bytes, so each way is a 4-byte load) and `row` names each lane's set,
// trapping on one outside [0, K); a null `row` is the gathered form, lane
// i on row i.  `cts` is per lane or one clock for every lane (cts_step 0:
// a tier's replica clock), and a null mwts / mrts reads as 0, so the
// caller gathers, fills and allocates nothing before the launch.  The
// set is short (W <= 8 in the repo's geometries) and all its ways are
// loaded at once (halcone::first_way); the first match is exactly the
// reference's `eq & (cumsum(eq) == 1)`; way and row_rts are 0 when no way
// matches.
#include "halcone.cuh"

namespace {

__global__ void lease_probe_kernel(
    const int* __restrict__ tag, int64_t tag_ld,
    const int* __restrict__ rts, int64_t rts_ld,
    const int* __restrict__ row, int K,
    const int* __restrict__ cts, int cts_step,
    const int* __restrict__ addr,
    const int* __restrict__ mwts, const int* __restrict__ mrts,
    bool* __restrict__ tag_hit, bool* __restrict__ hit,
    int* __restrict__ way, int* __restrict__ row_rts,
    int* __restrict__ nwts, int* __restrict__ nrts, int* __restrict__ ncts,
    int N, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  // the lane's own words first, all in flight with its row index
  const int a = addr[i];
  const int c = cts[cts_step * i];
  const int mw = mwts != nullptr ? mwts[i] : 0;
  const int mr = mrts != nullptr ? mrts[i] : 0;
  const int r = row != nullptr ? row[i] : i;
  if (r < 0 || r >= K) __trap();
  const int w = halcone::first_way(tag + static_cast<int64_t>(r) * tag_ld,
                                   W, a);
  const bool th = w >= 0;
  const int rr = th ? rts[static_cast<int64_t>(r) * rts_ld + w] : 0;
  const int bw = max(c, mw);
  const int br = max(halcone::add32(bw, 1), mr);
  tag_hit[i] = th;
  hit[i] = th && (c <= rr);
  way[i] = th ? w : 0;
  row_rts[i] = rr;
  nwts[i] = bw;
  nrts[i] = br;
  ncts[i] = max(c, bw);
}

}  // namespace

// tag/rts: [K, W] with row strides; row: [N] or null (K == N, lane i on
// row i); cts: [N] (cts_step 1) or [1] (cts_step 0); mwts/mrts: [N] or
// null for 0.
extern "C" int halcone_lease_probe(
    const void* tag, long long tag_ld, const void* rts, long long rts_ld,
    const void* row, int K, const void* cts, int cts_step, const void* addr,
    const void* mwts, const void* mrts, void* tag_hit, void* hit, void* way,
    void* row_rts, void* nwts, void* nrts, void* ncts, int N, int W,
    void* stream) {
  constexpr int kThreads = 256;
  const int blocks = (N + kThreads - 1) / kThreads;
  lease_probe_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tag), tag_ld, static_cast<const int*>(rts),
      rts_ld, static_cast<const int*>(row), K, static_cast<const int*>(cts),
      cts_step, static_cast<const int*>(addr),
      static_cast<const int*>(mwts), static_cast<const int*>(mrts),
      static_cast<bool*>(tag_hit), static_cast<bool*>(hit),
      static_cast<int*>(way), static_cast<int*>(row_rts),
      static_cast<int*>(nwts), static_cast<int*>(nrts),
      static_cast<int*>(ncts), N, W);
  return static_cast<int>(cudaGetLastError());
}
