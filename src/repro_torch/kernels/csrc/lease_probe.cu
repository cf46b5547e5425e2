// HALCONE lease probe on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/lease_probe.py::_probe_kernel
// (pallas_call at lease_probe.py:81): first-match tag compare over a set
// row, lease validity cts <= rts, and the Algorithm 1/2 install
// bwts = max(cts, mwts), brts = max(bwts + 1, mrts), new_cts = max(cts, bwts).
//
// Bound: bytes.  A lane reads 2W + 4 int32 and writes 5 int32 and 2 bools,
// with no reuse, so the least time is the bytes over HBM's 3.35 TB/s; at
// the serving path's lane counts (1 .. a few thousand) launch latency
// dominates instead.
//
// Design: one thread per lane, blocks of 256 threads and a masked tail
// (N may be 1 on the op scan).  The way loop is short (W <= 8 in the
// repo's geometries) and stops at the first match, which is exactly the
// reference's `eq & (cumsum(eq) == 1)`; way and row_rts are 0 when no way
// matches.  Rows may be strided views (the gathered set rows with the
// trailing trash way sliced off), so each matrix comes with its row stride.
#include "halcone.cuh"

namespace {

__global__ void lease_probe_kernel(
    const int* __restrict__ tag, int64_t tag_ld,
    const int* __restrict__ rts, int64_t rts_ld,
    const int* __restrict__ cts, const int* __restrict__ addr,
    const int* __restrict__ mwts, const int* __restrict__ mrts,
    bool* __restrict__ tag_hit, bool* __restrict__ hit,
    int* __restrict__ way, int* __restrict__ row_rts,
    int* __restrict__ nwts, int* __restrict__ nrts, int* __restrict__ ncts,
    int N, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int a = addr[i];
  const int* t = tag + static_cast<int64_t>(i) * tag_ld;
  int w = -1;
  for (int j = 0; j < W; ++j) {
    if (t[j] == a) {
      w = j;
      break;
    }
  }
  const bool th = w >= 0;
  const int rr = th ? rts[static_cast<int64_t>(i) * rts_ld + w] : 0;
  const int c = cts[i];
  const int bw = max(c, mwts[i]);
  const int br = max(halcone::add32(bw, 1), mrts[i]);
  tag_hit[i] = th;
  hit[i] = th && (c <= rr);
  way[i] = th ? w : 0;
  row_rts[i] = rr;
  nwts[i] = bw;
  nrts[i] = br;
  ncts[i] = max(c, bw);
}

}  // namespace

extern "C" int halcone_lease_probe(
    const void* tag, long long tag_ld, const void* rts, long long rts_ld,
    const void* cts, const void* addr, const void* mwts, const void* mrts,
    void* tag_hit, void* hit, void* way, void* row_rts, void* nwts,
    void* nrts, void* ncts, int N, int W, void* stream) {
  constexpr int kThreads = 256;
  const int blocks = (N + kThreads - 1) / kThreads;
  lease_probe_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tag), tag_ld, static_cast<const int*>(rts),
      rts_ld, static_cast<const int*>(cts), static_cast<const int*>(addr),
      static_cast<const int*>(mwts), static_cast<const int*>(mrts),
      static_cast<bool*>(tag_hit), static_cast<bool*>(hit),
      static_cast<int*>(way), static_cast<int*>(row_rts),
      static_cast<int*>(nwts), static_cast<int*>(nrts),
      static_cast<int*>(ncts), N, W);
  return static_cast<int>(cudaGetLastError());
}
