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
// Bound: bytes.  miss_round: each lane scans its gathered TSU row of C
// ways (C = 1024 by default), a streaming read of 8*C bytes per lane
// against HBM's 3.35 TB/s.  write_grant: each distinct TSU row that some
// lane names is read once (12*C bytes: tag, memts, seq), plus a few
// bytes per lane; on the write pass that is the K = 8 shard rows however
// many lanes (16-64) the round has.  The compares per way are far below
// the card's integer rate; at the path's sizes launch latency dominates.
//
// miss_round design: one warp per lane, 8 lanes per 256-thread block,
// masked tail.  The 32 threads stride over the ways with coalesced loads;
// the first match is the warp minimum of matching indices
// (__reduce_min_sync).  Rows are gathered [N, W] views with explicit row
// strides.
//
// write_grant design: the tables are [K, C] with a row stride (e.g. the
// TSU's set 0 with its trash way sliced off) and `row` names each lane's
// table row; a null `row` means lane i reads row i (the gathered form).
// One block per table row; the row's ways are held in registers, 256
// threads of up to 16 ways each (1024 threads past 4096 ways), and read
// once: every load of the row is issued first, so its round trip
// overlaps the scan of `row`.  That scan collects the lanes naming the
// row into shared memory with their address and lease (256 at a time),
// traps on an index outside [0, K) as a device-side assert, and a block
// with no lane returns (its row's loads were issued, and go unused).
// `full` and the victim take four block reductions, each one barrier and
// one redux.sync a warp: all valid; pmin over p = (empty ? -2^30 :
// memts); the minimum of key = (p == pmin ? seq : 2^30); the first index
// holding it.  The victim is not one packed
// (p, seq, index) key: the cap at 2^30 makes them differ when
// seq >= 2^30.  The collected lanes' addresses fill an open-addressing
// table in shared memory (512 slots, linear probing); every thread looks
// its ways' tags up in it and keeps the first matching way of each
// address by atomicMin, so the search costs a probe or two a way however
// many lanes name the row; one thread a lane then takes that way's memts
// from shared memory for the mm_write grant and the 16-bit overflow
// reinit.  Every lane gets all seven outputs, active or not.  A row past
// 16384 ways (the user sets the TSU's capacity) is walked in tiles of
// 16384 ways, 1024 threads of 16, three times: for `full` and pmin, for
// the victim, and for each 256 lanes' matches; each reduction is carried
// from tile to tile, and a granted way's memts is read from the table.
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

// Minimum of v over the block, returned to every thread; `red` holds
// one int per warp and is not reused by another reduction.
__device__ __forceinline__ int block_min(int v, int* red) {
  const int lane = threadIdx.x & 31;
  v = __reduce_min_sync(kFull, v);
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : INT_MAX;
  return __reduce_min_sync(kFull, v);
}

constexpr int kLaneChunk = 256;     // lanes a block collects at a time
constexpr int kSlots = 2 * kLaneChunk;   // their address table

// A table slot's word: the address with bit 32 set (0 = empty slot).
__device__ __forceinline__ unsigned long long slot_word(int a) {
  return (1ull << 32) | static_cast<unsigned>(a);
}
__device__ __forceinline__ int slot_of(int a) {
  return static_cast<int>((static_cast<unsigned>(a) * 2654435761u) >> 23) &
         (kSlots - 1);
}

// One block of NT threads per table row (see the header), WPT ways a
// thread: way c0 + tid + k * NT is the thread's k-th of the tile at c0.
// A row of at most WPT * NT ways is one tile, held in registers, with its
// C memts in dynamic shared memory.  A longer row (kTiled) is walked in
// tiles of WPT * NT ways, each reduction carried from tile to tile, and
// a granted way's memts is read from the table.
template <int WPT, int NT, bool kTiled>
__global__ void __launch_bounds__(NT) write_grant_kernel(
    const int* __restrict__ ts_tag, int64_t ts_tag_ld,
    const int* __restrict__ ts_mem, int64_t ts_mem_ld,
    const int* __restrict__ ts_seq, int64_t ts_seq_ld,
    const int* __restrict__ row, const int* __restrict__ addr,
    const int* __restrict__ wl,
    bool* __restrict__ th_o, int* __restrict__ way_o,
    bool* __restrict__ full_o, int* __restrict__ wts_o,
    int* __restrict__ rts_o, int* __restrict__ nmem_o,
    bool* __restrict__ ovf_o, int N, int K, int C) {
  extern __shared__ int mems[];
  __shared__ int red[3][NT / 32];
  __shared__ int lane_i[kLaneChunk], lane_w[kLaneChunk], lane_s[kLaneChunk];
  __shared__ unsigned long long slot_key[kSlots];
  __shared__ int slot_way[kSlots];
  __shared__ int n_mine;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  constexpr int nt = NT;
  constexpr int kTile = WPT * NT;

  // the row's ways first, all loads in flight together, so their round
  // trip overlaps the scan of `row`
  const int* tag = ts_tag + b * ts_tag_ld;
  const int* mem = ts_mem + b * ts_mem_ld;
  const int* seq = ts_seq + b * ts_seq_ld;
  int t[WPT], m[WPT], sq[WPT];
  auto load = [&](int c0, bool tags_only) {
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const int j = c0 + tid + k * nt;
      const bool in = j < C;
      t[k] = in ? tag[j] : 0;
      if (!tags_only) {
        m[k] = in ? mem[j] : 0;
        sq[k] = in ? seq[j] : 0;
      }
    }
  };
  load(0, false);

  // the lanes of [base, base + kLaneChunk) that name this row, with their
  // lease and their address's slot in an open-addressing table, into
  // shared memory (lanes with one address share a slot); an index outside
  // [0, K) traps
  const int n_lanes = row != nullptr ? N : 1;
  auto collect = [&](int base) {
    if (tid == 0) n_mine = 0;
    for (int h = tid; h < kSlots; h += nt) {
      slot_key[h] = 0;
      slot_way[h] = INT_MAX;
    }
    __syncthreads();
    const int end = min(n_lanes, base + kLaneChunk);
    for (int i = base + tid; i < end; i += nt) {
      const int li = row != nullptr ? i : b;
      const int r = row != nullptr ? row[i] : b;
      const int a = addr[li];
      const int w = wl[li];
      if (r < 0 || r >= K) __trap();
      if (r == b) {
        const unsigned long long want = slot_word(a);
        int h = slot_of(a);
        for (;;) {
          const unsigned long long old = atomicCAS(&slot_key[h], 0ull, want);
          if (old == 0 || old == want) break;
          h = (h + 1) & (kSlots - 1);
        }
        const int k = atomicAdd(&n_mine, 1);
        lane_i[k] = li;
        lane_w[k] = w;
        lane_s[k] = h;
      }
    }
    __syncthreads();
    return n_mine;
  };
  int n = collect(0);
  if (n == 0 && n_lanes <= kLaneChunk) return;

  // full, pmin over p = where(empty, -2^30, memts), then the victim: the
  // first index of the minimum of key = where(p == pmin, seq, 2^30).
  // Each thread keeps the least (key, way) of its ways, in way order;
  // the block takes the least key, then the first way holding it.
  bool all_valid = true;
  int pmin = INT_MAX;
  for (int c0 = 0;;) {
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const int j = c0 + tid + k * nt;
      if (j < C) {
        if (!kTiled) mems[j] = m[k];
        const bool empty = t[k] == halcone::kInvalid;
        all_valid = all_valid && !empty;
        pmin = min(pmin, empty ? halcone::kNeg : m[k]);
      }
    }
    c0 += kTile;
    if (!kTiled || c0 >= C) break;
    load(c0, false);
  }
  const bool full = __syncthreads_and(all_valid);
  pmin = block_min(pmin, red[0]);
  int kmin = INT_MAX, first = INT_MAX;
  if (kTiled) load(0, false);
  for (int c0 = 0;;) {
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const int j = c0 + tid + k * nt;
      const int p = t[k] == halcone::kInvalid ? halcone::kNeg : m[k];
      const int key = p == pmin ? sq[k] : halcone::kSeqCap;
      if (j < C && key < kmin) {
        kmin = key;
        first = j;
      }
    }
    c0 += kTile;
    if (!kTiled || c0 >= C) break;
    load(c0, false);
  }
  const int kblock = block_min(kmin, red[1]);
  const int victim = block_min(kmin == kblock ? first : INT_MAX, red[2]);

  // every way looks its tag up in the address table (the first matching
  // way is the least index, by atomicMin), then one thread a lane grants:
  // mm_write + 16-bit overflow reinit
  for (int base = 0;;) {
    if (kTiled) load(0, true);
    for (int c0 = 0;;) {
#pragma unroll
      for (int k = 0; k < WPT; ++k) {
        const int j = c0 + tid + k * nt;
        if (j >= C) continue;
        const unsigned long long want = slot_word(t[k]);
        for (int h = slot_of(t[k]);; h = (h + 1) & (kSlots - 1)) {
          const unsigned long long sk = slot_key[h];
          if (sk == want) atomicMin(&slot_way[h], j);
          if (sk == want || sk == 0) break;
        }
      }
      c0 += kTile;
      if (!kTiled || c0 >= C) break;
      load(c0, true);
    }
    __syncthreads();
    for (int k = tid; k < n; k += nt) {
      const int li = lane_i[k];
      const int way = slot_way[lane_s[k]];
      const bool th = way != INT_MAX;
      const int memts = th ? (kTiled ? mem[way] : mems[way]) : 0;
      const int w = lane_w[k];
      int wts = add32(memts, 1);
      int rts = add32(memts, w);
      int nmem = rts;
      const bool ovf = nmem > halcone::kTsMax;
      if (ovf) {
        wts = 0;
        rts = w;
        nmem = w;
      }
      th_o[li] = th;
      way_o[li] = th ? way : victim;
      full_o[li] = full;
      wts_o[li] = wts;
      rts_o[li] = rts;
      nmem_o[li] = nmem;
      ovf_o[li] = ovf;
    }
    base += kLaneChunk;
    if (base >= n_lanes) break;
    __syncthreads();   // the table and lists are refilled
    n = collect(base);
  }
}

template <int WPT, int NT, bool kTiled = false>
int launch_write_grant(const int* const* p, const int64_t* ld, void* const* o,
                       int N, int K, int C, cudaStream_t stream) {
  const size_t smem = kTiled ? 0 : sizeof(int) * static_cast<size_t>(C);
  if (smem > 40 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        write_grant_kernel<WPT, NT, kTiled>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  write_grant_kernel<WPT, NT, kTiled><<<p[3] != nullptr ? K : N, NT, smem,
                                        stream>>>(
      p[0], ld[0], p[1], ld[1], p[2], ld[2], p[3], p[4], p[5],
      static_cast<bool*>(o[0]), static_cast<int*>(o[1]),
      static_cast<bool*>(o[2]), static_cast<int*>(o[3]),
      static_cast<int*>(o[4]), static_cast<int*>(o[5]),
      static_cast<bool*>(o[6]), N, K, C);
  return static_cast<int>(cudaGetLastError());
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

// Tables [K, C] with row strides; `row` [N] names each lane's table row,
// or is null for the gathered form (K == N, lane i reads row i).  A row
// is 256 threads of up to 16 ways each (C <= 4096), or 1024 threads
// (C <= 16384); a longer row is walked in tiles of 16384 ways.
extern "C" int halcone_write_grant(
    const void* ts_tag, long long ts_tag_ld, const void* ts_mem,
    long long ts_mem_ld, const void* ts_seq, long long ts_seq_ld,
    const void* row, const void* addr, const void* wl, void* th, void* way,
    void* full, void* wts, void* rts, void* nmem, void* ovf, int N, int K,
    int C, void* stream) {
  const int* p[6] = {static_cast<const int*>(ts_tag),
                     static_cast<const int*>(ts_mem),
                     static_cast<const int*>(ts_seq),
                     static_cast<const int*>(row),
                     static_cast<const int*>(addr),
                     static_cast<const int*>(wl)};
  const int64_t ld[3] = {ts_tag_ld, ts_mem_ld, ts_seq_ld};
  void* const o[7] = {th, way, full, wts, rts, nmem, ovf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 256) return launch_write_grant<1, 256>(p, ld, o, N, K, C, s);
  if (C <= 512) return launch_write_grant<2, 256>(p, ld, o, N, K, C, s);
  if (C <= 1024) return launch_write_grant<4, 256>(p, ld, o, N, K, C, s);
  if (C <= 2048) return launch_write_grant<8, 256>(p, ld, o, N, K, C, s);
  if (C <= 4096) return launch_write_grant<16, 256>(p, ld, o, N, K, C, s);
  if (C <= 16384) return launch_write_grant<16, 1024>(p, ld, o, N, K, C, s);
  return launch_write_grant<16, 1024, true>(p, ld, o, N, K, C, s);
}
