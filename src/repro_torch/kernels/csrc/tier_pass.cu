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
// Bound: bytes.  miss_round: each distinct TSU row that some lane names
// is read once (its C tags, 4*C bytes), plus per lane its replica and
// shared set rows up to the first match, the matched ways' clocks, one
// memts on a TSU hit, its row indexes, address and flags and the 16
// outputs.  write_grant: each distinct TSU row that some lane names is
// read once (12*C bytes: tag, memts, seq), plus a few bytes per lane; on
// the read and write passes that is the K = 8 shard rows however many
// lanes (16-64) the round has.  The compares per way are far below the
// card's integer rate; at the path's sizes launch latency dominates.
//
// miss_round design: the tiers' tables are read in place, as write_grant
// reads the TSU's: replica [K1, W1], shared [K2, W2] and TSU [KT, C]
// tables with row strides (each tier's sets with the trailing trash way
// sliced off: rows of W + 1 or C + 1 ints, not whole 16 bytes, so every
// load is 4 bytes wide, coalesced across the block), and row1 / row2 /
// rowt naming each lane's rows, or null for the gathered form (lane i on
// row i of each).  One block of 256 threads per TSU row, as write_grant,
// and per 256 lanes (a warm-up read of 8192 keys makes 32 blocks a row,
// not 32 passes of one block): the row's tags are held in registers
// (each way is read by one thread only, so there is nothing to share
// through shared memory), every load issued before the scan of its 256
// entries of rowt, which collects the lanes naming the row into an
// open-addressing table of their addresses.
// The thread that collects a lane probes its replica and shared sets at
// once (W <= 8: one thread a lane), writes those six outputs and stashes
// what the grant needs.  Every way then looks its tag up in the table
// (a probe or two a way, in place of a C-way scan per lane), the first
// matching way of each address kept by atomicMin; one thread a lane reads
// memts for its matched way only and finishes the Algorithm 3 grant, the
// 16-bit reinit and the install chain.  cts1 / cts2 may be one clock for
// every lane, act bool or int32, rd one value for every lane, so the
// caller gathers, fills and casts nothing before the launch.  A row past
// 1024 ways is walked in tiles of 2048; an index outside its table traps.
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
using halcone::first_way;
using halcone::kFull;

constexpr int kThreads = 256;

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

// The miss pass's per-lane values, stashed in shared memory by the lane's
// collector until its TSU way is known.
struct MissLane {
  int lane, slot, flags, wts2, rts2, c1, c2, rd;
};
constexpr int kNeed = 1, kHit2 = 2;
static_assert(kLaneChunk == kThreads, "miss_round: one lane a thread");

// One block of kThreads per (TSU table row, kLaneChunk lanes), WPT ways a
// thread per tile: way c0 + tid + k * kThreads is the thread's k-th of
// the tile at c0.  A row of at most WPT * kThreads ways is one tile, held
// in registers; a longer row is walked tile by tile.
template <int WPT>
__global__ void __launch_bounds__(kThreads) miss_round_kernel(
    const int* __restrict__ rp_tag, int64_t rp_tag_ld,
    const int* __restrict__ rp_rts, int64_t rp_rts_ld,
    const int* __restrict__ sh_tag, int64_t sh_tag_ld,
    const int* __restrict__ sh_rts, int64_t sh_rts_ld,
    const int* __restrict__ sh_wts, int64_t sh_wts_ld,
    const int* __restrict__ ts_tag, int64_t ts_tag_ld,
    const int* __restrict__ ts_mem, int64_t ts_mem_ld,
    const int* __restrict__ row1, const int* __restrict__ row2,
    const int* __restrict__ rowt, int K1, int K2, int KT,
    const int* __restrict__ cts1, int cts1_step,
    const int* __restrict__ cts2, int cts2_step,
    const int* __restrict__ addr, const void* __restrict__ act, int act_bool,
    const int* __restrict__ rd, int rd_value,
    bool* __restrict__ th1_o, bool* __restrict__ h1_o,
    int* __restrict__ way1_o, bool* __restrict__ th2_o,
    bool* __restrict__ h2_o, int* __restrict__ way2_o,
    bool* __restrict__ fnd_o, int* __restrict__ tway_o,
    int* __restrict__ mwts_o, int* __restrict__ mrts_o,
    int* __restrict__ nmem_o, bool* __restrict__ ovf_o,
    int* __restrict__ nwa_o, int* __restrict__ nra_o,
    int* __restrict__ nw1_o, int* __restrict__ nr1_o,
    int N, int W1, int W2, int C) {
  __shared__ MissLane lanes[kLaneChunk];
  __shared__ unsigned long long slot_key[kSlots];
  __shared__ int slot_way[kSlots];
  __shared__ int n_mine;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  constexpr int kTile = WPT * kThreads;

  // the row's first tile of tags, every load in flight before the scan of
  // the lanes below, whose round trips they overlap
  const int* tag = ts_tag + b * ts_tag_ld;
  int t[WPT];
  auto load = [&](int c0) {
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const int j = c0 + tid + k * kThreads;
      t[k] = j < C ? tag[j] : 0;
    }
  };
  load(0);

  // this block's lanes (kLaneChunk from blockIdx.y on; one in the
  // gathered form, lane b) that name its TSU row:
  // each goes into the address table (lanes with one address share a
  // slot), and its collector probes the replica and shared tiers in place
  // at once, writes those six outputs and stashes what the TSU grant
  // needs.  A row index outside its table traps.
  if (tid == 0) n_mine = 0;
  for (int h = tid; h < kSlots; h += kThreads) {
    slot_key[h] = 0;
    slot_way[h] = INT_MAX;
  }
  __syncthreads();
  const int i = blockIdx.y * kLaneChunk + tid;   // one lane a thread
  const int li = rowt != nullptr ? i : b;
  int r = -1;
  if (rowt != nullptr ? i < N : tid == 0) {
    r = rowt != nullptr ? rowt[i] : b;
    if (r < 0 || r >= KT) __trap();
  }
  if (r == b) {
    // the lane's own words, all in flight together
    const int a = addr[li];
    const int r1 = row1 != nullptr ? row1[li] : li;
    const int r2 = row2 != nullptr ? row2[li] : li;
    const bool act_i = act_bool ? static_cast<const bool*>(act)[li]
                                : static_cast<const int*>(act)[li] != 0;
    const int c1 = cts1[cts1_step * li];
    const int c2 = cts2[cts2_step * li];
    const int rdv = rd != nullptr ? rd[li] : rd_value;
    if (r1 < 0 || r1 >= K1 || r2 < 0 || r2 >= K2) __trap();
    const unsigned long long want = slot_word(a);
    int h = slot_of(a);
    for (;;) {
      const unsigned long long old = atomicCAS(&slot_key[h], 0ull, want);
      if (old == 0 || old == want) break;
      h = (h + 1) & (kSlots - 1);
    }
    // replica probe (first-match way + protocol.valid), act-masked
    const int m1 = first_way(rp_tag + r1 * rp_tag_ld, W1, a);
    const int rts1 = m1 >= 0 ? rp_rts[r1 * rp_rts_ld + m1] : 0;
    const bool th1 = m1 >= 0 && act_i;
    const bool h1 = th1 && c1 <= rts1;
    const bool miss = act_i && !h1;
    // shared probe, meaningful only on a replica miss
    const int m2 = first_way(sh_tag + r2 * sh_tag_ld, W2, a);
    const int rts2 = m2 >= 0 ? sh_rts[r2 * sh_rts_ld + m2] : 0;
    const int wts2 = m2 >= 0 ? sh_wts[r2 * sh_wts_ld + m2] : 0;
    const bool th2 = m2 >= 0 && miss;
    const bool h2 = th2 && c2 <= rts2;
    th1_o[li] = th1;
    h1_o[li] = h1;
    way1_o[li] = max(m1, 0);
    th2_o[li] = th2;
    h2_o[li] = h2;
    way2_o[li] = max(m2, 0);
    const int k = atomicAdd(&n_mine, 1);
    lanes[k] = MissLane{li, h, (miss && !h2 ? kNeed : 0) | (h2 ? kHit2 : 0),
                        wts2, rts2, c1, c2, rdv};
  }
  __syncthreads();
  const int n = n_mine;
  if (n == 0) return;

  // every way looks its tag up in the address table and keeps the first
  // matching way of each address (atomicMin)
  for (int c0 = 0; c0 < C; c0 += kTile) {
    if (c0 > 0) load(c0);
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const int j = c0 + tid + k * kThreads;
      if (j >= C) continue;
      const unsigned long long want = slot_word(t[k]);
      for (int h = slot_of(t[k]);; h = (h + 1) & (kSlots - 1)) {
        const unsigned long long sk = slot_key[h];
        if (sk == want) atomicMin(&slot_way[h], j);
        if (sk == want || sk == 0) break;
      }
    }
  }
  __syncthreads();
  // one thread a lane: the matched way's memts (the only one read), the
  // Algorithm 3 read grant with the 16-bit reinit, then the response
  // chain: install at the shared tier, then at the replica
  if (tid < n) {
    const MissLane l = lanes[tid];
    const int way = slot_way[l.slot];
    const bool tht = way != INT_MAX;
    const int memts = tht ? ts_mem[b * ts_mem_ld + way] : 0;
    int mwts = memts;
    int mrts = add32(memts, l.rd);
    int nmem = mrts;
    const bool ovf = nmem > halcone::kTsMax;
    if (ovf) {
      mwts = 0;
      mrts = l.rd;
      nmem = l.rd;
    }
    const bool fnd = (l.flags & kNeed) && tht;
    const bool h2 = l.flags & kHit2;
    const int nwa = max(l.c2, mwts);
    const int nra = max(add32(nwa, 1), mrts);
    const int nw1 = max(l.c1, h2 ? l.wts2 : nwa);
    const int nr1 = max(add32(nw1, 1), h2 ? l.rts2 : nra);
    fnd_o[l.lane] = fnd;
    tway_o[l.lane] = tht ? way : 0;
    mwts_o[l.lane] = mwts;
    mrts_o[l.lane] = mrts;
    nmem_o[l.lane] = nmem;
    ovf_o[l.lane] = fnd && ovf;
    nwa_o[l.lane] = nwa;
    nra_o[l.lane] = nra;
    nw1_o[l.lane] = nw1;
    nr1_o[l.lane] = nr1;
  }
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

}  // namespace

// Tables with row strides: replica [K1, W1], shared [K2, W2], TSU [KT, C];
// row1/row2/rowt [N] name each lane's rows, or are all null for the
// gathered form (every K == N, lane i on row i).  cts1/cts2 are [N]
// (step 1) or [1] (step 0); act is bool (act_bool) or int32; rd is [N],
// or null for rd_value.  One block per TSU row and 256 lanes (one per
// lane in the gathered form); a row of at most 1024 ways is held in
// registers, a longer one walked in tiles of 2048.
extern "C" int halcone_miss_round(
    const void* rp_tag, long long rp_tag_ld, const void* rp_rts,
    long long rp_rts_ld, const void* sh_tag, long long sh_tag_ld,
    const void* sh_rts, long long sh_rts_ld, const void* sh_wts,
    long long sh_wts_ld, const void* ts_tag, long long ts_tag_ld,
    const void* ts_mem, long long ts_mem_ld, const void* row1,
    const void* row2, const void* rowt, int K1, int K2, int KT,
    const void* cts1, int cts1_step, const void* cts2, int cts2_step,
    const void* addr, const void* act, int act_bool, const void* rd,
    int rd_value, void* th1, void* h1, void* way1, void* th2, void* h2,
    void* way2, void* fnd, void* tway, void* mwts, void* mrts, void* nmem,
    void* ovf, void* nwa, void* nra, void* nw1, void* nr1, int N, int W1,
    int W2, int C, void* stream) {
  using I = const int*;
  const dim3 grid = rowt != nullptr
      ? dim3(KT, (N + kLaneChunk - 1) / kLaneChunk) : dim3(N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<I>(rp_tag), rp_tag_ld, static_cast<I>(rp_rts),
        rp_rts_ld, static_cast<I>(sh_tag), sh_tag_ld, static_cast<I>(sh_rts),
        sh_rts_ld, static_cast<I>(sh_wts), sh_wts_ld, static_cast<I>(ts_tag),
        ts_tag_ld, static_cast<I>(ts_mem), ts_mem_ld, static_cast<I>(row1),
        static_cast<I>(row2), static_cast<I>(rowt), K1, K2, KT,
        static_cast<I>(cts1), cts1_step, static_cast<I>(cts2), cts2_step,
        static_cast<I>(addr), act, act_bool, static_cast<I>(rd), rd_value,
        static_cast<bool*>(th1), static_cast<bool*>(h1),
        static_cast<int*>(way1), static_cast<bool*>(th2),
        static_cast<bool*>(h2), static_cast<int*>(way2),
        static_cast<bool*>(fnd), static_cast<int*>(tway),
        static_cast<int*>(mwts), static_cast<int*>(mrts),
        static_cast<int*>(nmem), static_cast<bool*>(ovf),
        static_cast<int*>(nwa), static_cast<int*>(nra),
        static_cast<int*>(nw1), static_cast<int*>(nr1), N, W1, W2, C);
    return static_cast<int>(cudaGetLastError());
  };
  if (C <= 256) return go(miss_round_kernel<1>);
  if (C <= 512) return go(miss_round_kernel<2>);
  if (C <= 1024) return go(miss_round_kernel<4>);
  return go(miss_round_kernel<8>);
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
