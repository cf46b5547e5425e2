// Shared device helpers for the HALCONE coherence kernels (sm_90a).
//
// All lattice math is int32 and must wrap like the reference's int32
// arithmetic, so additions go through unsigned (signed overflow is
// undefined behaviour in C++).
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace halcone {

constexpr int kTsMax = 65535;            // core.protocol.TS_MAX (16-bit)
constexpr int kInvalid = -1;             // core.state.INVALID (empty way)
constexpr int kNeg = -(1 << 30);         // victim score of an empty way
constexpr int kSeqCap = 1 << 30;         // victim key of a non-minimal way
constexpr unsigned kFull = 0xffffffffu;  // full-warp shuffle mask

__device__ __forceinline__ int add32(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// Lowest way index j < W with row[j] == a, or INT_MAX when none, reduced
// over the calling warp: lane l scans ways l, l+32, ... (coalesced loads)
// and keeps its first hit, then the warp takes the minimum.  Every lane
// of the warp must call it.
__device__ __forceinline__ int warp_first_match(const int* __restrict__ row,
                                                int W, int a, int lane) {
  int m = INT_MAX;
  for (int j = lane; j < W; j += 32) {
    if (row[j] == a) {
      m = j;
      break;
    }
  }
  return __reduce_min_sync(kFull, m);
}

}  // namespace halcone
