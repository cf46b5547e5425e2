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

// First way j < W of `row` holding a, or -1.  The compares of 32 ways
// at a time fold into a bit mask with no branch, so every load of them
// is in flight at once (a loop that stops at the first match would wait
// for each load before issuing the next); the mask's lowest set bit is
// the reference's first match.
__device__ __forceinline__ int first_way(const int* __restrict__ row, int W,
                                         int a) {
  for (int j0 = 0; j0 < W; j0 += 32) {
    const int n = min(W - j0, 32);
    unsigned m = 0;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      m |= static_cast<unsigned>(row[j0 + j] == a) << j;
    }
    if (m != 0) return j0 + __ffs(m) - 1;
  }
  return -1;
}

}  // namespace halcone
