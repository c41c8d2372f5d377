// Searches over a closed table of segment starts: `starts` [n + 1] i64,
// nondecreasing, starts[0] == 0, segment g = [starts[g], starts[g + 1]).
// A segment may be empty (starts[g] == starts[g + 1]), so a position's
// owner is the largest g with starts[g] <= k, which skips the empty ones.
// Used by the gid reduce (csrc/gid_reduce.cu: Gaussians' ranges of the gid
// order) and by emit (csrc/emit.cu: Gaussians' ranges of emit positions).

#pragma once

#include <cuda_runtime.h>

namespace segments {

// The Gaussian whose segment holds gid-order position k: the largest g with
// starts[g] <= k (n_out for positions past starts[n_out]). Called by a
// whole warp: a 32-way search, each step one load per lane, about five
// steps over a 4M-Gaussian pool (a binary search's 22 dependent loads would
// stall every chunk's block on their latency).
__device__ inline long long owner(const long long* __restrict__ starts, int n_out, long long k, int lane) {
  long long lo = 0, hi = n_out;  // the answer lies in [lo, hi]; starts[0] == 0 <= k
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + step * (lane + 1);
    const unsigned below = __ballot_sync(0xffffffffu, q <= hi && starts[q] <= k);
    const int n = __popc(below);  // the probes at or below k are a prefix
    const long long top = lo + step * (n + 1) - 1;
    lo += step * n;
    hi = top < hi ? top : hi;
  }
  return lo;
}

// The same owner found by one thread, given that it lies in [lo, hi]: a
// binary search of ceil(log2(hi - lo + 1)) steps
__device__ inline long long owner_in(const long long* __restrict__ starts, long long lo, long long hi,
                                     long long k) {
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (__ldg(starts + mid) <= k)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

}  // namespace segments
