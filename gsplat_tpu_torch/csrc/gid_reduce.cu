// Per-Gaussian gradient reduce of the binned rasterizer
// (gsplat_tpu_torch/ops/rasterize_binned.py).
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_binned.py::_reduce_kernel
// (called by _reduce_call). That kernel summed the gid-sorted per-slot rows
// with one-hot matrix products on the MXU (three bf16 passes for an exact
// f32 sum) because the TPU has no cheap scatter. Here the segmented sum is
// direct. The caller sorts the per-slot gids once (stable, so a segment
// keeps stream order) and finds each Gaussian's segment [starts[g],
// starts[g+1]) with searchsorted. Who sums a segment depends on its length:
//
//   - at most SHORT slots (nearly every Gaussian of a frame): its own lane,
//     in stream order, the permutation entries in registers and the R rows
//     gathered through them, all loads independent;
//   - up to LONG slots: the lane's warp, its lanes striding the segment,
//     RCHUNK rows at a time, a fixed shuffle tree adding the lanes;
//   - longer (a large splat, up to every tile of the frame): cut at the
//     boundaries of LONG-slot chunks of the sorted order. A first kernel
//     gives each chunk a block that sums the part of such a segment lying
//     in the chunk; the owner's lane then adds the chunk partials in order.
//     So a splat's slots are spread over many SMs, not left to one warp,
//     whose dependent perm-then-row loads would keep the card waiting.
//
// A Gaussian with no slot gets 0. No atomics and a fixed order of adds, so
// the result is the same on every run.
//
// Bound on the card: bytes (each slot's R rows and its gid read once, R
// values written per Gaussian; one add per value read). The row reads are
// gathers through the permutation, one 32-byte sector per value.

#include <cuda_runtime.h>

namespace {

constexpr int SHORT = 8;     // longest segment one lane sums alone
constexpr int LONG = 256;    // longest segment one warp sums; chunk length
constexpr int RCHUNK = 12;   // rows a warp sums together

// The Gaussian whose segment holds sorted position k: the largest g with
// starts[g] <= k (n_out for the culled slots sorted past starts[n_out]).
// Called by a whole warp: a 32-way search, each step one load per lane,
// about five steps over a 4M-Gaussian pool (a binary search's 22 dependent
// loads would stall every chunk's block on their latency).
__device__ long long owner(const long long* __restrict__ starts, int n_out, long long k, int lane) {
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

// One block of LONG threads per chunk of LONG consecutive sorted slots. A
// segment longer than LONG cannot lie inside a chunk, so it holds the
// chunk's first or its last slot: at most two meet a chunk, part 0 (the
// owner of the first slot) and part 1 (the owner of the last, if another).
// The block sums each such segment's slots in the chunk, one thread per
// slot, shuffles within a warp and the warp sums in warp order, into
// partials[chunk][part][R].
__global__ void __launch_bounds__(LONG) chunk_partials_kernel(
    const float* __restrict__ rows, long long M, int R, const long long* __restrict__ perm,
    const long long* __restrict__ starts, int n_out, float* __restrict__ partials) {
  __shared__ long long own[2];
  __shared__ float warp_sum[LONG / 32];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c0 = (long long)blockIdx.x * LONG;
  const long long c1 = c0 + LONG < M ? c0 + LONG : M;
  if (warp < 2) {  // warp 0 finds the first slot's owner, warp 1 the last's
    const long long g = owner(starts, n_out, warp == 0 ? c0 : c1 - 1, lane);
    if (lane == 0) own[warp] = g;
  }
  __syncthreads();
  const long long k = c0 + threadIdx.x;
  for (int part = 0; part < 2; ++part) {
    // every test below reads the same values in every thread of the block
    const long long g = own[part];
    if ((part == 1 && g == own[0]) || g >= n_out) continue;
    const long long s0 = starts[g], s1 = starts[g + 1];
    if (s1 - s0 <= LONG) continue;
    const bool in = k < c1 && k >= s0 && k < s1;
    const long long p = in ? perm[k] : 0;
    float* dst = partials + ((long long)blockIdx.x * 2 + part) * R;
    for (int r = 0; r < R; ++r) {
      float v = in ? rows[(long long)r * M + p] : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(full, v, o);
      if (lane == 0) warp_sum[warp] = v;
      __syncthreads();
      if (threadIdx.x == 0) {
        float s = 0.0f;
        for (int w = 0; w < LONG / 32; ++w) s += warp_sum[w];
        dst[r] = s;
      }
      __syncthreads();
    }
  }
}

// One lane per Gaussian, 32 consecutive Gaussians per warp. Held to 64
// registers (4 blocks of 256 per SM): the short path's gathers need the
// warps in flight more than the medium path needs its registers.
__global__ void __launch_bounds__(256, 4) gid_reduce_kernel(const float* __restrict__ rows,  // [R, M]
                                  long long M, int R,
                                  const long long* __restrict__ perm,    // [M]
                                  const long long* __restrict__ starts,  // [n_out + 1]
                                  int n_out,
                                  const float* __restrict__ partials,  // [chunks, 2, R]
                                  float* __restrict__ out) {           // [R, n_out]
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long base = (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 32;
  if (base >= n_out) return;  // the same for every lane of the warp
  const long long mine = base + lane;
  long long s0 = 0, s1 = 0;
  if (mine < n_out) {
    s0 = starts[mine];
    s1 = starts[mine + 1];
  }
  const long long len = s1 - s0;
  if (mine < n_out && len <= SHORT) {
    long long p[SHORT];
#pragma unroll
    for (int j = 0; j < SHORT; ++j) p[j] = j < len ? perm[s0 + j] : 0;
    for (int r = 0; r < R; ++r) {
      const float* row = rows + (long long)r * M;
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < SHORT; ++j)
        if (j < len) s += row[p[j]];
      out[(long long)r * n_out + mine] = s;
    }
  } else if (mine < n_out && len > LONG) {
    // the chunk partials, in chunk order; the first chunk holds this
    // segment as part 1 when the segment starts inside it
    const long long cA = s0 / LONG, cB = (s1 - 1) / LONG;
    for (int r = 0; r < R; ++r) {
      float s = 0.0f;
      for (long long c = cA; c <= cB; ++c) s += partials[(c * 2 + (s0 <= c * LONG ? 0 : 1)) * R + r];
      out[(long long)r * n_out + mine] = s;
    }
  }
  for (unsigned todo = __ballot_sync(full, len > SHORT && len <= LONG); todo; todo &= todo - 1) {
    const int i = __ffs(todo) - 1;
    const long long k0 = __shfl_sync(full, s0, i);
    const long long k1 = __shfl_sync(full, s1, i);
    for (int r0 = 0; r0 < R; r0 += RCHUNK) {
      float acc[RCHUNK];
#pragma unroll
      for (int j = 0; j < RCHUNK; ++j) acc[j] = 0.0f;
      for (long long k = k0 + lane; k < k1; k += 32) {
        const long long p = perm[k];
#pragma unroll
        for (int j = 0; j < RCHUNK; ++j)
          if (r0 + j < R) acc[j] += rows[(long long)(r0 + j) * M + p];
      }
#pragma unroll
      for (int j = 0; j < RCHUNK; ++j) {
        float s = acc[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(full, s, o);
        if (lane == 0 && r0 + j < R) out[(long long)(r0 + j) * n_out + base + i] = s;
      }
    }
  }
}

}  // namespace

// The number of floats the caller provides as `partials`.
extern "C" long long gid_reduce_partials_size(long long M, int R) {
  return ((M + LONG - 1) / LONG) * 2 * R;
}

extern "C" int gid_reduce_launch(const void* rows, long long M, int R, const void* perm,
                                 const void* starts, int n_out, void* partials, void* out,
                                 void* stream) {
  if (n_out <= 0 || R <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (M > 0) {
    const long long chunks = (M + LONG - 1) / LONG;
    chunk_partials_kernel<<<(unsigned)chunks, LONG, 0, s>>>(
        (const float*)rows, M, R, (const long long*)perm, (const long long*)starts, n_out,
        (float*)partials);
  }
  const int threads = 256;  // 8 warps, 256 Gaussians per block
  const int blocks = (n_out + threads - 1) / threads;
  gid_reduce_kernel<<<blocks, threads, 0, s>>>(
      (const float*)rows, M, R, (const long long*)perm, (const long long*)starts, n_out,
      (const float*)partials, (float*)out);
  return (int)cudaGetLastError();
}
