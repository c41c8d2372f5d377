// Per-Gaussian gradient reduce of the binned and tiled rasterizers
// (gsplat_tpu_torch/ops/rasterize_binned.py::reduce_by_gid).
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_binned.py::_reduce_kernel
// (called by _reduce_call). That kernel summed the gid-sorted per-slot rows
// with one-hot matrix products on the MXU (three bf16 passes for an exact
// f32 sum) because the TPU has no cheap scatter. Here the segmented sum is
// direct, in two passes over a slot-major scratch.
//
// The caller hands each stream slot k its place dst[k] in gid order and
// each Gaussian g its segment [starts[g], starts[g+1]) of that order. The
// stream's own sort gives both: emission (binned) and expansion (tiled) run
// in ascending flat gid, and the sort's permutation says where each slot
// came from, so no second sort is needed (a caller without a stream order
// derives them from a sort of the gids).
//
//   pass 1 (scatter_kernel): a warp reads its 32 slots' R values,
//     coalesced in the [R, M] stream-order rows, stages them in shared
//     memory and writes each slot's values as one row of Rp floats
//     (zero-padded; the caller rounds R up to whole 16-byte vectors, or to
//     whole 32-byte sectors for wide rows) at dst[k] of a [M, Rp] scratch,
//     Q = Rp / 4 lanes a row with 16-byte stores: a slot's row is a few
//     sectors written by one store, not R scattered 4-byte values;
//   pass 2 sums each Gaussian's now-contiguous segment, by its length:
//     - at most SHORT slots (nearly every Gaussian): its own lane, reading
//       the segment's rows front to back with 16-byte loads;
//     - up to LONG: the lane's warp, its lanes striding the segment, then
//       a butterfly per row;
//     - longer (a large splat, up to every tile of the frame): cut at the
//       boundaries of LONG-slot chunks of the gid order; chunk_partials_
//       kernel gives each chunk a block that sums the part of each such
//       segment lying in the chunk, all R rows of a position read at once
//       and one barrier per part; the owner's warp then adds the chunk
//       partials in chunk order.
//   These are the parent design's orders of adds (it gathered each value
//   through a gid sort's permutation): where the stream culls nothing its
//   gid sort's order is the emit order, so the sums are the same bits, and
//   a training run the same trajectory.
//
// A Gaussian with no slot gets 0. Slots the stream culled (binned, cull)
// keep their place inside their Gaussian's segment; the backward kernels
// leave their rows zero, so they add nothing. No atomics and a fixed order
// of adds, so two launches give the same bits.
//
// Bound on the card: bytes. The function needs each slot's R values and a
// gid read once and [R, n_out] written once. This design moves more: pass 1
// reads the rows (4 R M bytes) and dst (8 M) and writes the scratch (4 Rp
// M); pass 2 reads the scratch (4 Rp M) and starts (8 n_out) and writes
// [R, n_out]. At the 2DGS train shapes (M = 21.15 M slots, R = 19, Rp =
// 24, n_out = 4.19 M): 1.61 + 0.17 + 2.03 GB, then 2.03 + 0.03 + 0.32 GB,
// ~6.2 GB, 1.9 ms at 3.35 TB/s; the scratch holds ~2.0 GB of card memory
// for the length of the call.

#include <cuda_runtime.h>

#include "segments.cuh"

namespace {

constexpr int SHORT = 8;   // longest segment one lane sums alone
constexpr int LONG = 256;  // longest segment one warp sums; chunk length
constexpr int QC = 3;      // float4 columns a lane sums at once in pass 2
constexpr int MAX_Q = 16;  // Rp <= 64 (the chunk kernel keeps a warp sum per row)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Pass 1: slot k's R values from the [R, M] rows into scratch row dst[k].
// A warp stages its 32 slots' values in shared memory, one coalesced load
// per row, then writes each slot's whole row with Q lanes (lane q the float4
// q), 32 / Q slots a store. A thread writing its own slot's Q float4s one
// after another (each warp store 32 pieces of 16 bytes, 80 bytes apart) ran
// 2.4x slower on an H100, even with the rows in stream order.
__global__ void __launch_bounds__(256) scatter_kernel(const float* __restrict__ rows, long long M,
                                                      int R, int Q,
                                                      const long long* __restrict__ dst,
                                                      float4* __restrict__ scratch) {
  extern __shared__ float stage[];  // [warps][32][4 Q + 1]
  const int S = 4 * Q + 1;          // an odd stride: the staging stores hit 32 banks
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long k0 = ((long long)blockIdx.x * blockDim.x) + warp * 32;  // the warp's first slot
  if (k0 >= M) return;  // the same for every lane of the warp
  float* sm = stage + warp * 32 * S;
  const long long k = k0 + lane;
#pragma unroll 4
  for (int r = 0; r < 4 * Q; ++r)
    sm[lane * S + r] = k < M && r < R ? __ldg(rows + (long long)r * M + k) : 0.0f;
  __syncwarp();
  const int G = 32 / Q;
  const int g = lane / Q;
  const int q = lane - g * Q;
  if (g >= G) return;
  for (int j = g; j < 32 && k0 + j < M; j += G) {
    const float* v = sm + j * S + 4 * q;
    scratch[__ldg(dst + k0 + j) * Q + q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// v summed over the warp's lanes by a butterfly (every lane gets the sum)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Pass 2a: a block of LONG threads per chunk of LONG consecutive gid-order
// positions, a thread per position. A segment longer than LONG cannot lie
// inside a chunk, so it holds the chunk's first or its last position: at
// most two meet a chunk, part 0 (the owner of the first position) and part
// 1 (the owner of the last, if another). For each such segment the block
// sums its rows in the chunk (zero for the other positions): a butterfly
// within each warp, then the warps' sums in warp order, into
// partials[chunk][part][R]. The thread's row is read once per part, all R
// values, with one barrier per part.
__global__ void __launch_bounds__(LONG) chunk_partials_kernel(const float4* __restrict__ scratch,
                                                              long long M, int R, int Q,
                                                              const long long* __restrict__ starts,
                                                              int n_out,
                                                              float* __restrict__ partials) {
  __shared__ long long own[2];
  __shared__ float wsum[LONG / 32][4 * MAX_Q];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c0 = (long long)blockIdx.x * LONG;
  const long long c1 = c0 + LONG < M ? c0 + LONG : M;
  if (warp < 2) {  // warp 0 finds the first position's owner, warp 1 the last's
    const long long g = segments::owner(starts, n_out, warp == 0 ? c0 : c1 - 1, lane);
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
    for (int q = 0; q < Q; ++q) {
      const float4 x = in ? __ldg(scratch + k * Q + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = warp_sum(comp(x, i));
        if (lane == 0) wsum[warp][4 * q + i] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < R) {
      float t = 0.0f;
      for (int w = 0; w < LONG / 32; ++w) t += wsum[w][threadIdx.x];
      partials[((long long)blockIdx.x * 2 + part) * R + threadIdx.x] = t;
    }
    __syncthreads();
  }
}

// Pass 2b: a lane per Gaussian, 32 consecutive Gaussians a warp. A short
// segment is summed by its lane front to back; a medium one by the whole
// warp, its lanes striding the segment (each lane front to back, then a
// butterfly); a long one by adding its chunk partials in chunk order.
__global__ void __launch_bounds__(256) segment_sum_kernel(const float4* __restrict__ scratch,
                                                          int R, int Q,
                                                          const long long* __restrict__ starts,
                                                          int n_out,
                                                          const float* __restrict__ partials,
                                                          float* __restrict__ out) {  // [R, n_out]
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
    for (int c = 0; c < Q; c += QC) {
      float4 acc[QC];
#pragma unroll
      for (int j = 0; j < QC; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      // a fixed trip count, so the loads of all SHORT slots can be in
      // flight together; the adds stay in slot order
#pragma unroll
      for (int u = 0; u < SHORT; ++u) {
        if (u < len) {
#pragma unroll
          for (int j = 0; j < QC; ++j)
            if (c + j < Q) acc[j] = add4(acc[j], __ldg(scratch + (s0 + u) * Q + c + j));
        }
      }
#pragma unroll
      for (int j = 0; j < QC; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * (c + j) + i;
          if (c + j < Q && r < R) out[(long long)r * n_out + mine] = comp(acc[j], i);
        }
      }
    }
  }
  for (unsigned todo = __ballot_sync(FULL, mine < n_out && len > SHORT); todo; todo &= todo - 1) {
    const int i = __ffs(todo) - 1;
    const long long k0 = __shfl_sync(FULL, s0, i);
    const long long k1 = __shfl_sync(FULL, s1, i);
    const long long g = base + i;
    if (k1 - k0 <= LONG) {
      for (int c = 0; c < Q; c += QC) {
        float4 acc[QC];
#pragma unroll
        for (int j = 0; j < QC; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int u = 0; u < LONG / 32; ++u) {
          const long long k = k0 + lane + 32 * u;
          if (k < k1) {
#pragma unroll
            for (int j = 0; j < QC; ++j)
              if (c + j < Q) acc[j] = add4(acc[j], __ldg(scratch + k * Q + c + j));
          }
        }
#pragma unroll
        for (int j = 0; j < QC; ++j) {
          if (c + j >= Q) break;  // the same for every lane
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 4 * (c + j) + e;
            const float v = warp_sum(comp(acc[j], e));
            if (lane == 0 && r < R) out[(long long)r * n_out + g] = v;
          }
        }
      }
    } else {
      // the chunk partials in chunk order, a lane per row; the first chunk
      // holds this segment as part 1 when the segment starts inside it
      for (int r = lane; r < R; r += 32) {
        float t = 0.0f;
        for (long long c = k0 / LONG; c <= (k1 - 1) / LONG; ++c)
          t += partials[(c * 2 + (k0 <= c * LONG ? 0 : 1)) * R + r];
        out[(long long)r * n_out + g] = t;
      }
    }
  }
}

int check_args(long long M, int R, int Rp, int n_out) {
  if (n_out <= 0 || R <= 0 || M < 0 || Rp % 4 != 0 || Rp < R || Rp > 4 * MAX_Q) return 1;
  return 0;
}

}  // namespace

// The number of floats the caller provides as `partials`: [chunks][2][R].
extern "C" long long gid_reduce_partials_size(long long M, int R) {
  return ((M + LONG - 1) / LONG) * 2 * R;
}

// Pass 1 alone: rows [R, M] (stream order) -> scratch [M, Rp] (gid order).
extern "C" int gid_reduce_scatter_launch(const void* rows, long long M, int R, int Rp,
                                         const void* dst, void* scratch, void* stream) {
  if (R <= 0 || M < 0 || Rp % 4 != 0 || Rp < R || Rp > 4 * MAX_Q) return (int)cudaErrorInvalidValue;
  if (M > 0) {
    const int smem = 256 * (Rp + 1) * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    scatter_kernel<<<(unsigned)((M + 255) / 256), 256, smem, (cudaStream_t)stream>>>(
        (const float*)rows, M, R, Rp / 4, (const long long*)dst, (float4*)scratch);
  }
  return (int)cudaGetLastError();
}

// Pass 2 alone: scratch [M, Rp] and the segments [n_out + 1] -> out [R, n_out].
extern "C" int gid_reduce_sum_launch(const void* scratch, long long M, int R, int Rp,
                                     const void* starts, int n_out, void* partials, void* out,
                                     void* stream) {
  if (check_args(M, R, Rp, n_out)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int Q = Rp / 4;
  if (M > 0) {
    const long long chunks = (M + LONG - 1) / LONG;
    chunk_partials_kernel<<<(unsigned)chunks, LONG, 0, s>>>(
        (const float4*)scratch, M, R, Q, (const long long*)starts, n_out, (float*)partials);
  }
  segment_sum_kernel<<<(n_out + 255) / 256, 256, 0, s>>>(
      (const float4*)scratch, R, Q, (const long long*)starts, n_out, (const float*)partials,
      (float*)out);
  return (int)cudaGetLastError();
}

// Both passes: rows [R, M] in stream order, slot k's gid-order place dst[k]
// and the segments -> out [R, n_out].
extern "C" int gid_reduce_launch(const void* rows, long long M, int R, int Rp, const void* dst,
                                 const void* starts, int n_out, void* scratch, void* partials,
                                 void* out, void* stream) {
  if (check_args(M, R, Rp, n_out)) return (int)cudaErrorInvalidValue;
  const int err = gid_reduce_scatter_launch(rows, M, R, Rp, dst, scratch, stream);
  if (err != 0) return err;
  return gid_reduce_sum_launch(scratch, M, R, Rp, starts, n_out, partials, out, stream);
}
