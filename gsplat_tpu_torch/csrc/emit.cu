// Emit kernel of the binning engine (gsplat_tpu_torch/ops/binning.py).
//
// Replaces the TPU kernel gsplat_tpu/ops/binning.py::_emit_kernel (called by
// emit_entries). That kernel walked blocks of 1024 Gaussians and duplicated
// their rows into per-entry rows with one-hot selection matmuls on the MXU,
// because the TPU has no cheap gather. Here the contract is kept and the
// mechanism is not: each flattened (camera, Gaussian) id i owns the emit
// positions [starts[i], starts[i + 1]) (an exclusive prefix sum of its
// entry counts, closed by the total), so the emission order is ascending
// flat id, and entry k of i's tile rectangle (row-major) lies at
// starts[i] + k.
//
// Per position it writes only
//   keys[pos]  = tile_key << 32 | (depth bits ^ 0x80000000)  (64-bit sort key;
//                the xor maps signed int32 bit order to unsigned, so the key
//                orders depths as the JAX package's int32 depth key does)
//   gids[pos]  = i,
// and, where the exact ellipse-vs-tile cull drops the entry, the sentinel key
// (T << 32) and gid C*N instead. The payload rows are not copied here:
// csrc/emit_gather.cu gathers them once, in sort order, after the key sort.
// The cull is the JAX kernel's (binning.py:154-186) in the same operation
// order; this file is compiled with -fmad=false so that no multiply-add
// contraction changes a keep/drop decision against the plain torch version
// (_emit_plain). It reads the six values gx, gy, conic a, b, c and opacity
// from the front of i's row of the packed payload table ([C*N, F], F a
// multiple of 8 floats: one 32-byte sector).
//
// Threads run over positions, not over Gaussians, so the work of a thread
// is bounded whatever a rectangle's size: a block of kThreads threads takes
// the run of kRun = kThreads * kPerThread consecutive positions, and a
// thread handles at most kPerThread (4) of them, kThreads apart, so that
// neighbouring threads write neighbouring keys and gids. The block's first
// warp finds the owner of its run's first position and the second warp the
// owner of its last (segments::owner, a 32-way warp search over starts);
// each thread then finds the owner of each of its positions by a binary
// search between those two (segments::owner_in: about log2 of the number of
// Gaussians that meet the run, ~8 steps at the train shapes).
//
// Bound on the card: bytes. Each entry costs 12 bytes of writes (key and
// gid) and, with the cull, a few dozen flops (one expf) far under the H100's
// 67 TFLOP/s f32; each live id's rectangle, start, depth and six cull
// values are read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segments.cuh"

namespace {

constexpr float kAlphaCull = 1.0f / 255.0f;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // positions a thread handles, at most
constexpr int kRun = kThreads * kPerThread;

__device__ __forceinline__ float quad(float ca, float cb, float cc, float dx, float dy) {
  return 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// op * exp(-min over the tile's pixel-centre box of the conic quadratic) >= 1/255
__device__ bool tile_keeps(int tx, int ty, int ts, float gx, float gy, float ca,
                           float cb, float cc, float op) {
  const float x0 = (float)tx * (float)ts + 0.5f - gx;
  const float x1 = x0 + (float)(ts - 1);
  const float y0 = (float)ty * (float)ts + 0.5f - gy;
  const float y1 = y0 + (float)(ts - 1);
  const float safe_cc = fabsf(cc) > 1e-12f ? cc : 1.0f;
  const float safe_ca = fabsf(ca) > 1e-12f ? ca : 1.0f;
  const float ye0 = clampf(-cb * x0 / safe_cc, y0, y1);
  const float ye1 = clampf(-cb * x1 / safe_cc, y0, y1);
  const float xe0 = clampf(-cb * y0 / safe_ca, x0, x1);
  const float xe1 = clampf(-cb * y1 / safe_ca, x0, x1);
  float minq = fminf(fminf(quad(ca, cb, cc, x0, ye0), quad(ca, cb, cc, x1, ye1)),
                     fminf(quad(ca, cb, cc, xe0, y0), quad(ca, cb, cc, xe1, y1)));
  const bool inside = (x0 <= 0.0f) && (0.0f <= x1) && (y0 <= 0.0f) && (0.0f <= y1);
  if (inside) minq = 0.0f;
  return op * expf(-minq) >= kAlphaCull;
}

__global__ void __launch_bounds__(kThreads)
emit_kernel(const long long* __restrict__ starts,  // [CN + 1]
            const int* __restrict__ tminx, const int* __restrict__ tminy,
            const int* __restrict__ rw, const float* __restrict__ depth,
            const float4* __restrict__ packed,  // [CN, F4] float4
            int F4, int CN, int N, int n_tiles, int tile_width, int tile_size, int cull,
            long long M, long long sentinel, long long* __restrict__ keys,
            int* __restrict__ gids) {
  __shared__ long long own[2];
  const long long p0 = (long long)blockIdx.x * kRun;
  const long long p1 = p0 + kRun < M ? p0 + kRun : M;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {  // warp 0 finds the run's first position's owner, warp 1 its last's
    const long long g = segments::owner(starts, CN, warp == 0 ? p0 : p1 - 1, threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) own[warp] = g;
  }
  __syncthreads();
  const long long g0 = own[0], g1 = own[1];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long pos = p0 + u * kThreads + threadIdx.x;
    if (pos >= p1) break;
    const int i = (int)segments::owner_in(starts, g0, g1, pos);
    const int k = (int)(pos - __ldg(starts + i));
    const int w = max(__ldg(rw + i), 1);
    const int tx = __ldg(tminx + i) + k % w;
    const int ty = __ldg(tminy + i) + k / w;
    bool keep = true;
    if (cull) {
      // the 3DGS layout's first six values; a custom payload (cull = 0)
      // may have fewer
      const float4 a = __ldg(packed + (long long)i * F4);
      const float4 b = __ldg(packed + (long long)i * F4 + 1);
      keep = tile_keeps(tx, ty, tile_size, a.x, a.y, a.z, a.w, b.x, b.y);
    }
    const long long dlow = (long long)(__float_as_uint(__ldg(depth + i)) ^ 0x80000000u);
    const long long tile_key = (long long)(i / N) * n_tiles + (long long)ty * tile_width + tx;
    keys[pos] = keep ? ((tile_key << 32) | dlow) : sentinel;
    gids[pos] = keep ? i : CN;
  }
}

}  // namespace

extern "C" int emit_launch(const void* starts, const void* tminx, const void* tminy,
                           const void* rw, const void* depth, const void* packed, int F, int CN,
                           int N, int n_tiles, int tile_width, int tile_size, int cull,
                           long long M, long long sentinel, void* keys, void* gids,
                           void* stream) {
  if (M < 0 || CN <= 0 || F % 8 != 0 || (cull && F < 8)) return (int)cudaErrorInvalidValue;
  if (M > 0) {
    const long long blocks = (M + kRun - 1) / kRun;
    emit_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)starts, (const int*)tminx, (const int*)tminy, (const int*)rw,
        (const float*)depth, (const float4*)packed, F / 4, CN, N, n_tiles, tile_width, tile_size,
        cull, M, sentinel, (long long*)keys, (int*)gids);
  }
  return (int)cudaGetLastError();
}
