// The binned forward at four levels of work (gsplat_tpu_torch/microbench/
// fwd_breakdown.py), the Hopper counterpart of
// scripts/exp_fwd_breakdown.py::make_kernel (:67, pallas_call :146), which
// asks whether the forward is bound by reading its stream or by its
// arithmetic. One template over the level, a block per (camera, tile), a
// thread per pixel (ts x ts threads). Over the tile's entries [off, off + n)
// of the binned stream (entries [NF, M], the layout csrc/rasterize_fwd.cu
// reads) it reads, as the TPU kernel does, every Kb = 512-entry batch from
// astart = floor(off / Kb) Kb up to off + n, staged in shared memory (the
// TPU's double-buffered DMA), and then per level:
//   L0  the batches' checksum: out = 1e-9 x the sum of every staged value
//       (the rows past NF count as the TPU's zero padding to F = 16);
//   L1  + sigma and alpha of each (pixel, entry) pair in 128-entry slices:
//       out = 1e-9 x the sum of alpha over the valid pairs (entry in [off,
//       off + n), alpha >= 1/255, sigma >= 0);
//   L2  + the transmittance, restarting at every slice (the TPU's in-slice
//       scan; a slice starts at a multiple of 128 of the stream index):
//       w = T_excl alpha where valid and T_incl > 1e-4; out = 1e-9 x sum w;
//   L3  + the colour contraction: out[d, p] = sum of w times entry row 6 + d
//       (d < 8, rows past NF zero), per pixel.
// L0-L2 write their one value to every [8, P] output of the tile, as the
// TPU's accumulator broadcasts it. Sigma and alpha round as the forward
// kernels round them (csrc/raster.cuh::gauss_sigma), the transmittance in
// order, so the plain version gives the same decisions.
//
// Bound on the card: the larger of the bytes (the staged batches' NF rows
// and the [T, 8, P] output) and the operations this stream needs at each
// level (microbench/fwd_breakdown.py counts them).

#include <cuda_runtime.h>

namespace {

constexpr int kKb = 512;
constexpr int kLanes = 128;
constexpr int kMaxRows = 16;

__device__ __forceinline__ float gauss_sigma(float ca, float cb, float cc, float dx, float dy) {
  return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx), __fmul_rn(__fmul_rn(cc, dy), dy))),
                   __fmul_rn(__fmul_rn(cb, dx), dy));
}

template <int LEVEL>
__global__ void __launch_bounds__(1024)
fwd_breakdown_kernel(const float* __restrict__ entries, long long M, int NF, const int* __restrict__ offs,
                     const int* __restrict__ cnts, int tw, int th, int ts, float* __restrict__ out) {
  __shared__ float eb[kMaxRows][kKb];
  __shared__ float red[32];
  const int t = blockIdx.x, p = threadIdx.x, P = ts * ts;
  const long long off = offs[t], n = cnts[t];
  const long long astart = (off / kKb) * kKb;
  const long long nb = (off + n - astart + kKb - 1) / kKb;
  const int rem = t % (th * tw);
  const float px = (float)((rem % tw) * ts + p % ts) + 0.5f;
  const float py = (float)((rem / tw) * ts + p / ts) + 0.5f;
  float local = 0.0f, acc[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) acc[d] = 0.0f;

  for (long long b = 0; b < nb; ++b) {
    const long long base = astart + b * kKb;
    __syncthreads();
    for (int i = p; i < NF * kKb; i += P) {
      const int f = i / kKb, j = i % kKb;
      const long long col = base + j;
      eb[f][j] = col < M ? entries[f * M + col] : 0.0f;
    }
    __syncthreads();
    if constexpr (LEVEL == 0) {
      for (int i = p; i < NF * kKb; i += P) local += eb[i / kKb][i % kKb];
    } else {
      for (int s = 0; s < kKb / kLanes; ++s) {
        float T = 1.0f;
        for (int k = 0; k < kLanes; ++k) {
          const int j = s * kLanes + k;
          const long long gidx = base + j;
          const float dx = __fsub_rn(px, eb[0][j]), dy = __fsub_rn(py, eb[1][j]);
          const float sigma = gauss_sigma(eb[2][j], eb[3][j], eb[4][j], dx, dy);
          const float alpha = fminf(__fmul_rn(eb[5][j], expf(-sigma)), 0.999f);
          const bool valid = gidx >= off && gidx < off + n && alpha >= 1.0f / 255.0f && sigma >= 0.0f;
          if constexpr (LEVEL == 1) {
            local += valid ? alpha : 0.0f;
          } else {
            const float t_excl = T;
            T = __fmul_rn(T, valid ? __fsub_rn(1.0f, alpha) : 1.0f);
            const float w = valid && T > 1e-4f ? __fmul_rn(t_excl, alpha) : 0.0f;
            if constexpr (LEVEL == 2) {
              local += w;
            } else {
#pragma unroll
              for (int d = 0; d < 8; ++d)
                if (6 + d < NF) acc[d] += eb[6 + d][j] * w;
            }
          }
        }
      }
    }
  }

  float* o = out + (long long)t * 8 * P + p;
  if constexpr (LEVEL == 3) {
#pragma unroll
    for (int d = 0; d < 8; ++d) o[d * P] = acc[d];
  } else {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) local += __shfl_down_sync(0xffffffffu, local, d);
    if ((p & 31) == 0) red[p >> 5] = local;
    __syncthreads();
    float total = 0.0f;
    for (int w = 0; w < (P + 31) / 32; ++w) total += red[w];
    const float v = total * 1e-9f;
#pragma unroll
    for (int d = 0; d < 8; ++d) o[d * P] = v;
  }
}

}  // namespace

// entries [NF, M] (NF <= 16); offs, cnts [T] i32; out [T, 8, ts * ts]
extern "C" int fwd_breakdown_launch(int level, const void* entries, long long M, int NF, const void* offs,
                                    const void* cnts, int T, int tw, int th, int ts, void* out, void* stream) {
  if (level < 0 || level > 3 || NF < 6 || NF > kMaxRows || ts < 1 || ts * ts > 1024 || (ts * ts) % 32 || T < 0 ||
      M < 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int P = ts * ts;
  const float* e = (const float*)entries;
  const int *o = (const int*)offs, *c = (const int*)cnts;
  float* y = (float*)out;
  switch (level) {
    case 0: fwd_breakdown_kernel<0><<<T, P, 0, s>>>(e, M, NF, o, c, tw, th, ts, y); break;
    case 1: fwd_breakdown_kernel<1><<<T, P, 0, s>>>(e, M, NF, o, c, tw, th, ts, y); break;
    case 2: fwd_breakdown_kernel<2><<<T, P, 0, s>>>(e, M, NF, o, c, tw, th, ts, y); break;
    default: fwd_breakdown_kernel<3><<<T, P, 0, s>>>(e, M, NF, o, c, tw, th, ts, y);
  }
  return (int)cudaGetLastError();
}
