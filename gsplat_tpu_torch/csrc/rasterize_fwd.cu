// Forward compositing kernel of the binned rasterizer
// (gsplat_tpu_torch/ops/rasterize_binned.py).
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_binned.py::_fwd_kernel
// (called by _fwd_call). That kernel put a tile's pixels on sublanes and 128
// entries on lanes, and built the transmittance chain with lane-roll scans
// because the TPU's vector unit has no per-pixel loop. Here each pixel is a
// thread and walks the chain itself, as the reference CUDA rasterizers do:
//
//   one block per (camera, tile): T = C*th*tw blocks; rem = t % (th*tw),
//   ty = rem / tw, tx = rem % tw; one thread per pixel (ts*ts threads).
//
// The block walks its range [offs[t], offs[t]+cnts[t]) of the depth-sorted
// stream in batches of kBatch entries that the whole block stages in shared
// memory (coalesced loads of each feature row). Per pixel, at the pixel
// centre (+0.5):
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy
//   alpha = min(0.999, op * exp(-sigma)); skipped if alpha < 1/255 or sigma < 0
//   T_incl = T (1 - alpha); if T_incl <= 1e-4 the pixel is done and the entry
//   is NOT accepted; else accumulate T alpha color, T = T_incl, last = index.
// The block leaves its loop once every pixel is done (__syncthreads_count):
// the CUDA form of the JAX kernel's skip_saturated.
//
// Outputs, per pixel inside the image: image [C,H,W,D] = accum + T bg (bg
// optional), T_final [C,H,W] (the JAX kernel stores log T) and last [C,H,W],
// the absolute stream index of the last accepted entry or -1; the backward
// of the training slice reads it.
//
// Bound on the card: operations, about 18 + 2D flops and one expf per
// evaluated (pixel, entry) pair against a stream read once. The design keeps
// the stream in shared memory, so each entry is read from device memory once
// per tile, and stops a tile as soon as all its pixels saturate.

#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 256;  // entries staged per batch: (6 + D) * 256 * 4 B <= 38 KB
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;
constexpr float kTransmittanceEps = 1e-4f;

template <int DMAX>
__global__ void __launch_bounds__(1024)
rasterize_fwd_kernel(const float* __restrict__ entries,  // [6 + D, M]
                     long long M, const int* __restrict__ offs,
                     const int* __restrict__ cnts, int th, int tw, int ts, int W, int H,
                     int D, const float* __restrict__ bg,  // [C, D] or null
                     float* __restrict__ img,                // [C, H, W, D]
                     float* __restrict__ T_out,              // [C, H, W]
                     int* __restrict__ last) {               // [C, H, W]
  extern __shared__ float sm[];  // [6 + D][kBatch]
  const int t = blockIdx.x;
  const int cam = t / (th * tw);
  const int rem = t % (th * tw);
  const int ty = rem / tw;
  const int tx = rem % tw;
  const int p = threadIdx.x;
  const int x = tx * ts + p % ts;
  const int y = ty * ts + p / ts;
  const bool inside = x < W && y < H;
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const int off = offs[t];
  const int n = cnts[t];
  const int nf = 6 + D;

  float acc[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) acc[d] = 0.0f;
  float T = 1.0f;
  int lst = -1;
  bool done = !inside;  // pixels past the image edge never hold the tile open

  for (int b0 = 0; b0 < n; b0 += kBatch) {
    // also the barrier that keeps the previous batch's readers ahead of
    // this batch's loads
    if (__syncthreads_count(done) == (int)blockDim.x) break;
    const int nb = min(kBatch, n - b0);
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      const long long src = (long long)off + b0 + j;
      for (int f = 0; f < nf; ++f) sm[f * kBatch + j] = entries[(long long)f * M + src];
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < nb; ++j) {
        const float dx = px - sm[j];
        const float dy = py - sm[kBatch + j];
        const float ca = sm[2 * kBatch + j];
        const float cb = sm[3 * kBatch + j];
        const float cc = sm[4 * kBatch + j];
        const float op = sm[5 * kBatch + j];
        // sigma and alpha round op by op, as the plain version's torch ops
        // do (no multiply-add contraction): an entry on the alpha = 1/255
        // threshold must not flip between the two
        const float sigma = __fadd_rn(
            __fmul_rn(0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                      __fmul_rn(__fmul_rn(cc, dy), dy))),
            __fmul_rn(__fmul_rn(cb, dx), dy));
        const float alpha = fminf(__fmul_rn(op, expf(-sigma)), kAlphaMax);
        if (sigma < 0.0f || alpha < kAlphaMin) continue;
        const float T_incl = T * (1.0f - alpha);
        if (T_incl <= kTransmittanceEps) {
          done = true;
          break;
        }
        const float w = T * alpha;
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) acc[d] += w * sm[(6 + d) * kBatch + j];
        T = T_incl;
        lst = off + b0 + j;
      }
    }
  }
  if (!inside) return;
  const long long pix = ((long long)cam * H + y) * W + x;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    if (d < D) img[pix * D + d] = acc[d] + (bg != nullptr ? T * bg[cam * D + d] : 0.0f);
  }
  T_out[pix] = T;
  last[pix] = lst;
}

template <int DMAX>
cudaError_t launch(const float* entries, long long M, const int* offs, const int* cnts,
                   int C, int th, int tw, int ts, int W, int H, int D, const float* bg,
                   float* img, float* T_out, int* last, cudaStream_t stream) {
  const size_t smem = (size_t)(6 + D) * kBatch * sizeof(float);
  rasterize_fwd_kernel<DMAX><<<C * th * tw, ts * ts, smem, stream>>>(
      entries, M, offs, cnts, th, tw, ts, W, H, D, bg, img, T_out, last);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rasterize_fwd_launch(const void* entries, long long M, const void* offs,
                                    const void* cnts, int C, int th, int tw, int ts, int W,
                                    int H, int D, const void* bg, void* img, void* T_out,
                                    void* last, void* stream) {
  if (ts != 8 && ts != 16 && ts != 32) return (int)cudaErrorInvalidValue;
  if (D < 1 || D > 32) return (int)cudaErrorInvalidValue;
  auto* e = (const float*)entries;
  auto* o = (const int*)offs;
  auto* c = (const int*)cnts;
  auto* b = (const float*)bg;
  auto* im = (float*)img;
  auto* to = (float*)T_out;
  auto* l = (int*)last;
  auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (D <= 4)
    err = launch<4>(e, M, o, c, C, th, tw, ts, W, H, D, b, im, to, l, s);
  else if (D <= 8)
    err = launch<8>(e, M, o, c, C, th, tw, ts, W, H, D, b, im, to, l, s);
  else if (D <= 16)
    err = launch<16>(e, M, o, c, C, th, tw, ts, W, H, D, b, im, to, l, s);
  else
    err = launch<32>(e, M, o, c, C, th, tw, ts, W, H, D, b, im, to, l, s);
  return (int)err;
}
