// Forward compositing kernel of the binned 2DGS (surfel) rasterizer
// (gsplat_tpu_torch/ops/rasterize_2dgs_binned.py).
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_2dgs_binned.py::_fwd2_kernel
// (called by _fwd2_call). That kernel put a tile's pixels on sublanes and
// 128 entries on lanes, built the transmittance chain and the distortion's
// prefix sums with lane-roll scans, composited the features with an MXU
// contraction and found the median with lane max-reductions. Here, as in
// csrc/rasterize_fwd.cu, each pixel is a thread and walks the chain itself:
//
//   one block per (camera, tile): T = C*th*tw blocks; one thread per pixel
//   (ts*ts threads). The block walks its range [offs[t], offs[t]+cnts[t])
//   of the depth-sorted stream in batches of kBatch entries staged in shared
//   memory (12 + L floats each), and leaves once every pixel is done
//   (__syncthreads_count), the JAX kernel's whole-tile saturation skip.
//
// Stream rows: mx, my, M00..M22, opacity, then L = D + 3 features (D
// colours, the last of them the depth m, then 3 normals). Per pixel, at the
// pixel centre (+0.5), in stream order:
//   sigma  = surfel_sigma (surfel.cuh); alpha = min(0.999, op exp(-sigma));
//            skipped unless alpha >= 1/255 and sigma >= 0
//   T_incl = T (1 - alpha); if T_incl <= 1e-4 the pixel is done and the
//            entry is NOT accepted; else, with w = T alpha:
//   feat  += w f;   dist += 2 (w m W_< - w WM_<);  W_< += w;  WM_< += w m
//   median = m if T > 0.5;   T = T_incl;   last = the entry's stream index
// Outputs per pixel inside the image: features [C,H,W,L], T_final [C,H,W]
// (the JAX kernel stores log T), last [C,H,W] (absolute stream index or
// -1), distortion [C,H,W] and median [C,H,W]. The background is composited
// by the caller.
//
// Bound on the card: operations. Counted from the code below, a division and
// an expf one operation each: 41 per evaluated (pixel, entry) pair (the
// ray-plane cross product, sigma, alpha and the tests) and 2L + 13 more per
// accepted pair, against a stream read once per tile. The design keeps
// each batch in shared memory, so an entry is read from device memory once
// per tile, and stops a tile when all its pixels saturate.

#include <cuda_runtime.h>

#include "surfel.cuh"

namespace {

constexpr int kBatch = 256;  // entries per batch: (12 + L) * 256 * 4 B <= 47 KB at L = 35
constexpr int kFix = 12;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;
constexpr float kTransmittanceEps = 1e-4f;

template <int LMAX>
__global__ void __launch_bounds__(1024)
rasterize_2dgs_fwd_kernel(const float* __restrict__ entries,  // [12 + L, M]
                          long long M, const int* __restrict__ offs,
                          const int* __restrict__ cnts, int th, int tw, int ts, int W, int H,
                          int L, float* __restrict__ feat,    // [C, H, W, L]
                          float* __restrict__ T_out,           // [C, H, W]
                          int* __restrict__ last,              // [C, H, W]
                          float* __restrict__ dist_out,        // [C, H, W]
                          float* __restrict__ med_out) {       // [C, H, W]
  extern __shared__ float sm[];  // [12 + L][kBatch]
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
  const int nf = kFix + L;
  const int md = L - 4;  // the depth: the last colour channel

  float acc[LMAX];
#pragma unroll
  for (int l = 0; l < LMAX; ++l) acc[l] = 0.0f;
  float T = 1.0f;
  int lst = -1;
  float dist = 0.0f, wsum = 0.0f, wmsum = 0.0f, med = 0.0f;
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
        float m[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) m[i] = sm[(2 + i) * kBatch + j];
        const SurfelSigma s = surfel_sigma(m, sm[j], sm[kBatch + j], px, py);
        const float alpha = fminf(sm[11 * kBatch + j] * expf(-s.sig), kAlphaMax);
        if (!(s.sig >= 0.0f) || !(alpha >= kAlphaMin)) continue;
        const float T_incl = T * (1.0f - alpha);
        if (T_incl <= kTransmittanceEps) {
          done = true;
          break;
        }
        const float w = T * alpha;
#pragma unroll
        for (int l = 0; l < LMAX; ++l)
          if (l < L) acc[l] += w * sm[(kFix + l) * kBatch + j];
        const float depth = sm[(kFix + md) * kBatch + j];
        const float wm = w * depth;
        dist += 2.0f * (wm * wsum - w * wmsum);
        wsum += w;
        wmsum += wm;
        if (T > 0.5f) med = depth;
        T = T_incl;
        lst = off + b0 + j;
      }
    }
  }
  if (!inside) return;
  const long long pix = ((long long)cam * H + y) * W + x;
#pragma unroll
  for (int l = 0; l < LMAX; ++l)
    if (l < L) feat[pix * L + l] = acc[l];
  T_out[pix] = T;
  last[pix] = lst;
  dist_out[pix] = dist;
  med_out[pix] = med;
}

template <int LMAX>
cudaError_t launch(const float* entries, long long M, const int* offs, const int* cnts, int C,
                   int th, int tw, int ts, int W, int H, int L, float* feat, float* T_out,
                   int* last, float* dist, float* med, cudaStream_t stream) {
  const size_t smem = (size_t)(kFix + L) * kBatch * sizeof(float);
  rasterize_2dgs_fwd_kernel<LMAX><<<C * th * tw, ts * ts, smem, stream>>>(
      entries, M, offs, cnts, th, tw, ts, W, H, L, feat, T_out, last, dist, med);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rasterize_2dgs_fwd_launch(const void* entries, long long M, const void* offs,
                                         const void* cnts, int C, int th, int tw, int ts,
                                         int W, int H, int L, void* feat, void* T_out,
                                         void* last, void* dist, void* med, void* stream) {
  if (ts != 8 && ts != 16 && ts != 32) return (int)cudaErrorInvalidValue;
  if (L < 4 || L > 35) return (int)cudaErrorInvalidValue;
  auto* e = (const float*)entries;
  auto* o = (const int*)offs;
  auto* c = (const int*)cnts;
  auto* f = (float*)feat;
  auto* to = (float*)T_out;
  auto* l = (int*)last;
  auto* d = (float*)dist;
  auto* md = (float*)med;
  auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (L <= 4)
    err = launch<4>(e, M, o, c, C, th, tw, ts, W, H, L, f, to, l, d, md, s);
  else if (L <= 8)
    err = launch<8>(e, M, o, c, C, th, tw, ts, W, H, L, f, to, l, d, md, s);
  else if (L <= 16)
    err = launch<16>(e, M, o, c, C, th, tw, ts, W, H, L, f, to, l, d, md, s);
  else
    err = launch<35>(e, M, o, c, C, th, tw, ts, W, H, L, f, to, l, d, md, s);
  return (int)err;
}
