// Backward kernel of the binned rasterizer
// (gsplat_tpu_torch/ops/rasterize_binned.py).
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_binned.py::_bwd_kernel
// (called by _bwd_call). That kernel swept 128-lane slices back to front
// with lane-roll scans and turned the per-entry pixel sums into one MXU
// moment contraction, writing K-aligned slots plus an f32 gid row. Here
// each pixel is a thread and walks the chain itself, and the per-entry
// sums are block reductions:
//
//   one block per (camera, tile), one thread per pixel (ts*ts threads), as
//   csrc/rasterize_fwd.cu. Each pixel starts from the forward's T_final and
//   `last` (absolute stream index of its last accepted entry). The block
//   walks its stream range back to front, in batches of kBatch entries
//   staged in shared memory, from the tile's largest `last` down to its
//   first entry (later entries were never accepted by any pixel: their rows
//   stay as the caller zeroed them).
//
// Per pixel and entry (index <= last, and the forward's alpha/sigma test,
// rounded op by op exactly as the forward kernel does so that both kernels
// accept the same entries):
//   T       /= 1 - alpha              (T before this entry)
//   w        = alpha T
//   cv       = sum_d v_img[d] color[d]
//   v_alpha  = T cv - (s_later + v_logT) / (1 - alpha),  v_logT = v_T T_final
//   s_later += w cv
//   v_sigma  = -alpha v_alpha, v_op = exp(-sigma) v_alpha  (0 if alpha was
//              clamped at 0.999)
//   v_conic  = v_sigma (dx^2 / 2, dx dy, dy^2 / 2)
//   v_mean   = -v_sigma (a dx + b dy, b dx + c dy),   dx = px - gx
//   v_color  = w v_img
// Each of those 6 + D values is summed over the tile's pixels: warp
// shuffles (skipped when no lane of the warp accepted the entry), then the
// per-warp partials in shared memory added in warp order, so the result is
// deterministic. One (tile, Gaussian) per stream slot, so every slot's row
// is written by one block and no atomics are needed:
//   rows [6 + D (+2), M]: v_gx, v_gy, v_a, v_b, v_c, v_op, v_color[D]
//   (+ |v_gx|, |v_gy| of the slot: the per-tile absgrad statistic).
//
// Bound on the card: operations. Counted from the code below: 16 flops
// (sigma, exp, alpha and the tests) per evaluated (pixel, entry) pair, those
// at or before the pixel's `last`, and 28 + 3D more per accepted pair, for
// the stream read once per tile.
// The design keeps each batch of entries in shared memory and stops the
// sweep at the tile's largest `last`; the warp-level skip keeps the
// reductions off entries that only part of the tile sees.

#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 32;  // entries per staged batch
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;

template <int DMAX>
__global__ void __launch_bounds__(1024)
rasterize_bwd_kernel(const float* __restrict__ entries,  // [6 + D, M]
                     long long M, const int* __restrict__ offs,
                     const int* __restrict__ cnts, int th, int tw, int ts, int W, int H,
                     int D, const float* __restrict__ T_fin,  // [C, H, W]
                     const int* __restrict__ last,            // [C, H, W]
                     const float* __restrict__ v_img,         // [C, H, W, D]
                     const float* __restrict__ v_T,           // [C, H, W]
                     int absgrad,
                     float* __restrict__ rows) {              // [6 + D (+2), M]
  extern __shared__ float sm[];
  const int nf = 6 + D;
  float* ent = sm;                   // [nf][kBatch]
  float* part = sm + nf * kBatch;    // [warps][kBatch][nf]
  __shared__ int s_lmax;

  const int t = blockIdx.x;
  const int cam = t / (th * tw);
  const int rem = t % (th * tw);
  const int ty = rem / tw;
  const int tx = rem % tw;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nwarps = blockDim.x >> 5;
  const int x = tx * ts + p % ts;
  const int y = ty * ts + p / ts;
  const bool inside = x < W && y < H;
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const int off = offs[t];
  const int n = cnts[t];

  int lst = -1;
  float T = 1.0f;
  float vlogT = 0.0f;
  float vimg[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) vimg[d] = 0.0f;
  if (inside) {
    const long long pix = ((long long)cam * H + y) * W + x;
    lst = last[pix];
    T = T_fin[pix];
    vlogT = v_T[pix] * T;
#pragma unroll
    for (int d = 0; d < DMAX; ++d)
      if (d < D) vimg[d] = v_img[pix * D + d];
  }
  if (p == 0) s_lmax = -1;
  __syncthreads();
  if (lst >= 0) atomicMax(&s_lmax, lst);
  __syncthreads();
  const int nact = min(n, s_lmax + 1 - off);  // entries past the tile's largest `last` add nothing

  float s_later = 0.0f;
  for (int b0 = ((nact - 1) / kBatch) * kBatch; nact > 0 && b0 >= 0; b0 -= kBatch) {
    const int nb = min(kBatch, nact - b0);
    __syncthreads();  // the previous batch's readers of ent/part are done
    for (int i = p; i < nf * nb; i += blockDim.x) {
      const int f = i / nb;
      const int j = i % nb;
      ent[f * kBatch + j] = entries[(long long)f * M + off + b0 + j];
    }
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      float g[6 + DMAX];
#pragma unroll
      for (int r = 0; r < 6 + DMAX; ++r) g[r] = 0.0f;
      bool accepted = false;
      if (off + b0 + j <= lst) {
        const float dx = px - ent[j];
        const float dy = py - ent[kBatch + j];
        const float ca = ent[2 * kBatch + j];
        const float cb = ent[3 * kBatch + j];
        const float cc = ent[4 * kBatch + j];
        const float op = ent[5 * kBatch + j];
        // the forward kernel's exact rounding: the same entries pass
        const float sigma = __fadd_rn(
            __fmul_rn(0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                      __fmul_rn(__fmul_rn(cc, dy), dy))),
            __fmul_rn(__fmul_rn(cb, dx), dy));
        const float eneg = expf(-sigma);
        const float araw = __fmul_rn(op, eneg);
        const float alpha = fminf(araw, kAlphaMax);
        if (sigma >= 0.0f && alpha >= kAlphaMin) {
          accepted = true;
          const float one_m = 1.0f - alpha;
          T = T / one_m;
          const float w = alpha * T;
          float cv = 0.0f;
#pragma unroll
          for (int d = 0; d < DMAX; ++d)
            if (d < D) cv += vimg[d] * ent[(6 + d) * kBatch + j];
          const float v_alpha = T * cv - (s_later + vlogT) / one_m;
          s_later += w * cv;
          const bool notclamp = araw < kAlphaMax;
          const float v_sig = notclamp ? -alpha * v_alpha : 0.0f;
          g[0] = -(ca * dx + cb * dy) * v_sig;
          g[1] = -(cb * dx + cc * dy) * v_sig;
          g[2] = 0.5f * dx * dx * v_sig;
          g[3] = dx * dy * v_sig;
          g[4] = 0.5f * dy * dy * v_sig;
          g[5] = notclamp ? eneg * v_alpha : 0.0f;
#pragma unroll
          for (int d = 0; d < DMAX; ++d)
            if (d < D) g[6 + d] = w * vimg[d];
        }
      }
      float* dst = part + ((long long)warp * kBatch + j) * nf;
      if (__any_sync(0xffffffffu, accepted)) {
#pragma unroll
        for (int r = 0; r < 6 + DMAX; ++r) {
          if (r < nf) {
            float v = g[r];
#pragma unroll
            for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
            if (lane == 0) dst[r] = v;
          }
        }
      } else {
        for (int r = lane; r < nf; r += 32) dst[r] = 0.0f;
      }
    }
    __syncthreads();
    // per-entry sums over the warps, in warp order; row-major so that
    // neighbouring threads write neighbouring slots
    for (int i = p; i < nf * nb; i += blockDim.x) {
      const int r = i / nb;
      const int j = i % nb;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += part[((long long)w * kBatch + j) * nf + r];
      const long long slot = (long long)off + b0 + j;
      rows[(long long)r * M + slot] = s;
      if (absgrad && r < 2) rows[(long long)(nf + r) * M + slot] = fabsf(s);
    }
  }
}

template <int DMAX>
cudaError_t launch(const float* entries, long long M, const int* offs, const int* cnts,
                   int C, int th, int tw, int ts, int W, int H, int D, const float* T_fin,
                   const int* last, const float* v_img, const float* v_T, int absgrad,
                   float* rows, cudaStream_t stream) {
  const int threads = ts * ts;
  const size_t smem = (size_t)(6 + D) * kBatch * sizeof(float) * (1 + threads / 32);
  cudaError_t err = cudaFuncSetAttribute(rasterize_bwd_kernel<DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  rasterize_bwd_kernel<DMAX><<<C * th * tw, threads, smem, stream>>>(
      entries, M, offs, cnts, th, tw, ts, W, H, D, T_fin, last, v_img, v_T, absgrad, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rasterize_bwd_launch(const void* entries, long long M, const void* offs,
                                    const void* cnts, int C, int th, int tw, int ts, int W,
                                    int H, int D, const void* T_fin, const void* last,
                                    const void* v_img, const void* v_T, int absgrad,
                                    void* rows, void* stream) {
  if (ts != 8 && ts != 16 && ts != 32) return (int)cudaErrorInvalidValue;
  if (D < 1 || D > 32) return (int)cudaErrorInvalidValue;
  auto* e = (const float*)entries;
  auto* o = (const int*)offs;
  auto* c = (const int*)cnts;
  auto* tf = (const float*)T_fin;
  auto* l = (const int*)last;
  auto* vi = (const float*)v_img;
  auto* vt = (const float*)v_T;
  auto* r = (float*)rows;
  auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (D <= 4)
    err = launch<4>(e, M, o, c, C, th, tw, ts, W, H, D, tf, l, vi, vt, absgrad, r, s);
  else if (D <= 8)
    err = launch<8>(e, M, o, c, C, th, tw, ts, W, H, D, tf, l, vi, vt, absgrad, r, s);
  else if (D <= 16)
    err = launch<16>(e, M, o, c, C, th, tw, ts, W, H, D, tf, l, vi, vt, absgrad, r, s);
  else
    err = launch<32>(e, M, o, c, C, th, tw, ts, W, H, D, tf, l, vi, vt, absgrad, r, s);
  return (int)err;
}
