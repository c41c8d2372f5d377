// Backward kernel of the binned 2DGS (surfel) rasterizer
// (gsplat_tpu_torch/ops/rasterize_2dgs_binned.py).
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_2dgs_binned.py::_bwd2_kernel
// (called by _bwd2_call), its exact (non-coefficient) branch. That kernel
// swept 128-lane slices back to front with lane-roll scans, split the
// tile's pixels into sub-blocks to fit its live set in VMEM, and wrote
// K-aligned slots with an f32 gid row. Here, as in csrc/rasterize_bwd.cu:
//
//   one block per (camera, tile), one thread per pixel (ts*ts threads).
//   Each pixel starts from the forward's T_final and `last`. The block
//   walks its range back to front, in batches of kBatch entries staged in
//   shared memory, from the tile's largest `last` down to its first entry
//   (later entries were accepted by no pixel: their rows stay as the
//   caller zeroed them).
//
// Per pixel, carrying the later sums S_W = sum w, S_WM = sum w m and
// S_G = sum w G, and per entry at or before `last` that passes the
// forward's test (surfel.cuh, so both kernels accept the same entries):
//   T        /= 1 - alpha                       (T before this entry)
//   w         = alpha T,   cv = sum_l v_feat[l] f[l],   m = f[depth]
//   W_<       = W_tot - w - S_W,   WM_< = WM_tot - w m - S_WM
//               (W_tot = 1 - T_final, WM_tot = the composited depth)
//   G         = cv + 2 v_dist (m W_< - WM_< + S_WM - m S_W)
//   v_alpha   = T G - (S_G + v_logT) / (1 - alpha),  v_logT = v_T T_final
//   v_sigma   = -alpha v_alpha, v_op = exp(-sigma) v_alpha (0 if alpha was
//               clamped at 0.999)
//   v_f[l]    = w v_feat[l], plus 2 v_dist w (W_< - S_W) on the depth
//   3D branch: v_u = u v_sigma, v_v = v v_sigma, through the cross product
//              h_u x h_v to the nine v_M; 2D branch: v_mean = -2 d v_sigma.
// The median gets no gradient. Each of those 12 + L values is summed over
// the tile's pixels: warp shuffles (skipped when no lane of the warp
// accepted the entry), then the per-warp partials added in warp order, so
// the result is deterministic. One (tile, Gaussian) per stream slot, so
// every slot's row is written by one block and no atomics are needed:
//   rows [12 + L, M]: v_gx, v_gy, v_M00..v_M22, v_op, v_feat[L].
//
// Bound on the card: operations. Counted from the code below, a division and
// an expf one operation each: 41 per evaluated pair (those at or before the
// pixel's `last`: the forward's sigma and tests) and 5L + 87 more per
// accepted pair (the chain, the cross-product VJP, and one add into the
// slot's sum per row; the shuffle tree's further adds are this design's
// own), for the stream read once per tile and one row written per slot.

#include <cuda_runtime.h>

#include "surfel.cuh"

namespace {

constexpr int kBatch = 32;  // entries per staged batch
constexpr int kFix = 12;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;

template <int LMAX, int MAXT>
__global__ void __launch_bounds__(MAXT)
rasterize_2dgs_bwd_kernel(const float* __restrict__ entries,  // [12 + L, M]
                          long long M, const int* __restrict__ offs,
                          const int* __restrict__ cnts, int th, int tw, int ts, int W, int H,
                          int L, const float* __restrict__ T_fin,  // [C, H, W]
                          const int* __restrict__ last,            // [C, H, W]
                          const float* __restrict__ wm_tot_in,     // [C, H, W]
                          const float* __restrict__ v_feat,        // [C, H, W, L]
                          const float* __restrict__ v_T,           // [C, H, W]
                          const float* __restrict__ v_dist,        // [C, H, W]
                          float* __restrict__ rows) {              // [12 + L, M]
  extern __shared__ float sm[];
  const int nf = kFix + L;
  float* ent = sm;                 // [nf][kBatch]
  float* part = sm + nf * kBatch;  // [warps][kBatch][nf]
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
  const int md = L - 4;  // the depth: the last colour channel

  int lst = -1;
  float T = 1.0f, vlogT = 0.0f, vdist = 0.0f, w_tot = 0.0f, wm_tot = 0.0f;
  float vf[LMAX];
#pragma unroll
  for (int l = 0; l < LMAX; ++l) vf[l] = 0.0f;
  if (inside) {
    const long long pix = ((long long)cam * H + y) * W + x;
    lst = last[pix];
    T = T_fin[pix];
    vlogT = v_T[pix] * T;
    vdist = v_dist[pix];
    w_tot = 1.0f - T;
    wm_tot = wm_tot_in[pix];
#pragma unroll
    for (int l = 0; l < LMAX; ++l)
      if (l < L) vf[l] = v_feat[pix * L + l];
  }
  if (p == 0) s_lmax = -1;
  __syncthreads();
  if (lst >= 0) atomicMax(&s_lmax, lst);
  __syncthreads();
  const int nact = min(n, s_lmax + 1 - off);  // entries past the tile's largest `last` add nothing

  float sG = 0.0f, sW = 0.0f, sWM = 0.0f;
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
      float g[kFix + LMAX];
#pragma unroll
      for (int r = 0; r < kFix + LMAX; ++r) g[r] = 0.0f;
      bool accepted = false;
      if (off + b0 + j <= lst) {
        float m[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) m[i] = ent[(2 + i) * kBatch + j];
        const SurfelSigma s = surfel_sigma(m, ent[j], ent[kBatch + j], px, py);
        const float eneg = expf(-s.sig);
        const float araw = ent[11 * kBatch + j] * eneg;
        const float alpha = fminf(araw, kAlphaMax);
        if (s.sig >= 0.0f && alpha >= kAlphaMin) {
          accepted = true;
          const float one_m = 1.0f - alpha;
          T = T / one_m;
          const float w = alpha * T;
          float cv = 0.0f;
#pragma unroll
          for (int l = 0; l < LMAX; ++l)
            if (l < L) cv += vf[l] * ent[(kFix + l) * kBatch + j];
          const float depth = ent[(kFix + md) * kBatch + j];
          const float wm = w * depth;
          const float W_pref = w_tot - w - sW;
          const float WM_pref = wm_tot - wm - sWM;
          const float G = cv + vdist * 2.0f * (depth * W_pref - WM_pref + (sWM - depth * sW));
          const float v_alpha = T * G - (sG + vlogT) / one_m;
          const float v_m_extra = vdist * 2.0f * w * (W_pref - sW);
          sG += w * G;
          sW += w;
          sWM += wm;
          const bool notclamp = araw < kAlphaMax;
          const float v_sig = notclamp ? -alpha * v_alpha : 0.0f;
          g[11] = notclamp ? eneg * v_alpha : 0.0f;
#pragma unroll
          for (int l = 0; l < LMAX; ++l)
            if (l < L) g[kFix + l] = w * vf[l] + (l == md ? v_m_extra : 0.0f);
          if (s.use3d) {
            const float v_u = s.u * v_sig;
            const float v_v = s.v * v_sig;
            const float vc0 = v_u / s.crz;
            const float vc1 = v_v / s.crz;
            const float vc2 = -(s.u * v_u + s.v * v_v) / s.crz;
            const float vhu[3] = {s.hv[1] * vc2 - s.hv[2] * vc1, s.hv[2] * vc0 - s.hv[0] * vc2,
                                  s.hv[0] * vc1 - s.hv[1] * vc0};
            const float vhv[3] = {vc1 * s.hu[2] - vc2 * s.hu[1], vc2 * s.hu[0] - vc0 * s.hu[2],
                                  vc0 * s.hu[1] - vc1 * s.hu[0]};
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              g[2 + c] = -vhu[c];
              g[5 + c] = -vhv[c];
              g[8 + c] = px * vhu[c] + py * vhv[c];
            }
          } else {
            g[0] = -(2.0f * s.dx * v_sig);
            g[1] = -(2.0f * s.dy * v_sig);
          }
        }
      }
      float* dst = part + ((long long)warp * kBatch + j) * nf;
      if (__any_sync(0xffffffffu, accepted)) {
#pragma unroll
        for (int r = 0; r < kFix + LMAX; ++r) {
          if (r < nf) {
            float v = g[r];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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
      float sum = 0.0f;
      for (int w = 0; w < nwarps; ++w) sum += part[((long long)w * kBatch + j) * nf + r];
      rows[(long long)r * M + off + b0 + j] = sum;
    }
  }
}

template <int LMAX, int MAXT>
cudaError_t launch(const float* entries, long long M, const int* offs, const int* cnts, int C,
                   int th, int tw, int ts, int W, int H, int L, const float* T_fin,
                   const int* last, const float* wm_tot, const float* v_feat, const float* v_T,
                   const float* v_dist, float* rows, cudaStream_t stream) {
  const int threads = ts * ts;
  const size_t smem = (size_t)(kFix + L) * kBatch * sizeof(float) * (1 + threads / 32);
  cudaError_t err = cudaFuncSetAttribute(rasterize_2dgs_bwd_kernel<LMAX, MAXT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  rasterize_2dgs_bwd_kernel<LMAX, MAXT><<<C * th * tw, threads, smem, stream>>>(
      entries, M, offs, cnts, th, tw, ts, W, H, L, T_fin, last, wm_tot, v_feat, v_T, v_dist,
      rows);
  return cudaGetLastError();
}

// the L instantiations, each with a register budget for tiles up to 16x16
// (256 threads) and for 32x32 (1024 threads)
template <int MAXT>
cudaError_t launch_l(const float* e, long long M, const int* o, const int* c, int C, int th,
                     int tw, int ts, int W, int H, int L, const float* tf, const int* l,
                     const float* wm, const float* vf, const float* vt, const float* vd,
                     float* r, cudaStream_t s) {
  if (L <= 4) return launch<4, MAXT>(e, M, o, c, C, th, tw, ts, W, H, L, tf, l, wm, vf, vt, vd, r, s);
  if (L <= 8) return launch<8, MAXT>(e, M, o, c, C, th, tw, ts, W, H, L, tf, l, wm, vf, vt, vd, r, s);
  if (L <= 16) return launch<16, MAXT>(e, M, o, c, C, th, tw, ts, W, H, L, tf, l, wm, vf, vt, vd, r, s);
  return launch<35, MAXT>(e, M, o, c, C, th, tw, ts, W, H, L, tf, l, wm, vf, vt, vd, r, s);
}

}  // namespace

extern "C" int rasterize_2dgs_bwd_launch(const void* entries, long long M, const void* offs,
                                         const void* cnts, int C, int th, int tw, int ts,
                                         int W, int H, int L, const void* T_fin,
                                         const void* last, const void* wm_tot,
                                         const void* v_feat, const void* v_T,
                                         const void* v_dist, void* rows, void* stream) {
  if (ts != 8 && ts != 16 && ts != 32) return (int)cudaErrorInvalidValue;
  if (L < 4 || L > 35) return (int)cudaErrorInvalidValue;
  auto* e = (const float*)entries;
  auto* o = (const int*)offs;
  auto* c = (const int*)cnts;
  auto* tf = (const float*)T_fin;
  auto* l = (const int*)last;
  auto* wm = (const float*)wm_tot;
  auto* vf = (const float*)v_feat;
  auto* vt = (const float*)v_T;
  auto* vd = (const float*)v_dist;
  auto* r = (float*)rows;
  auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (ts * ts <= 256)
    err = launch_l<256>(e, M, o, c, C, th, tw, ts, W, H, L, tf, l, wm, vf, vt, vd, r, s);
  else
    err = launch_l<1024>(e, M, o, c, C, th, tw, ts, W, H, L, tf, l, wm, vf, vt, vd, r, s);
  return (int)err;
}
