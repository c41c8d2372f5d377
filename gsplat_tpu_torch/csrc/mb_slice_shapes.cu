// Per-slice building blocks of the rasterizers
// (gsplat_tpu_torch/microbench/kernel_shapes.py), the Hopper counterpart of
// scripts/exp_mxu_kernel_shapes.py::_kernel (:43, pallas_call :175). One
// template over the script's six variants. Each of T blocks (the TPU's T
// grid steps, all the same work) runs NB batches of NS = K / 128 slices of
// 128 entry lanes over P = ts * ts pixels, e[f, k] = x[f, s 128 + k] + dep[k]
// with dep = acc[0, :] * 1e-20 taken at each batch's start (the script's
// loop-carried dependency: no batch can be hoisted), and accumulates
// acc [8, 128]:
//   vpu_sigma    acc += Qm^T sig, sig = 0.5 (ca dx^2 + cc dy^2) + cb dx dy
//   mxu_sigma    acc += Qm^T (Qm coef), coef the sigma polynomial's
//                coefficients per lane (sig as a [P, 8] @ [8, 128] product)
//   moments      acc += Qm^T (ca dx + cb dy)
//   vpu_reduce5  acc[0..4] += five per-lane sums over the pixels
//   scan         acc += Qm^T Tm, Tm the product of 1 - min(|ca dx|, 0.99)
//                along the lanes (inclusive)
//   fwd_mix      a forward slice: alpha = min(op exp(-sig), 0.999), its
//                valid mask, Tm along the lanes, w = Tm alpha, and
//                acc[:, j] += e[6:14] w[j, :]^T for the first 128 pixels j
// with Qm [P, 8] = (px^2, px py, py^2, px, py, 1, 0, 0) at the pixel centres
// of a ts x ts tile and every contraction in f32 (HIGHEST's contract).
//
// Two layouts, one template. The five lane-indexed variants: a thread per
// lane and pixel group (128 lanes x 4 groups), each walking its group's
// pixels and summing its lane's contraction in registers; the groups'
// partial sums are added in a fixed order at each batch's end. The scan's
// product along the lanes crosses threads: a shuffle scan in each warp over
// chunks of 32 pixels, then the warps' totals through shared memory. The
// pixel-indexed fwd_mix: a thread per pixel walking the slice's 128 lanes in
// order (the transmittance a running product), the entries of the slice in
// shared memory. Its pixels past the first 128 feed nothing in the output;
// their sums go to `sink`, written only if the runtime flag asks, so their
// work stays (the TPU's computes the whole [8, P]).
//
// Bound on the card: operations, this data's (pixel, lane) pairs times
// each variant's f32 flops at 67 TFLOP/s (and fwd_mix's exponentials at the
// SFU's rate); x is 32 KB. T = 64 blocks fill 64 of the 132 SMs: the TPU's
// steps ran one after another on one core.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kGroups = 4;
constexpr int kLaneThreads = kLanes * kGroups;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { VPU_SIGMA = 0, MXU_SIGMA = 1, MOMENTS = 2, VPU_REDUCE5 = 3, SCAN = 4, FWD_MIX = 5 };

template <int V>
__global__ void __launch_bounds__(kLaneThreads)
slice_lanes_kernel(const float* __restrict__ x, int K, int P, int ts, int NB, float* __restrict__ out) {
  __shared__ float part[kGroups][8][kLanes];
  __shared__ float tot[kGroups][kLanes / 32][32];
  const int lane = threadIdx.x % kLanes, g = threadIdx.x / kLanes;
  const int wl = threadIdx.x & 31, wig = lane >> 5;  // lane in warp, warp in group
  const int per = P / kGroups, p0 = g * per;
  const int NS = K / kLanes;
  float acc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0.0f;

  for (int b = 0; b < NB; ++b) {
    const float dep = acc[0] * 1e-20f;
    float pr[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) pr[r] = 0.0f;
    for (int s = 0; s < NS; ++s) {
      const float* xs = x + s * kLanes + lane;
      const float gx = xs[0] + dep, gy = xs[K] + dep, ca = xs[2 * K] + dep, cb = xs[3 * K] + dep,
                  cc = xs[4 * K] + dep;
      if constexpr (V == SCAN) {
        for (int pc = p0; pc < p0 + per; pc += 32) {
          float tm[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float dx = (float)((pc + i) % ts) + 0.5f - gx;
            tm[i] = 1.0f - fminf(fabsf(ca * dx), 0.99f);
          }
#pragma unroll
          for (int d = 1; d < 32; d <<= 1)
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const float t = __shfl_up_sync(kFull, tm[i], d);
              if (wl >= d) tm[i] *= t;
            }
          if (wl == 31)
#pragma unroll
            for (int i = 0; i < 32; ++i) tot[g][wig][i] = tm[i];
          __syncthreads();
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            float carry = 1.0f;
            for (int w = 0; w < wig; ++w) carry *= tot[g][w][i];
            const int p = pc + i;
            const float pxl = (float)(p % ts) + 0.5f, pyl = (float)(p / ts) + 0.5f;
            const float v = tm[i] * carry;
            pr[0] += pxl * pxl * v;
            pr[1] += pxl * pyl * v;
            pr[2] += pyl * pyl * v;
            pr[3] += pxl * v;
            pr[4] += pyl * v;
            pr[5] += v;
          }
          __syncthreads();
        }
      } else {
        // the sigma polynomial's coefficients (mxu_sigma)
        const float c0 = 0.5f * ca, c2 = 0.5f * cc, c3 = -(ca * gx + cb * gy), c4 = -(cc * gy + cb * gx),
                    c5 = 0.5f * ca * gx * gx + cb * gx * gy + 0.5f * cc * gy * gy;
        for (int p = p0; p < p0 + per; ++p) {
          const float pxl = (float)(p % ts) + 0.5f, pyl = (float)(p / ts) + 0.5f;
          const float q[6] = {pxl * pxl, pxl * pyl, pyl * pyl, pxl, pyl, 1.0f};
          const float dx = pxl - gx, dy = pyl - gy;
          if constexpr (V == VPU_REDUCE5) {
            const float v = ca * dx + cb * dy;
            pr[0] += 0.5f * dx * dx * v;
            pr[1] += dx * dy * v;
            pr[2] += 0.5f * dy * dy * v;
            pr[3] += (ca * dx + cb * dy) * v;
            pr[4] += (cb * dx + cc * dy) * v;
          } else {
            float v;
            if constexpr (V == VPU_SIGMA)
              v = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
            else if constexpr (V == MXU_SIGMA)
              v = q[0] * c0 + q[1] * cb + q[2] * c2 + q[3] * c3 + q[4] * c4 + q[5] * c5;
            else
              v = ca * dx + cb * dy;
#pragma unroll
            for (int r = 0; r < 6; ++r) pr[r] += q[r] * v;
          }
        }
      }
    }
    // the groups' partial sums, added in a fixed order
#pragma unroll
    for (int r = 0; r < 8; ++r) part[g][r][lane] = pr[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float sum = part[0][r][lane];
#pragma unroll
      for (int k = 1; k < kGroups; ++k) sum += part[k][r][lane];
      acc[r] += sum;
    }
    __syncthreads();
  }
  if (g == 0)
#pragma unroll
    for (int r = 0; r < 8; ++r) out[((long long)blockIdx.x * 8 + r) * kLanes + lane] = acc[r];
}

__global__ void __launch_bounds__(1024)
slice_fwd_mix_kernel(const float* __restrict__ x, int K, int P, int ts, int NB, int keep_sink,
                     float* __restrict__ out, float* __restrict__ sink) {
  __shared__ float es[14][kLanes];
  __shared__ float row0[kLanes];
  const int p = threadIdx.x;
  const float pxl = (float)(p % ts) + 0.5f, pyl = (float)(p / ts) + 0.5f;
  const int NS = K / kLanes;
  float acc[8], spill = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0.0f;
  for (int b = 0; b < NB; ++b) {
    __syncthreads();
    if (p < kLanes) row0[p] = acc[0];
    __syncthreads();
    for (int s = 0; s < NS; ++s) {
      for (int i = p; i < 14 * kLanes; i += blockDim.x) {
        const int f = i / kLanes, k = i % kLanes;
        es[f][k] = x[f * K + s * kLanes + k] + row0[k] * 1e-20f;
      }
      __syncthreads();
      float T = 1.0f, c[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) c[r] = 0.0f;
      for (int k = 0; k < kLanes; ++k) {
        const float dx = pxl - es[0][k], dy = pyl - es[1][k];
        const float sig = 0.5f * (es[2][k] * dx * dx + es[4][k] * dy * dy) + es[3][k] * dx * dy;
        const float alpha = fminf(es[5][k] * expf(-sig), 0.999f);
        const bool valid = alpha >= 1.0f / 255.0f && sig >= 0.0f;
        T *= valid ? 1.0f - alpha : 1.0f;
        const float w = valid ? T * alpha : 0.0f;
#pragma unroll
        for (int r = 0; r < 8; ++r) c[r] += es[6 + r][k] * w;
      }
      if (p < kLanes) {
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r] += c[r];
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r) spill += c[r];
      }
      __syncthreads();
    }
  }
  if (p < kLanes)
#pragma unroll
    for (int r = 0; r < 8; ++r) out[((long long)blockIdx.x * 8 + r) * kLanes + p] = acc[r];
  if (keep_sink) sink[(long long)blockIdx.x * blockDim.x + p] = spill;
}

template <int V>
void lanes(const float* x, int K, int P, int ts, int NB, int T, float* out, cudaStream_t s) {
  slice_lanes_kernel<V><<<T, kLaneThreads, 0, s>>>(x, K, P, ts, NB, out);
}

}  // namespace

// x [16, K] f32; out [T, 8, 128]; sink [T, P] (fwd_mix, written if keep_sink)
extern "C" int slice_shapes_launch(int variant, const void* x, int K, int P, int ts, int NB, int T, int keep_sink,
                                   void* out, void* sink, void* stream) {
  if (K < kLanes || K % kLanes || ts < 1 || P != ts * ts || NB < 0 || T < 0 || variant < 0 || variant > 5)
    return (int)cudaErrorInvalidValue;
  if (variant == FWD_MIX ? (P < kLanes || P > 1024) : P % (kGroups * 32) != 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  float* o = (float*)out;
  switch (variant) {
    case VPU_SIGMA: lanes<VPU_SIGMA>(xf, K, P, ts, NB, T, o, s); break;
    case MXU_SIGMA: lanes<MXU_SIGMA>(xf, K, P, ts, NB, T, o, s); break;
    case MOMENTS: lanes<MOMENTS>(xf, K, P, ts, NB, T, o, s); break;
    case VPU_REDUCE5: lanes<VPU_REDUCE5>(xf, K, P, ts, NB, T, o, s); break;
    case SCAN: lanes<SCAN>(xf, K, P, ts, NB, T, o, s); break;
    default:
      slice_fwd_mix_kernel<<<T, P, 0, s>>>(xf, K, P, ts, NB, keep_sink, o, (float*)sink);
  }
  return (int)cudaGetLastError();
}
