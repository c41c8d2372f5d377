// Per-slice building blocks of the rasterizers
// (gsplat_tpu_torch/microbench/kernel_shapes.py), the Hopper counterpart of
// scripts/exp_mxu_kernel_shapes.py::_kernel (:43, pallas_call :175). The
// script's six variants, each over T tiles (the TPU's T grid steps, all the
// same work), each running NB batches of NS = K / 128 slices of 128 entry
// lanes over P = ts * ts pixels, e[f, k] = x[f, s 128 + k] + dep[k] with
// dep = acc[0, :] * 1e-20 taken at each batch's start (the script's
// loop-carried dependency: no batch can be hoisted), accumulating
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
// of a ts x ts tile and every product in f32 on FFMA (HIGHEST's contract).
// Every pair keeps the script's arithmetic: nothing is factored out of the
// pair loop.
//
// What bounds it on the card: issue slots, ~10-35 a (pixel, lane) pair.
// The layouts spread each tile's work over the whole card:
//   - the four lane variants: lane k's chain over the batches reads only
//     lane k's entries and dep[k] = acc[0, k], so lanes split with no
//     communication. A warp holds 4 lanes of one tile (their coefficients
//     in registers) and walks all P pixels as 32 runs, one a thread, px and
//     py stepped as exact floats; Qm is built once a pixel for the 4 lanes.
//     The warp's row-0 totals (a fixed-order tree) give dep at each batch's
//     end; 8 T warps, 4 a block (kernel_shapes.slice_plan).
//   - scan: a warp walks one pixel's 128 lanes at a time, 4 consecutive
//     lanes a thread with their products in registers, one warp scan of
//     the run totals; two pixels at once for overlap. Every lane of a tile
//     shares the chain, so a tile's pixels split over a thread-block
//     cluster of C blocks; each batch's row-0 totals go through
//     distributed shared memory, summed in rank order.
//   - fwd_mix: a thread holds a pixel and walks the slice's lanes (four at
//     once, so their exp chains overlap), staged entry-major as four
//     float4s a lane. Its dep couples every lane through acc[0, pixel], so
//     a tile's pixels split over a cluster as for the scan, and the ranks
//     that hold pixels 0-127 hand their row 0 to the others each batch.
//     Pixels past the first 128 feed nothing in the output; their sums go
//     to `sink`, written only if the runtime flag asks, so their work stays
//     (the TPU's computes the whole [8, P]).
// Partial sums are added in a fixed order and no atomics are used, so every
// launch gives the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;
constexpr int kLpt = 4;                       // lanes a thread (lane variants, scan)
constexpr int kRuns = 32;                     // a lane warp's pixel runs, one a thread
constexpr int kUnitsPerTile = kLanes / kLpt;  // lane warps a tile
constexpr int kLaneBlock = 128;               // 4 lane warps a block
constexpr int kScanThreads = 512;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kMixThreads = 1024;             // fwd_mix: a pixel a thread
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { VPU_SIGMA = 0, MXU_SIGMA = 1, MOMENTS = 2, VPU_REDUCE5 = 3, SCAN = 4, FWD_MIX = 5 };

// the first of part i's items when n items split into `parts` (floor)
__device__ __forceinline__ int split(int i, int n, int parts) { return (int)((long long)i * n / parts); }

// a fixed-order tree to lane 0, then lane 0's total to every lane
__device__ __forceinline__ float warp_total(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  return __shfl_sync(kFull, v, 0);
}

// 4 consecutive lanes of row f of slice s, plus their dep
__device__ __forceinline__ void lanes4(const float* __restrict__ xs, const float* dep, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(xs);
  v[0] = __fadd_rn(q.x, dep[0]);
  v[1] = __fadd_rn(q.y, dep[1]);
  v[2] = __fadd_rn(q.z, dep[2]);
  v[3] = __fadd_rn(q.w, dep[3]);
}

template <int V>
__global__ void __launch_bounds__(kLaneBlock)
slice_lanes_kernel(const float* __restrict__ x, int K, int P, int ts, int NB, int units, float* __restrict__ out) {
  const int unit = blockIdx.x * (kLaneBlock / 32) + (threadIdx.x >> 5);
  if (unit >= units) return;  // a whole warp: this kernel has no block barrier
  const int l = threadIdx.x & 31;
  const int t = unit / kUnitsPerTile, k0 = (unit % kUnitsPerTile) * kLpt;
  const int p0 = split(l, P, kRuns), p1 = split(l + 1, P, kRuns);
  const float tsf = (float)ts;
  const float px0 = (float)(p0 % ts) + 0.5f, py0 = (float)(p0 / ts) + 0.5f;
  const int NS = K / kLanes;
  float racc[6][kLpt], dep[kLpt];
#pragma unroll
  for (int i = 0; i < kLpt; ++i) {
    dep[i] = 0.0f;
#pragma unroll
    for (int r = 0; r < 6; ++r) racc[r][i] = 0.0f;
  }

  for (int b = 0; b < NB; ++b) {
    float pr[6][kLpt];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int i = 0; i < kLpt; ++i) pr[r][i] = 0.0f;
    for (int s = 0; s < NS; ++s) {
      const float* xs = x + s * kLanes + k0;
      float gx[kLpt], gy[kLpt], ca[kLpt], cb[kLpt], cc[kLpt];
      lanes4(xs, dep, gx);
      lanes4(xs + K, dep, gy);
      lanes4(xs + 2 * K, dep, ca);
      lanes4(xs + 3 * K, dep, cb);
      lanes4(xs + 4 * K, dep, cc);
      // the sigma polynomial's coefficients (mxu_sigma)
      float c0[kLpt], c2[kLpt], c3[kLpt], c4[kLpt], c5[kLpt];
      if constexpr (V == MXU_SIGMA) {
#pragma unroll
        for (int i = 0; i < kLpt; ++i) {
          c0[i] = 0.5f * ca[i];
          c2[i] = 0.5f * cc[i];
          c3[i] = -(ca[i] * gx[i] + cb[i] * gy[i]);
          c4[i] = -(cc[i] * gy[i] + cb[i] * gx[i]);
          c5[i] = 0.5f * ca[i] * gx[i] * gx[i] + cb[i] * gx[i] * gy[i] + 0.5f * cc[i] * gy[i] * gy[i];
        }
      }
      float px = px0, py = py0;
#pragma unroll 2
      for (int p = p0; p < p1; ++p) {
        const float q0 = px * px, q1 = px * py, q2 = py * py;
#pragma unroll
        for (int i = 0; i < kLpt; ++i) {
          const float dx = px - gx[i], dy = py - gy[i];
          if constexpr (V == VPU_REDUCE5) {
            const float v = ca[i] * dx + cb[i] * dy;
            pr[0][i] += 0.5f * dx * dx * v;
            pr[1][i] += dx * dy * v;
            pr[2][i] += 0.5f * dy * dy * v;
            pr[3][i] += (ca[i] * dx + cb[i] * dy) * v;
            pr[4][i] += (cb[i] * dx + cc[i] * dy) * v;
          } else {
            float v;
            if constexpr (V == VPU_SIGMA)
              v = 0.5f * (ca[i] * dx * dx + cc[i] * dy * dy) + cb[i] * dx * dy;
            else if constexpr (V == MXU_SIGMA)
              v = q0 * c0[i] + q1 * cb[i] + q2 * c2[i] + px * c3[i] + py * c4[i] + 1.0f * c5[i];
            else
              v = ca[i] * dx + cb[i] * dy;
            pr[0][i] += q0 * v;
            pr[1][i] += q1 * v;
            pr[2][i] += q2 * v;
            pr[3][i] += px * v;
            pr[4][i] += py * v;
            pr[5][i] += v;
          }
        }
        px += 1.0f;
        if (px > tsf) {
          px = 0.5f;
          py += 1.0f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kLpt; ++i) {
#pragma unroll
      for (int r = 0; r < 6; ++r) racc[r][i] += pr[r][i];
      dep[i] = __fmul_rn(warp_total(racc[0][i]), 1e-20f);
    }
  }
  float tot[6][kLpt];
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int i = 0; i < kLpt; ++i) tot[r][i] = warp_total(racc[r][i]);
  if (l == 0) {
    float4* o = reinterpret_cast<float4*>(out + (long long)t * 8 * kLanes + k0);
#pragma unroll
    for (int r = 0; r < 6; ++r) o[r * kLanes / 4] = make_float4(tot[r][0], tot[r][1], tot[r][2], tot[r][3]);
    o[6 * kLanes / 4] = o[7 * kLanes / 4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// one pixel of the scan: this thread's 4 lanes' inclusive products and
// their run total (after the warp scan: the total up to this thread)
struct ScanPixel {
  float inc[kLpt], tot;
};

__device__ __forceinline__ void scan_lanes(ScanPixel& a, float px, const float* gx, const float* ca) {
  float prev = 1.0f;
#pragma unroll
  for (int i = 0; i < kLpt; ++i) {
    const float om = 1.0f - fminf(fabsf(ca[i] * (px - gx[i])), 0.99f);
    prev = i == 0 ? om : prev * om;
    a.inc[i] = prev;
  }
  a.tot = prev;
}

// the pixel's Qm row times its products (this thread's, times the lanes
// before it: `carry`) into pr
__device__ __forceinline__ void scan_add(const ScanPixel& a, float carry, float px, float py, float (*pr)[kLpt]) {
  const float q0 = px * px, q1 = px * py, q2 = py * py;
#pragma unroll
  for (int i = 0; i < kLpt; ++i) {
    const float v = a.inc[i] * carry;
    pr[0][i] += q0 * v;
    pr[1][i] += q1 * v;
    pr[2][i] += q2 * v;
    pr[3][i] += px * v;
    pr[4][i] += py * v;
    pr[5][i] += v;
  }
}

__global__ void __launch_bounds__(kScanThreads)
slice_scan_kernel(const float* __restrict__ x, int K, int P, int ts, int NB, float* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int t = blockIdx.x / C;
  __shared__ float red[kScanWarps][kLanes];
  __shared__ __align__(16) float blk[2][kLanes];  // this block's row-0 totals by batch parity
  __shared__ float rows[6][kLanes];               // this block's totals at the end
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31, k0 = l * kLpt;
  // this warp's run of this rank's pixels, walked as two halves at once
  const int c0 = split(rank, P, C), n = split(rank + 1, P, C) - c0;
  const int w0 = c0 + split(w, n, kScanWarps), w1 = c0 + split(w + 1, n, kScanWarps);
  const int half = (w1 - w0 + 1) / 2, pb = w0 + half;
  const float tsf = (float)ts;
  const float ax0 = (float)(w0 % ts) + 0.5f, ay0 = (float)(w0 / ts) + 0.5f;
  const float bx0 = (float)(pb % ts) + 0.5f, by0 = (float)(pb / ts) + 0.5f;
  const int NS = K / kLanes;
  float racc[6][kLpt], dep[kLpt];
#pragma unroll
  for (int i = 0; i < kLpt; ++i) {
    dep[i] = 0.0f;
#pragma unroll
    for (int r = 0; r < 6; ++r) racc[r][i] = 0.0f;
  }

  for (int b = 0; b < NB; ++b) {
    float pr[6][kLpt];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int i = 0; i < kLpt; ++i) pr[r][i] = 0.0f;
    for (int s = 0; s < NS; ++s) {
      float gx[kLpt], ca[kLpt];
      lanes4(x + s * kLanes + k0, dep, gx);
      lanes4(x + 2 * K + s * kLanes + k0, dep, ca);
      float ax = ax0, ay = ay0, bx = bx0, by = by0;
      for (int j = 0; j < half; ++j) {
        ScanPixel sa, sb;
        scan_lanes(sa, ax, gx, ca);
        scan_lanes(sb, bx, gx, ca);
        // inclusive warp scans of the run totals, both pixels at once
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float ua = __shfl_up_sync(kFull, sa.tot, d), ub = __shfl_up_sync(kFull, sb.tot, d);
          if (l >= d) {
            sa.tot *= ua;
            sb.tot *= ub;
          }
        }
        float carry_a = __shfl_up_sync(kFull, sa.tot, 1), carry_b = __shfl_up_sync(kFull, sb.tot, 1);
        if (l == 0) carry_a = carry_b = 1.0f;
        scan_add(sa, carry_a, ax, ay, pr);
        if (pb + j < w1) scan_add(sb, carry_b, bx, by, pr);  // warp-uniform: the second half may be one short
        ax += 1.0f;
        if (ax > tsf) {
          ax = 0.5f;
          ay += 1.0f;
        }
        bx += 1.0f;
        if (bx > tsf) {
          bx = 0.5f;
          by += 1.0f;
        }
      }
    }
    // row 0's totals over the cluster, for dep
#pragma unroll
    for (int i = 0; i < kLpt; ++i) {
#pragma unroll
      for (int r = 0; r < 6; ++r) racc[r][i] += pr[r][i];
      red[w][k0 + i] = racc[0][i];
    }
    __syncthreads();
    if (threadIdx.x < kLanes) {
      float sum = 0.0f;
      for (int v = 0; v < kScanWarps; ++v) sum += red[v][threadIdx.x];
      blk[b & 1][threadIdx.x] = sum;
    }
    cluster.sync();
    float tot[kLpt] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < C; ++r) {
      const float4 q = *reinterpret_cast<const float4*>(cluster.map_shared_rank(&blk[b & 1][k0], r));
      tot[0] += q.x;
      tot[1] += q.y;
      tot[2] += q.z;
      tot[3] += q.w;
    }
#pragma unroll
    for (int i = 0; i < kLpt; ++i) dep[i] = __fmul_rn(tot[i], 1e-20f);
  }
  // every row's totals: the block's warps in order, then rank 0 adds the ranks in order
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int i = 0; i < kLpt; ++i) red[w][k0 + i] = racc[r][i];
    __syncthreads();
    if (threadIdx.x < kLanes) {
      float sum = 0.0f;
      for (int v = 0; v < kScanWarps; ++v) sum += red[v][threadIdx.x];
      rows[r][threadIdx.x] = sum;
    }
    __syncthreads();
  }
  cluster.sync();
  if (rank == 0)
    for (int i = threadIdx.x; i < 8 * kLanes; i += blockDim.x) {
      const int r = i / kLanes, k = i % kLanes;
      float sum = 0.0f;
      if (r < 6)
        for (int c = 0; c < C; ++c) sum += cluster.map_shared_rank(&rows[r][0], c)[k];
      out[(long long)t * 8 * kLanes + i] = sum;
    }
  cluster.sync();  // no block leaves while rank 0 reads its rows
}

// at least one block an SM: nvcc then gives the loop 64 registers, ~10% faster than its own 52
__global__ void __launch_bounds__(kMixThreads, 1)
slice_fwd_mix_kernel(const float* __restrict__ x, int K, int P, int ts, int NB, int keep_sink,
                     float* __restrict__ out, float* __restrict__ sink) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int t = blockIdx.x / C;
  // a lane's 16 rows, entry-major as four float4s: (gx, gy, ca, cb), (cc, op, c0, c1), (c2..c5), (c6, c7, -, -)
  __shared__ float4 es[2][4][kLanes];
  __shared__ float dep[kLanes];
  __shared__ float own[2][kLanes];  // row 0 of this rank's output pixels, by batch parity
  const int c0 = split(rank, P, C), c1 = split(rank + 1, P, C);
  const int nt = blockDim.x, p = c0 + threadIdx.x;
  const bool live = p < c1;
  const float pxl = (float)((live ? p : c0) % ts) + 0.5f, pyl = (float)((live ? p : c0) / ts) + 0.5f;
  float acc[8], spill = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0.0f;
  // the rank that holds pixel k (< 128), for lane k's dep
  __shared__ int owner[kLanes];
  for (int k = threadIdx.x; k < kLanes; k += nt) {
    int r = 0;
    while (split(r + 1, P, C) <= k) ++r;
    owner[k] = r;
  }
  const int NS = K / kLanes;
  int slice = 0;
  for (int b = 0; b < NB; ++b) {
    __syncthreads();
    for (int k = threadIdx.x; k < kLanes; k += nt)
      dep[k] = b == 0 ? 0.0f : __fmul_rn(cluster.map_shared_rank(&own[(b - 1) & 1][0], owner[k])[k], 1e-20f);
    __syncthreads();
    for (int s = 0; s < NS; ++s, ++slice) {
      // a float4 of 4 rows of one lane a thread: coalesced reads, conflict-free 16-byte stores
      for (int u = threadIdx.x; u < 4 * kLanes; u += nt) {
        const int q = u / kLanes, k = u % kLanes;
        const float* xs = x + 4 * q * K + s * kLanes + k;
        const float d = dep[k];
        es[slice & 1][q][k] = make_float4(__fadd_rn(xs[0], d), __fadd_rn(xs[K], d), __fadd_rn(xs[2 * K], d),
                                          __fadd_rn(xs[3 * K], d));
      }
      __syncthreads();
      const float4(*ek)[kLanes] = es[slice & 1];
      float T = 1.0f, c[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) c[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < kLanes; ++k) {
        const float4 g = ek[0][k], h = ek[1][k], c25 = ek[2][k], c67 = ek[3][k];
        const float dx = pxl - g.x, dy = pyl - g.y;
        const float sig = 0.5f * (g.z * dx * dx + h.x * dy * dy) + g.w * dx * dy;
        const float alpha = fminf(h.y * expf(-sig), 0.999f);
        const bool valid = alpha >= 1.0f / 255.0f && sig >= 0.0f;
        T *= valid ? 1.0f - alpha : 1.0f;
        const float w = valid ? T * alpha : 0.0f;
        c[0] += h.z * w;
        c[1] += h.w * w;
        c[2] += c25.x * w;
        c[3] += c25.y * w;
        c[4] += c25.z * w;
        c[5] += c25.w * w;
        c[6] += c67.x * w;
        c[7] += c67.y * w;
      }
      if (p < kLanes) {
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r] += c[r];
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r) spill += c[r];
      }
    }
    if (live && p < kLanes) own[b & 1][p] = acc[0];
    cluster.sync();  // own[] for the next batch's dep; no block reads it after the last
  }
  if (!live) return;
  if (p < kLanes)
#pragma unroll
    for (int r = 0; r < 8; ++r) out[((long long)t * 8 + r) * kLanes + p] = acc[r];
  if (keep_sink) sink[(long long)t * P + p] = spill;
}

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int blocks, int threads, int cluster, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// x [16, K] f32, 16-byte aligned; out [T, 8, 128]; sink [T, P] (fwd_mix,
// written if keep_sink); cluster: the blocks a tile of the scan and fwd_mix
// (1 for the lane variants), kernel_shapes.slice_plan's, which mirrors the
// blocks and threads derived here
extern "C" int slice_shapes_launch(int variant, const void* x, int K, int P, int ts, int NB, int T, int keep_sink,
                                   int cluster, void* out, void* sink, void* stream) {
  if (K < kLanes || K % kLanes || ts < 1 || P != ts * ts || NB < 0 || T < 0 || variant < 0 || variant > 5 ||
      ((unsigned long long)x & 15))
    return (int)cudaErrorInvalidValue;
  if (variant == FWD_MIX && (P < kLanes || P > 1024)) return (int)cudaErrorInvalidValue;
  if (variant < SCAN ? cluster != 1 : (cluster < 1 || cluster > kMaxCluster)) return (int)cudaErrorInvalidValue;
  int blocks, threads;
  if (variant < SCAN) {
    blocks = (int)(((long long)T * kUnitsPerTile + kLaneBlock / 32 - 1) / (kLaneBlock / 32));
    threads = kLaneBlock;
  } else {
    blocks = T * cluster;
    threads = variant == SCAN ? kScanThreads : ((P + cluster - 1) / cluster + 31) / 32 * 32;
  }
  if (T == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  float* o = (float*)out;
  const int units = T * kUnitsPerTile;
  cudaError_t err;
  switch (variant) {
    case VPU_SIGMA: err = launch(slice_lanes_kernel<VPU_SIGMA>, blocks, threads, 1, s, xf, K, P, ts, NB, units, o); break;
    case MXU_SIGMA: err = launch(slice_lanes_kernel<MXU_SIGMA>, blocks, threads, 1, s, xf, K, P, ts, NB, units, o); break;
    case MOMENTS: err = launch(slice_lanes_kernel<MOMENTS>, blocks, threads, 1, s, xf, K, P, ts, NB, units, o); break;
    case VPU_REDUCE5:
      err = launch(slice_lanes_kernel<VPU_REDUCE5>, blocks, threads, 1, s, xf, K, P, ts, NB, units, o);
      break;
    case SCAN: err = launch(slice_scan_kernel, blocks, threads, cluster, s, xf, K, P, ts, NB, o); break;
    default:
      err = launch(slice_fwd_mix_kernel, blocks, threads, cluster, s, xf, K, P, ts, NB, keep_sink, o, (float*)sink);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
