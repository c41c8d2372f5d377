// The binned forward at four levels of work (gsplat_tpu_torch/microbench/
// fwd_breakdown.py), the Hopper counterpart of
// scripts/exp_fwd_breakdown.py::make_kernel (:67, pallas_call :146), which
// asks whether the forward is bound by reading its stream or by its
// arithmetic. Over each tile's entries [off, off + n) of the binned stream
// (entries [NF, M], the layout csrc/rasterize_fwd.cu reads), per level:
//   L0  the batches' checksum: out = 1e-9 x the sum of every value of the
//       tile's aligned Kb = 512-entry batches, floor(off / Kb) Kb up to
//       off + n (the TPU's staged batches; the rows past NF count as its
//       zero padding to F = 16, the entries past M as zeros);
//   L1  + sigma and alpha of each (pixel, entry) pair: out = 1e-9 x the sum
//       of alpha over the valid pairs (alpha >= 1/255, sigma >= 0);
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
// What bounds it on the card: issue slots at L1-L3 (~25-35 a pair), the
// bytes of the batches at L0. The design:
//   - a work list (fwd_breakdown.breakdown_plan) cuts each tile's range
//     into items of at most 8 slices (L0: two batches), heaviest first, so
//     the heaviest tile (~17 k entries at 1080p) spreads over ~17 SMs and
//     no tile sets the pace; a block an item. L1-L3 walk only the entries
//     the output needs, [off, off + n): entries outside it contributed
//     nothing (nor do entries past M, which read as zeros), so the output
//     is the same; 32-bit slice-relative bounds, once a slice.
//   - a tile of one item writes its output; a split tile's items write
//     partials ([8, P] at L3, a scalar at L0-L2) that a second pass over
//     the split tiles adds in item order, and that pass also writes the
//     tiles with no item (their zeros, or their value).
//   - a thread holds 4 pixels of a column: dx and the entry's shared loads
//     serve all four, and with 4 entries unrolled their exp chains
//     overlap. A slice's entries are
//     staged entry-major (float4 + float2 for the six parameters, two
//     float4s for the colours); the colour-row count is a template
//     parameter.
// Sums run in a fixed order and no atomics are used: the same bits every
// launch.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kPpt = 4;  // pixels of a column a thread
constexpr int kMaxThreads = 256;
constexpr int kSumThreads = 256;
constexpr int kFinishThreads = 256;
constexpr int kMaxRows = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float gauss_sigma(float ca, float cb, float cc, float dx, float dy) {
  return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx), __fmul_rn(__fmul_rn(cc, dy), dy))),
                   __fmul_rn(__fmul_rn(cb, dx), dy));
}

// the block's sum of v in a fixed order (a tree in each warp, then the
// warps in order); blockDim.x a multiple of 32
__device__ float block_total(float v, float* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) sum += red[w];
    red[32] = sum;
  }
  __syncthreads();
  return red[32];
}

// L0-L2's value of a tile, or a split tile's partial
__device__ __forceinline__ void put_value(float total, int tile, int slot, int P, float* __restrict__ out,
                                          float* __restrict__ partial) {
  if (slot >= 0) {
    if (threadIdx.x == 0) partial[slot] = total;
    return;
  }
  const float v = total * 1e-9f;
  float* o = out + (long long)tile * 8 * P;
  for (int i = threadIdx.x; i < 8 * P; i += blockDim.x) o[i] = v;
}

// L1-L3 over one item: entries [start, end) of one tile, D colour rows (L3)
template <int LEVEL, int D>
__global__ void __launch_bounds__(kMaxThreads)
breakdown_pairs_kernel(const float* __restrict__ entries, long long M, const int4* __restrict__ items, int tw, int th,
                       int ts, float* __restrict__ out, float* __restrict__ partial) {
  __shared__ float4 sa[kLanes];     // gx, gy, ca, cb
  __shared__ float2 sb[kLanes];     // cc, op
  __shared__ float4 sc[2][kLanes];  // colour rows 0-3, 4-7
  __shared__ float red[33];
  constexpr int kRows = LEVEL == 3 ? 6 + D : 6;
  const int4 it = items[blockIdx.x];
  const int tile = it.x, start = it.y, end = it.z, slot = it.w;
  const int P = ts * ts;
  const bool has = (int)threadIdx.x < P / kPpt;
  const int col = threadIdx.x % ts, row0 = (threadIdx.x / ts) * kPpt;
  const int rem = tile % (th * tw);
  const float px = (float)((rem % tw) * ts + col) + 0.5f;
  float py[kPpt], T[kPpt], local[kPpt], acc[kPpt][D > 0 ? D : 1];
#pragma unroll
  for (int j = 0; j < kPpt; ++j) {
    py[j] = (float)((rem / tw) * ts + row0 + j) + 0.5f;
    local[j] = 0.0f;
#pragma unroll
    for (int d = 0; d < (D > 0 ? D : 1); ++d) acc[j][d] = 0.0f;
  }

  for (int lo = start; lo < end;) {
    const int hi = min(end, (lo / kLanes + 1) * kLanes), n = hi - lo;
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * n; i += blockDim.x) {
      const int f = i / n, j = i - f * n;
      const float v = entries[f * M + lo + j];
      if (f < 4)
        reinterpret_cast<float*>(&sa[j])[f] = v;
      else if (f < 6)
        reinterpret_cast<float*>(&sb[j])[f - 4] = v;
      else
        reinterpret_cast<float*>(&sc[(f - 6) >> 2][j])[(f - 6) & 3] = v;
    }
    __syncthreads();
    if (has) {
#pragma unroll
      for (int j = 0; j < kPpt; ++j) T[j] = 1.0f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float4 a = sa[k];
        const float2 b = sb[k];
        const float dx = __fsub_rn(px, a.x);
        float c[8];
        if constexpr (LEVEL == 3) {
          const float4 c0 = sc[0][k], c1 = sc[1][k];
          c[0] = c0.x, c[1] = c0.y, c[2] = c0.z, c[3] = c0.w, c[4] = c1.x, c[5] = c1.y, c[6] = c1.z, c[7] = c1.w;
        }
#pragma unroll
        for (int j = 0; j < kPpt; ++j) {
          const float dy = __fsub_rn(py[j], a.y);
          const float sigma = gauss_sigma(a.z, a.w, b.x, dx, dy);
          const float alpha = fminf(__fmul_rn(b.y, expf(-sigma)), 0.999f);
          const bool valid = alpha >= 1.0f / 255.0f && sigma >= 0.0f;
          if constexpr (LEVEL == 1) {
            local[j] += valid ? alpha : 0.0f;
          } else {
            const float t_excl = T[j];
            T[j] = __fmul_rn(T[j], valid ? __fsub_rn(1.0f, alpha) : 1.0f);
            const float w = valid && T[j] > 1e-4f ? __fmul_rn(t_excl, alpha) : 0.0f;
            if constexpr (LEVEL == 2) {
              local[j] += w;
            } else {
#pragma unroll
              for (int d = 0; d < D; ++d) acc[j][d] += c[d] * w;
            }
          }
        }
      }
    }
    lo = hi;
  }

  if constexpr (LEVEL == 3) {
    if (!has) return;
    float* o = (slot >= 0 ? partial + (long long)slot * 8 * P : out + (long long)tile * 8 * P) + row0 * ts + col;
#pragma unroll
    for (int j = 0; j < kPpt; ++j)
#pragma unroll
      for (int d = 0; d < 8; ++d) o[d * P + j * ts] = d < D ? acc[j][d] : 0.0f;
  } else {
    float v = 0.0f;
    if (has)
#pragma unroll
      for (int j = 0; j < kPpt; ++j) v += local[j];
    put_value(block_total(v, red), tile, slot, P, out, partial);
  }
}

// L0 over one item: every value of NF rows of entries [start, end)
__global__ void __launch_bounds__(kSumThreads)
breakdown_sum_kernel(const float* __restrict__ entries, long long M, int NF, const int4* __restrict__ items, int ts,
                     float* __restrict__ out, float* __restrict__ partial) {
  __shared__ float red[33];
  const int4 it = items[blockIdx.x];
  const int n = it.z - it.y;
  float local = 0.0f;
  if ((M & 3) == 0 && ((unsigned long long)entries & 15) == 0) {  // rows and starts 16-byte aligned, n % 4 == 0
    for (int f = 0; f < NF; ++f) {
      const float4* row = reinterpret_cast<const float4*>(entries + f * M + it.y);
      for (int q = threadIdx.x; q < n / 4; q += blockDim.x) {
        const float4 v = row[q];
        local += ((v.x + v.y) + v.z) + v.w;
      }
    }
  } else {
    for (int f = 0; f < NF; ++f)
      for (int q = threadIdx.x; q < n; q += blockDim.x) local += entries[f * M + it.y + q];
  }
  put_value(block_total(local, red), it.x, it.w, ts * ts, out, partial);
}

// the tiles pass 1 leaves: each sums its `count` partials in item order
// (none: a tile with no item)
template <bool PIXELS>
__global__ void __launch_bounds__(kFinishThreads)
breakdown_finish_kernel(const int4* __restrict__ finish, int P, const float* __restrict__ partial,
                        float* __restrict__ out) {
  const int4 f = finish[blockIdx.x];
  float* o = out + (long long)f.x * 8 * P;
  if constexpr (PIXELS) {
    for (int i = threadIdx.x; i < 8 * P; i += blockDim.x) {
      float sum = 0.0f;
      for (int s = 0; s < f.z; ++s) sum += partial[(long long)(f.y + s) * 8 * P + i];
      o[i] = sum;
    }
  } else {
    float sum = 0.0f;
    for (int s = 0; s < f.z; ++s) sum += partial[f.y + s];
    const float v = sum * 1e-9f;
    for (int i = threadIdx.x; i < 8 * P; i += blockDim.x) o[i] = v;
  }
}

template <int D>
void pairs_l3(int blocks, int threads, cudaStream_t s, const float* e, long long M, const int4* it, int tw, int th,
              int ts, float* y, float* part) {
  breakdown_pairs_kernel<3, D><<<blocks, threads, 0, s>>>(e, M, it, tw, th, ts, y, part);
}

}  // namespace

// entries [NF, M] (6 <= NF <= 16, M < 2^31); items [n_items] int4 (tile,
// first entry, end entry, partial slot or -1) and finish [n_finish] int4
// (tile, first slot, slots, 0), both of fwd_breakdown.breakdown_plan for
// this level; partial [slots, 8, ts * ts] (L3) or [slots] (L0-L2); out
// [T, 8, ts * ts]
extern "C" int fwd_breakdown_launch(int level, const void* entries, long long M, int NF, int tw, int th, int ts,
                                    const void* items, int n_items, const void* finish, int n_finish, void* partial,
                                    void* out, void* stream) {
  if (level < 0 || level > 3 || NF < 6 || NF > kMaxRows || ts < 1 || ts * ts > 1024 || (ts * ts) % 32 || M < 0 ||
      M >= (1LL << 31) || n_items < 0 || n_finish < 0 || tw < 1 || th < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int P = ts * ts, threads = (P / kPpt + 31) / 32 * 32;
  const float* e = (const float*)entries;
  const int4* it = (const int4*)items;
  float *y = (float*)out, *part = (float*)partial;
  if (n_items > 0) {
    switch (level) {
      case 0: breakdown_sum_kernel<<<n_items, kSumThreads, 0, s>>>(e, M, NF, it, ts, y, part); break;
      case 1: breakdown_pairs_kernel<1, 0><<<n_items, threads, 0, s>>>(e, M, it, tw, th, ts, y, part); break;
      case 2: breakdown_pairs_kernel<2, 0><<<n_items, threads, 0, s>>>(e, M, it, tw, th, ts, y, part); break;
      default:
        switch (NF - 6 < 8 ? NF - 6 : 8) {
          case 0: pairs_l3<0>(n_items, threads, s, e, M, it, tw, th, ts, y, part); break;
          case 1: pairs_l3<1>(n_items, threads, s, e, M, it, tw, th, ts, y, part); break;
          case 2: pairs_l3<2>(n_items, threads, s, e, M, it, tw, th, ts, y, part); break;
          case 3: pairs_l3<3>(n_items, threads, s, e, M, it, tw, th, ts, y, part); break;
          case 4: pairs_l3<4>(n_items, threads, s, e, M, it, tw, th, ts, y, part); break;
          case 5: pairs_l3<5>(n_items, threads, s, e, M, it, tw, th, ts, y, part); break;
          case 6: pairs_l3<6>(n_items, threads, s, e, M, it, tw, th, ts, y, part); break;
          case 7: pairs_l3<7>(n_items, threads, s, e, M, it, tw, th, ts, y, part); break;
          default: pairs_l3<8>(n_items, threads, s, e, M, it, tw, th, ts, y, part);
        }
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_finish > 0) {
    const int4* fin = (const int4*)finish;
    if (level == 3)
      breakdown_finish_kernel<true><<<n_finish, kFinishThreads, 0, s>>>(fin, P, part, y);
    else
      breakdown_finish_kernel<false><<<n_finish, kFinishThreads, 0, s>>>(fin, P, part, y);
  }
  return (int)cudaGetLastError();
}
