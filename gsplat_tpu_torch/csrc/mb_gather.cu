// Gather micro-benchmarks (gsplat_tpu_torch/microbench/primitives.py), the
// Hopper counterparts of the TPU's in-kernel gathers:
//
//   gather_rows   <- scripts/exp_r2_batch2.py::g1.kern (:18, pallas_call :27):
//                 out[b, s, l] = tab[b, idx[b, s, l], l], tab, idx and out
//                 [NB, S, L]; also exp_r2_primitives.py::e1.k_taa0 (:57,
//                 :67: take_along_axis along sublanes, idx % F).
//                 A table [S, L] is S L 4 bytes (1 MB at the script's 2048 x
//                 128): more than a block's 227 KB of shared memory. So a
//                 block stages one group of LANES lanes of one table, S x
//                 LANES floats, and gathers that group's outputs from it.
//                 Every byte moves in whole 16-byte pieces of a row: the
//                 group's rows by cp.async (a row's LANES x 4 bytes, 64 at
//                 16 lanes), the indices by 16-byte loads and the outputs
//                 by 16-byte stores along l, 8 of each a thread in flight.
//                 The lanes are 16 where a stage of S x 16 floats fits
//                 (S <= 3632; the script's 2048: 128 KB), else 8 (S <=
//                 7264) (`primitives.gather_plan`). Blocks are persistent
//                 and walk the (b, lane group) groups; the next group's
//                 copy starts as soon as the stage is free.
//   gather_window <- e1.kern2 (:79, :86): out[b, f, k] = tab[f, idx[b, f, k]]
//                 from a resident window tab [F, W]; also e1.k_taa (:52,
//                 :67: take_along_axis along lanes, one block). A block
//                 stages one row of the window (W floats, 32 KB at W = 8192)
//                 by cp.async and gathers an equal share of that row's NB x K
//                 outputs, indices and outputs as 16-byte vectors along k;
//                 the plan gives each row as many blocks as fill the card in
//                 one wave (33 at e1b: 528 blocks, 4 an SM).
//   gather_cols   <- e4.kern (:155, :168): out[b, f, s] = tab[b, f, idx[b, 0,
//                 s]], done on the TPU as a one-hot matmul at HIGHEST (exact);
//                 here the gather itself, the contract and not the
//                 mechanism. A block stages tab[b] (F x G floats, 64 KB at 16
//                 x 1024) and writes out[b], coalesced along s.
//
// Where a width is not a multiple of 4 or a pointer is off 16-byte alignment
// the same kernels run their scalar form: 4-byte cp.async and 4-byte loads
// and stores. Bound on the card: bytes, each input read once and each
// output written once (the script's shapes: 1.61 GB, 67.6 MB and 105 MB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// blocks an SM holds by registers at least (64 a thread): the plan counts no
// more resident blocks than this, so its persistent grids run in one wave
constexpr int kMinBlocks = 4;
constexpr int kUnroll = 8;  // index loads a thread keeps in flight (16 bytes each: 32 KB a block)
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- gather_rows
// One group: rows [0, S) x lanes [l0, l0 + nl) of one table, at src = tab +
// b S L + l0, into stage [S][LANES]. VEC: nl and L multiples of 4, 16-byte
// pieces.
template <int LANES, bool VEC>
__device__ __forceinline__ void stage_rows(float* stage, const float* __restrict__ src, int S, int L, int nl) {
  constexpr int P = VEC ? LANES / 4 : LANES;  // pieces a row
  const int np = VEC ? nl / 4 : nl;
  for (int i = threadIdx.x; i < S * P; i += kThreads) {
    const int s = i / P, c = i % P;
    if (c < np) {
      if (VEC)
        cp16(stage + s * LANES + 4 * c, src + (long long)s * L + 4 * c);
      else
        cp4(stage + s * LANES + c, src + (long long)s * L + c);
    }
  }
  cp_commit();
}

// out[s, j] = stage[idx[s, j]][j] for the group's rows and lanes (idx and out
// at the group's origin)
template <int LANES, bool VEC>
__device__ __forceinline__ void gather_group(const float* stage, const int* __restrict__ idx,
                                             float* __restrict__ out, int S, int L, int nl) {
  constexpr int P = VEC ? LANES / 4 : LANES;
  const int np = VEC ? nl / 4 : nl;
  const int n = S * P;
  // the offsets are recomputed after the loads (cheap) rather than kept
  // live beside the loaded indices
  auto at = [&](int i) { return (long long)(i / P) * L + (VEC ? 4 : 1) * (i % P); };
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n && i % P < np) {
        if (VEC)
          v[u] = __ldcs(reinterpret_cast<const int4*>(idx + at(i)));
        else
          v[u].x = __ldcs(idx + at(i));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads, c = i % P;
      if (i >= n || c >= np) continue;
      if (VEC) {
        const float* col = stage + 4 * c;
        const float4 r = make_float4(col[v[u].x * LANES], col[v[u].y * LANES + 1], col[v[u].z * LANES + 2],
                                     col[v[u].w * LANES + 3]);
        __stcs(reinterpret_cast<float4*>(out + at(i)), r);
      } else {
        __stcs(out + at(i), stage[v[u].x * LANES + c]);
      }
    }
  }
}

template <int LANES, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gather_rows_kernel(const float* __restrict__ tab, const int* __restrict__ idx, int NB, int S, int L,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) float stage[];  // [S][LANES]
  const int groups_l = (L + LANES - 1) / LANES;
  const long long groups = (long long)NB * groups_l, SL = (long long)S * L;
  long long q = blockIdx.x;
  if (q >= groups) return;
  auto origin = [&](long long g) { return (g / groups_l) * SL + (g % groups_l) * LANES; };
  auto width = [&](long long g) { return min(LANES, L - (int)(g % groups_l) * LANES); };
  stage_rows<LANES, VEC>(stage, tab + origin(q), S, L, width(q));
  for (; q < groups; q += gridDim.x) {
    const long long o = origin(q), next = q + gridDim.x;
    cp_wait<0>();
    __syncthreads();
    gather_group<LANES, VEC>(stage, idx + o, out + o, S, L, width(q));
    __syncthreads();  // the stage is free for the next group
    if (next < groups) stage_rows<LANES, VEC>(stage, tab + origin(next), S, L, width(next));
  }
}

// ---------------------------------------------------------------- gather_window
// Block (f, part) of `per_f` a row: stages tab[f] (16-byte copies where
// copy16: W % 4 == 0 and the pointers aligned) and writes its share
// [c0, c1) of the row's NB x Kc chunks (Kc = K / 4 vectors, or K scalars), in
// the index type I (32-bit where NB Kc fits).
template <bool VEC, typename I>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gather_window_kernel(const float* __restrict__ tab, const int* __restrict__ idx, int NB, int F, int W, int K,
                     int per_f, int copy16, float* __restrict__ out) {
  extern __shared__ __align__(16) float row[];  // [W]
  const int f = blockIdx.x / per_f, part = blockIdx.x % per_f;
  const float* src = tab + (long long)f * W;
  if (copy16) {
    for (int w = 4 * threadIdx.x; w < W; w += 4 * kThreads) cp16(row + w, src + w);
  } else {
    for (int w = threadIdx.x; w < W; w += kThreads) cp4(row + w, src + w);
  }
  cp_commit();
  const I Kc = VEC ? K / 4 : K;
  const I n = (I)NB * Kc, share = n / per_f, rest = n % per_f;
  const I c0 = part * share + min((I)part, rest), c1 = c0 + share + ((I)part < rest);
  const long long FK = (long long)F * K, fK = (long long)f * K;
  cp_wait<0>();
  __syncthreads();
  auto at = [&](I i) {
    const I b = i / Kc;
    return (long long)b * FK + fK + (VEC ? 4 : 1) * (long long)(i - b * Kc);
  };
  for (I i0 = c0 + threadIdx.x; i0 < c1; i0 += kThreads * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I i = i0 + u * kThreads;
      if (i < c1) {
        if (VEC)
          v[u] = __ldcs(reinterpret_cast<const int4*>(idx + at(i)));
        else
          v[u].x = __ldcs(idx + at(i));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I i = i0 + u * kThreads;
      if (i >= c1) continue;
      if (VEC)
        __stcs(reinterpret_cast<float4*>(out + at(i)), make_float4(row[v[u].x], row[v[u].y], row[v[u].z], row[v[u].w]));
      else
        __stcs(out + at(i), row[v[u].x]);
    }
  }
}

// ---------------------------------------------------------------- gather_cols
__global__ void __launch_bounds__(kThreads)
gather_cols_kernel(const float* __restrict__ tab, const int* __restrict__ idx, int F, int G, int S,
                   float* __restrict__ out) {
  extern __shared__ float slab[];  // [F][G]
  const int b = blockIdx.x;
  const float* t = tab + (long long)b * F * G;
  for (int i = threadIdx.x; i < F * G; i += kThreads) slab[i] = __ldg(t + i);
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const int g = __ldg(idx + (long long)b * S + s);
    for (int f = 0; f < F; ++f) out[((long long)b * F + f) * S + s] = slab[f * G + g];
  }
}

int smem_ok(const void* kernel, size_t bytes) {
  if (bytes > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

using RowsKernel = void (*)(const float*, const int*, int, int, int, float*);
using WindowKernel = void (*)(const float*, const int*, int, int, int, int, int, int, float*);

template <int LANES>
RowsKernel rows_kernel(bool vec) {
  return vec ? gather_rows_kernel<LANES, true> : gather_rows_kernel<LANES, false>;
}

}  // namespace

// tab, idx, out [NB, S, L]; dims {NB, S, L, lanes, blocks}, the last two
// from primitives.gather_plan: a stage of S x lanes floats (lanes 16 or 8),
// `blocks` persistent blocks. The ints come in one array, which the wrapper
// makes once a shape: ctypes converts every argument of every call on the
// host.
extern "C" int gather_rows_launch(const void* tab, const void* idx, void* out, const int* dims, void* stream) {
  const int NB = dims[0], S = dims[1], L = dims[2], lanes = dims[3], blocks = dims[4];
  if (NB < 0 || S < 1 || L < 1 || NB > 65535 || blocks < 0) return (int)cudaErrorInvalidValue;
  if (lanes != 8 && lanes != 16) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * lanes * sizeof(float);
  const bool vec = L % 4 == 0 && aligned16(tab) && aligned16(idx) && aligned16(out);
  const RowsKernel kernel = lanes == 16 ? rows_kernel<16>(vec) : rows_kernel<8>(vec);
  if (int e = smem_ok((const void*)kernel, smem)) return e;
  if (NB > 0) {
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>((const float*)tab, (const int*)idx, NB, S, L,
                                                             (float*)out);
  }
  return (int)cudaGetLastError();
}

// tab [F, W]; idx, out [NB, F, K]; dims {NB, F, W, K, blocks}, blocks
// (primitives.gather_plan) a multiple of F, blocks / F for each row of the
// window
extern "C" int gather_window_launch(const void* tab, const void* idx, void* out, const int* dims, void* stream) {
  const int NB = dims[0], F = dims[1], W = dims[2], K = dims[3], blocks = dims[4];
  if (NB < 0 || F < 1 || W < 1 || K < 0 || blocks < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)((W + 3) / 4) * 4 * sizeof(float);
  const bool aligned = aligned16(tab) && aligned16(idx) && aligned16(out);
  const bool vec = K % 4 == 0 && aligned;
  // 32-bit chunk indices where a row's NB x Kc chunks leave room for a
  // thread's last step past them
  const bool wide = (unsigned long long)NB * (vec ? K / 4 : K) >= (1ull << 30);
  const WindowKernel kernel = vec ? (wide ? gather_window_kernel<true, long long> : gather_window_kernel<true, int>)
                                  : (wide ? gather_window_kernel<false, long long> : gather_window_kernel<false, int>);
  if (int e = smem_ok((const void*)kernel, smem)) return e;
  if (NB > 0 && K > 0) {
    if (blocks < F || blocks % F) return (int)cudaErrorInvalidValue;
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>((const float*)tab, (const int*)idx, NB, F, W, K,
                                                             blocks / F, W % 4 == 0 && aligned, (float*)out);
  }
  return (int)cudaGetLastError();
}

// tab [NB, F, G]; idx [NB, S]; out [NB, F, S]
extern "C" int gather_cols_launch(const void* tab, const void* idx, int NB, int F, int G, int S, void* out,
                                  void* stream) {
  if (NB < 0 || F < 1 || G < 1 || S < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)F * G * sizeof(float);
  if (int e = smem_ok((const void*)gather_cols_kernel, smem)) return e;
  if (NB > 0 && S > 0)
    gather_cols_kernel<<<NB, kThreads, smem, (cudaStream_t)stream>>>((const float*)tab, (const int*)idx, F, G, S,
                                                                     (float*)out);
  return (int)cudaGetLastError();
}
