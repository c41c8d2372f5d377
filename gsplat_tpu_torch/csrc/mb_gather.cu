// Gather micro-benchmarks (gsplat_tpu_torch/microbench/primitives.py), the
// Hopper counterparts of the TPU's in-kernel gathers:
//
//   gather_rows   <- scripts/exp_r2_batch2.py::g1.kern (:18, pallas_call :27):
//                 out[b, s, l] = tab[b, idx[b, s, l], l], tab, idx and out
//                 [NB, S, L]; also exp_r2_primitives.py::e1.k_taa0 (:57,
//                 :67: take_along_axis along sublanes, idx % F).
//                 A table [S, L] is S L 4 bytes (1 MB at the script's 2048 x
//                 128): more than a block's 227 KB of shared memory. So a
//                 block stages one group of kLanes lanes of one table,
//                 S x kLanes floats (64 KB at S = 2048), and gathers that
//                 group's outputs from it; a warp reads and writes 4 rows of
//                 8 lanes, 32-byte sectors.
//   gather_window <- e1.kern2 (:79, :86): out[b, f, k] = tab[f, idx[b, f, k]]
//                 from a resident window tab [F, W]; also e1.k_taa (:52,
//                 :67: take_along_axis along lanes, one block). A block
//                 stages one row of the window (W floats, 32 KB at W = 8192)
//                 and gathers kBatch of its b's.
//   gather_cols   <- e4.kern (:155, :168): out[b, f, s] = tab[b, f, idx[b, 0,
//                 s]], done on the TPU as a one-hot matmul at HIGHEST (exact);
//                 here the gather itself, the contract and not the
//                 mechanism. A block stages tab[b] (F x G floats, 64 KB at 16
//                 x 1024) and writes out[b], coalesced along s.
//
// Bound on the card: bytes, each input read once and each output written
// once (the script's shapes: 1.61 GB, 67.6 MB and 105 MB).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;    // gather_rows: lanes a block stages
constexpr int kBatch = 16;   // gather_window: b's a block gathers

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ tab, const int* __restrict__ idx, int S, int L,
                   float* __restrict__ out) {
  extern __shared__ float stage[];  // [S][kLanes]
  const int b = blockIdx.y, l0 = blockIdx.x * kLanes;
  const int nl = min(kLanes, L - l0);
  const long long base = (long long)b * S * L + l0;
  const int j = threadIdx.x % kLanes;
  for (int s = threadIdx.x / kLanes; s < S; s += kThreads / kLanes)
    if (j < nl) stage[s * kLanes + j] = __ldg(tab + base + (long long)s * L + j);
  __syncthreads();
  for (int s = threadIdx.x / kLanes; s < S; s += kThreads / kLanes)
    if (j < nl) {
      const long long o = base + (long long)s * L + j;
      out[o] = stage[__ldg(idx + o) * kLanes + j];
    }
}

__global__ void __launch_bounds__(kThreads)
gather_window_kernel(const float* __restrict__ tab, const int* __restrict__ idx, int NB, int F, int W, int K,
                     float* __restrict__ out) {
  extern __shared__ float row[];  // [W]
  const int f = blockIdx.x, b0 = blockIdx.y * kBatch;
  for (int w = threadIdx.x; w < W; w += kThreads) row[w] = __ldg(tab + (long long)f * W + w);
  __syncthreads();
  const int nb = min(kBatch, NB - b0);
  for (int i = threadIdx.x; i < nb * K; i += kThreads) {
    const long long o = ((long long)(b0 + i / K) * F + f) * K + i % K;
    out[o] = row[__ldg(idx + o)];
  }
}

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
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return 0;
}

}  // namespace

// tab, idx, out [NB, S, L]
extern "C" int gather_rows_launch(const void* tab, const void* idx, int NB, int S, int L, void* out,
                                  void* stream) {
  if (NB < 0 || S < 1 || L < 1 || NB > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * kLanes * sizeof(float);
  if (int e = smem_ok((const void*)gather_rows_kernel, smem)) return e;
  if (NB > 0)
    gather_rows_kernel<<<dim3((L + kLanes - 1) / kLanes, NB), kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)tab, (const int*)idx, S, L, (float*)out);
  return (int)cudaGetLastError();
}

// tab [F, W]; idx, out [NB, F, K]
extern "C" int gather_window_launch(const void* tab, const void* idx, int NB, int F, int W, int K, void* out,
                                    void* stream) {
  if (NB < 0 || F < 1 || W < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)W * sizeof(float);
  if (int e = smem_ok((const void*)gather_window_kernel, smem)) return e;
  if (NB > 0 && K > 0)
    gather_window_kernel<<<dim3(F, (NB + kBatch - 1) / kBatch), kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)tab, (const int*)idx, NB, F, W, K, (float*)out);
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
