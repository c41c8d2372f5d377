// Payload gather of the binning engine (gsplat_tpu_torch/ops/binning.py::
// sort_entries), the second half of the port of the TPU kernel
// gsplat_tpu/ops/binning.py::_emit_kernel (csrc/emit.cu is the first).
//
// The TPU kernel wrote every entry's payload rows at emit time and the sort
// permuted them. Here emit writes only keys and gids, and after the one key
// sort this kernel builds the sorted stream directly from the packed
// per-Gaussian table ([C*N, F] f32, F a multiple of 8: a row is whole
// 32-byte sectors), so the payload crosses memory once:
//   gids_s[k]     = gids[perm[k]]                      for every slot k
//   entries[f, k] = packed[gids_s[k], f]  (f < nf)     for k < n_isects
//   entries[f, k] = 0                                  past n_isects
// (past n_isects lie the culled entries: the sentinel gid C*N, no row).
// n_isects is read from device memory by every thread, so the caller needs
// no host sync.
//
// A thread per slot: it reads perm and the gid (4 bytes at a random place),
// then its row's first ceil(nf / 4) float4 with 16-byte loads, all in flight
// together, and writes the nf values to the nf output rows: a warp's store
// to a row is 32 neighbouring floats, coalesced along k.
//
// Bound on the card: bytes. The function reads perm (8 B) and a gid (4 B)
// per slot and each distinct row once, and writes a gid and nf floats per
// slot; the random reads cost whole 32-byte sectors, which this design pays
// (the gid's sector and the row's sectors per slot).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int NQ>
__global__ void __launch_bounds__(kThreads)
emit_gather_kernel(const long long* __restrict__ perm, const int* __restrict__ gids,
                   const float4* __restrict__ packed, int F4, int nf,
                   const long long* __restrict__ n_isects, long long M,
                   int* __restrict__ gids_s, float* __restrict__ entries) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= M) return;
  const int g = __ldg(gids + __ldg(perm + k));
  gids_s[k] = g;
  const bool live = k < __ldg(n_isects);
  const int nq = (nf + 3) / 4;
  const float4* row = packed + (long long)g * F4;
  float v[4 * NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float4 x = live && q < nq ? __ldg(row + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
#pragma unroll
  for (int f = 0; f < 4 * NQ; ++f)
    if (f < nf) entries[(long long)f * M + k] = v[f];
}

template <int NQ>
void launch(const void* perm, const void* gids, const void* packed, int F, int nf,
            const void* n_isects, long long M, void* gids_s, void* entries, cudaStream_t s) {
  emit_gather_kernel<NQ><<<(unsigned)((M + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const long long*)perm, (const int*)gids, (const float4*)packed, F / 4, nf,
      (const long long*)n_isects, M, (int*)gids_s, (float*)entries);
}

}  // namespace

extern "C" int emit_gather_launch(const void* perm, const void* gids, const void* packed, int F,
                                  int nf, const void* n_isects, long long M, void* gids_s,
                                  void* entries, void* stream) {
  if (M < 0 || nf < 1 || nf > F || F % 8 != 0 || nf > 48) return (int)cudaErrorInvalidValue;
  if (M > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (nf <= 12)
      launch<3>(perm, gids, packed, F, nf, n_isects, M, gids_s, entries, s);
    else if (nf <= 24)
      launch<6>(perm, gids, packed, F, nf, n_isects, M, gids_s, entries, s);
    else
      launch<12>(perm, gids, packed, F, nf, n_isects, M, gids_s, entries, s);
  }
  return (int)cudaGetLastError();
}
