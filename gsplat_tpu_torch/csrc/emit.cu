// Emit kernel of the binning engine (gsplat_tpu_torch/ops/binning.py).
//
// Replaces the TPU kernel gsplat_tpu/ops/binning.py::_emit_kernel (called by
// emit_entries). That kernel walked blocks of 1024 Gaussians and duplicated
// their rows into per-entry rows with one-hot selection matmuls on the MXU,
// because the TPU has no cheap gather. Here the contract is kept and the
// mechanism is not: one thread per flattened (camera, Gaussian) id walks its
// tile rectangle and writes each entry directly at its exclusive prefix-sum
// position `woff[i] + k`, so the emission order is ascending flat id.
//
// Per entry it writes
//   keys[pos]  = tile_key << 32 | (depth bits ^ 0x80000000)  (64-bit sort key;
//                the xor maps signed int32 bit order to unsigned, so the key
//                orders depths as the JAX package's int32 depth key does)
//   gids[pos]  = i
//   feats[f, pos] = payload[f, i] for the NF payload rows,
// and, where the exact ellipse-vs-tile cull drops the entry, the sentinel key
// (T << 32) and gid C*N instead. The cull is the JAX kernel's
// (binning.py:154-186) in the same operation order; this file is compiled
// with -fmad=false so that no multiply-add contraction changes a keep/drop
// decision against the plain torch version (_emit_plain).
//
// Bound on the card: bytes. Each entry costs 12 + 4*NF bytes of writes and a
// few dozen flops (one expf), far under the H100's 67 TFLOP/s f32 for any NF.
// The design keeps the writes of a warp close together (neighbouring ids
// write neighbouring ranges) but one thread serialises a large splat's whole
// rectangle: load imbalance from large splats is left for a later PR.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaCull = 1.0f / 255.0f;

__device__ __forceinline__ float quad(float ca, float cb, float cc, float dx, float dy) {
  return 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// op * exp(-min over the tile's pixel-centre box of the conic quadratic) >= 1/255
__device__ bool tile_keeps(int tx, int ty, int ts, float gx, float gy, float ca,
                           float cb, float cc, float op) {
  const float x0 = (float)tx * (float)ts + 0.5f - gx;
  const float x1 = x0 + (float)(ts - 1);
  const float y0 = (float)ty * (float)ts + 0.5f - gy;
  const float y1 = y0 + (float)(ts - 1);
  const float safe_cc = fabsf(cc) > 1e-12f ? cc : 1.0f;
  const float safe_ca = fabsf(ca) > 1e-12f ? ca : 1.0f;
  const float ye0 = clampf(-cb * x0 / safe_cc, y0, y1);
  const float ye1 = clampf(-cb * x1 / safe_cc, y0, y1);
  const float xe0 = clampf(-cb * y0 / safe_ca, x0, x1);
  const float xe1 = clampf(-cb * y1 / safe_ca, x0, x1);
  float minq = fminf(fminf(quad(ca, cb, cc, x0, ye0), quad(ca, cb, cc, x1, ye1)),
                     fminf(quad(ca, cb, cc, xe0, y0), quad(ca, cb, cc, xe1, y1)));
  const bool inside = (x0 <= 0.0f) && (0.0f <= x1) && (y0 <= 0.0f) && (0.0f <= y1);
  if (inside) minq = 0.0f;
  return op * expf(-minq) >= kAlphaCull;
}

__global__ void emit_kernel(const int* __restrict__ tminx, const int* __restrict__ tminy,
                            const int* __restrict__ rw, const int* __restrict__ counts,
                            const long long* __restrict__ woff,
                            const float* __restrict__ depth,
                            const float* __restrict__ payload,  // [NF, CN]
                            int CN, int N, int NF, int n_tiles, int tile_width,
                            int tile_size, int cull, long long M, long long sentinel,
                            long long* __restrict__ keys, int* __restrict__ gids,
                            float* __restrict__ feats) {  // [NF, M]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= CN) return;
  const int n = counts[i];
  if (n == 0) return;
  const long long base = woff[i];
  const int x0 = tminx[i];
  const int y0 = tminy[i];
  const int w = max(rw[i], 1);
  const int cam = i / N;
  // the cull reads the 3DGS layout's first six rows; a custom payload
  // (cull = 0) may have fewer
  float gx = 0.0f, gy = 0.0f, ca = 0.0f, cb = 0.0f, cc = 0.0f, op = 0.0f;
  if (cull) {
    gx = payload[i];
    gy = payload[(long long)CN + i];
    ca = payload[2LL * CN + i];
    cb = payload[3LL * CN + i];
    cc = payload[4LL * CN + i];
    op = payload[5LL * CN + i];
  }
  const long long dlow =
      (long long)(__float_as_uint(depth[i]) ^ 0x80000000u);

  for (int k = 0; k < n; ++k) {
    const int tx = x0 + k % w;
    const int ty = y0 + k / w;
    const bool keep = !cull || tile_keeps(tx, ty, tile_size, gx, gy, ca, cb, cc, op);
    const long long tile_key = (long long)cam * n_tiles + (long long)ty * tile_width + tx;
    keys[base + k] = keep ? ((tile_key << 32) | dlow) : sentinel;
    gids[base + k] = keep ? i : CN;
  }
  for (int f = 0; f < NF; ++f) {
    const float v = payload[(long long)f * CN + i];
    float* row = feats + (long long)f * M + base;
    for (int k = 0; k < n; ++k) row[k] = v;
  }
}

}  // namespace

extern "C" int emit_launch(const void* tminx, const void* tminy, const void* rw,
                           const void* counts, const void* woff, const void* depth,
                           const void* payload, int CN, int N, int NF, int n_tiles,
                           int tile_width, int tile_size, int cull, long long M,
                           long long sentinel, void* keys, void* gids, void* feats,
                           void* stream) {
  const int threads = 256;
  const int blocks = (CN + threads - 1) / threads;
  emit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)tminx, (const int*)tminy, (const int*)rw, (const int*)counts,
      (const long long*)woff, (const float*)depth, (const float*)payload, CN, N, NF,
      n_tiles, tile_width, tile_size, cull, M, sentinel, (long long*)keys, (int*)gids,
      (float*)feats);
  return (int)cudaGetLastError();
}
