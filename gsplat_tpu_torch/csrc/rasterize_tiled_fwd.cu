// Forward compositing kernel of the tiled rasterizer
// (gsplat_tpu_torch/ops/rasterize_tiled.py): raster::fwd_3dgs
// (csrc/raster.cuh) over the isect stream, rows gathered by flatten_ids.
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_tiled.py::_fwd_kernel
// (called by _fwd_call). That kernel read a pre-gathered [F, capA] entry
// stream (packed[:, flatten_ids], written once and read once per frame) in
// K-aligned 128-lane slices, and built the transmittance chain with lane
// rolls. Here nothing is pre-gathered: the per-Gaussian values are packed
// once as rows of F floats ([C*N, F], F a multiple of 8: 64 B at D = 3), and
// a block copies the rows its range names into shared memory, 256 at a time
// (F * 256 * 4 B <= 40 KB at F = 40), already entry-major. Row layout: mx,
// my, conic a, b, c, opacity, the D colours, zero padding. A thread owns P
// pixels of a tile column, and a warp skips the entries its pixels cannot
// reach, most of this stream's (it has no cull). The caller adds the
// background (T bg), as the JAX package does.

#include "raster.cuh"

extern "C" int rasterize_tiled_fwd_launch(const void* packed, int F, const void* ids,
                                          const void* offs, const void* cnts, int C, int th,
                                          int tw, int ts, int W, int H, int D, void* img,
                                          void* T_out, void* last, void* stream) {
  if (!raster::valid_tile(ts) || D < 1 || D > 32 || F % 8 != 0 || F < 6 + D)
    return (int)cudaErrorInvalidValue;
  const raster::Gathered<256> st{(const float4*)packed, (const int*)ids, F};
  return (int)raster::launch_fwd_3dgs(st, (const int*)offs, (const int*)cnts, C, th, tw, ts, W,
                                      H, D, (float*)img, (float*)T_out, (int*)last,
                                      (cudaStream_t)stream);
}
