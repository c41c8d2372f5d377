// Forward compositing kernel of the tiled 2DGS (surfel) rasterizer
// (gsplat_tpu_torch/ops/rasterize_2dgs_tiled.py): raster::fwd_2dgs
// (csrc/raster.cuh) over the isect stream, rows gathered by flatten_ids.
// Built with -fmad=false (csrc/surfel.cuh).
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_2dgs_tiled.py::_fwd_kernel
// (called by _fwd_call). That kernel read a pre-gathered [F, capA] entry
// stream in K-aligned 128-lane slices, built the transmittance chain and
// the distortion's prefix sums with lane-roll scans, composited the
// features with an MXU contraction and found the median with lane
// max-reductions. Here a thread owns P pixels of a tile column and walks
// the chain of each itself, and a block copies the rows
// packed[flatten_ids[i]] (F floats, F a multiple of 8: 96 B for RGB+ED) its
// range names into shared memory, 64 at a time (F * 64 * 4 B <= 12 KB at
// F = 48), instead of reading a pre-gathered stream; each row is read as
// float4, once for the thread's P pixels. Row layout: mx, my, M00..M22,
// opacity, the L features, zero padding.

#include "raster.cuh"

extern "C" int rasterize_2dgs_tiled_fwd_launch(const void* packed, int F, const void* ids,
                                               const void* offs, const void* cnts, int C, int th,
                                               int tw, int ts, int W, int H, int L, void* feat,
                                               void* T_out, void* last, void* dist, void* med,
                                               void* stream) {
  if (!raster::valid_tile(ts) || L < 4 || L > 35 || F % 8 != 0 || F < raster::kFix2 + L)
    return (int)cudaErrorInvalidValue;
  const raster::Gathered<64> st{(const float4*)packed, (const int*)ids, F};
  return (int)raster::launch_fwd_2dgs(st, (const int*)offs, (const int*)cnts, C, th, tw, ts, W,
                                      H, L, (float*)feat, (float*)T_out, (int*)last,
                                      (float*)dist, (float*)med, (cudaStream_t)stream);
}
