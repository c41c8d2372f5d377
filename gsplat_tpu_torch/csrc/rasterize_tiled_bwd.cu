// Backward kernel of the tiled rasterizer
// (gsplat_tpu_torch/ops/rasterize_tiled.py): raster::bwd_3dgs
// (csrc/raster.cuh) over the isect stream, rows gathered by flatten_ids as
// in csrc/rasterize_tiled_fwd.cu.
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_tiled.py::_bwd_kernel
// (called by _bwd_call). That kernel swept the pre-gathered [F, capA]
// stream back to front in K-aligned 128-lane slices with lane-roll scans,
// wrote per-entry gradients into ventries [F, capA], and left the
// per-Gaussian sums to the gather's VJP, an XLA scatter-add. Here a block
// gathers 64 rows of its range at a time (a thread owns P pixels of a
// column, as in csrc/rasterize_bwd.cu) and writes one row per stream slot
// (one tile of one Gaussian): rows [6 + D (+2), M], summed per Gaussian by
// the caller with the gid reduce kernel (csrc/gid_reduce.cu), so no atomics
// are needed and the sums are deterministic.

#include "raster.cuh"

extern "C" int rasterize_tiled_bwd_launch(const void* packed, int F, const void* ids,
                                          long long M, const void* offs, const void* cnts,
                                          int C, int th, int tw, int ts, int W, int H, int D,
                                          const void* T_fin, const void* last,
                                          const void* v_img, const void* v_T, int absgrad,
                                          void* rows, void* stream) {
  if (!raster::valid_tile(ts) || D < 1 || D > 32 || F % 8 != 0 || F < 6 + D)
    return (int)cudaErrorInvalidValue;
  const raster::Gathered<64> st{(const float4*)packed, (const int*)ids, F};
  return (int)raster::launch_bwd_3dgs(st, M, (const int*)offs, (const int*)cnts, C, th, tw, ts,
                                      W, H, D, (const float*)T_fin, (const int*)last,
                                      (const float*)v_img, (const float*)v_T, absgrad,
                                      (float*)rows, (cudaStream_t)stream);
}
