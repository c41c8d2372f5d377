// Backward kernel of the tiled 2DGS (surfel) rasterizer
// (gsplat_tpu_torch/ops/rasterize_2dgs_tiled.py): raster::bwd_2dgs
// (csrc/raster.cuh) over the isect stream, rows gathered by flatten_ids as
// in csrc/rasterize_2dgs_tiled_fwd.cu. Its decisions round op by op
// (csrc/surfel.cuh), so it accepts the forward's entries; its gradient chain
// builds with multiply-add contraction.
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_2dgs_tiled.py::_bwd_kernel
// (called by _bwd_call). That kernel swept the pre-gathered [F, capA]
// stream back to front in K-aligned 128-lane slices with lane-roll scans,
// wrote per-entry gradients into ventries [F, capA] and left the
// per-Gaussian sums to the gather's VJP, an XLA scatter-add. Here a block
// gathers 64 rows of its range at a time and writes one row per stream slot
// (one tile of one Gaussian): rows [12 + L, M], summed per Gaussian by the
// caller with csrc/gid_reduce.cu. The distortion prefixes are rebuilt from
// the totals (W_tot = 1 - T_final, WM_tot = composited depth); the median
// takes no gradient.

#include "raster.cuh"

extern "C" int rasterize_2dgs_tiled_bwd_launch(const void* packed, int F, const void* ids,
                                               long long M, const void* offs, const void* cnts,
                                               int C, int th, int tw, int ts, int W, int H, int L,
                                               const void* T_fin, const void* last,
                                               const void* wm_tot, const void* v_feat,
                                               const void* v_T, const void* v_dist, void* rows,
                                               void* stream) {
  if (!raster::valid_tile(ts) || L < 4 || L > 35 || F % 8 != 0 || F < raster::kFix2 + L)
    return (int)cudaErrorInvalidValue;
  const raster::Gathered<64> st{(const float4*)packed, (const int*)ids, F};
  return (int)raster::launch_bwd_2dgs(st, M, (const int*)offs, (const int*)cnts, C, th, tw, ts,
                                      W, H, L, (const float*)T_fin, (const int*)last,
                                      (const float*)wm_tot, (const float*)v_feat,
                                      (const float*)v_T, (const float*)v_dist, (float*)rows,
                                      (cudaStream_t)stream);
}
