// Backward kernel of the binned 2DGS (surfel) rasterizer
// (gsplat_tpu_torch/ops/rasterize_2dgs_binned.py): raster::bwd_2dgs
// (csrc/raster.cuh) over the binned stream. Its decisions round op by op
// (csrc/surfel.cuh), so it accepts the forward's entries; its gradient chain
// builds with multiply-add contraction.
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_2dgs_binned.py::_bwd2_kernel
// (called by _bwd2_call), its exact (non-coefficient) branch. That kernel
// swept 128-lane slices back to front with lane-roll scans, split the
// tile's pixels into sub-blocks to fit its live set in VMEM, and wrote
// K-aligned slots with an f32 gid row. Here a thread owns P pixels of a
// column, a block stages 64 entries of the [12 + L, M] stream at a time, and
// each stream slot's row [12 + L, M] is written by the one block of its tile
// (summed over the tile by a transposed warp reduction).

#include "raster.cuh"

extern "C" int rasterize_2dgs_bwd_launch(const void* entries, long long M, const void* offs,
                                         const void* cnts, int C, int th, int tw, int ts,
                                         int W, int H, int L, const void* T_fin,
                                         const void* last, const void* wm_tot,
                                         const void* v_feat, const void* v_T,
                                         const void* v_dist, void* rows, void* stream) {
  if (!raster::valid_tile(ts) || L < 4 || L > 35) return (int)cudaErrorInvalidValue;
  const raster::Streamed<64> st{(const float*)entries, M, raster::kFix2 + L};
  return (int)raster::launch_bwd_2dgs(st, M, (const int*)offs, (const int*)cnts, C, th, tw, ts,
                                      W, H, L, (const float*)T_fin, (const int*)last,
                                      (const float*)wm_tot, (const float*)v_feat,
                                      (const float*)v_T, (const float*)v_dist, (float*)rows,
                                      (cudaStream_t)stream);
}
