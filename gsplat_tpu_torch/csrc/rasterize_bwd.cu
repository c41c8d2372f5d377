// Backward kernel of the binned rasterizer
// (gsplat_tpu_torch/ops/rasterize_binned.py): raster::bwd_3dgs
// (csrc/raster.cuh) over the binned stream.
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_binned.py::_bwd_kernel
// (called by _bwd_call). That kernel swept 128-lane slices back to front
// with lane-roll scans and turned the per-entry pixel sums into one MXU
// moment contraction, writing K-aligned slots plus an f32 gid row. Here a
// thread owns P pixels of a column and walks their chains itself, and the
// per-entry sums are a transposed warp reduction and a sum over the warps in
// a fixed order. A block stages 64 entries of the [6 + D, M] stream at a
// time; each stream slot is one (tile, Gaussian), so its row [6 + D (+2), M]
// is written by one block.

#include "raster.cuh"

extern "C" int rasterize_bwd_launch(const void* entries, long long M, const void* offs,
                                    const void* cnts, int C, int th, int tw, int ts, int W,
                                    int H, int D, const void* T_fin, const void* last,
                                    const void* v_img, const void* v_T, int absgrad,
                                    void* rows, void* stream) {
  if (!raster::valid_tile(ts) || D < 1 || D > 32) return (int)cudaErrorInvalidValue;
  const raster::Streamed<64> st{(const float*)entries, M, 6 + D};
  return (int)raster::launch_bwd_3dgs(st, M, (const int*)offs, (const int*)cnts, C, th, tw, ts,
                                      W, H, D, (const float*)T_fin, (const int*)last,
                                      (const float*)v_img, (const float*)v_T, absgrad,
                                      (float*)rows, (cudaStream_t)stream);
}
