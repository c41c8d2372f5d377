// Forward compositing kernel of the binned rasterizer
// (gsplat_tpu_torch/ops/rasterize_binned.py): raster::fwd_3dgs
// (csrc/raster.cuh) over the binned stream.
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_binned.py::_fwd_kernel
// (called by _fwd_call). That kernel put a tile's pixels on sublanes and 128
// entries on lanes, and built the transmittance chain with lane-roll scans
// because the TPU's vector unit has no per-pixel loop. Here a thread owns P
// pixels of a tile column and walks the chain of each itself, as the
// reference CUDA rasterizers walk one. The stream [6 + D, M] holds the
// emitted entries' rows in sort order; a block stages 256 of its entries at
// a time entry-major (Streamed::load_rows: each row padded to an odd number
// of float4, <= 44 KB at D = 32), so each entry is read from device memory
// once per tile, skips per warp the entries its pixels cannot reach, and
// stops as soon as all its pixels saturate. The caller composites the
// background (T bg).

#include "raster.cuh"

extern "C" int rasterize_fwd_launch(const void* entries, long long M, const void* offs,
                                    const void* cnts, int C, int th, int tw, int ts, int W,
                                    int H, int D, void* img, void* T_out, void* last,
                                    void* stream) {
  if (!raster::valid_tile(ts) || D < 1 || D > 32) return (int)cudaErrorInvalidValue;
  const raster::Streamed<256> st{(const float*)entries, M, 6 + D};
  return (int)raster::launch_fwd_3dgs(st, (const int*)offs, (const int*)cnts, C, th, tw, ts, W,
                                      H, D, (float*)img, (float*)T_out, (int*)last,
                                      (cudaStream_t)stream);
}
