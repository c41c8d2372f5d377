// Forward compositing kernel of the binned 2DGS (surfel) rasterizer
// (gsplat_tpu_torch/ops/rasterize_2dgs_binned.py): raster::fwd_2dgs
// (csrc/raster.cuh) over the binned stream. Built with -fmad=false
// (csrc/surfel.cuh).
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize_2dgs_binned.py::_fwd2_kernel
// (called by _fwd2_call). That kernel put a tile's pixels on sublanes and
// 128 entries on lanes, built the transmittance chain and the distortion's
// prefix sums with lane-roll scans, composited the features with an MXU
// contraction and found the median with lane max-reductions. Here a thread
// owns P pixels of a tile column and walks the chain of each itself; a block
// stages 64 entries of the [12 + L, M] stream at a time, entry-major
// (Streamed::load_rows: each entry's row of 12 + L values padded to an odd
// number of float4, <= 13 KB at L = 35), reads each entry once for its P
// pixels, and leaves once every pixel is done, the JAX kernel's whole-tile
// saturation skip.

#include "raster.cuh"

extern "C" int rasterize_2dgs_fwd_launch(const void* entries, long long M, const void* offs,
                                         const void* cnts, int C, int th, int tw, int ts,
                                         int W, int H, int L, void* feat, void* T_out,
                                         void* last, void* dist, void* med, void* stream) {
  if (!raster::valid_tile(ts) || L < 4 || L > 35) return (int)cudaErrorInvalidValue;
  const raster::Streamed<64> st{(const float*)entries, M, raster::kFix2 + L};
  return (int)raster::launch_fwd_2dgs(st, (const int*)offs, (const int*)cnts, C, th, tw, ts, W,
                                      H, L, (float*)feat, (float*)T_out, (int*)last,
                                      (float*)dist, (float*)med, (cudaStream_t)stream);
}
