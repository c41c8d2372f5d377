// The surfel sigma of the 2DGS kernels (raster::fwd_2dgs and
// raster::bwd_2dgs in raster.cuh), written in the operation order of the
// plain version (gsplat_tpu_torch/ops/rasterize_2dgs_binned.py::_sigma). The
// four 2DGS sources build with -fmad=false, so every product and sum rounds
// on its own as the plain version's torch ops do: the cross products cancel
// heavily, and a contracted multiply-add would flip entries on the alpha = 1/255
// threshold between the kernel and its plain version, and between the
// forward and the backward.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct SurfelSigma {
  float sig;  // 0.5 min(u^2 + v^2, 2 |d|^2)
  bool use3d;  // the ray-plane branch is the minimum
  float u, v, crz, dx, dy;
  float hu[3], hv[3];
};

// torch.minimum: NaN if either side is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (a <= b ? a : b);
}

// m: the ray transform M00..M22 (row-major); (gx, gy) the projected centre;
// (px, py) the pixel centre
__device__ __forceinline__ SurfelSigma surfel_sigma(const float (&m)[9], float gx, float gy,
                                                    float px, float py) {
  SurfelSigma s;
  s.dx = px - gx;
  s.dy = py - gy;
  // h_u = -M0 + px M2, h_v = -M1 + py M2
  for (int c = 0; c < 3; ++c) {
    s.hu[c] = -m[c] + px * m[6 + c];
    s.hv[c] = -m[3 + c] + py * m[6 + c];
  }
  const float cr0 = s.hu[1] * s.hv[2] - s.hu[2] * s.hv[1];
  const float cr1 = s.hu[2] * s.hv[0] - s.hu[0] * s.hv[2];
  const float cr2 = s.hu[0] * s.hv[1] - s.hu[1] * s.hv[0];
  s.crz = fabsf(cr2) < 1e-12f ? 1e-12f : cr2;
  s.u = cr0 / s.crz;
  s.v = cr1 / s.crz;
  const float sig3 = s.u * s.u + s.v * s.v;
  const float sig2 = 2.0f * (s.dx * s.dx + s.dy * s.dy);
  s.use3d = sig3 <= sig2;
  s.sig = 0.5f * nan_min(sig3, sig2);
  return s;
}
