// The surfel sigma of the 2DGS kernels (raster::fwd_2dgs and
// raster::bwd_2dgs in raster.cuh), written in the operation order of the
// plain version (gsplat_tpu_torch/ops/rasterize_2dgs_binned.py::_sigma),
// every product, sum and quotient rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn) as the plain version's torch ops are, whatever the
// build's flags: the cross products cancel heavily, and a contracted
// multiply-add would flip entries on the alpha = 1/255 threshold between the
// kernel and its plain version, and between the forward and the backward.
// So the forwards may build with -fmad=false and the backwards without it
// (multiply-add in their gradient chains), and both decide alike.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct SurfelSigma {
  float sig;  // 0.5 min(u^2 + v^2, 2 |d|^2)
  bool use3d;  // the ray-plane branch is the minimum
  float u, v, crz, dx, dy;
  float hu[3], hv[3];
};

// what the pixels of one column (one pixel centre x) share for one surfel:
// d_x = px - gx, its square, and h_u = -M0 + px M2
struct SurfelColumn {
  float dx, dx2;
  float hu[3];
};

// torch.minimum: NaN if either side is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (a <= b ? a : b);
}

// q0 = a0 / b and q1 = a1 / b, each rounded correctly (IEEE division)
__device__ __forceinline__ void div2_rn(float a0, float a1, float b, float& q0, float& q1) {
  q0 = __fdiv_rn(a0, b);
  q1 = __fdiv_rn(a1, b);
}

// m: the ray transform M00..M22 (row-major); gx the projected centre's x;
// px the pixel centre's x
__device__ __forceinline__ SurfelColumn surfel_column(const float (&m)[9], float gx, float px) {
  SurfelColumn c;
  c.dx = __fsub_rn(px, gx);
  c.dx2 = __fmul_rn(c.dx, c.dx);
#pragma unroll
  for (int i = 0; i < 3; ++i) c.hu[i] = __fadd_rn(-m[i], __fmul_rn(px, m[6 + i]));
  return c;
}

// the sigma of the pixel at (col's px, py); gy the projected centre's y
__device__ __forceinline__ SurfelSigma surfel_sigma(const float (&m)[9], const SurfelColumn& col,
                                                    float gy, float py) {
  SurfelSigma s;
  s.dx = col.dx;
  s.dy = __fsub_rn(py, gy);
  // h_u = -M0 + px M2 (the column's), h_v = -M1 + py M2
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.hu[i] = col.hu[i];
    s.hv[i] = __fadd_rn(-m[3 + i], __fmul_rn(py, m[6 + i]));
  }
  const float cr0 = __fsub_rn(__fmul_rn(s.hu[1], s.hv[2]), __fmul_rn(s.hu[2], s.hv[1]));
  const float cr1 = __fsub_rn(__fmul_rn(s.hu[2], s.hv[0]), __fmul_rn(s.hu[0], s.hv[2]));
  const float cr2 = __fsub_rn(__fmul_rn(s.hu[0], s.hv[1]), __fmul_rn(s.hu[1], s.hv[0]));
  s.crz = fabsf(cr2) < 1e-12f ? 1e-12f : cr2;
  div2_rn(cr0, cr1, s.crz, s.u, s.v);
  const float sig3 = __fadd_rn(__fmul_rn(s.u, s.u), __fmul_rn(s.v, s.v));
  const float sig2 = __fmul_rn(2.0f, __fadd_rn(col.dx2, __fmul_rn(s.dy, s.dy)));
  s.use3d = sig3 <= sig2;
  s.sig = __fmul_rn(0.5f, nan_min(sig3, sig2));
  return s;
}

// the sigma of the pixel centre (px, py)
__device__ __forceinline__ SurfelSigma surfel_sigma(const float (&m)[9], float gx, float gy,
                                                    float px, float py) {
  return surfel_sigma(m, surfel_column(m, gx, px), gy, py);
}
