// Gradient of the bilateral grid's trilinear slice with respect to the grids
// (gsplat_tpu_torch/bilagrid.py::grid_grad). The JAX package has no TPU
// kernel here: gsplat_tpu/bilagrid.py::_trilerp is plain JAX, and XLA
// transposes its eight gathers into scatter-adds. The port's slice is
// F.grid_sample, whose backward adds into the cells with atomics, so two runs
// of a step gave two gradients; this kernel gives the same bits on every
// launch.
//
// For each image b, each pixel (h, w) with grid coordinates
//   gx = u (X - 1), u = (w + 0.5) / W;  gy = v (Y - 1), v = (h + 0.5) / H;
//   gz = gray[b, h, w] (Z - 1)
// (the JAX package's arithmetic) reads the eight cells around it with
// trilinear weights; the gradient is the transposed sum
//   out[b, z, y, x, c] = sum over pixels of weight(pixel, z, y, x) v[b, h, w, c]
// for the 12 affine coefficients c.
//
// A gather, no atomics: one block per (image, y node, x node), i.e. per
// column of Z levels x 12 coefficients (Z x 12 sums). The block walks the
// pixels whose (gx, gy) lie within one cell of its node, thread t taking
// the region's pixels t, t + 256, ... in row-major order; each pixel adds its
// weights times its 12 values into the thread's Z x 12 registers (the two z
// levels around gz get (1 - fz) and fz of the pixel's xy weight, every other
// level 0). The block then sums the threads' registers by a fixed shuffle
// tree in each warp and the warps in order, so the sums are the same on
// every launch. Each pixel is visited by the (at most) four nodes around it.
//
// Bound on the card: bytes. The function reads v [B, H, W, 12] and gray
// [B, H, W] once (52 B a pixel) and writes the grids' gradient; the four
// visits a pixel are this design's own (the second to fourth mostly from L2).
//
// The same source holds the gradient with respect to the luminance
// (bilagrid_lum_bwd_kernel, below), per pixel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCoef = 12;

// the first and last pixel (of n along an axis) whose coordinate
// (i + 0.5) / n * (g - 1) may lie within one cell of node k: a superset,
// every pixel inside is tested exactly
__device__ inline void pixel_range(int k, int g, int n, int* lo, int* hi) {
  if (g <= 1) {
    *lo = 0;
    *hi = n - 1;
    return;
  }
  const double s = (double)n / (double)(g - 1);
  *lo = max(0, (int)floor((k - 1) * s - 0.5) - 1);
  *hi = min(n - 1, (int)ceil((k + 1) * s - 0.5) + 1);
}

// the pixel's lower corner, upper corner and fraction along an axis of g
// nodes at coordinate c = t (g - 1), clipped as the JAX package clips
__device__ inline void corners(float c, int g, int* i0, int* i1, float* f) {
  int a = (int)floorf(c);
  a = min(max(a, 0), g - 1);
  *i0 = a;
  *i1 = min(a + 1, g - 1);
  *f = __fsub_rn(c, (float)a);
}

// the weight node k gets from a pixel with corners (i0, i1) and fraction f
__device__ inline float node_weight(int k, int i0, int i1, float f) {
  float w = 0.0f;
  if (i0 == k) w = __fsub_rn(1.0f, f);
  if (i1 == k) w = __fadd_rn(w, f);
  return w;
}

template <int ZMAX>
__global__ void __launch_bounds__(kThreads)
bilagrid_bwd_kernel(const float* __restrict__ v, const float* __restrict__ gray, int H, int Wd, int Z,
                    int Y, int X, float* __restrict__ out) {
  const int xi = blockIdx.x, yi = blockIdx.y, b = blockIdx.z;
  int r0, r1, c0, c1;
  pixel_range(yi, Y, H, &r0, &r1);
  pixel_range(xi, X, Wd, &c0, &c1);
  const int nc = c1 - c0 + 1;
  const int n = (r1 - r0 + 1) * nc;

  float acc[ZMAX][kCoef];
#pragma unroll
  for (int z = 0; z < ZMAX; ++z)
#pragma unroll
    for (int c = 0; c < kCoef; ++c) acc[z][c] = 0.0f;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int h = r0 + i / nc;
    const int w = c0 + i % nc;
    int x0, x1, y0, y1, z0, z1;
    float fx, fy, fz;
    corners(__fmul_rn(__fdiv_rn((float)w + 0.5f, (float)Wd), (float)(X - 1)), X, &x0, &x1, &fx);
    corners(__fmul_rn(__fdiv_rn((float)h + 0.5f, (float)H), (float)(Y - 1)), Y, &y0, &y1, &fy);
    const float wxy = __fmul_rn(node_weight(yi, y0, y1, fy), node_weight(xi, x0, x1, fx));
    if (wxy == 0.0f) continue;
    const long long pix = ((long long)b * H + h) * Wd + w;
    corners(__fmul_rn(__ldg(gray + pix), (float)(Z - 1)), Z, &z0, &z1, &fz);
    const float a0 = __fmul_rn(wxy, __fsub_rn(1.0f, fz));
    const float a1 = __fmul_rn(wxy, fz);
    const float4* vp = reinterpret_cast<const float4*>(v + pix * kCoef);
    const float4 q0 = __ldg(vp), q1 = __ldg(vp + 1), q2 = __ldg(vp + 2);
    const float vv[kCoef] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
#pragma unroll
    for (int z = 0; z < ZMAX; ++z) {
      // z0 == z1 only where gz sits on the top node, and then fz = 0
      const float wz = z == z0 ? a0 : (z == z1 ? a1 : 0.0f);
#pragma unroll
      for (int c = 0; c < kCoef; ++c) acc[z][c] = fmaf(wz, vv[c], acc[z][c]);
    }
  }

  // a fixed shuffle tree in each warp, then the warps in order
  __shared__ float part[kWarps][ZMAX * kCoef];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int z = 0; z < ZMAX; ++z)
#pragma unroll
    for (int c = 0; c < kCoef; ++c) {
      float s = acc[z][c];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
      if (lane == 0) part[warp][z * kCoef + c] = s;
    }
  __syncthreads();
  for (int j = threadIdx.x; j < Z * kCoef; j += kThreads) {
    float s = part[0][j];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s += part[k][j];
    const int z = j / kCoef, c = j % kCoef;
    out[((((long long)b * Z + z) * Y + yi) * X + xi) * kCoef + c] = s;
  }
}

// The slice's gradient with respect to each pixel's luminance (bilagrid.py::
// lum_grad): (Z - 1) v . (c1 - c0), c0 and c1 the bilinear (x, y) slices of
// the z levels below and above gz (the JAX package's derivative of its lerp
// in fz, also where gz sits on the top or bottom node). A thread per pixel;
// its eight corners' 12 coefficients come from the image's grid, which the
// neighbouring pixels share (L1 and L2 hits). Per pixel, no sums across
// threads. Bound: bytes, v, gray and the output (56 B a pixel).
__global__ void __launch_bounds__(kThreads)
bilagrid_lum_bwd_kernel(const float* __restrict__ g, const float* __restrict__ v, const float* __restrict__ gray,
                        int B, int H, int Wd, int Z, int Y, int X, float* __restrict__ out) {
  const long long pix = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= (long long)B * H * Wd) return;
  const int w = (int)(pix % Wd), h = (int)((pix / Wd) % H), b = (int)(pix / ((long long)Wd * H));
  int x0, x1, y0, y1, z0, z1;
  float fx, fy, fz;
  corners(__fmul_rn(__fdiv_rn((float)w + 0.5f, (float)Wd), (float)(X - 1)), X, &x0, &x1, &fx);
  corners(__fmul_rn(__fdiv_rn((float)h + 0.5f, (float)H), (float)(Y - 1)), Y, &y0, &y1, &fy);
  corners(__fmul_rn(__ldg(gray + pix), (float)(Z - 1)), Z, &z0, &z1, &fz);
  const float4* vp = reinterpret_cast<const float4*>(v + pix * kCoef);
  const float4 q0 = __ldg(vp), q1 = __ldg(vp + 1), q2 = __ldg(vp + 2);
  const float vv[kCoef] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
  const long long img = (long long)b * Z * Y * X;
  float d = 0.0f;
#pragma unroll
  for (int c = 0; c < kCoef; ++c) {
    float lv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long zb = (img + (long long)(i ? z1 : z0) * Y * X) * kCoef + c;
      const float a00 = __ldg(g + zb + ((long long)y0 * X + x0) * kCoef);
      const float a01 = __ldg(g + zb + ((long long)y0 * X + x1) * kCoef);
      const float a10 = __ldg(g + zb + ((long long)y1 * X + x0) * kCoef);
      const float a11 = __ldg(g + zb + ((long long)y1 * X + x1) * kCoef);
      lv[i] = (a00 * (1.0f - fx) + a01 * fx) * (1.0f - fy) + (a10 * (1.0f - fx) + a11 * fx) * fy;
    }
    d = fmaf(vv[c], lv[1] - lv[0], d);
  }
  out[pix] = d * (float)(Z - 1);
}

}  // namespace

extern "C" int bilagrid_lum_bwd_launch(const void* g, const void* v, const void* gray, int B, int H, int Wd, int Z,
                                       int Y, int X, void* out, void* stream) {
  if (B < 0 || H < 0 || Wd < 0 || Z < 1 || Y < 1 || X < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * Wd;
  if (n > 0)
    bilagrid_lum_bwd_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)g, (const float*)v, (const float*)gray, B, H, Wd, Z, Y, X, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int bilagrid_bwd_launch(const void* v, const void* gray, int B, int H, int Wd, int Z, int Y, int X,
                                   void* out, void* stream) {
  if (B < 0 || H < 0 || Wd < 0 || Z < 1 || Z > 16 || Y < 1 || X < 1 || B > 65535 || Y > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const dim3 grid(X, Y, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (Z <= 8)
    bilagrid_bwd_kernel<8><<<grid, kThreads, 0, s>>>((const float*)v, (const float*)gray, H, Wd, Z, Y, X,
                                                     (float*)out);
  else
    bilagrid_bwd_kernel<16><<<grid, kThreads, 0, s>>>((const float*)v, (const float*)gray, H, Wd, Z, Y, X,
                                                      (float*)out);
  return (int)cudaGetLastError();
}
