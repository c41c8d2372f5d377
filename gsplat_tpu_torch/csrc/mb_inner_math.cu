// The sigma / exp inner math in f32 and bf16 (gsplat_tpu_torch/microbench/
// primitives.py::inner_math), the Hopper counterpart of
// scripts/exp_r2_primitives.py::e5.mk(dtype).kern (:189, pallas_call :204):
// for each block b and lane k, with gx = e[b, 0, k], ca = e[b, 1, k] and
// px = 0 .. P - 1,
//   acc[p, k] = sum over 6 repeats of ca exp(-sig),
//   sig = 0.5 ca dx dx + dx gx, dx = px - gx,
// every operation in the working type (f32, or bf16 rounded after each
// operation as the plain torch version's bf16 ops are), then
//   out[b, 0, k] = sum over p of acc[p, k] in f32.
// The six repeats read the same inputs; each is fed gx + zero, `zero` a
// runtime 0, so none is merged with another (the TPU's may have been).
//
// A thread per (b, lane) in f32, per (b, lane pair) in bf16 (__nv_bfloat162
// operations, two lanes at once; the exponential of each lane in f32 by
// __expf, rounded to bf16); the thread walks the P pixels in order.
//
// Bound on the card: operations. 6 P K NB exponentials (4.03e8 at the
// script's NB = 2048, P = 256, K = 128) at the SFU's MUFU.EX2 rate, 16 a
// clock an SM (132 SMs at 1.98 GHz: 4.18e12 a second); the f32 flops (7 a
// term, 2.82e9) are a lower second bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRepeats = 6;

__global__ void __launch_bounds__(kThreads)
inner_f32_kernel(const float* __restrict__ e, int NB, int R, int K, int P, float zero, float* __restrict__ out) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (k >= K) return;
  const float gx0 = __ldg(e + (long long)b * R * K + k);
  const float ca = __ldg(e + ((long long)b * R + 1) * K + k);
  float total = 0.0f;
  for (int p = 0; p < P; ++p) {
    const float px = (float)p;
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < kRepeats; ++r) {
      const float gx = __fadd_rn(gx0, zero * (float)r);
      const float dx = __fsub_rn(px, gx);
      const float sig = __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, ca), dx), dx), __fmul_rn(dx, gx));
      acc = __fadd_rn(acc, __fmul_rn(ca, expf(-sig)));
    }
    total += acc;
  }
  out[(long long)b * K + k] = total;
}

__global__ void __launch_bounds__(kThreads)
inner_bf16_kernel(const float* __restrict__ e, int NB, int R, int K, int P, float zero, float* __restrict__ out) {
  const int k = 2 * (blockIdx.x * kThreads + threadIdx.x);
  const int b = blockIdx.y;
  if (k >= K) return;
  const float* row0 = e + (long long)b * R * K;
  const float* row1 = row0 + K;
  const bool pair = k + 1 < K;
  const __nv_bfloat162 gx0 = __floats2bfloat162_rn(row0[k], pair ? row0[k + 1] : 0.0f);
  const __nv_bfloat162 ca = __floats2bfloat162_rn(row1[k], pair ? row1[k + 1] : 0.0f);
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 half_ca = __hmul2_rn(half, ca);
  float t0 = 0.0f, t1 = 0.0f;
  for (int p = 0; p < P; ++p) {
    const __nv_bfloat162 px = __float2bfloat162_rn((float)p);
    __nv_bfloat162 acc = __float2bfloat162_rn(0.0f);
#pragma unroll
    for (int r = 0; r < kRepeats; ++r) {
      // each operation rounded (the _rn forms are never contracted to a
      // multiply-add: one rounding less moves sig near -15 by a bf16 step,
      // exp(-sig) by 6%)
      const __nv_bfloat162 gx = __hadd2_rn(gx0, __float2bfloat162_rn(zero * (float)r));
      const __nv_bfloat162 dx = __hsub2_rn(px, gx);
      const __nv_bfloat162 sig = __hadd2_rn(__hmul2_rn(__hmul2_rn(half_ca, dx), dx), __hmul2_rn(dx, gx));
      // the exponential in f32, rounded to bf16, as torch's bf16 exp is
      const float2 ns = __bfloat1622float2(__hneg2(sig));
      acc = __hadd2_rn(acc, __hmul2_rn(ca, __floats2bfloat162_rn(__expf(ns.x), __expf(ns.y))));
    }
    const float2 a = __bfloat1622float2(acc);
    t0 += a.x;
    t1 += a.y;
  }
  out[(long long)b * K + k] = t0;
  if (pair) out[(long long)b * K + k + 1] = t1;
}

}  // namespace

// e [NB, R, K] f32 (rows 0 and 1 read), out [NB, K] f32
extern "C" int inner_math_launch(const void* e, int NB, int R, int K, int P, int bf16, float zero, void* out,
                                 void* stream) {
  if (NB < 0 || R < 2 || K < 0 || P < 0 || NB > 65535) return (int)cudaErrorInvalidValue;
  if (NB == 0 || K == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const int pairs = (K + 1) / 2;
    inner_bf16_kernel<<<dim3((pairs + kThreads - 1) / kThreads, NB), kThreads, 0, s>>>(
        (const float*)e, NB, R, K, P, zero, (float*)out);
  } else {
    inner_f32_kernel<<<dim3((K + kThreads - 1) / kThreads, NB), kThreads, 0, s>>>((const float*)e, NB, R, K, P,
                                                                                  zero, (float*)out);
  }
  return (int)cudaGetLastError();
}
