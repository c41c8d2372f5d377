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
// Bound on the card: operations. 6 P K NB exponentials (4.03e8 at the
// script's NB = 2048, P = 256, K = 128) at the SFU's MUFU.EX2 rate, 16 a
// clock an SM (132 SMs at 1.98 GHz: 4.18e12 a second); the f32 flops (7 a
// term, 2.82e9) are a lower second bound.
//
// Design: the kernels spend issue slots only on the term's own operations.
// A term is dx, three products, the sum, the exponential's argument, one
// MUFU.EX2, ca e and the add into acc: 8 f32 instructions and one MUFU in
// f32; in bf16 a lane pair's 7 HFMA2-pipe operations, an exact unpack of
// sig (two integer instructions), two FMULs, two MUFUs and one F2FP pack.
// - The exponential is ex2.approx.ftz.f32 of the f32 product sig (-log2 e)
//   (the library's expf spends a range reduction of ~7 instructions around
//   its MUFU; __expf without -ftz guards subnormals with three more).
//   Every term is computed, those that underflow to 0 included.
// - What does not change over the pixels is made once a thread: the six
//   gx + zero r, 0.5 ca. px steps by an exact + 1 (P <= 2^24), so no
//   conversion a pixel in f32 and one F2FP a pixel in bf16, which rounds
//   as torch.arange(P).to(bfloat16) does.
// - One thread per (b, lane) over all NB x K flattened into 128-thread
//   blocks: 64 warps an SM at the script's size, every thread with work at
//   any K. bf16 has a thread for two lanes, half as many: kRuns = 4
//   threads share a lane pair, each a run of ceil(P / 4) pixels, their sums
//   added by two shuffles (on an H100 ~4% faster at the script's size than
//   a thread a pair, with 64 warps an SM where it had 32; f32 split so was
//   slower).
// - Every operation of a term is its own rounded operation (_rn intrinsics:
//   never contracted to a multiply-add); the first repeat's add into a 0
//   acc is exact and left out. The sum over the pixels runs in pixel order
//   (bf16: in each run, then the runs' sums pairwise); the plain version's
//   torch sum takes another, which the tolerance allows.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRepeats = 6;
constexpr int kRuns = 4;  // bf16: threads a lane pair, each a run of the pixels
constexpr int kMaxP = 1 << 24;  // px counts exactly in f32 up to 2^24
constexpr float kNegLog2e = -1.4426950408889634f;

// 2^x, flushing subnormal inputs and results to 0: one MUFU.EX2
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ca exp(-sig), sig = 0.5 ca dx dx + dx gx, each operation rounded
__device__ __forceinline__ float term_f32(float px, float gx, float half_ca, float ca) {
  const float dx = __fsub_rn(px, gx);
  const float sig = __fadd_rn(__fmul_rn(__fmul_rn(half_ca, dx), dx), __fmul_rn(dx, gx));
  return __fmul_rn(ca, ex2_ftz(__fmul_rn(sig, kNegLog2e)));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) { return *reinterpret_cast<const unsigned*>(&v); }

// the same on a lane pair in bf16, the exponential of each lane in f32 from
// sig's exact unpack, rounded to bf16 (the _rn forms are never contracted
// to a multiply-add: one rounding less moves sig near -15 by a bf16 step,
// exp(-sig) by 6%)
__device__ __forceinline__ __nv_bfloat162 term_bf16(__nv_bfloat162 px, __nv_bfloat162 gx, __nv_bfloat162 half_ca,
                                                    __nv_bfloat162 ca) {
  const __nv_bfloat162 dx = __hsub2_rn(px, gx);
  const __nv_bfloat162 sig = __hadd2_rn(__hmul2_rn(__hmul2_rn(half_ca, dx), dx), __hmul2_rn(dx, gx));
  const unsigned u = bits(sig);
  const float lo = __uint_as_float(u << 16), hi = __uint_as_float(u & 0xffff0000u);
  const __nv_bfloat162 ex =
      __floats2bfloat162_rn(ex2_ftz(__fmul_rn(lo, kNegLog2e)), ex2_ftz(__fmul_rn(hi, kNegLog2e)));
  return __hmul2_rn(ca, ex);
}

__global__ void __launch_bounds__(kThreads)
inner_f32_kernel(const float* __restrict__ e, int R, int K, int items, int P, float zero, float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= items) return;
  const int b = t / K, k = t - b * K;
  const float* row0 = e + (long long)b * R * K;
  const float ca = __ldg(row0 + K + k);
  const float half_ca = __fmul_rn(0.5f, ca);
  const float gx0 = __ldg(row0 + k);
  float gx[kRepeats];
#pragma unroll
  for (int r = 0; r < kRepeats; ++r) gx[r] = __fadd_rn(gx0, __fmul_rn(zero, (float)r));
  float total = 0.0f, px = 0.0f;
#pragma unroll 2
  for (int p = 0; p < P; ++p) {
    float acc = term_f32(px, gx[0], half_ca, ca);
#pragma unroll
    for (int r = 1; r < kRepeats; ++r) acc = __fadd_rn(acc, term_f32(px, gx[r], half_ca, ca));
    total = __fadd_rn(total, acc);
    px = __fadd_rn(px, 1.0f);
  }
  out[t] = total;
}

// threads kRuns t .. kRuns t + kRuns - 1 share lane pair t, in one warp
__global__ void __launch_bounds__(kThreads)
inner_bf16_kernel(const float* __restrict__ e, int R, int K, int items, int P, float zero, float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int item = t / kRuns, run = t % kRuns;
  const bool live = item < items;  // the others add zeros to the shuffles
  const int pairs = (K + 1) / 2;
  const int b = live ? item / pairs : 0, k = live ? 2 * (item - b * pairs) : 0;
  const float* row0 = e + (long long)b * R * K;
  const float* row1 = row0 + K;
  const bool pair = live && k + 1 < K;  // the last lane of an odd K has no partner
  const __nv_bfloat162 gx0 = __floats2bfloat162_rn(live ? __ldg(row0 + k) : 0.0f, pair ? __ldg(row0 + k + 1) : 0.0f);
  const __nv_bfloat162 ca = __floats2bfloat162_rn(live ? __ldg(row1 + k) : 0.0f, pair ? __ldg(row1 + k + 1) : 0.0f);
  const __nv_bfloat162 half_ca = __hmul2_rn(__float2bfloat162_rn(0.5f), ca);
  __nv_bfloat162 gx[kRepeats];
#pragma unroll
  for (int r = 0; r < kRepeats; ++r) gx[r] = __hadd2_rn(gx0, __float2bfloat162_rn(__fmul_rn(zero, (float)r)));
  const int per = (P + kRuns - 1) / kRuns;
  const int p0 = live ? min(P, run * per) : 0, p1 = live ? min(P, p0 + per) : 0;
  float t0 = 0.0f, t1 = 0.0f, pxf = (float)p0;
#pragma unroll 2
  for (int p = p0; p < p1; ++p) {
    const __nv_bfloat162 px = __float2bfloat162_rn(pxf);
    __nv_bfloat162 acc = term_bf16(px, gx[0], half_ca, ca);
#pragma unroll
    for (int r = 1; r < kRepeats; ++r) acc = __hadd2_rn(acc, term_bf16(px, gx[r], half_ca, ca));
    const unsigned u = bits(acc);
    t0 = __fadd_rn(t0, __uint_as_float(u << 16));
    t1 = __fadd_rn(t1, __uint_as_float(u & 0xffff0000u));
    pxf = __fadd_rn(pxf, 1.0f);
  }
#pragma unroll
  for (int m = 1; m < kRuns; m *= 2) {
    t0 = __fadd_rn(t0, __shfl_xor_sync(0xffffffffu, t0, m));
    t1 = __fadd_rn(t1, __shfl_xor_sync(0xffffffffu, t1, m));
  }
  if (!live || run) return;
  const long long o = (long long)b * K + k;
  out[o] = t0;
  if (pair) out[o + 1] = t1;
}

}  // namespace

// e [NB, R, K] f32 (rows 0 and 1 read), out [NB, K] f32; P <= 2^24 and
// the threads, NB x K (kRuns x NB x ceil(K / 2) in bf16), below 2^31 - 128
extern "C" int inner_math_launch(const void* e, int NB, int R, int K, int P, int bf16, float zero, void* out,
                                 void* stream) {
  if (NB < 0 || R < 2 || K < 0 || P < 0 || P > kMaxP) return (int)cudaErrorInvalidValue;
  const long long items = (long long)NB * (bf16 ? (K + 1) / 2 : K);
  const long long threads = items * (bf16 ? kRuns : 1);
  if (threads > INT_MAX - kThreads) return (int)cudaErrorInvalidValue;
  if (items == 0) return (int)cudaGetLastError();
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    inner_bf16_kernel<<<blocks, kThreads, 0, s>>>((const float*)e, R, K, (int)items, P, zero, (float*)out);
  } else {
    inner_f32_kernel<<<blocks, kThreads, 0, s>>>((const float*)e, R, K, (int)items, P, zero, (float*)out);
  }
  return (int)cudaGetLastError();
}
