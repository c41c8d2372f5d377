// Calibration micro-benchmarks (gsplat_tpu_torch/microbench/vpu_calib.py),
// the Hopper counterparts of scripts/exp_vpu_calib.py's TPU kernels:
//
//   fma_chain  <- vpu_kernel (:18, pallas_call :47): per element of x [P, K]
//              a = x; b = x / 2; 24 times { a = a b + 1e-6; b = b + a / 4 };
//              out = a + b (48 chained multiply-adds), the TPU's B grid steps
//              over the same block. Here each thread runs its element B times
//              in a loop; each pass starts from x + zero * (the last pass's
//              result), `zero` a runtime argument equal to 0, so no pass can
//              be hoisted or merged and the output equals one pass. Bound:
//              operations, B P K 48 multiply-adds at the card's f32 FMA rate.
//   sgemm      <- mxu_kernel (:29, :62) at Precision.HIGHEST: out = x @ y,
//              x [M, K], y [K, N] f32, in f32 FFMA on the CUDA cores, the B
//              repeats spread over blocks (blockIdx.z) and a loop of `reps`
//              passes in each block, each pass's sums starting from zero *
//              the last pass's. Every repeat writes the same bits. Bound:
//              operations, 2 M N K B flops at 67 TFLOP/s; in practice the
//              card's sustained FFMA issue rate, so the design keeps the
//              issue slots on FFMA and the registers under 128 (two blocks,
//              16 warps an SM): a pre-pass writes x^T [K, M] to scratch, so
//              both operands are k-major panels copied by coalesced 16-byte
//              cp.async; 128 x 128 output tiles, 256 threads of 8 x 8
//              outputs (2 x 2 sub-tiles of 4 x 4, so the float4 reads of
//              shared memory are broadcasts or neighbours): 64 FFMA for
//              every 4 shared loads; a ring of three 16-deep stages, two in
//              flight while one is multiplied, one barrier a stage.
//   tf32_mma   <- mxu_kernel at Precision.DEFAULT: the TPU's one bf16 pass
//              on the matrix unit; Hopper's one-pass tensor-core product of
//              float32 inputs is TF32 (10-bit mantissa, f32 sums). A
//              pre-pass rounds x to TF32 (cvt.rna) into xs [M, K] and y
//              transposed into ys [N, K] (wgmma takes .tf32 operands only
//              K-major; unrounded, the tensor cores would truncate). The
//              product is warp-specialised: one producer thread keeps a
//              ring of 4 stages of 128 x 32 A and BN x 32 B tiles filled by
//              TMA (128-byte swizzled, one 128-byte row = 32 TF32 values =
//              4 k8 steps), two consumer warpgroups each issue
//              wgmma.mma_async m64nBNk8 on a 64 x BN slice from shared
//              memory with the f32 sums in registers, full / empty
//              mbarriers between them, setmaxnreg moving registers to the
//              consumers. Each repeat's first wgmma takes scale-d = 0, so a
//              repeat starts from zero and is a full product. Bound: 2 M N
//              K B flops at 495 TFLOP/s (TF32, dense); x and y stay in the
//              50 MB L2, so the tile's flops per byte from L2 is what the
//              design sizes: 43.7 at 128 x 256.

#include <cuda.h>  // CUtensorMap and its enums (the encoder is reached through the runtime: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- fma_chain
constexpr int kChainThreads = 256;

__global__ void __launch_bounds__(kChainThreads)
fma_chain_kernel(const float* __restrict__ x, long long n, int passes, float zero, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kChainThreads + threadIdx.x;
  if (i >= n) return;
  const float x0 = x[i];
  float r = 0.0f;
  for (int p = 0; p < passes; ++p) {
    const float xi = fmaf(zero, r, x0);  // x0 exactly: zero = 0 and r finite
    float a = xi;
    float b = xi * 0.5f;
#pragma unroll
    for (int k = 0; k < 24; ++k) {
      a = fmaf(a, b, 1e-6f);
      b = fmaf(a, 0.25f, b);
    }
    r = a + b;
  }
  out[i] = r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- staging
// dst [cols, rows] = src [rows, cols]^T (rounded to TF32 with kRound), one
// 32 x 32 tile a block of 32 x 8 threads, through shared memory so both
// sides stay coalesced
constexpr int kTr = 32;

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

template <bool kRound>
__device__ __forceinline__ void transpose_tile(const float* __restrict__ src, int rows, int cols, int tile,
                                               float* __restrict__ dst, float (*t)[kTr + 1]) {
  const int tx = threadIdx.x % kTr, ty = threadIdx.x / kTr;
  const long long r0 = (long long)(tile / (cols / kTr)) * kTr, c0 = (long long)(tile % (cols / kTr)) * kTr;
#pragma unroll
  for (int i = ty; i < kTr; i += 8) t[i][tx] = src[(r0 + i) * cols + c0 + tx];
  __syncthreads();
#pragma unroll
  for (int i = ty; i < kTr; i += 8) {
    const float v = t[tx][i];
    dst[(c0 + i) * rows + r0 + tx] = kRound ? to_tf32(v) : v;
  }
}

// ---------------------------------------------------------------- sgemm
// a pre-pass writes xt = x^T [K, M], so that both operands are k-major
// panels; then block tile kSgBM x kSgBN, kSgTM x kSgTN outputs a thread as
// (kSgTM / 4) x (kSgTN / 4) sub-tiles of 4 x 4 spaced 4 kSgTY rows and 4
// kSgTX columns apart (a warp's float4 reads of a k row are broadcasts or
// neighbours), a ring of kSgStages stages kSgK deep filled by coalesced
// 16-byte cp.async, kSgStages - 1 of them in flight while one is
// multiplied, one barrier a stage
constexpr int kSgBM = 128, kSgBN = 128, kSgTM = 8, kSgTN = 8, kSgK = 16, kSgStages = 3, kSgMinBlocks = 2;
constexpr int kSgTY = kSgBM / kSgTM, kSgTX = kSgBN / kSgTN;  // the threads' grid
constexpr int kSgThreads = kSgTY * kSgTX;
constexpr int kSgStage = kSgK * (kSgBM + kSgBN);            // floats of a stage (A^T, then B)
constexpr int kSgSmem = kSgStages * kSgStage * 4;
constexpr int kSgALoads = kSgK * kSgBM / 4 / kSgThreads;    // 16-byte copies of A^T a thread a stage
constexpr int kSgBLoads = kSgK * kSgBN / 4 / kSgThreads;    // and of B
static_assert(kSgThreads % 32 == 0 && kSgALoads * kSgThreads * 4 == kSgBM * kSgK &&
                  kSgBLoads * kSgThreads * 4 == kSgK * kSgBN && kSgTM % 4 == 0 && kSgTN % 4 == 0 && kSgStages >= 2,
              "sgemm's tiles");

__global__ void __launch_bounds__(kTr * 8) sgemm_stage_kernel(const float* __restrict__ x, int M, int K,
                                                              float* __restrict__ xt) {
  __shared__ float t[kTr][kTr + 1];
  transpose_tile<false>(x, M, K, blockIdx.x, xt, t);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__global__ void __launch_bounds__(kSgThreads, kSgMinBlocks)
sgemm_kernel(const float* __restrict__ At, const float* __restrict__ B, int M, int N, int K, int reps, float zero,
             float* __restrict__ C) {
  extern __shared__ __align__(16) float sg[];
  const int tid = threadIdx.x, tx = tid % kSgTX, ty = tid / kSgTX;
  const int m0 = blockIdx.y * kSgBM, n0 = blockIdx.x * kSgBN;
  const int nk = K / kSgK, total = reps * nk;
  const uint32_t s0 = smem_addr(sg);
  // the copies of the next step not yet issued: its k step and ring slot;
  // a group is committed every step, empty past the last, so that before
  // step s exactly kSgStages - 2 groups are younger than step s's
  int load_k = 0, load_slot = 0, loaded = 0;
  auto load_next = [&]() {
    if (loaded < total) {
      const uint32_t as = s0 + load_slot * kSgStage * 4, bs = as + kSgK * kSgBM * 4;
      const int k0 = load_k * kSgK;
#pragma unroll
      for (int t = 0; t < kSgALoads; ++t) {
        const int c = tid + kSgThreads * t, k = c / (kSgBM / 4), m4 = (c % (kSgBM / 4)) * 4;
        cp_async16(as + (k * kSgBM + m4) * 4, At + (long long)(k0 + k) * M + m0 + m4);
      }
#pragma unroll
      for (int t = 0; t < kSgBLoads; ++t) {
        const int c = tid + kSgThreads * t, k = c / (kSgBN / 4), n4 = (c % (kSgBN / 4)) * 4;
        cp_async16(bs + (k * kSgBN + n4) * 4, B + (long long)(k0 + k) * N + n0 + n4);
      }
      ++loaded;
      load_k = load_k + 1 == nk ? 0 : load_k + 1;
      load_slot = load_slot + 1 == kSgStages ? 0 : load_slot + 1;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  float acc[kSgTM][kSgTN];
#pragma unroll
  for (int i = 0; i < kSgTM; ++i)
#pragma unroll
    for (int j = 0; j < kSgTN; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < kSgStages - 1; ++i) load_next();
  int slot = 0;
  for (int rep = 0; rep < reps; ++rep) {
    // a repeat starts from 0 * the last one's sums (0 exactly: they are
    // finite), so no repeat can be hoisted or merged
#pragma unroll
    for (int i = 0; i < kSgTM; ++i)
#pragma unroll
      for (int j = 0; j < kSgTN; ++j) acc[i][j] *= zero;
    for (int ks = 0; ks < nk; ++ks) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kSgStages - 2) : "memory");
      __syncthreads();  // this step's tiles are in; every thread is done with the slot refilled next
      load_next();
      const float* as = sg + slot * kSgStage;
      const float* bs = as + kSgK * kSgBM;
#pragma unroll
      for (int k = 0; k < kSgK; ++k) {
        float av[kSgTM], bv[kSgTN];
#pragma unroll
        for (int r = 0; r < kSgTM / 4; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(as + k * kSgBM + r * 4 * kSgTY + ty * 4);
          av[4 * r] = v.x, av[4 * r + 1] = v.y, av[4 * r + 2] = v.z, av[4 * r + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < kSgTN / 4; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(bs + k * kSgBN + c * 4 * kSgTX + tx * 4);
          bv[4 * c] = v.x, bv[4 * c + 1] = v.y, bv[4 * c + 2] = v.z, bv[4 * c + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kSgTM; ++i)
#pragma unroll
          for (int j = 0; j < kSgTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      slot = slot + 1 == kSgStages ? 0 : slot + 1;
    }
  }
#pragma unroll
  for (int i = 0; i < kSgTM; ++i) {
    float* row = C + (long long)(m0 + (i / 4) * 4 * kSgTY + ty * 4 + i % 4) * N + n0 + tx * 4;
#pragma unroll
    for (int c = 0; c < kSgTN / 4; ++c)
      *reinterpret_cast<float4*>(row + c * 4 * kSgTX) =
          make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]);
  }
}

// ---------------------------------------------------------------- tf32_mma
// the pre-pass: xs = tf32(x) [M, K], ys = tf32(y)^T [N, K]
__global__ void __launch_bounds__(kTr * 8)
tf32_stage_kernel(const float* __restrict__ x, const float* __restrict__ y, int M, int N, int K,
                  float* __restrict__ xs, float* __restrict__ ys) {
  __shared__ float t[kTr][kTr + 1];
  const int nx = (M / kTr) * (K / kTr);
  if (blockIdx.x < nx) {  // x's tiles: rounded in place order
    const int tx = threadIdx.x % kTr, ty = threadIdx.x / kTr;
    const long long r0 = (long long)(blockIdx.x / (K / kTr)) * kTr, c0 = (long long)(blockIdx.x % (K / kTr)) * kTr;
#pragma unroll
    for (int i = ty; i < kTr; i += 8) xs[(r0 + i) * K + c0 + tx] = to_tf32(x[(r0 + i) * K + c0 + tx]);
    return;
  }
  transpose_tile<true>(y, K, N, blockIdx.x - nx, ys, t);
}

// the product: warp-specialised, TMA ring -> wgmma
constexpr int kTfBM = 128;        // rows of a block: two consumer warpgroups of 64
constexpr int kTfBK = 32;         // TF32 values of one 128-byte swizzled row
constexpr int kTfStages = 4;
constexpr int kTfThreads = 384;   // producer warpgroup, then two consumer warpgroups
constexpr int kTfABytes = kTfBM * kTfBK * 4;

constexpr int tf32_smem_bytes(int bn) { return kTfStages * (kTfBM + bn) * kTfBK * 4 + 1024; }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// waits for the phase of `parity` to complete; a wait of over a second is a
// broken pipeline, and traps (the launch fails) rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 1000000000ull) __trap();
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a K-major operand tile in shared memory, 128-byte swizzled as TMA wrote
// it: 8-row groups 1024 bytes apart (SBO), the leading offset unused
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d [64 x N slice, N / 2 a thread] (+)= A [64 x 8] B [8 x N]^T: scale_d 0
// drops the old sums
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 256)
    wgmma_n256(d, da, db, scale_d);
  else
    wgmma_n128(d, da, db, scale_d);
}

template <int BN>
__global__ void __launch_bounds__(kTfThreads, 1)
tf32_mma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b, int K,
                  int reps, float* __restrict__ C, int N) {
  constexpr int kBBytes = BN * kTfBK * 4;
  __shared__ __align__(8) uint64_t full_bar[kTfStages], empty_bar[kTfStages];
  extern __shared__ __align__(1024) uint8_t tf_smem[];
  const uint32_t base = (smem_addr(tf_smem) + 1023u) & ~1023u;  // 128-byte swizzle: 1024-byte aligned tiles
  const uint32_t a_base = base, b_base = base + kTfStages * kTfABytes;
  const int wg = threadIdx.x / 128, nk = K / kTfBK, total = reps * nk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTfStages; ++s) {
      mbar_init(smem_addr(&full_bar[s]), 1);
      mbar_init(smem_addr(&empty_bar[s]), 8);  // a lane of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");  // visible to TMA's async proxy
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
      const int m0 = blockIdx.y * kTfBM, n0 = blockIdx.x * BN;
      int stage = 0, phase = 0, kstep = 0;
      for (int s = 0; s < total; ++s) {
        const uint32_t full = smem_addr(&full_bar[stage]);
        mbar_wait(smem_addr(&empty_bar[stage]), phase ^ 1);  // the first round finds every stage empty
        mbar_expect_tx(full, kTfABytes + kBBytes);
        const int k0 = kstep * kTfBK;
        tma_load(a_base + stage * kTfABytes, &map_a, full, k0, m0);
        tma_load(b_base + stage * kBBytes, &map_b, full, k0, n0);
        kstep = kstep + 1 == nk ? 0 : kstep + 1;
        if (++stage == kTfStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // consumers: rows [64 g, 64 g + 64) of the block's tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = wg - 1, lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    const uint32_t a_off = g * 64 * kTfBK * 4;
    int stage = 0, phase = 0, kstep = 0, prev = 0;
    for (int s = 0; s < total; ++s) {
      mbar_wait(smem_addr(&full_bar[stage]), phase);
      __syncwarp();  // wgmma is .aligned: the warp converged after the wait
      const uint32_t a = a_base + stage * kTfABytes + a_off, b = b_base + stage * kBBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTfBK / 8; ++kk)  // 8 TF32 values = 32 bytes a step along the swizzled row
        wgmma_tile<BN>(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32), (kstep == 0 && kk == 0) ? 0 : 1);
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one is read: release it
      if (s > 0 && lane == 0) mbar_arrive(smem_addr(&empty_bar[prev]));
      prev = stage;
      kstep = kstep + 1 == nk ? 0 : kstep + 1;
      if (++stage == kTfStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    // the accumulator fragment: warp w holds rows 16 w + lane / 4 (+ 8),
    // columns 8 j + 2 (lane % 4) (+ 1)
    const long long row = (long long)blockIdx.y * kTfBM + g * 64 + warp * 16 + lane / 4;
    float* out = C + row * N + (long long)blockIdx.x * BN + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(out + 8 * N + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [rows, K] f32 matrix (K contiguous) as TMA tiles of box_rows x 32,
// 128-byte swizzled
bool encode_kmajor(EncodeTiled enc, CUtensorMap* map, void* ptr, int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kTfBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ptr, dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch_wgmma(const CUtensorMap& ma, const CUtensorMap& mb, int M, int N, int K, int repeats, int reps,
                         float* C, cudaStream_t stream) {
  const int smem = tf32_smem_bytes(BN);
  const cudaError_t e = cudaFuncSetAttribute(tf32_mma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  tf32_mma_kernel<BN><<<dim3(N / BN, M / kTfBM, repeats / reps), kTfThreads, smem, stream>>>(ma, mb, K, reps, C, N);
  return cudaGetLastError();
}

bool repeats_ok(int repeats, int reps) {
  return reps > 0 && repeats > 0 && repeats % reps == 0 && repeats / reps <= 65535;
}

}  // namespace

extern "C" int fma_chain_launch(const void* x, long long n, int passes, float zero, void* out, void* stream) {
  if (n < 0 || passes < 1) return (int)cudaErrorInvalidValue;
  if (n > 0)
    fma_chain_kernel<<<(unsigned)((n + kChainThreads - 1) / kChainThreads), kChainThreads, 0,
                       (cudaStream_t)stream>>>((const float*)x, n, passes, zero, (float*)out);
  return (int)cudaGetLastError();
}

// out [M, N] = A [M, K] @ B [K, N], `repeats` times: the pre-pass writes
// At = A^T [K, M] (scratch of the caller's), then repeats / reps blocks of
// each kSgBM x kSgBN output tile loop reps passes
extern "C" int sgemm_launch(const void* A, const void* B, int M, int N, int K, int repeats, int reps, float zero,
                            void* At, void* C, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % kSgBM || N % kSgBN || K % kSgK || M % kTr || K % kTr ||
      !repeats_ok(repeats, reps))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  sgemm_stage_kernel<<<(M / kTr) * (K / kTr), kTr * 8, 0, st>>>((const float*)A, M, K, (float*)At);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(sgemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSgSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / kSgBN, M / kSgBM, repeats / reps);
  sgemm_kernel<<<grid, kSgThreads, kSgSmem, st>>>((const float*)At, (const float*)B, M, N, K, reps, zero,
                                                  (float*)C);
  return (int)cudaGetLastError();
}

// out [M, N] = tf32(A) [M, K] @ tf32(B) [K, N], `repeats` times: the
// pre-pass writes xs = tf32(A) [M, K] and ys = tf32(B)^T [N, K] (scratch of
// the caller's), then repeats / reps blocks of each 128 x bn output tile
// loop reps passes. bn 256 or 128.
extern "C" int tf32_mma_launch(const void* A, const void* B, int M, int N, int K, int repeats, int reps, int bn,
                               void* xs, void* ys, void* C, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (bn != 256 && bn != 128) || M % kTfBM || N % bn || K % kTfBK ||
      !repeats_ok(repeats, reps))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap ma, mb;
  if (!encode_kmajor(enc, &ma, xs, M, K, kTfBM) || !encode_kmajor(enc, &mb, ys, N, K, bn))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (M / kTr) * (K / kTr) + (K / kTr) * (N / kTr);
  tf32_stage_kernel<<<blocks, kTr * 8, 0, st>>>((const float*)A, (const float*)B, M, N, K, (float*)xs, (float*)ys);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  float* out = (float*)C;
  return (int)(bn == 256 ? launch_wgmma<256>(ma, mb, M, N, K, repeats, reps, out, st)
                         : launch_wgmma<128>(ma, mb, M, N, K, repeats, reps, out, st));
}
