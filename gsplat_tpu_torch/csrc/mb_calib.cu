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
//              x [M, K], y [K, N] f32, in f32 on the CUDA cores, the B
//              repeats spread over blocks (blockIdx.z) and a loop of
//              `reps` passes in each block, each pass's sums starting from
//              zero * the last pass's. Every repeat writes the same bits.
//              Bound: operations, 2 M N K B flops at 67 TFLOP/s.
//   tf32_mma   <- mxu_kernel at Precision.DEFAULT: the TPU's one bf16 pass
//              on the matrix unit; Hopper's one-pass tensor-core product of
//              float32 inputs is TF32 (10-bit mantissa, f32 sums), issued
//              here as mma.sync m16n8k8 (the warp-level instruction; the
//              warpgroup's wgmma is the faster form). Inputs rounded to TF32
//              (cvt.rna) as they are staged. Bound: 2 M N K B flops at 495
//              TFLOP/s (TF32, dense).
//
// The products' blocks are 64 x 64 output tiles, 16 (sgemm) or 32 (tf32)
// deep stages of A and B in shared memory.

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

// ---------------------------------------------------------------- sgemm
constexpr int kTile = 64;
constexpr int kSgK = 16;
constexpr int kGemmThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kGemmThreads)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B, int M, int N, int K, int reps, float zero,
             float* __restrict__ C) {
  __shared__ float As[kSgK][kTile + 4];  // A tile transposed: [k][m]
  __shared__ float Bs[kSgK][kTile + 4];  // [k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= zero;  // 0 exactly: the last pass is finite
    for (int k0 = 0; k0 < K; k0 += kSgK) {
      // A: 64 rows x 16 k, a float4 of k per thread; B: 16 k x 64 n, a float4 of n
      {
        const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 4;
        const float4 a = *reinterpret_cast<const float4*>(A + (long long)(m0 + r) * K + k0 + c);
        As[c][r] = a.x;
        As[c + 1][r] = a.y;
        As[c + 2][r] = a.z;
        As[c + 3][r] = a.w;
        const int kr = threadIdx.x / 16, nc = (threadIdx.x % 16) * 4;
        *reinterpret_cast<float4*>(&Bs[kr][nc]) =
            *reinterpret_cast<const float4*>(B + (long long)(k0 + kr) * N + n0 + nc);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kSgK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(C + (long long)(m0 + ty * 4 + i) * N + n0 + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// ---------------------------------------------------------------- tf32_mma
constexpr int kTfK = 32;
constexpr int kTfThreads = 128;  // 4 warps, 2 x 2, each a 32 x 32 output tile

__device__ inline uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__global__ void __launch_bounds__(kTfThreads)
tf32_mma_kernel(const float* __restrict__ A, const float* __restrict__ B, int M, int N, int K, int reps, float zero,
                float* __restrict__ C) {
  __shared__ uint32_t As[kTile][kTfK + 4];  // [m][k]
  __shared__ uint32_t Bs[kTfK][kTile + 8];  // [k][n]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] *= zero;
    for (int k0 = 0; k0 < K; k0 += kTfK) {
      // A: 64 x 32 (4 float4 a thread), B: 32 x 64 (4 float4 a thread)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int ia = threadIdx.x + t * kTfThreads;
        const int r = ia / 8, c = (ia % 8) * 4;
        const float4 a = *reinterpret_cast<const float4*>(A + (long long)(m0 + r) * K + k0 + c);
        As[r][c] = to_tf32(a.x);
        As[r][c + 1] = to_tf32(a.y);
        As[r][c + 2] = to_tf32(a.z);
        As[r][c + 3] = to_tf32(a.w);
        const int kr = ia / 16, nc = (ia % 16) * 4;
        const float4 b = *reinterpret_cast<const float4*>(B + (long long)(k0 + kr) * N + n0 + nc);
        Bs[kr][nc] = to_tf32(b.x);
        Bs[kr][nc + 1] = to_tf32(b.y);
        Bs[kr][nc + 2] = to_tf32(b.z);
        Bs[kr][nc + 3] = to_tf32(b.w);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTfK; kk += 8) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wm + i * 16 + gid;
          af[i][0] = As[r][kk + tig];
          af[i][1] = As[r + 8][kk + tig];
          af[i][2] = As[r][kk + tig + 4];
          af[i][3] = As[r + 8][kk + tig + 4];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = wn + j * 8 + gid;
          bf[j][0] = Bs[kk + tig][c];
          bf[j][1] = Bs[kk + tig + 4][c];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            asm volatile(
                "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]), "+f"(acc[i][j][3])
                : "r"(af[i][0]), "r"(af[i][1]), "r"(af[i][2]), "r"(af[i][3]), "r"(bf[j][0]), "r"(bf[j][1]));
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + wm + i * 16 + gid, c = n0 + wn + j * 8 + tig * 2;
      *reinterpret_cast<float2*>(C + (long long)r * N + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(C + (long long)(r + 8) * N + c) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

bool gemm_shape_ok(int M, int N, int K, int repeats, int reps) {
  return M > 0 && N > 0 && K > 0 && M % kTile == 0 && N % kTile == 0 && K % kTfK == 0 && reps > 0 &&
         repeats > 0 && repeats % reps == 0 && repeats / reps <= 65535;
}

}  // namespace

extern "C" int fma_chain_launch(const void* x, long long n, int passes, float zero, void* out, void* stream) {
  if (n < 0 || passes < 1) return (int)cudaErrorInvalidValue;
  if (n > 0)
    fma_chain_kernel<<<(unsigned)((n + kChainThreads - 1) / kChainThreads), kChainThreads, 0,
                       (cudaStream_t)stream>>>((const float*)x, n, passes, zero, (float*)out);
  return (int)cudaGetLastError();
}

// out [M, N] = A [M, K] @ B [K, N], `repeats` times: repeats / reps blocks
// of each output tile, each looping reps passes
extern "C" int sgemm_launch(const void* A, const void* B, int M, int N, int K, int repeats, int reps, float zero,
                            void* C, void* stream) {
  if (!gemm_shape_ok(M, N, K, repeats, reps)) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kTile, M / kTile, repeats / reps);
  sgemm_kernel<<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>((const float*)A, (const float*)B, M, N, K, reps,
                                                                zero, (float*)C);
  return (int)cudaGetLastError();
}

extern "C" int tf32_mma_launch(const void* A, const void* B, int M, int N, int K, int repeats, int reps, float zero,
                               void* C, void* stream) {
  if (!gemm_shape_ok(M, N, K, repeats, reps)) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kTile, M / kTile, repeats / reps);
  tf32_mma_kernel<<<grid, kTfThreads, 0, (cudaStream_t)stream>>>((const float*)A, (const float*)B, M, N, K, reps,
                                                                 zero, (float*)C);
  return (int)cudaGetLastError();
}
