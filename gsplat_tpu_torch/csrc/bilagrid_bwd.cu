// Gradients of the bilateral grid's trilinear slice (gsplat_tpu_torch/
// bilagrid.py::grid_grad and ::lum_grad). The JAX package has no TPU kernel
// here: gsplat_tpu/bilagrid.py::_trilerp is plain JAX, and XLA transposes its
// eight gathers into scatter-adds. The port's slice is F.grid_sample, whose
// backward adds into the cells with atomics, so two runs of a step gave two
// gradients; these kernels give the same bits on every launch, with no
// atomics.
//
// For each image b, each pixel (h, w) with grid coordinates
//   gx = u (X - 1), u = (w + 0.5) / W;  gy = v (Y - 1), v = (h + 0.5) / H;
//   gz = gray[b, h, w] (Z - 1)
// (the JAX package's arithmetic) reads the eight cells around it with
// trilinear weights. The grids' gradient is the transposed sum
//   out[b, z, y, x, c] = sum over pixels of weight(pixel, z, y, x) v[b, h, w, c]
// for the 12 affine coefficients c; the luminance's is, per pixel,
//   (Z - 1) v . (c1 - c0), c0 and c1 the bilinear (x, y) slices of the z
// levels below and above gz.
//
// Tiles. bilagrid.py::grad_plan cuts each image into tiles whose columns
// share their lower x node and whose rows share their lower y node (computed
// with the kernels' own float32 rounding), so a tile's pixels all read the
// same 2 x 2 (x, y) nodes, at any of the Z levels: a node window of 2 x 2 x
// Z x 12 values. Each cell is cut along its rows into as many tiles as give
// a few waves of blocks. Both kernels take one block of 256 threads a tile;
// each warp takes chunks of up to 32 pixels of a tile row in turn and copies
// each chunk's v and gray into shared memory by 16-byte cp.async (coalesced),
// one chunk ahead of the one it works on (kStages), so the next chunk's
// bytes are in flight while it computes. Index math is 32-bit from the
// tile's origin.
//
// bilagrid_lum_bwd. What held the first version back (a thread a pixel): its
// 96 grid reads a pixel came from L1, each load instruction touching up to
// Z lines because the lanes of a warp sit on different z levels (with every
// pixel on one level it ran 3x faster). Here the block first stages the
// tile's window as level differences
//   win[z][corner][c] = g[z + 1] - g[z] at the corner (0 at the top level,
// where z0 = z1 and the plain version's two slices cancel), at a pitch of
// 13 float4s a level so that lanes on eight different levels read eight
// different bank groups; a pixel then reads its level's 4 corners x 12
// differences as 12 float4s from shared memory. Bound on the card: bytes (v,
// gray and the output once, 56 B a pixel); the window's reads from L2 are
// ~1.5 KB a tile. What is left above the bound is the chunks' load latency
// that one chunk ahead does not cover (deeper rings cost blocks an SM).
//
// bilagrid_bwd, two passes. What held the first version back (a block a
// node): each pixel was read by up to four blocks, three quarters of its
// multiply-adds were by 0 (a select over every z level), and 256 blocks
// walked ~38,000 pixels each. Pass 1 (bilagrid_bwd_tiles) reads each pixel
// once. A warp computes each pixel of its chunk's weights in the pixel's
// lane, groups the chunk's pixels by lower z level (__match_any_sync) and
// moves them, in shared memory, into the order of the groups' first lanes,
// each group's pixels in lane order. Then lane (c, s) of the first 24 walks
// each group with a plain counter (a bit scan a pixel was slower): v[c]
// times the pixel's (wz_s (1 - fx), wz_s fx) into two registers, which it
// adds, times the chunk row's (1 - fy, fy), into the warp's sums at level
// z0 + s, [Z + 1][12][4 corners] in shared memory, once a group (level Z
// takes the upper weight of a pixel whose two levels coincide, z0 = Z - 1,
// and is never read). The block then adds its warps' sums in warp order
// into the tile's partials [4 (y, x) corners, Z, 12], in a scratch buffer
// [tiles, 4, Z, 12]. Pass 2 (bilagrid_bwd_nodes) sums, for each (image, z,
// y, x, c), the partials of the tiles around the node in the plan's tile
// order: four lanes an output, one a cell, their sums added in the cells'
// order. Every order is fixed, so every launch gives the same bits. Bound on
// the card: bytes (v and gray once, 52 B a pixel, and the gradient
// written). This design stays above it on shared memory, by count ~5
// wavefronts a pixel: the chunk's copy and its move, the walk's reads of
// v[c] and of the weights, a group's sums read and written. A lane's Z sums
// of one (corner, coefficient) in registers, with a select a level, would
// bound Z by registers; this version takes Z up to its shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCoef = 12;
constexpr int kHeader = 4;       // grad_plan's header ints
constexpr int kLevelPitch = 52;  // floats a level of the luminance kernel's window: 13 float4s
constexpr int kSmemLimit = 232448;
constexpr int kStages = 2;                      // a warp's chunks in flight
constexpr int kStageFloats = 32 * kCoef + 32;   // a chunk's v and gray
constexpr int kWalkLanes = 2 * kCoef;           // lanes (c, s) of pass 1's walk

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// the coordinate of pixel i of n along an axis of g nodes: ((i + 0.5) / n) (g - 1)
__device__ inline float axis_coord(int i, int n, int g) {
  return __fmul_rn(__fdiv_rn((float)i + 0.5f, (float)n), (float)(g - 1));
}

// A warp's chunk q of its tile t = (b * H + h0, w0, rows, columns): up to 32
// pixels of one tile row, chunks_per_row a row.
struct Chunk {
  int row, w, n;
  long long pix;  // its first pixel's index in [B, H, W]
  __device__ Chunk(int4 t, int Wd, int per_row, int q) {
    row = q / per_row;
    w = t.y + 32 * (q - row * per_row);
    n = min(32, t.y + t.w - w);
    pix = ((long long)t.x + row) * Wd + w;
  }
};

// A warp's copies of chunk q's v (n x 12 floats, 16-byte aligned) and gray
// into the stage st: [32][12] v, then [32] gray. One commit group a call,
// empty where q is past the tile's chunks.
__device__ inline void issue_chunk(const float* __restrict__ v, const float* __restrict__ gray, int4 t, int Wd,
                                   int per_row, int q, float* st, int lane) {
  if (q < t.z * per_row) {
    const Chunk k(t, Wd, per_row, q);
    const float* src = v + k.pix * kCoef;
    for (int f = lane; f < 3 * k.n; f += 32) cp16(st + 4 * f, src + 4 * f);
    if (lane < k.n) cp4(st + 32 * kCoef + lane, gray + k.pix + lane);
  }
  cp_commit();
}

// the tile of this block: (b * H + h0, w0, rows, columns)
__device__ inline int4 block_tile(const int* __restrict__ plan) {
  return __ldg(reinterpret_cast<const int4*>(plan + kHeader) + blockIdx.x);
}

// floats of a warp's shared memory in pass 1: its stages, its pixels'
// x-and-z weights [32][2 levels][2 x], its sums [Z + 1][12][4 corners]
__host__ __device__ constexpr int warp_floats(int Z) { return kStages * kStageFloats + 32 * 4 + (Z + 1) * 4 * kCoef; }

__global__ void __launch_bounds__(kThreads)
bilagrid_bwd_tiles(const float* __restrict__ v, const float* __restrict__ gray, const int* __restrict__ plan, int H,
                   int Wd, int Z, int Y, int X, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = warp_floats(Z);
  float* stages = smem + warp * stride;
  float4* rec = reinterpret_cast<float4*>(stages + kStages * kStageFloats);
  float4* acc = rec + 32;
  const int4 t = block_tile(plan);
  const int per_row = (t.w + 31) >> 5;
  for (int k = 0; k < kStages - 1; ++k)
    issue_chunk(v, gray, t, Wd, per_row, warp + k * kWarps, stages + k * kStageFloats, lane);
  for (int i = lane; i < (Z + 1) * kCoef; i += 32) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const int h0 = t.x % H;
  const int c = lane % kCoef, s = lane / kCoef;  // the walk's lanes (c, s), s < 2
  const float2* rec2 = reinterpret_cast<const float2*>(rec);
  for (int i = 0, q = warp; q < t.z * per_row; ++i, q += kWarps) {
    issue_chunk(v, gray, t, Wd, per_row, q + (kStages - 1) * kWarps,
                stages + (i + kStages - 1) % kStages * kStageFloats, lane);
    cp_wait<kStages - 1>();
    __syncwarp();
    float* vs = stages + i % kStages * kStageFloats;
    float4* vs4 = reinterpret_cast<float4*>(vs);
    const Chunk k(t, Wd, per_row, q);
    const unsigned valid = k.n == 32 ? 0xffffffffu : (1u << k.n) - 1u;
    int y0, y1, z0 = -1, z1;
    float fy, fz;
    corners(axis_coord(h0 + k.row, H, Y), Y, &y0, &y1, &fy);  // the same for the chunk
    float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f), q0 = r, q1 = r, q2 = r;
    if (lane < k.n) {
      int x0, x1;
      float fx;
      corners(axis_coord(k.w + lane, Wd, X), X, &x0, &x1, &fx);
      corners(__fmul_rn(vs[32 * kCoef + lane], (float)(Z - 1)), Z, &z0, &z1, &fz);
      float wz0 = __fsub_rn(1.0f, fz), wz1 = fz;
      if (z1 == z0) {  // the top level: both weights on it, none on the level past it
        wz0 = __fadd_rn(wz0, wz1);
        wz1 = 0.0f;
      }
      const float wx0 = __fsub_rn(1.0f, fx);
      r = make_float4(wz0 * wx0, wz0 * fx, wz1 * wx0, wz1 * fx);
      q0 = vs4[3 * lane];
      q1 = vs4[3 * lane + 1];
      q2 = vs4[3 * lane + 2];
    }
    // the chunk's pixels by lower level: groups in order of their first
    // lane, each group's pixels in lane order, moved into that order
    const unsigned peers = __match_any_sync(0xffffffffu, z0);
    int place = 0;
    for (unsigned todo = valid, base = 0; todo;) {
      const unsigned group = __shfl_sync(0xffffffffu, peers, __ffs(todo) - 1);
      if (group >> lane & 1u) place = base + __popc(group & ((1u << lane) - 1u));
      base += __popc(group);
      todo &= ~group;
    }
    __syncwarp();
    if (lane < k.n) {
      vs4[3 * place] = q0;
      vs4[3 * place + 1] = q1;
      vs4[3 * place + 2] = q2;
      rec[place] = r;
    }
    __syncwarp();
    // a group's sums at (x0, x1) in registers, times the chunk's (1 - fy,
    // fy) into the warp's sums
    const float wy0 = __fsub_rn(1.0f, fy);
    for (unsigned todo = valid, base = 0; todo;) {
      const int lead = __ffs(todo) - 1;
      const unsigned group = __shfl_sync(0xffffffffu, peers, lead);
      const int z = __shfl_sync(0xffffffffu, z0, lead);
      const unsigned end = base + __popc(group);
      todo &= ~group;
      if (lane < kWalkLanes) {
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
        for (unsigned p = base; p < end; ++p) {
          const float x = vs[p * kCoef + c];
          const float2 w = rec2[p * 2 + s];
          a0 = fmaf(w.x, x, a0);
          a1 = fmaf(w.y, x, a1);
        }
        float4* ap = acc + (z + s) * kCoef + c;
        float4 a = *ap;
        a.x = fmaf(a0, wy0, a.x);
        a.y = fmaf(a1, wy0, a.y);
        a.z = fmaf(a0, fy, a.z);
        a.w = fmaf(a1, fy, a.w);
        *ap = a;
      }
      base = end;
      __syncwarp();  // the next group's lanes read what this one wrote
    }
  }
  cp_wait<0>();
  __syncthreads();

  // the tile's partials [4 corners][Z][12]: the warps' sums in warp order
  const int per = 4 * Z * kCoef;
  float* out = partial + (long long)blockIdx.x * per;
  const float* sums = smem + kStages * kStageFloats + 32 * 4;
  for (int i = threadIdx.x; i < per; i += kThreads) {
    const int corner = i / (Z * kCoef), zc = i - corner * Z * kCoef;
    const float* a = sums + zc * 4 + corner;
    float sum = a[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += a[w * stride];
    out[i] = sum;
  }
}

constexpr int kNodeThreads = 128;

__global__ void __launch_bounds__(kNodeThreads)
bilagrid_bwd_nodes(const float* __restrict__ partial, const int* __restrict__ plan, int ntiles, int B, int Z, int Y,
                   int X, float* __restrict__ out) {
  // four lanes an output (b, z, y, x, c), below 2^29 (the launch checks): lane
  // j sums the tiles of the j-th cell around the node, lane 0 the four sums
  const int i = (blockIdx.x * kNodeThreads + threadIdx.x) >> 2, j = threadIdx.x & 3;
  const bool live = i < B * Z * Y * X * kCoef;
  float sum = 0.0f;
  if (live) {
    const int tiles = __ldg(plan), runs_x = __ldg(plan + 1);
    const int* xreach = plan + kHeader + 4 * ntiles;  // [X][2] (column run * 2 + slot), -1 past the last
    const int* yreach = xreach + 2 * X;               // [Y][2]
    const int* first = yreach + 2 * Y;                // each cell's first tile in an image
    const int c = i % kCoef, r = i / kCoef, x = r % X, y = (r / X) % Y, zb = r / (X * Y), z = zb % Z, b = zb / Z;
    const int sy = __ldg(yreach + 2 * y + (j >> 1)), sx = __ldg(xreach + 2 * x + (j & 1));
    if (sy >= 0 && sx >= 0) {
      const int cell = (sy >> 1) * runs_x + (sx >> 1);
      const int t0 = __ldg(first + cell), n = __ldg(first + cell + 1) - t0;
      const long long step = 4LL * Z * kCoef;
      const float* p = partial + (((long long)b * tiles + t0) * 4 + (sy & 1) * 2 + (sx & 1)) * Z * kCoef + z * kCoef + c;
      int k = 0;
      for (; k + 4 <= n; k += 4, p += 4 * step) {  // four loads in flight, added in order
        const float a = __ldg(p), bq = __ldg(p + step), cq = __ldg(p + 2 * step), d = __ldg(p + 3 * step);
        sum += a;
        sum += bq;
        sum += cq;
        sum += d;
      }
      for (; k < n; ++k, p += step) sum += __ldg(p);
    }
  }
  // the cells in the plan's order (their reach entries ascend)
  const int lane = threadIdx.x & 31;
  const float s1 = __shfl_sync(0xffffffffu, sum, lane + 1), s2 = __shfl_sync(0xffffffffu, sum, lane + 2),
              s3 = __shfl_sync(0xffffffffu, sum, lane + 3);
  if (live && j == 0) out[i] = ((sum + s1) + s2) + s3;
}

__global__ void __launch_bounds__(kThreads)
bilagrid_lum_bwd_kernel(const float* __restrict__ g, const float* __restrict__ v, const float* __restrict__ gray,
                        const int* __restrict__ plan, int H, int Wd, int Z, int Y, int X, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* stages = reinterpret_cast<float*>(smem4) + warp * kStages * kStageFloats;
  float* win = reinterpret_cast<float*>(smem4) + kWarps * kStages * kStageFloats;  // [Z][4 corners][12]
  const int4 t = block_tile(plan);
  const int per_row = (t.w + 31) >> 5;
  for (int k = 0; k < kStages - 1; ++k)
    issue_chunk(v, gray, t, Wd, per_row, warp + k * kWarps, stages + k * kStageFloats, lane);

  // the tile's node window as level differences, 0 at the top level
  const int b = t.x / H, h0 = t.x - b * H;
  int x0, x1, y0, y1;
  float f;
  corners(axis_coord(t.y, Wd, X), X, &x0, &x1, &f);
  corners(axis_coord(h0, H, Y), Y, &y0, &y1, &f);
  const float* gb = g + (long long)b * Z * Y * X * kCoef;
  const int YX = Y * X;
  for (int i = threadIdx.x; i < Z * 4 * kCoef; i += kThreads) {
    const int z = i / (4 * kCoef), k = (i / kCoef) & 3, c = i % kCoef;
    const int node = (k >> 1 ? y1 : y0) * X + (k & 1 ? x1 : x0);
    float d = 0.0f;
    if (z + 1 < Z) {
      const float* p = gb + ((long long)z * YX + node) * kCoef + c;
      d = __fsub_rn(__ldg(p + (long long)YX * kCoef), __ldg(p));
    }
    win[z * kLevelPitch + k * kCoef + c] = d;
  }
  __syncthreads();

  const float zm = (float)(Z - 1);
  for (int i = 0, q = warp; q < t.z * per_row; ++i, q += kWarps) {
    issue_chunk(v, gray, t, Wd, per_row, q + (kStages - 1) * kWarps,
                stages + (i + kStages - 1) % kStages * kStageFloats, lane);
    cp_wait<kStages - 1>();
    __syncwarp();
    const float* vs = stages + i % kStages * kStageFloats;
    const Chunk k(t, Wd, per_row, q);
    if (lane < k.n) {
      int z0, z1;
      float fx, fy, fz;
      corners(axis_coord(k.w + lane, Wd, X), X, &x0, &x1, &fx);
      corners(axis_coord(h0 + k.row, H, Y), Y, &y0, &y1, &fy);
      corners(__fmul_rn(vs[32 * kCoef + lane], zm), Z, &z0, &z1, &fz);
      const float gx = 1.0f - fx, gy = 1.0f - fy;
      const float w00 = gx * gy, w01 = fx * gy, w10 = gx * fy, w11 = fx * fy;
      const float4* lv = reinterpret_cast<const float4*>(win + z0 * kLevelPitch);
      const float4* vp = reinterpret_cast<const float4*>(vs + lane * kCoef);
      float d = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 a = lv[j], bq = lv[3 + j], cq = lv[6 + j], e = lv[9 + j], x = vp[j];
        d = fmaf(x.x, w00 * a.x + w01 * bq.x + w10 * cq.x + w11 * e.x, d);
        d = fmaf(x.y, w00 * a.y + w01 * bq.y + w10 * cq.y + w11 * e.y, d);
        d = fmaf(x.z, w00 * a.z + w01 * bq.z + w10 * cq.z + w11 * e.z, d);
        d = fmaf(x.w, w00 * a.w + w01 * bq.w + w10 * cq.w + w11 * e.w, d);
      }
      out[k.pix + lane] = d * zm;
    }
    __syncwarp();  // before a later copy overwrites this stage
  }
  cp_wait<0>();
}

bool valid(int ntiles, int B, int H, int Wd, int Z, int Y, int X) {
  return ntiles >= 0 && B >= 0 && H >= 0 && Wd >= 0 && Z >= 1 && Y >= 1 && X >= 1;
}

// set a kernel's dynamic shared memory where it is above the 48 KB default
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int bilagrid_lum_bwd_launch(const void* g, const void* v, const void* gray, const void* plan, int ntiles,
                                       int B, int H, int Wd, int Z, int Y, int X, void* out, void* stream) {
  if (!valid(ntiles, B, H, Wd, Z, Y, X)) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)Z * kLevelPitch + kWarps * kStages * kStageFloats) * sizeof(float);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  if (ntiles == 0) return (int)cudaGetLastError();
  cudaError_t e = allow_smem(bilagrid_lum_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  bilagrid_lum_bwd_kernel<<<ntiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)v, (const float*)gray, (const int*)plan, H, Wd, Z, Y, X, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int bilagrid_bwd_launch(const void* v, const void* gray, const void* plan, int ntiles, int B, int H,
                                   int Wd, int Z, int Y, int X, void* partial, void* out, void* stream) {
  if (!valid(ntiles, B, H, Wd, Z, Y, X)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * warp_floats(Z) * sizeof(float);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ntiles > 0) {
    cudaError_t e = allow_smem(bilagrid_bwd_tiles, smem);
    if (e != cudaSuccess) return (int)e;
    bilagrid_bwd_tiles<<<ntiles, kThreads, smem, s>>>((const float*)v, (const float*)gray, (const int*)plan, H, Wd,
                                                      Z, Y, X, (float*)partial);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long total = (long long)B * Z * Y * X * kCoef;
  if (total >= (1LL << 29)) return (int)cudaErrorInvalidValue;
  if (total > 0) {
    bilagrid_bwd_nodes<<<(unsigned)((4 * total + kNodeThreads - 1) / kNodeThreads), kNodeThreads, 0, s>>>(
        (const float*)partial, (const int*)plan, ntiles, B, Z, Y, X, (float*)out);
  }
  return (int)cudaGetLastError();
}
