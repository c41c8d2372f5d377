// The compositing kernels of the binned and the tiled rasterizers, 3DGS and
// 2DGS, forward and backward (the four rasterize_*.cu files of each backend
// are thin C entry points over these).
//
// Every kernel runs one block per (camera, tile), P pixels of a tile column
// a thread (Column below):
//   T = C*th*tw blocks; cam = t / (th*tw), rem = t % (th*tw), tile row
//   rem / tw, column rem % tw; thread i on column i % ts, rows (i / ts) P ..
//   (i / ts) P + P - 1 of the tile.
// The block walks its range [offs[t], offs[t] + cnts[t]) of a depth-sorted
// stream in batches staged in shared memory. The two backends differ only in
// where a batch comes from, which the staging policy says:
//   Streamed<B>: the binned stream, [nf, M] rows of the emitted entries in
//     sort order; the block copies B columns at a time as [nf][B], so feature
//     f of entry j is sm[f * B + j] (load_rows, for the forwards: entry j's
//     row at sm[j * row_floats()], read as float4).
//   Gathered<B>: the tiled stream, flatten_ids [M] into a packed [C*N, F]
//     table of per-Gaussian rows (F a multiple of 8 floats, so a row is
//     32-byte aligned); the block copies the row packed[flatten_ids[i]] of
//     each entry with 16-byte loads (neighbouring threads on neighbouring
//     words of a row), so feature f of entry j is sm[j * F + f]. Nothing is
//     pre-gathered.
// The per-pixel bodies, and with them every accept / reject decision, are
// written once here: both backends, and each forward and its backward,
// decide alike.
//
// The backward kernels walk the range back to front from the tile's largest
// `last` and write one row per stream slot (one tile of one Gaussian, so one
// block writes it and no atomics are needed): each value is summed over a
// thread's pixels, then over a warp's by one transposed reduction over all
// values (warp_transpose_sum; skipped when no lane of the warp accepted the
// entry), then the per-warp partials in shared memory in warp order, so the
// result is deterministic. The caller sums each Gaussian's slots with
// csrc/gid_reduce.cu.

#pragma once

#include <cuda_runtime.h>

#include "surfel.cuh"

namespace raster {

constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr int kFix2 = 12;  // 2DGS rows before the features: mx, my, M00..M22, opacity

// the floats of an entry-major staged row of nf values: nf rounded up to
// whole float4, an odd number of them
__host__ __device__ constexpr int staged_row(int nf) {
  return ((nf + 3) / 4 | 1) * 4;
}

template <int B>
struct Streamed {
  static constexpr int kBatch = B;
  static constexpr int kStride = B;  // between one entry's features in shared memory
  const float* entries;              // [nf, M]
  long long M;
  int nf;

  __host__ __device__ int staged_floats() const { return nf * B; }
  // a thread per entry, its nf loads in flight together (a version staging
  // one (feature, entry) pair per step ran the binned 3DGS forward 9% slower
  // on an H100)
  __device__ void load(float* sm, int first, int nb) const {
    for (int j = threadIdx.x; j < nb; j += blockDim.x)
      for (int f = 0; f < nf; ++f) sm[f * B + j] = __ldg(entries + (long long)f * M + first + j);
  }
  __device__ const float* entry(const float* sm, int j) const { return sm + j; }

  // Entry-major staging (the forwards): entry j's nf values at sm[j *
  // row_floats() ...], zero padded, so a thread reads a row 16 bytes at a
  // time. A thread per entry reads its values coalesced across the warp as
  // load() does and writes them as float4; the row holds an odd number of
  // float4 (staged_row), so the 8 threads of a 16-byte store phase hit 8
  // distinct bank groups. NQ bounds row_floats() / 4 at compile time.
  __host__ __device__ int row_floats() const { return staged_row(nf); }
  template <int NQ>
  __device__ void load_rows(float* sm, int first, int nb) const {
    const int nq = row_floats() / 4;
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      const float* src = entries + first + j;
      float4* dst = reinterpret_cast<float4*>(sm) + j * nq;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (q < nq) {
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] = 4 * q + c < nf ? __ldg(src + (long long)(4 * q + c) * M) : 0.0f;
          dst[q] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
};

template <int B>
struct Gathered {
  static constexpr int kBatch = B;
  static constexpr int kStride = 1;
  const float4* packed;  // [C*N, F / 4]
  const int* ids;        // [M]
  int F;

  __host__ __device__ int staged_floats() const { return F * B; }
  __device__ void load(float* sm, int first, int nb) const {
    const int F4 = F / 4;
    float4* sm4 = reinterpret_cast<float4*>(sm);
    for (int i = threadIdx.x; i < nb * F4; i += blockDim.x) {
      const int j = i / F4;
      sm4[i] = __ldg(packed + (long long)__ldg(ids + first + j) * F4 + (i - j * F4));
    }
  }
  __device__ const float* entry(const float* sm, int j) const { return sm + j * F; }

  // already entry-major: a row of F floats, F a multiple of 8
  __host__ __device__ int row_floats() const { return F; }
  template <int NQ>
  __device__ void load_rows(float* sm, int first, int nb) const {
    load(sm, first, nb);
  }
};

// this thread's P pixels of one column (every kernel of this file): a
// block of TS * TS / P threads per tile; thread i owns column i % TS, rows
// (i / TS) P .. (i / TS) P + P - 1 of the tile
template <int TS, int P>
struct Column {
  int cam, x, y0;
  float px;  // the column's pixel centre x (+0.5)

  __device__ Column(int th, int tw) {
    cam = blockIdx.x / (th * tw);
    const int rem = blockIdx.x % (th * tw);
    x = (rem % tw) * TS + threadIdx.x % TS;
    y0 = (rem / tw) * TS + (threadIdx.x / TS) * P;
    px = (float)x + 0.5f;
  }
  __device__ bool inside(int k, int W, int H) const { return x < W && y0 + k < H; }
  // pixel k's index into [C, H, W]
  __device__ long long index(int k, int W, int H) const {
    return ((long long)cam * H + y0 + k) * W + x;
  }
};

// sigma = 0.5 (a dx^2 + c dy^2) + b dx dy, rounded op by op as the plain
// version's torch ops are (no multiply-add contraction, whatever the build's
// flags): an entry on the alpha = 1/255 threshold must not flip between a
// kernel and its plain version, or between a forward and its backward
__device__ __forceinline__ float gauss_sigma(float ca, float cb, float cc, float dx, float dy) {
  return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                             __fmul_rn(__fmul_rn(cc, dy), dy))),
                   __fmul_rn(__fmul_rn(cb, dx), dy));
}

// the largest `last` of the block's pixels, -1 if none
__device__ __forceinline__ int block_max_last(int lst) {
  __shared__ int s_lmax;
  if (threadIdx.x == 0) s_lmax = -1;
  __syncthreads();
  if (lst >= 0) atomicMax(&s_lmax, lst);
  __syncthreads();
  return s_lmax;
}

// One step of the transposed warp sum below: a[0, 2H) of each lane becomes
// a[0, H), the half that the lane's bit H selects, each value plus the one
// that lane ^ H held at the same index; then the steps H / 2 .. 1
template <int H, int N>
__device__ __forceinline__ void warp_halve(float (&a)[N], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? a[i] : a[i + H];
    const float keep = up ? a[i + H] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
  if constexpr (H > 1) warp_halve<H / 2>(a, lane);
}

// The transposed warp sum of N values a lane (N a multiple of 16): after it,
// v[c] of lane r holds the warp's sum of value 32 c + r, and where N ends
// in a half group of 16, v[N / 32] of lanes r and r + 16 holds that of
// value 32 (N / 32) + r. Recursive halving: at offset 16 a lane keeps the
// half of each 32 values that its lane bit selects, sends the other half to
// lane ^ 16 and adds what it receives; then offsets 8, 4, 2 and 1 the same
// way: 31 shuffles for 32 values, where a shuffle tree per value takes 5
// each. A half group halves at offsets 8 .. 1 within each 16 lanes, then
// adds the two halves at offset 16: 16 shuffles for 16 values. The order is
// fixed (deterministic). Every index is a compile-time constant, so the
// values stay in registers.
template <int N>
__device__ __forceinline__ void warp_transpose_sum(float (&v)[N]) {
  static_assert(N % 16 == 0, "whole half groups of 16 values");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < N / 32; ++c) {
    float a[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) a[i] = v[32 * c + i];
    warp_halve<16>(a, lane);
    v[c] = a[0];
  }
  if constexpr (N % 32 == 16) {
    float a[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = v[N - 16 + i];
    warp_halve<8>(a, lane);
    v[N / 32] = a[0] + __shfl_xor_sync(0xffffffffu, a[0], 16);
  }
}

// The batch's slot rows: part [warps][B][nr] summed over the warps in warp
// order into rows [nr, M] at slots [first, first + nb), row-major so that
// neighbouring threads write neighbouring slots; with absgrad also |row 0|
// and |row 1| into rows nr and nr + 1 (|v_mean| per slot, i.e. per tile)
template <int B>
__device__ __forceinline__ void write_slots(const float* part, int nr, int nb, int first,
                                            long long M, bool absgrad, float* rows) {
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < nr * nb; i += blockDim.x) {
    const int r = i / nb;
    const int j = i - r * nb;
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += part[(w * B + j) * nr + r];
    const long long slot = (long long)first + j;
    rows[(long long)r * M + slot] = s;
    if (absgrad && r < 2) rows[(long long)(nr + r) * M + slot] = fabsf(s);
  }
}

// The least sigma = 0.5 (a dx^2 + c dy^2) + b dx dy over the box [dx0, dx1]
// x [dy0, dy1] of offsets, for a positive definite conic: 0 if the box holds
// the centre, else the least of the four edges' minima, each edge's
// minimiser clamped to the edge (the emit cull bounds a tile the same way)
__device__ __forceinline__ float box_min_sigma(float a, float b, float c, float dx0, float dx1,
                                               float dy0, float dy1) {
  if (dx0 <= 0.0f && dx1 >= 0.0f && dy0 <= 0.0f && dy1 >= 0.0f) return 0.0f;
  const auto q = [=](float dx, float dy) {
    return 0.5f * (a * dx * dx + c * dy * dy) + b * dx * dy;
  };
  const float ye0 = fminf(fmaxf(-b * dx0 / c, dy0), dy1);
  const float ye1 = fminf(fmaxf(-b * dx1 / c, dy0), dy1);
  const float xe0 = fminf(fmaxf(-b * dy0 / a, dx0), dx1);
  const float xe1 = fminf(fmaxf(-b * dy1 / a, dx0), dx1);
  return fminf(fminf(q(dx0, ye0), q(dx1, ye1)), fminf(q(xe0, dy0), q(xe1, dy1)));
}

// A warp skips an entry when opacity x exp(-least sigma over its pixels)
// stays below 1/255 by this factor: the margin covers the rounding of the
// bound against each pixel's sigma, so no pair a pixel accepts is skipped
constexpr float kSkipMargin = 0.999f;

// Bit w of the result: warp w's pixel box (all TS columns, rows [w RW, w RW
// + RW) of the tile, RW = TS / NW) may hold a pixel that accepts entry e,
// whose values gx, gy, conic a, b, c and opacity lie at e[0], e[S], ...,
// e[5 S]. A warp whose bit is clear skips the entry (bwd_3dgs, fwd_3dgs):
// opacity x exp(-least sigma over the box) stays below 1/255 by
// kSkipMargin, so no pixel of the warp would accept it. A conic that is not
// positive definite has no such bound and keeps every bit.
template <int TS, int NW, int S>
__device__ __forceinline__ unsigned warp_reach(const float* e, int th, int tw) {
  constexpr int RW = TS / NW;
  const float a = e[2 * S], b = e[3 * S], c = e[4 * S];
  unsigned m = ~0u;  // not positive definite: no bound, every warp evaluates it
  if (a > 0.0f && c > 0.0f && a * c - b * b > 0.0f) {
    m = 0u;
    // the tile's first pixel centre, recomputed here so that it holds
    // no registers across the compositing loop
    const int t = blockIdx.x % (th * tw);
    const float bx0 = (float)((t % tw) * TS) + 0.5f;
    const float by0 = (float)((t / tw) * TS) + 0.5f;
    const float dx0 = bx0 - e[0];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float dy0 = by0 + (float)(w * RW) - e[S];
      const float smin = box_min_sigma(a, b, c, dx0, dx0 + (TS - 1), dy0, dy0 + (RW - 1));
      // written as "not below" so that a NaN bound keeps the entry
      if (!(e[5 * S] * expf(-smin) < kAlphaMin * kSkipMargin)) m |= 1u << w;
    }
  }
  return m;
}

// float4 q of a staged row (a function of its own, so that a variant can
// read the row another way)
__device__ __forceinline__ float4 row4(const float* e, int q) {
  return reinterpret_cast<const float4*>(e)[q];
}

// ---------------------------------------------------------------------------
// 3DGS forward. Entry rows: mx, my, conic a, b, c, opacity, D colours. Per
// pixel, in stream order:
//   sigma = gauss_sigma; alpha = min(0.999, op exp(-sigma)); skipped if
//   alpha < 1/255 or sigma < 0
//   T_incl = T (1 - alpha); if T_incl <= 1e-4 the pixel is done and the entry
//   is NOT accepted; else accumulate T alpha color, T = T_incl, last = index.
// Outputs per pixel inside the image: image [C,H,W,D] = accum (the caller
// composites the background), T_final [C,H,W] and last [C,H,W] (absolute
// stream index of the last accepted entry, or -1).
// Bound on the card: operations. Counted from the code: 18 per evaluated
// (pixel, entry) pair (the offsets, sigma's 9, expf as negate, scale and
// ex2, the opacity product, the clamp and the two tests) and 2D + 4 more per
// accepted pair (1 - alpha, T_incl, its test, w, and D multiply-adds).
//
// Layout (Column): a block of TS * TS / P threads per tile, thread i owning
// the P pixels of column i % TS, rows (i / TS) P .. (i / TS) P + P - 1
// (fwd3_pixels: 1 for up to 8 channels). The block stages B entries at a
// time entry-major (Stage::load_rows: each row zero padded to whole
// float4), then bounds each staged entry's reach over each warp's pixel box
// (warp_reach, one thread an entry, as bwd_3dgs does) and turns the bits
// into one word per warp and 32 entries by ballot. A warp then walks only
// the set bits of its words, in stream order (__ffs): an entry its box
// cannot reach costs it nothing, not even a test, and most entries of a
// tile are such for most warps (more so on the tiled stream, which has no
// cull). Per entry a thread reads the six fixed values as two float4,
// evaluates sigma, alpha and the test of its P pixels, and only if one
// accepts reads the colours as float4 and composites each accepting pixel
// into all DMAX lanes of its array (no lane tests D: the padding lanes are
// zero and never written out). Each pixel walks the stream in order and
// rounds every operation as the one-pixel-a-thread design did, and a
// skipped pair is one every pixel of the warp would have rejected, so
// image, T and last keep their bits. A thread is done when its P pixels are
// (pixels past the image edge start done); the block leaves once every
// pixel is done, that is once every thread is (__syncthreads_count).
// The per-entry test of a bit in shared memory that the walk replaces
// (a load and a branch on it before any work) ran 40-60% slower on an H100,
// and P = 2 35-60% slower than P = 1 (scripts/torch_emit_fwd3_ab.py).
template <class Stage, int DMAX, int TS, int P>
__global__ void __launch_bounds__(TS * TS / P)
fwd_3dgs(Stage st, const int* __restrict__ offs, const int* __restrict__ cnts, int th, int tw,
         int W, int H, int D, float* __restrict__ img, float* __restrict__ T_out,
         int* __restrict__ last) {
  extern __shared__ float4 smem[];
  float* sm = reinterpret_cast<float*>(smem);
  constexpr int B = Stage::kBatch;
  constexpr int NC = (6 + DMAX + 3) / 4;  // float4 of a row up to the last colour lane
  constexpr int NW = TS * TS / P / 32;    // warps a block
  static_assert(NW >= 1 && NW <= 32, "a block of whole warps, one bit each");
  const int rs = st.row_floats();
  const int nv = 6 + D;  // values a row holds
  const int warp = threadIdx.x >> 5;
  const Column<TS, P> pix(th, tw);
  const int off = offs[blockIdx.x];
  const int n = cnts[blockIdx.x];
  // bit i of reach[w * NG + g]: warp w's box may accept entry 32 g + i
  constexpr int NG = B / 32;
  __shared__ unsigned reach[NW * NG];

  float acc[P][DMAX];
  float T[P];
  int lst[P];
  bool done[P];
  bool all_done = true;
#pragma unroll
  for (int k = 0; k < P; ++k) {
#pragma unroll
    for (int d = 0; d < DMAX; ++d) acc[k][d] = 0.0f;
    T[k] = 1.0f;
    lst[k] = -1;
    done[k] = !pix.inside(k, W, H);  // pixels past the image edge never hold the tile open
    all_done = all_done && done[k];
  }

  for (int b0 = 0; b0 < n; b0 += B) {
    // also the barrier that keeps the previous batch's readers ahead of
    // this batch's loads
    if (__syncthreads_count(all_done) == (int)blockDim.x) break;
    const int nb = min(B, n - b0);
    st.template load_rows<staged_row(6 + DMAX) / 4>(sm, off + b0, nb);
    __syncthreads();
    // a thread an entry, whole warps: each warp's bits of 32 entries by ballot
    for (int j = threadIdx.x; j < (nb + 31) / 32 * 32; j += blockDim.x) {
      const unsigned m = j < nb ? warp_reach<TS, NW, 1>(sm + j * rs, th, tw) : 0u;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const unsigned word = __ballot_sync(0xffffffffu, (m >> w) & 1u);
        if ((threadIdx.x & 31) == 0) reach[w * NG + (j >> 5)] = word;
      }
    }
    __syncthreads();
    // the warp walks only the entries its box may accept, in stream order
    for (int g = 0; 32 * g < nb && !all_done; ++g) {
      for (unsigned bits = reach[warp * NG + g]; bits != 0u && !all_done; bits &= bits - 1u) {
        const int j = 32 * g + __ffs(bits) - 1;
        const float* e = sm + j * rs;
        const float4 r0 = row4(e, 0), r1 = row4(e, 1);
        const float dx = pix.px - r0.x;
        float alpha[P];
        bool keep[P];
        bool any = false;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const float dy = (float)(pix.y0 + k) + 0.5f - r0.y;
          const float sigma = gauss_sigma(r0.z, r0.w, r1.x, dx, dy);
          alpha[k] = fminf(__fmul_rn(r1.y, expf(-sigma)), kAlphaMax);
          keep[k] = !done[k] && !(sigma < 0.0f || alpha[k] < kAlphaMin);
          any = any || keep[k];
        }
        if (!any) continue;
        float v[4 * NC];  // the row's values; colour d at v[6 + d]
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const float4 x = q < 2 ? (q == 0 ? r0 : r1)
                                 : 4 * q < nv ? row4(e, q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          v[4 * q] = x.x;
          v[4 * q + 1] = x.y;
          v[4 * q + 2] = x.z;
          v[4 * q + 3] = x.w;
        }
#pragma unroll
        for (int k = 0; k < P; ++k) {
          if (!keep[k]) continue;
          const float T_incl = T[k] * (1.0f - alpha[k]);
          if (T_incl <= kTransmittanceEps) {
            done[k] = true;
            continue;
          }
          const float w = T[k] * alpha[k];
#pragma unroll
          for (int d = 0; d < DMAX; ++d) acc[k][d] += w * v[6 + d];
          T[k] = T_incl;
          lst[k] = off + b0 + j;
        }
        all_done = true;
#pragma unroll
        for (int k = 0; k < P; ++k) all_done = all_done && done[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (!pix.inside(k, W, H)) continue;
    const long long q = pix.index(k, W, H);
#pragma unroll
    for (int d = 0; d < DMAX; ++d)
      if (d < D) img[q * D + d] = acc[k][d];
    T_out[q] = T[k];
    last[q] = lst[k];
  }
}

// ---------------------------------------------------------------------------
// 3DGS backward. Each pixel starts from the forward's T_final and `last`.
// Per pixel and entry at or before `last` that passes the forward's test:
//   T       /= 1 - alpha              (T before this entry)
//   w        = alpha T
//   cv       = sum_d v_img[d] color[d]
//   v_alpha  = T cv - (s_later + v_logT) / (1 - alpha),  v_logT = v_T T_final
//   s_later += w cv
//   v_sigma  = -alpha v_alpha, v_op = exp(-sigma) v_alpha  (0 if alpha was
//              clamped at 0.999)
//   v_conic  = v_sigma (dx^2 / 2, dx dy, dy^2 / 2)
//   v_mean   = -v_sigma (a dx + b dy, b dx + c dy),   dx = px - gx
//   v_color  = w v_img
// rows [6 + D (+2), M]: v_gx, v_gy, v_a, v_b, v_c, v_op, v_color[D] (+ |v_gx|,
// |v_gy| of the slot with absgrad). Slots past the tile's largest `last`
// stay as the caller zeroed them.
//
// Layout, as bwd_2dgs below: a block of TS * TS / P threads per tile;
// thread i owns the P pixels of column i % TS, rows (i / TS) P .. (i / TS)
// P + P - 1, so they share dx and each staged entry is read from shared
// memory once for all P (bwd3_pixels: 1 for RGB at 16x16 tiles). Per
// entry a thread first evaluates sigma, alpha and the accept test of its P
// pixels (independent, so their expf overlap), then runs the chain of each
// accepting pixel, adding its 6 + D gradient values into one register sum.
// The warp sums those by recursive halving
// (warp_transpose_sum: 16 shuffles for up to 16 rows, 31 for 32), after
// which lane r holds row r, written with one warp-wide store into
// part[warp][entry][row]; an entry no lane of the warp accepted writes
// zeros and shuffles nothing. After staging a batch the block bounds, per
// entry and warp, the least sigma over the warp's pixel box
// (box_min_sigma); a warp whose box the entry cannot reach writes the
// entry's zeros without evaluating it (most warp-entries of small splats).
// Skipping changes no bit: no pixel of the warp would accept the entry.
// write_slots adds the warps in warp order, so
// the rows are deterministic. The decisions round through gauss_sigma and
// __fmul_rn whatever the build's flags, so the kernel builds with
// multiply-add contraction and accepts exactly the forward's entries.
// Bound on the card: operations. Counted from the code: 16 per evaluated
// (pixel, entry) pair, those at or before the pixel's `last`, and 28 + 3D
// more per accepted pair (the warp reduction's adds are this design's own).
template <class Stage, int DMAX, int TS, int P>
__global__ void __launch_bounds__(TS * TS / P)
bwd_3dgs(Stage st, long long M, const int* __restrict__ offs, const int* __restrict__ cnts,
         int th, int tw, int W, int H, int D, const float* __restrict__ T_fin,
         const int* __restrict__ last, const float* __restrict__ v_img,
         const float* __restrict__ v_T, int absgrad, float* __restrict__ rows) {
  extern __shared__ float4 smem[];
  float* sm = reinterpret_cast<float*>(smem);
  constexpr int S = Stage::kStride;
  constexpr int B = Stage::kBatch;
  constexpr int R = (6 + DMAX + 15) / 16 * 16;  // the register sum, padded to half warps
  const int nf = 6 + D;
  float* part = sm + st.staged_floats();  // [warps][B][nf]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int off = offs[blockIdx.x];
  const int n = cnts[blockIdx.x];

  const Column<TS, P> pix(th, tw);
  const int y0 = pix.y0;
  const float px = pix.px;

  int lst[P];
  float T[P], vlogT[P], vimg[P][DMAX];
  int lmax = -1;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    lst[k] = -1;
    T[k] = 1.0f;
    vlogT[k] = 0.0f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) vimg[k][d] = 0.0f;
    if (pix.inside(k, W, H)) {
      const long long q = pix.index(k, W, H);
      lst[k] = last[q];
      T[k] = T_fin[q];
      vlogT[k] = v_T[q] * T[k];
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < D) vimg[k][d] = v_img[q * D + d];
      lmax = max(lmax, lst[k]);
    }
  }
  // entries past the tile's largest `last` add nothing
  const int nact = min(n, block_max_last(lmax) + 1 - off);

  // each warp's pixel box: all TS columns, rows [warp RW, warp RW + RW) of the tile
  constexpr int NW = TS * TS / P / 32;
  __shared__ unsigned reach[B];  // bit w: warp w's box may accept the entry

  float s_later[P];
#pragma unroll
  for (int k = 0; k < P; ++k) s_later[k] = 0.0f;
  for (int b0 = ((nact - 1) / B) * B; nact > 0 && b0 >= 0; b0 -= B) {
    const int nb = min(B, nact - b0);
    __syncthreads();  // the previous batch's readers of sm / part / reach are done
    st.load(sm, off + b0, nb);
    __syncthreads();
    for (int j = threadIdx.x; j < nb; j += blockDim.x)
      reach[j] = warp_reach<TS, NW, S>(st.entry(sm, j), th, tw);
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      const int idx = off + b0 + j;
      if (!((reach[j] >> warp) & 1u)) {  // the same for every lane of the warp
        float* dst = part + (warp * B + j) * nf;
        for (int r = lane; r < nf; r += 32) dst[r] = 0.0f;
        continue;
      }
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      bool any = false;
      if (idx <= lmax) {
        const float* e = st.entry(sm, j);
        const float dx = px - e[0];
        const float gy = e[S];
        const float ca = e[2 * S];
        const float cb = e[3 * S];
        const float cc = e[4 * S];
        const float op = e[5 * S];
        // the forward's decisions for the thread's P pixels
        float dy[P], eneg[P], araw[P];
        bool keep[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          dy[k] = (float)(y0 + k) + 0.5f - gy;
          const float sigma = gauss_sigma(ca, cb, cc, dx, dy[k]);
          eneg[k] = expf(-sigma);
          araw[k] = __fmul_rn(op, eneg[k]);
          keep[k] = idx <= lst[k] && sigma >= 0.0f && fminf(araw[k], kAlphaMax) >= kAlphaMin;
        }
#pragma unroll
        for (int k = 0; k < P; ++k) {
          if (!keep[k]) continue;
          any = true;
          const float alpha = fminf(araw[k], kAlphaMax);
          const float one_m = 1.0f - alpha;
          T[k] = T[k] / one_m;
          const float w = alpha * T[k];
          float cv = 0.0f;
#pragma unroll
          for (int d = 0; d < DMAX; ++d)
            if (d < D) cv += vimg[k][d] * e[(6 + d) * S];
          const float v_alpha = T[k] * cv - (s_later[k] + vlogT[k]) / one_m;
          s_later[k] += w * cv;
          const bool notclamp = araw[k] < kAlphaMax;
          const float v_sig = notclamp ? -alpha * v_alpha : 0.0f;
          acc[0] -= (ca * dx + cb * dy[k]) * v_sig;
          acc[1] -= (cb * dx + cc * dy[k]) * v_sig;
          acc[2] += 0.5f * dx * dx * v_sig;
          acc[3] += dx * dy[k] * v_sig;
          acc[4] += 0.5f * dy[k] * dy[k] * v_sig;
          if (notclamp) acc[5] += eneg[k] * v_alpha;
#pragma unroll
          for (int d = 0; d < DMAX; ++d)
            if (d < D) acc[6 + d] += w * vimg[k][d];
        }
      }
      float* dst = part + (warp * B + j) * nf;
      if (__any_sync(0xffffffffu, any)) {
        warp_transpose_sum(acc);
#pragma unroll
        for (int c = 0; c < R / 32; ++c)
          if (32 * c + lane < nf) dst[32 * c + lane] = acc[c];
        constexpr int H = R / 32 * 32;  // the half group's first row
        if (R % 32 == 16 && lane < 16 && H + lane < nf) dst[H + lane] = acc[R / 32];
      } else {
        for (int r = lane; r < nf; r += 32) dst[r] = 0.0f;
      }
    }
    __syncthreads();
    write_slots<B>(part, nf, nb, off + b0, M, absgrad != 0, rows);
  }
}

// ---------------------------------------------------------------------------
// 2DGS (surfel) forward, built with -fmad=false (surfel.cuh). Entry rows: mx,
// my, M00..M22, opacity, then L = D + 3 features (D colours, the last of them
// the depth m, then 3 normals). Per pixel, in stream order:
//   sigma  = surfel_sigma; alpha = min(0.999, op exp(-sigma)); skipped
//            unless alpha >= 1/255 and sigma >= 0
//   T_incl = T (1 - alpha); if T_incl <= 1e-4 the pixel is done and the
//            entry is NOT accepted; else, with w = T alpha:
//   feat  += w f;   dist += 2 (w m W_< - w WM_<);  W_< += w;  WM_< += w m
//   median = m if T > 0.5;   T = T_incl;   last = the entry's stream index
// Outputs per pixel inside the image: features [C,H,W,L], T_final, last,
// distortion and median [C,H,W]. The caller composites the background.
//
// Bound on the card: operations. Counted from the code, a division and an
// expf one operation each: 41 per evaluated (pixel, entry) pair (the
// ray-plane cross product, sigma, alpha and the tests) and 2L + 13 more per
// accepted pair. Nearly every evaluated pair is accepted on trained surfels,
// and every product and sum rounds on its own (two IEEE divisions, expf and
// some 40 more operations for sigma and alpha alone), so the kernel is bound
// by the instructions it issues a pair, not by latency or bytes: the design
// cuts those.
//
// Layout (Column): a block of TS * TS / P threads per tile, thread i owning
// the P pixels of column i % TS, rows (i / TS) P .. (i / TS) P + P - 1
// (fwd2_pixels: 2 at 16x16 tiles). What the P pixels share is done once an
// entry: the 12 fixed values and the features are read from shared memory
// as float4 (the batch is staged entry-major, Stage::load_rows) and
// surfel_column's d_x and h_u computed once. Per entry a thread first
// evaluates sigma, alpha and the test of its P pixels (independent, so their
// divisions and expf overlap), then composites each accepting pixel into
// all LMAX lanes of its array (no lane tests L). Each pixel walks the stream
// in order and rounds every product and sum on its own, as the one pixel a
// thread design did, so all five outputs keep their bits. A thread is done
// when its P pixels are (pixels past the image edge start done), and the
// block leaves once all its threads are. P = 4 issues fewer instructions a
// pair but holds twice the registers, and with fewer warps an SM it ran
// slower than P = 2 (scripts/torch_fwd2_ab.py).
template <class Stage, int LMAX, int TS, int P>
__global__ void __launch_bounds__(TS * TS / P)
fwd_2dgs(Stage st, const int* __restrict__ offs, const int* __restrict__ cnts, int th, int tw,
         int W, int H, int L, float* __restrict__ feat, float* __restrict__ T_out,
         int* __restrict__ last, float* __restrict__ dist_out, float* __restrict__ med_out) {
  extern __shared__ float4 smem[];
  float* sm = reinterpret_cast<float*>(smem);
  constexpr int B = Stage::kBatch;
  constexpr int NQ = (LMAX + 3) / 4;  // float4 of features
  const int rs = st.row_floats();
  const Column<TS, P> pix(th, tw);
  const int off = offs[blockIdx.x];
  const int n = cnts[blockIdx.x];
  const int md = L - 4;  // the depth: the last colour channel

  float acc[P][LMAX];
  float T[P], dist[P], wsum[P], wmsum[P], med[P];
  int lst[P];
  bool done[P];
  bool all_done = true;
#pragma unroll
  for (int k = 0; k < P; ++k) {
#pragma unroll
    for (int l = 0; l < LMAX; ++l) acc[k][l] = 0.0f;
    T[k] = 1.0f;
    dist[k] = wsum[k] = wmsum[k] = med[k] = 0.0f;
    lst[k] = -1;
    done[k] = !pix.inside(k, W, H);  // pixels past the image edge never hold the tile open
    all_done = all_done && done[k];
  }

  for (int b0 = 0; b0 < n; b0 += B) {
    // also the barrier that keeps the previous batch's readers ahead of
    // this batch's loads
    if (__syncthreads_count(all_done) == (int)blockDim.x) break;
    const int nb = min(B, n - b0);
    st.template load_rows<staged_row(kFix2 + LMAX) / 4>(sm, off + b0, nb);
    __syncthreads();
    for (int j = 0; j < nb && !all_done; ++j) {
      const float* e = sm + j * rs;
      const float4* e4 = reinterpret_cast<const float4*>(e);
      const float4 r0 = e4[0], r1 = e4[1], r2 = e4[2];
      const float m[9] = {r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x, r2.y, r2.z};
      const SurfelColumn col = surfel_column(m, r0.x, pix.px);
      // the tests of the thread's P pixels
      float alpha[P];
      bool keep[P];
      bool any = false;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const SurfelSigma s = surfel_sigma(m, col, r0.y, (float)(pix.y0 + k) + 0.5f);
        alpha[k] = fminf(r2.w * expf(-s.sig), kAlphaMax);
        keep[k] = !done[k] && s.sig >= 0.0f && alpha[k] >= kAlphaMin;
        any = any || keep[k];
      }
      if (!any) continue;
      float f[4 * NQ];  // LMAX <= 4 NQ
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 v = 4 * q < L ? e4[kFix2 / 4 + q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        f[4 * q] = v.x;
        f[4 * q + 1] = v.y;
        f[4 * q + 2] = v.z;
        f[4 * q + 3] = v.w;
      }
      const float depth = e[kFix2 + md];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (!keep[k]) continue;
        const float T_incl = T[k] * (1.0f - alpha[k]);
        if (T_incl <= kTransmittanceEps) {
          done[k] = true;
          continue;
        }
        const float w = T[k] * alpha[k];
        // every lane of the array, the padding's too (zeros, or the row's
        // next values: never written out), so no lane tests L
#pragma unroll
        for (int l = 0; l < LMAX; ++l) acc[k][l] += w * f[l];
        const float wm = w * depth;
        dist[k] += 2.0f * (wm * wsum[k] - w * wmsum[k]);
        wsum[k] += w;
        wmsum[k] += wm;
        if (T[k] > 0.5f) med[k] = depth;
        T[k] = T_incl;
        lst[k] = off + b0 + j;
      }
      all_done = true;
#pragma unroll
      for (int k = 0; k < P; ++k) all_done = all_done && done[k];
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (!pix.inside(k, W, H)) continue;
    const long long q = pix.index(k, W, H);
#pragma unroll
    for (int l = 0; l < LMAX; ++l)
      if (l < L) feat[q * L + l] = acc[k][l];
    T_out[q] = T[k];
    last[q] = lst[k];
    dist_out[q] = dist[k];
    med_out[q] = med[k];
  }
}

// ---------------------------------------------------------------------------
// 2DGS backward (the exact, non-coefficient branch of the JAX kernels).
// Per pixel, carrying the later sums S_W = sum w, S_WM = sum w m and
// S_G = sum w G, and per entry at or before `last` that passes the
// forward's test:
//   T        /= 1 - alpha                       (T before this entry)
//   w         = alpha T,   cv = sum_l v_feat[l] f[l],   m = f[depth]
//   W_<       = W_tot - w - S_W,   WM_< = WM_tot - w m - S_WM
//               (W_tot = 1 - T_final, WM_tot = the composited depth)
//   G         = cv + 2 v_dist (m W_< - WM_< + S_WM - m S_W)
//   v_alpha   = T G - (S_G + v_logT) / (1 - alpha),  v_logT = v_T T_final
//   v_sigma   = -alpha v_alpha, v_op = exp(-sigma) v_alpha (0 if alpha was
//               clamped at 0.999)
//   v_f[l]    = w v_feat[l], plus 2 v_dist w (W_< - S_W) on the depth
//   3D branch: v_u = u v_sigma, v_v = v v_sigma, through the cross product
//              h_u x h_v to the nine v_M; 2D branch: v_mean = -2 d v_sigma.
// The median gets no gradient. rows [12 + L, M]: v_gx, v_gy, v_M00..v_M22,
// v_op, v_feat[L].
//
// Layout: a block of TS * TS / P threads per tile; thread i owns the P
// pixels of column i % TS, rows (i / TS) P .. (i / TS) P + P - 1, so they
// share d_x and h_u (surfel_column) and each staged entry is read from shared
// memory once for all P. Per entry a thread first evaluates sigma, alpha and
// the accept test of its P pixels (independent, so their divisions and expf
// overlap), then runs the chain of each accepting pixel, adding its gradient
// values into one register sum. The warp then sums those by recursive
// halving (warp_transpose_sum: 31 shuffles for up to 32 rows), after which
// lane r holds row r, written with one warp-wide store into
// part[warp][entry][row]; write_slots adds the warps in warp order. The
// order is fixed, so the rows are deterministic. Every keep / drop decision
// (surfel_sigma, the alpha product) rounds op by op whatever the build's
// flags, so the kernel builds with multiply-add contraction and accepts
// exactly the forward's entries; the cross-product VJP and the ray-transform
// rows' px / py terms round op by op too (they cancel for an edge-on surfel).
// Bound on the card: operations. Counted from the code, a division and an
// expf one operation each: 41 per evaluated pair (those at or before the
// pixel's `last`: the forward's sigma and tests) and 5L + 87 more per
// accepted pair (the chain, the cross-product VJP, and one add into the
// slot's sum per row; the warp reduction's further adds are this design's
// own). The f32 peak counts a multiply-add as two operations.
template <class Stage, int LMAX, int TS, int P>
__global__ void __launch_bounds__(TS * TS / P)
bwd_2dgs(Stage st, long long M, const int* __restrict__ offs, const int* __restrict__ cnts,
         int th, int tw, int W, int H, int L, const float* __restrict__ T_fin,
         const int* __restrict__ last, const float* __restrict__ wm_tot_in,
         const float* __restrict__ v_feat, const float* __restrict__ v_T,
         const float* __restrict__ v_dist, float* __restrict__ rows) {
  extern __shared__ float4 smem[];
  float* sm = reinterpret_cast<float*>(smem);
  constexpr int S = Stage::kStride;
  constexpr int B = Stage::kBatch;
  constexpr int R = (kFix2 + LMAX + 31) / 32 * 32;  // the register sum, padded to whole warps
  const int nf = kFix2 + L;
  float* part = sm + st.staged_floats();  // [warps][B][nf]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int off = offs[blockIdx.x];
  const int n = cnts[blockIdx.x];
  const int md = L - 4;  // the depth: the last colour channel

  const Column<TS, P> pix(th, tw);
  const int y0 = pix.y0;
  const float px = pix.px;

  int lst[P];
  float T[P], vlogT[P], vdist[P], w_tot[P], wm_tot[P], vf[P][LMAX];
  int lmax = -1;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    lst[k] = -1;
    T[k] = 1.0f;
    vlogT[k] = vdist[k] = w_tot[k] = wm_tot[k] = 0.0f;
#pragma unroll
    for (int l = 0; l < LMAX; ++l) vf[k][l] = 0.0f;
    if (pix.inside(k, W, H)) {
      const long long q = pix.index(k, W, H);
      lst[k] = last[q];
      T[k] = T_fin[q];
      vlogT[k] = v_T[q] * T[k];
      vdist[k] = v_dist[q];
      w_tot[k] = 1.0f - T[k];
      wm_tot[k] = wm_tot_in[q];
#pragma unroll
      for (int l = 0; l < LMAX; ++l)
        if (l < L) vf[k][l] = v_feat[q * L + l];
      lmax = max(lmax, lst[k]);
    }
  }
  // entries past the tile's largest `last` add nothing
  const int nact = min(n, block_max_last(lmax) + 1 - off);

  float sG[P], sW[P], sWM[P];
#pragma unroll
  for (int k = 0; k < P; ++k) sG[k] = sW[k] = sWM[k] = 0.0f;
  for (int b0 = ((nact - 1) / B) * B; nact > 0 && b0 >= 0; b0 -= B) {
    const int nb = min(B, nact - b0);
    __syncthreads();  // the previous batch's readers of sm / part are done
    st.load(sm, off + b0, nb);
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      const int idx = off + b0 + j;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      bool any = false;
      if (idx <= lmax) {
        const float* e = st.entry(sm, j);
        float m[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) m[i] = e[(2 + i) * S];
        const float gy = e[S];
        const float op = e[11 * S];
        float f[LMAX];
#pragma unroll
        for (int l = 0; l < LMAX; ++l) f[l] = l < L ? e[(kFix2 + l) * S] : 0.0f;
        const float depth = e[(kFix2 + md) * S];
        const SurfelColumn col = surfel_column(m, e[0], px);
        // the forward's decisions for the thread's P pixels
        SurfelSigma s[P];
        float eneg[P], araw[P];
        bool keep[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          s[k] = surfel_sigma(m, col, gy, (float)(y0 + k) + 0.5f);
          eneg[k] = expf(-s[k].sig);
          araw[k] = __fmul_rn(op, eneg[k]);
          keep[k] = idx <= lst[k] && s[k].sig >= 0.0f && fminf(araw[k], kAlphaMax) >= kAlphaMin;
        }
        float v_depth = 0.0f;  // the depth row's distortion term, added below
#pragma unroll
        for (int k = 0; k < P; ++k) {
          if (!keep[k]) continue;
          any = true;
          const float alpha = fminf(araw[k], kAlphaMax);
          const float one_m = 1.0f - alpha;
          T[k] = __fdiv_rn(T[k], one_m);
          const float w = alpha * T[k];
          float cv = 0.0f;
#pragma unroll
          for (int l = 0; l < LMAX; ++l) cv += vf[k][l] * f[l];
          const float wm = w * depth;
          const float W_pref = w_tot[k] - w - sW[k];
          const float WM_pref = wm_tot[k] - wm - sWM[k];
          const float G =
              cv + vdist[k] * 2.0f * (depth * W_pref - WM_pref + (sWM[k] - depth * sW[k]));
          const float v_alpha = T[k] * G - (sG[k] + vlogT[k]) / one_m;
          v_depth += vdist[k] * 2.0f * w * (W_pref - sW[k]);
          sG[k] += w * G;
          sW[k] += w;
          sWM[k] += wm;
          const bool notclamp = araw[k] < kAlphaMax;
          const float v_sig = notclamp ? -alpha * v_alpha : 0.0f;
          if (notclamp) acc[11] += eneg[k] * v_alpha;
#pragma unroll
          for (int l = 0; l < LMAX; ++l)
            if (l < L) acc[kFix2 + l] += w * vf[k][l];
          if (s[k].use3d) {
            // one reciprocal for the three quotients (the plain version
            // divides three times; this is gradient, not decision). The
            // cross-product VJP and the px / py terms round op by op as the
            // plain version's ops: for an edge-on surfel they cancel, and
            // contracted they moved a ray-transform slot past its gate
            const float rcz = __frcp_rn(s[k].crz);
            const float v_u = s[k].u * v_sig;
            const float v_v = s[k].v * v_sig;
            const float vc0 = v_u * rcz;
            const float vc1 = v_v * rcz;
            const float vc2 = -__fadd_rn(__fmul_rn(s[k].u, v_u), __fmul_rn(s[k].v, v_v)) * rcz;
            const float* hu = s[k].hu;
            const float* hv = s[k].hv;
            const float vhu[3] = {__fsub_rn(__fmul_rn(hv[1], vc2), __fmul_rn(hv[2], vc1)),
                                  __fsub_rn(__fmul_rn(hv[2], vc0), __fmul_rn(hv[0], vc2)),
                                  __fsub_rn(__fmul_rn(hv[0], vc1), __fmul_rn(hv[1], vc0))};
            const float vhv[3] = {__fsub_rn(__fmul_rn(vc1, hu[2]), __fmul_rn(vc2, hu[1])),
                                  __fsub_rn(__fmul_rn(vc2, hu[0]), __fmul_rn(vc0, hu[2])),
                                  __fsub_rn(__fmul_rn(vc0, hu[1]), __fmul_rn(vc1, hu[0]))};
            const float py = (float)(y0 + k) + 0.5f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              acc[2 + c] -= vhu[c];
              acc[5 + c] -= vhv[c];
              acc[8 + c] += __fadd_rn(__fmul_rn(px, vhu[c]), __fmul_rn(py, vhv[c]));
            }
          } else {
            acc[0] -= 2.0f * s[k].dx * v_sig;
            acc[1] -= 2.0f * s[k].dy * v_sig;
          }
        }
#pragma unroll
        for (int l = 0; l < LMAX; ++l)
          if (l == md) acc[kFix2 + l] += v_depth;
      }
      float* dst = part + (warp * B + j) * nf;
      if (__any_sync(0xffffffffu, any)) {
        warp_transpose_sum(acc);
#pragma unroll
        for (int c = 0; c < R / 32; ++c)
          if (32 * c + lane < nf) dst[32 * c + lane] = acc[c];
      } else {
        for (int r = lane; r < nf; r += 32) dst[r] = 0.0f;
      }
    }
    __syncthreads();
    write_slots<B>(part, nf, nb, off + b0, M, false, rows);
  }
}

// ---------------------------------------------------------------------------
// Host side: each launch picks the kernel's register-array width from D or L
// (the backwards also their tile size and pixels a thread) and sets its
// dynamic shared memory limit (above the 48 KB default where needed).

inline bool valid_tile(int ts) { return ts == 8 || ts == 16 || ts == 32; }

template <class K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// P, the pixels a thread of the 3DGS forward owns: kFwd3Pix (P = 2 and 4
// issued fewer instructions a pair but ran slower on an H100), at most 2
// at 8x8 tiles (a block keeps a whole warp), and DMAX / 8 for the 16- and
// 32-wide arrays at 32x32 tiles (1024 threads cap a thread at 64
// registers; 512 spilled the 32-wide array)
constexpr int kFwd3Pix = 1;

template <int TS, int DMAX>
constexpr int fwd3_pixels() {
  return TS == 8 && kFwd3Pix > 2 ? 2 : TS == 32 && DMAX > 8 && kFwd3Pix < DMAX / 8 ? DMAX / 8 : kFwd3Pix;
}

template <class Stage, int TS, int DMAX>
cudaError_t launch_fwd_3dgs_tl(const Stage& st, const int* offs, const int* cnts, int C, int th,
                               int tw, int W, int H, int D, float* img, float* T_out, int* last,
                               cudaStream_t stream) {
  constexpr int P = fwd3_pixels<TS, DMAX>();
  auto kernel = &fwd_3dgs<Stage, DMAX, TS, P>;
  const size_t smem = (size_t)Stage::kBatch * st.row_floats() * sizeof(float);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<C * th * tw, TS * TS / P, smem, stream>>>(st, offs, cnts, th, tw, W, H, D, img, T_out,
                                                     last);
  return cudaGetLastError();
}

// the D instantiations of one tile size
template <class Stage, int TS>
cudaError_t launch_fwd_3dgs_t(const Stage& st, const int* offs, const int* cnts, int C, int th,
                              int tw, int W, int H, int D, float* img, float* T_out, int* last,
                              cudaStream_t stream) {
  auto launch = D <= 4    ? &launch_fwd_3dgs_tl<Stage, TS, 4>
                : D <= 8  ? &launch_fwd_3dgs_tl<Stage, TS, 8>
                : D <= 16 ? &launch_fwd_3dgs_tl<Stage, TS, 16>
                          : &launch_fwd_3dgs_tl<Stage, TS, 32>;
  return launch(st, offs, cnts, C, th, tw, W, H, D, img, T_out, last, stream);
}

template <class Stage>
cudaError_t launch_fwd_3dgs(const Stage& st, const int* offs, const int* cnts, int C, int th,
                            int tw, int ts, int W, int H, int D, float* img, float* T_out,
                            int* last, cudaStream_t stream) {
  auto launch = ts == 8    ? &launch_fwd_3dgs_t<Stage, 8>
                : ts == 16 ? &launch_fwd_3dgs_t<Stage, 16>
                           : &launch_fwd_3dgs_t<Stage, 32>;
  return launch(st, offs, cnts, C, th, tw, W, H, D, img, T_out, last, stream);
}

// P, the pixels a thread of the 3DGS backward owns. kBwd3Pix at 16x16
// tiles for up to 8 channels (256 threads: with the warp-entry skip a
// warp's box of 2 rows skips more entries than 2 pixels' 4 rows; P = 1 ran
// 6-13% faster than 2 and 26% faster than 4 at the train shapes on an
// H100); 2 for the wider arrays there and at 8x8 tiles (ptxas spilled
// some of those at P = 1, none at 2); 4 at 32x32 tiles (256 threads; P = 2
// spilled the 32-channel array there)
constexpr int kBwd3Pix = 1;

template <int TS, int DMAX>
constexpr int bwd3_pixels() {
  return TS == 32 ? 4 : TS == 16 && DMAX <= 8 ? kBwd3Pix : 2;
}

template <class Stage, int TS, int DMAX>
cudaError_t launch_bwd_3dgs_tl(const Stage& st, long long M, const int* offs, const int* cnts,
                               int C, int th, int tw, int W, int H, int D, const float* T_fin,
                               const int* last, const float* v_img, const float* v_T,
                               int absgrad, float* rows, cudaStream_t stream) {
  constexpr int P = bwd3_pixels<TS, DMAX>();
  constexpr int threads = TS * TS / P;
  auto kernel = &bwd_3dgs<Stage, DMAX, TS, P>;
  const size_t smem =
      ((size_t)st.staged_floats() + (size_t)(6 + D) * Stage::kBatch * (threads / 32)) *
      sizeof(float);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<C * th * tw, threads, smem, stream>>>(st, M, offs, cnts, th, tw, W, H, D, T_fin, last,
                                                 v_img, v_T, absgrad, rows);
  return cudaGetLastError();
}

// the D instantiations of one tile size
template <class Stage, int TS>
cudaError_t launch_bwd_3dgs_t(const Stage& st, long long M, const int* offs, const int* cnts,
                              int C, int th, int tw, int W, int H, int D, const float* T_fin,
                              const int* last, const float* v_img, const float* v_T,
                              int absgrad, float* rows, cudaStream_t stream) {
  auto launch = D <= 4    ? &launch_bwd_3dgs_tl<Stage, TS, 4>
                : D <= 8  ? &launch_bwd_3dgs_tl<Stage, TS, 8>
                : D <= 16 ? &launch_bwd_3dgs_tl<Stage, TS, 16>
                          : &launch_bwd_3dgs_tl<Stage, TS, 32>;
  return launch(st, M, offs, cnts, C, th, tw, W, H, D, T_fin, last, v_img, v_T, absgrad, rows,
                stream);
}

template <class Stage>
cudaError_t launch_bwd_3dgs(const Stage& st, long long M, const int* offs, const int* cnts,
                            int C, int th, int tw, int ts, int W, int H, int D,
                            const float* T_fin, const int* last, const float* v_img,
                            const float* v_T, int absgrad, float* rows, cudaStream_t stream) {
  auto launch = ts == 8    ? &launch_bwd_3dgs_t<Stage, 8>
                : ts == 16 ? &launch_bwd_3dgs_t<Stage, 16>
                           : &launch_bwd_3dgs_t<Stage, 32>;
  return launch(st, M, offs, cnts, C, th, tw, W, H, D, T_fin, last, v_img, v_T, absgrad, rows,
                stream);
}

// P, the pixels a thread of the 2DGS forward owns: kFwd2Pix (4 issued
// fewer instructions a pair but, with its registers, ran slower on an H100);
// 4 at 32x32 tiles and for the 16-wide array, where ptxas spilled some
// P = 2 instantiations (512 threads cap a thread at 128 registers); at 8x8
// tiles no more than keeps a whole warp
constexpr int kFwd2Pix = 2;

template <int TS, int LMAX>
constexpr int fwd2_pixels() {
  return TS == 8 ? 2 : TS == 32 || LMAX == 16 ? 4 : kFwd2Pix;
}

template <class Stage, int TS, int LMAX>
cudaError_t launch_fwd_2dgs_tl(const Stage& st, const int* offs, const int* cnts, int C, int th,
                               int tw, int W, int H, int L, float* feat, float* T_out, int* last,
                               float* dist, float* med, cudaStream_t stream) {
  constexpr int P = fwd2_pixels<TS, LMAX>();
  auto kernel = &fwd_2dgs<Stage, LMAX, TS, P>;
  const size_t smem = (size_t)Stage::kBatch * st.row_floats() * sizeof(float);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<C * th * tw, TS * TS / P, smem, stream>>>(st, offs, cnts, th, tw, W, H, L, feat, T_out,
                                                     last, dist, med);
  return cudaGetLastError();
}

// the L instantiations of one tile size
template <class Stage, int TS>
cudaError_t launch_fwd_2dgs_t(const Stage& st, const int* offs, const int* cnts, int C, int th,
                              int tw, int W, int H, int L, float* feat, float* T_out, int* last,
                              float* dist, float* med, cudaStream_t stream) {
  auto launch = L <= 4    ? &launch_fwd_2dgs_tl<Stage, TS, 4>
                : L <= 8  ? &launch_fwd_2dgs_tl<Stage, TS, 8>
                : L <= 16 ? &launch_fwd_2dgs_tl<Stage, TS, 16>
                          : &launch_fwd_2dgs_tl<Stage, TS, 35>;
  return launch(st, offs, cnts, C, th, tw, W, H, L, feat, T_out, last, dist, med, stream);
}

template <class Stage>
cudaError_t launch_fwd_2dgs(const Stage& st, const int* offs, const int* cnts, int C, int th,
                            int tw, int ts, int W, int H, int L, float* feat, float* T_out,
                            int* last, float* dist, float* med, cudaStream_t stream) {
  auto launch = ts == 8    ? &launch_fwd_2dgs_t<Stage, 8>
                : ts == 16 ? &launch_fwd_2dgs_t<Stage, 16>
                           : &launch_fwd_2dgs_t<Stage, 32>;
  return launch(st, offs, cnts, C, th, tw, W, H, L, feat, T_out, last, dist, med, stream);
}

// P, the pixels a thread owns: kBwd2Pix; 2 for the L > 16 arrays below
// 32x32 tiles (P = 4 spilled there); fewer at 8x8 tiles so that a block
// keeps a whole warp
constexpr int kBwd2Pix = 4;

template <class Stage, int TS, int LMAX>
cudaError_t launch_bwd_2dgs_tl(const Stage& st, long long M, const int* offs, const int* cnts,
                               int C, int th, int tw, int W, int H, int L, const float* T_fin,
                               const int* last, const float* wm_tot, const float* v_feat,
                               const float* v_T, const float* v_dist, float* rows,
                               cudaStream_t stream) {
  constexpr int P0 = LMAX > 16 && TS < 32 ? 2 : kBwd2Pix;
  constexpr int P = P0 < TS * TS / 32 ? P0 : TS * TS / 32;
  constexpr int threads = TS * TS / P;
  auto kernel = &bwd_2dgs<Stage, LMAX, TS, P>;
  const size_t smem =
      ((size_t)st.staged_floats() + (size_t)(kFix2 + L) * Stage::kBatch * (threads / 32)) *
      sizeof(float);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<C * th * tw, threads, smem, stream>>>(st, M, offs, cnts, th, tw, W, H, L, T_fin, last,
                                                 wm_tot, v_feat, v_T, v_dist, rows);
  return cudaGetLastError();
}

// the L instantiations of one tile size
template <class Stage, int TS>
cudaError_t launch_bwd_2dgs_t(const Stage& st, long long M, const int* offs, const int* cnts,
                              int C, int th, int tw, int W, int H, int L, const float* T_fin,
                              const int* last, const float* wm_tot, const float* v_feat,
                              const float* v_T, const float* v_dist, float* rows,
                              cudaStream_t stream) {
  auto launch = L <= 4    ? &launch_bwd_2dgs_tl<Stage, TS, 4>
                : L <= 8  ? &launch_bwd_2dgs_tl<Stage, TS, 8>
                : L <= 16 ? &launch_bwd_2dgs_tl<Stage, TS, 16>
                          : &launch_bwd_2dgs_tl<Stage, TS, 35>;
  return launch(st, M, offs, cnts, C, th, tw, W, H, L, T_fin, last, wm_tot, v_feat, v_T, v_dist,
                rows, stream);
}

template <class Stage>
cudaError_t launch_bwd_2dgs(const Stage& st, long long M, const int* offs, const int* cnts,
                            int C, int th, int tw, int ts, int W, int H, int L,
                            const float* T_fin, const int* last, const float* wm_tot,
                            const float* v_feat, const float* v_T, const float* v_dist,
                            float* rows, cudaStream_t stream) {
  auto launch = ts == 8    ? &launch_bwd_2dgs_t<Stage, 8>
                : ts == 16 ? &launch_bwd_2dgs_t<Stage, 16>
                           : &launch_bwd_2dgs_t<Stage, 32>;
  return launch(st, M, offs, cnts, C, th, tw, W, H, L, T_fin, last, wm_tot, v_feat, v_T, v_dist,
                rows, stream);
}

}  // namespace raster
