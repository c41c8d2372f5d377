#!/usr/bin/env python3
"""Variants of the port's gid reduce and 3DGS backward kernels, timed on
the same inputs on one CUDA card (gsplat_tpu_torch, csrc/gid_reduce.cu and
csrc/raster.cuh::bwd_3dgs).

    python3 scripts/torch_reduce_bwd3_ab.py --parent DIR [--rounds 3] [--reps 5]

DIR is a checkout of the tree to compare with (for example the parent
commit unpacked with `git archive` into build/parent). The script:

  1. builds this tree's kernels (gsplat_tpu_torch._backend) and each
     variant below with nvcc, one process each, all started together, into
     build/reduce_bwd3_ab/<variant>/, and prints ptxas's registers and
     spills and the SHFL count in the SASS of each variant's bwd_3dgs
     instantiations (cuobjdump);
  2. trains Runner and Runner2DGS 12 steps each on chip_smoke.py's training
     scene (garden scene_grid=5, 1920x1080, tile 16) and takes view 0's
     binned stream and its tiled stream (isect_tiles) of each: chip_smoke's
     "train shapes" and "2DGS train shapes". The backward kernels run on
     the 3DGS streams; the reduce on the slot rows of all four (this tree's
     backward kernels' rows, seeded cotangents);
  3. holds every variant that computes rows or sums to the plain version by
     chip_smoke.py's gates (the backward's BWD_RTOL / BWD_ATOL per row, the
     reduce's REDUCE_TOL against index_add_), checks that two launches
     give the same bits, and whether this tree's reduce gives DIR's bits;
  4. times the variants in turns, `--rounds` rounds of `--reps` launches
     each (CUDA events), the order reversed every other round, and prints
     each variant's median.

Backward variants (`old` = DIR's csrc, `new` = this tree's); the ablations
compute wrong rows and are timed only:
  old, old-tiled            DIR's binned / tiled 3DGS backward
  new, new-tiled            this tree's
  new-noreduce,             this tree's without warp_transpose_sum and the
  new-tiled-noreduce        slot writes (the values kept live by a compare
                            and a store that never happens)
  new-noskip,               every warp evaluates every entry (this tree skips
  new-tiled-noskip          the entries its pixel box cannot reach; the rows
                            must be the same bits)
  new-P4, new-P2,           4 or 2 pixels a thread at 16x16 tiles (kBwd3Pix;
  new-tiled-P2              this tree: 1)
  new-B32, new-tiled-B32    staging 32 entries a batch (this tree: 64)
  new-rcp, new-tiled-rcp    one reciprocal of 1 - alpha for T and v_alpha
                            (this tree divides twice)
Reduce variants, on each of the four streams:
  old-path      DIR's reduce as its training path calls it: the gid sort
                and searchsorted (gid_segments), then its kernel
  old-kernel    DIR's kernel alone, the segments made beforehand
  new           this tree's, on the stream's own gid order (the training
                path's call: no sort)
  new-pass1     its pass 1 alone (the scatter into gid order)
  new-pass2     its pass 2 alone (the segment sums)
  new-rp4       both passes with a slot's scratch row rounded to 4 floats
                (this tree: to 8, whole 32-byte sectors, above 16 rows)
  new-gidsort   this tree's kernel through a gid sort (reduce_by_gid
                without an order: gid_order, then the kernel)
  index_add_    the plain version, one PyTorch call
and other layouts of pass 1, each held to its scratch bit for bit:
  p1-thread         a thread per slot writing its own row float4 after
                    float4 (this tree's pass 1 stages a warp's 32 rows in
                    shared memory and writes each with Q lanes)
  p1-gather-values  a thread per gid-order place gathering its slot's R
                    values from the [R, M] rows through the inverse of dst
  p1-gather-rows    a slot-major copy in stream order, then whole rows
                    gathered through the inverse of dst (writes in order)
  p1-identity       this tree's pass 1 with dst the identity (a transpose)
  p1-randperm       this tree's pass 1 with a random dst
  inverse-perm      the inverse of dst, one PyTorch scatter
Lines go to stdout; a JSON summary to build/reduce_bwd3_ab/summary.json.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

OUT = os.path.join(ROOT, "build", "reduce_bwd3_ab")

# (source, text, replacement) edits that make the ablations; each text must
# occur exactly once
NEW_NOREDUCE = [
    ("raster.cuh",
     "        warp_transpose_sum(acc);\n"
     "#pragma unroll\n"
     "        for (int c = 0; c < R / 32; ++c)\n"
     "          if (32 * c + lane < nf) dst[32 * c + lane] = acc[c];\n"
     "        constexpr int H = R / 32 * 32;  // the half group's first row\n"
     "        if (R % 32 == 16",
     "        {\n          float s_ = 0.0f;\n#pragma unroll\n          for (int r_ = 0; r_ < R; ++r_) s_ += acc[r_];\n"
     "          if (s_ == 1.2345e-30f) dst[0] = s_;\n        }\n        constexpr int H = R / 32 * 32;\n"
     "        if (R % 32 == 16 && nf < 0"),
    ("raster.cuh", "    write_slots<B>(part, nf, nb, off + b0, M, absgrad != 0, rows);",
     "    if (nf < 0) write_slots<B>(part, nf, nb, off + b0, M, absgrad != 0, rows);"),
]
P4 = [("raster.cuh", "constexpr int kBwd3Pix = 1;", "constexpr int kBwd3Pix = 4;")]
P2 = [("raster.cuh", "constexpr int kBwd3Pix = 1;", "constexpr int kBwd3Pix = 2;")]
NOSKIP = [("raster.cuh", "      unsigned m = ~0u;  // not positive definite: no bound, every warp evaluates it\n"
                          "      if (a > 0.0f",
           "      unsigned m = ~0u;  // not positive definite: no bound, every warp evaluates it\n"
           "      if (nb < 0 && a > 0.0f")]
RCP = [("raster.cuh", "          T[k] = T[k] / one_m;",
        "          const float inv_ = __frcp_rn(one_m);\n          T[k] = T[k] * inv_;"),
       ("raster.cuh", "          const float v_alpha = T[k] * cv - (s_later[k] + vlogT[k]) / one_m;",
        "          const float v_alpha = T[k] * cv - (s_later[k] + vlogT[k]) * inv_;")]
B32 = [("rasterize_bwd.cu", "raster::Streamed<64> st", "raster::Streamed<32> st")]
B32_TILED = [("rasterize_tiled_bwd.cu", "raster::Gathered<64> st", "raster::Gathered<32> st")]

# pass-1 layouts of the gid reduce, each writing the same gid-order scratch
# [M, Q] float4 as csrc/gid_reduce.cu's scatter_kernel (timed, and held to
# its bits)
LAYOUTS = r"""
#include <cuda_runtime.h>
// a thread per slot writes its own row, float4 after float4 (each warp store
// 32 pieces of 16 bytes, a row apart)
__global__ void __launch_bounds__(256) scatter_thread(const float* __restrict__ rows, long long M,
    int R, int Q, const long long* __restrict__ dst, float4* __restrict__ scratch) {
  const long long k = (long long)blockIdx.x * 256 + threadIdx.x;
  if (k >= M) return;
  float4* out = scratch + __ldg(dst + k) * Q;
#pragma unroll 4
  for (int q = 0; q < Q; ++q) {
    float v[4];
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * q + i;
      v[i] = r < R ? __ldg(rows + (long long)r * M + k) : 0.0f;
    }
    out[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}
// a thread per gid-order position j gathers slot src[j]'s values
__global__ void __launch_bounds__(256) gather_values(const float* __restrict__ rows, long long M,
    int R, int Q, const long long* __restrict__ src, float4* __restrict__ scratch) {
  const long long j = (long long)blockIdx.x * 256 + threadIdx.x;
  if (j >= M) return;
  const long long k = __ldg(src + j);
  for (int q = 0; q < Q; ++q) {
    float v[4];
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * q + i;
      v[i] = r < R ? __ldg(rows + (long long)r * M + k) : 0.0f;
    }
    scratch[j * Q + q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}
// float4 i of the output reads float4 i % Q of row src[i / Q] of a
// slot-major copy in stream order (reads of whole rows, writes in order)
__global__ void __launch_bounds__(256) gather_rows(const float4* __restrict__ tr, long long M, int Q,
    const long long* __restrict__ src, float4* __restrict__ scratch) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= M * Q) return;
  const long long j = i / Q;
  scratch[i] = __ldg(tr + __ldg(src + j) * Q + (i - j * Q));
}
extern "C" int layout_launch(int which, const void* rows, long long M, int R, int Q, const void* idx,
                             const void* tr, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 0) {
    scatter_thread<<<(unsigned)((M + 255) / 256), 256, 0, s>>>((const float*)rows, M, R, Q,
        (const long long*)idx, (float4*)scratch);
  } else if (which == 1) {
    gather_values<<<(unsigned)((M + 255) / 256), 256, 0, s>>>((const float*)rows, M, R, Q,
        (const long long*)idx, (float4*)scratch);
  } else {
    gather_rows<<<(unsigned)((M * Q + 255) / 256), 256, 0, s>>>((const float4*)tr, M, Q,
        (const long long*)idx, (float4*)scratch);
  }
  return (int)cudaGetLastError();
}
"""

_OLD_REDUCE_ARGS = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]  # rows, M, R
    + [ctypes.c_void_p] * 2  # perm, starts
    + [ctypes.c_int]  # n_out
    + [ctypes.c_void_p] * 3  # partials, out, stream
)


def variants(parent_csrc, csrc):
    """label -> (csrc dir, source, flags, edits, computes the rows)"""
    return {
        "old": (parent_csrc, "rasterize_bwd", (), [], True),
        "new": (csrc, "rasterize_bwd", (), [], True),
        "new-noreduce": (csrc, "rasterize_bwd", (), NEW_NOREDUCE, False),
        "new-noskip": (csrc, "rasterize_bwd", (), NOSKIP, True),
        "new-P4": (csrc, "rasterize_bwd", (), P4, True),
        "new-P2": (csrc, "rasterize_bwd", (), P2, True),
        "new-B32": (csrc, "rasterize_bwd", (), B32, True),
        "new-rcp": (csrc, "rasterize_bwd", (), RCP, True),
        "old-tiled": (parent_csrc, "rasterize_tiled_bwd", (), [], True),
        "new-tiled": (csrc, "rasterize_tiled_bwd", (), [], True),
        "new-tiled-noreduce": (csrc, "rasterize_tiled_bwd", (), NEW_NOREDUCE, False),
        "new-tiled-noskip": (csrc, "rasterize_tiled_bwd", (), NOSKIP, True),
        "new-tiled-P2": (csrc, "rasterize_tiled_bwd", (), P2, True),
        "new-tiled-B32": (csrc, "rasterize_tiled_bwd", (), B32_TILED, True),
        "new-tiled-rcp": (csrc, "rasterize_tiled_bwd", (), RCP, True),
    }


def build_variant(args):
    """Copy `csrc`, apply the edits, nvcc `source`. Returns (.so path, ptxas log)."""
    from gsplat_tpu_torch import _backend

    label, (csrc, source, flags, edits, _) = args
    work = os.path.join(OUT, label)
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(csrc, work)
    for fname, text, repl in edits:
        path = os.path.join(work, fname)
        body = open(path).read()
        if body.count(text) != 1:
            raise RuntimeError(f"{label}: edit of {fname} matches {body.count(text)} times")
        open(path, "w").write(body.replace(text, repl))
    out = os.path.join(work, source + ".so")
    cmd = [_backend._nvcc()] + list(_backend._COMMON_FLAGS) + list(flags) + [
        "-o", out, os.path.join(work, source + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {label}:\n{proc.stderr}")
    return out, proc.stderr


def shfl_counts(so, name):
    """{kernel: SHFL instructions in its SASS} of the kernels in `so` whose
    demangled name holds `name` (cuobjdump beside nvcc)."""
    from gsplat_tpu_torch import _backend

    cuobjdump = os.path.join(os.path.dirname(_backend._nvcc()), "cuobjdump")
    proc = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True)
    counts, fn = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and "SHFL" in line:
            counts[fn] += 1
    names = cs.demangle(list(counts))
    return {n: counts[k] for n, k in zip(names, counts) if name in n}


def swapped(backend, source, lib, fn):
    """fn() with `source`'s library replaced by `lib`."""
    keep = backend._LIBS[source]
    backend._LIBS[source] = lib
    try:
        return fn()
    finally:
        backend._LIBS[source] = keep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    smi = cs.phase_device()
    import torch
    from gsplat_tpu_torch import _backend, rasterization, rendering
    from gsplat_tpu_torch.ops import binning, rasterize_2dgs_binned as r2, rasterize_2dgs_tiled as r2t
    from gsplat_tpu_torch.ops import rasterize_binned as rb, rasterize_tiled as rt
    from gsplat_tpu_torch.ops.isect import isect_tiles
    from gsplat_tpu_torch.simple_trainer import Runner
    from gsplat_tpu_torch.simple_trainer_2dgs import Runner2DGS

    parent_csrc = os.path.join(os.path.abspath(args.parent), "gsplat_tpu_torch", "csrc")
    vs = variants(parent_csrc, _backend.CSRC)
    os.makedirs(OUT, exist_ok=True)
    old_reduce = ("old-reduce", (parent_csrc, "gid_reduce", (), [], True))
    layouts_src = os.path.join(OUT, "layouts.cu")
    open(layouts_src, "w").write(LAYOUTS)

    def build_layouts():
        out = os.path.join(OUT, "layouts.so")
        cmd = [_backend._nvcc()] + list(_backend._COMMON_FLAGS) + ["-o", out, layouts_src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the pass-1 layouts:\n{proc.stderr}")
        return out

    with ThreadPoolExecutor(max_workers=len(vs) + 3) as pool:
        f_all = pool.submit(_backend.build_all)
        f_vs = {k: pool.submit(build_variant, (k, v)) for k, v in vs.items()}
        f_old = pool.submit(build_variant, old_reduce)
        f_lay = pool.submit(build_layouts)
        f_all.result()
        built = {k: f.result() for k, f in f_vs.items()}
        old_lib = ctypes.CDLL(f_old.result()[0])
        layout_fn = ctypes.CDLL(f_lay.result()).layout_launch
    layout_fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    layout_fn.restype = ctypes.c_int
    summary = {"card": smi, "variants": {}, "reduce": {}}
    for label, (so, log) in built.items():
        regs = [r for r in cs.ptxas_report(log) if "bwd_3dgs" in r[0]]
        shfl = shfl_counts(so, "bwd_3dgs")
        summary["variants"][label] = {"ptxas": {k: f"{v}; {sp}" for k, v, sp in regs}, "shfl": shfl}
        for k, v, sp in regs:
            cs.log(f"ptxas {label} {k}: {v}; {sp}; SHFL in SASS {shfl.get(k, 'n/a')}")
    for k, v, sp in cs.ptxas_report(_backend.BUILD_LOG.get("gid_reduce", "")):
        cs.log(f"ptxas gid_reduce {k}: {v}; {sp}")
    libs = {label: ctypes.CDLL(so) for label, (so, _) in built.items()}

    dev = torch.device("cuda")
    W, H, ts = cs.MAIN_W, cs.MAIN_H, cs.MAIN_TILE
    scene = cs.train_scene(torch, rasterization, dev)
    streams = {}  # name -> (rows, gids, n_out, order)
    full = 1 << 40  # a capacity that truncates no tiled stream (its buffers are sized exactly)
    runner, _ = cs.train_runner(torch, Runner, scene, "binned",
                                ("emit", "rasterize_fwd", "rasterize_bwd", "gid_reduce"), "3DGS")
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
        view = runner.trainset[0]
        vm = torch.linalg.inv(view["camtoworld"])[None]
        K = view["K"][None]
        s = cs.shade(rendering, torch, runner.params, runner.live, vm, K, W, H, runner.cfg.sh_degree)
        plan, slab = cs.emit_plan(binning, s, ts, W, H, runner.isect_capacity)
        T = (-(-W // ts)) * (-(-H // ts))
        bk = binning.sort_entries(binning._emit_cuda(plan), plan.packed, plan.nf, T, slab, binning.segment_starts(plan))
        _, T_k, last_k = rb._fwd_cuda(bk.entries, bk.offs, bk.cnts, 1, W, H, ts)
        D = bk.entries.shape[0] - 6
        v_img, v_T = cs.cotangents(torch, gen, T_k, D)
        bargs = (bk.entries, bk.offs, bk.cnts, T_k, last_k, v_img, v_T, 1, W, H, ts, False)
        CN = plan.counts.shape[0]
        st = cs.tiled_stream(torch, rt, isect_tiles, s, ts, W, H, full)
        _, tT_k, tlast_k = rt._tiled_fwd_cuda(st[0], D, st[1], st[2], st[3], 1, W, H, ts)
        targs = (st[0], D, st[1], st[2], st[3], tT_k, tlast_k, v_img, v_T, 1, W, H, ts, False)
        streams["3DGS binned"] = (rb._bwd_cuda(*bargs), bk.gids, CN, bk.order)
        streams["3DGS tiled"] = (rt._tiled_bwd_cuda(*targs), st[1], CN, st[4].order)
        cs.log(f"3DGS train shapes: binned {int(bk.n_isects)} of {bk.gids.shape[0]} slots live, tiled "
               f"{st[1].shape[0]} slots, {CN} ids")
        del runner, s

    runner2, _ = cs.train_runner(torch, Runner2DGS, scene, "binned",
                                 ("emit", "rasterize_2dgs_fwd", "rasterize_2dgs_bwd", "gid_reduce"), "2DGS",
                                 normal_start=0, dist_start=0)
    with torch.no_grad():
        gen2 = torch.Generator(device=dev).manual_seed(cs.SEED + 4)
        s2 = cs.shade_2dgs(rendering, torch, runner2.params, runner2.live, vm, K, W, H, runner2.cfg.sh_degree,
                           "RGB+ED")
        D2 = s2.colors.shape[-1]
        L = D2 + 3
        plan2, slab2 = cs.emit_plan_2dgs(binning, r2, s2, ts, W, H, runner2.isect_capacity)
        bk2 = binning.sort_entries(binning._emit_cuda(plan2), plan2.packed, plan2.nf, T, slab2, binning.segment_starts(plan2))
        ko = r2._fwd2_cuda(bk2.entries, bk2.offs, bk2.cnts, 1, W, H, ts)
        cot = cs.cotangents_2dgs(torch, gen2, ko[1], L)
        rows2 = r2._bwd2_cuda(bk2.entries, bk2.offs, bk2.cnts, ko[1], ko[2], ko[0][..., D2 - 1].contiguous(), *cot,
                              1, W, H, ts)
        CN2 = plan2.counts.shape[0]
        streams["2DGS binned"] = (rows2, bk2.gids, CN2, bk2.order)
        del bk2, ko, rows2
        st2 = cs.tiled_stream_2dgs(torch, rt, r2, isect_tiles, s2, ts, W, H, full)
        tko = r2t._tiled2_fwd_cuda(st2[0], L, st2[1], st2[2], st2[3], 1, W, H, ts)
        trows2 = r2t._tiled2_bwd_cuda(st2[0], L, st2[1], st2[2], st2[3], tko[1], tko[2],
                                      tko[0][..., D2 - 1].contiguous(), *cot, 1, W, H, ts)
        streams["2DGS tiled"] = (trows2, st2[1], CN2, st2[4].order)
        del runner2, s2, st2, tko, plan2
    torch.cuda.empty_cache()

    with torch.no_grad():
        # the backward variants against the plain version, and their bits
        # from two launches
        inputs = {False: bargs, True: targs}
        plains = {False: rb._bwd_plain(*bargs), True: rt._tiled_bwd_plain(*targs)}
        rows_by = {}
        for label, (_, source, _, _, rows_ok) in vs.items():
            if not rows_ok:
                continue
            tiled = "tiled" in source
            fn = rt._tiled_bwd_cuda if tiled else rb._bwd_cuda
            a = swapped(_backend, source, libs[label], lambda: fn(*inputs[tiled]))
            b = swapped(_backend, source, libs[label], lambda: fn(*inputs[tiled]))
            det = bool(torch.equal(a, b))
            try:
                _, _, mx, _, _ = cs.gate_bwd(torch, a, *plains[tiled])
                verdict = f"gates hold, max abs {mx:.3e}"
            except AssertionError as e:
                verdict = f"GATE FAILS ({e})"
            rows_by[label] = a
            cs.log(f"backward variant {label} vs plain at the train shapes: {verdict}; two launches equal: {det}")
            summary["variants"][label].update(verdict=verdict, deterministic=det)
        for label, ref in (("new", "new-noskip"), ("new-tiled", "new-tiled-noskip")):
            same = bool(torch.equal(rows_by[label], rows_by[ref]))
            summary["variants"][label]["equals_" + ref] = same
            cs.log(f"backward {label}: the same bits as {ref}: {same}")
        del rows_by
        del plains

        # the reduce variants against index_add_
        def old_reduce_fn(rows, perm, starts, n_out):
            R = rows.shape[0]
            size = old_lib.gid_reduce_partials_size
            size.argtypes = [ctypes.c_longlong, ctypes.c_int]
            size.restype = ctypes.c_longlong
            partials = torch.empty(max(size(rows.shape[1], R), 1), dtype=torch.float32, device=dev)
            out = torch.empty((R, n_out), dtype=torch.float32, device=dev)
            fn = old_lib.gid_reduce_launch
            fn.argtypes = _OLD_REDUCE_ARGS
            fn.restype = ctypes.c_int
            _backend.check_launch(fn(rows.data_ptr(), rows.shape[1], R, perm.data_ptr(), starts.data_ptr(), n_out,
                                     partials.data_ptr(), out.data_ptr(), _backend.stream(dev)), "old gid_reduce")
            return out

        new_lib = _backend._LIBS["gid_reduce"]
        scatter = new_lib.gid_reduce_scatter_launch
        scatter.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_void_p]
        scatter.restype = ctypes.c_int
        summ = new_lib.gid_reduce_sum_launch
        summ.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        summ.restype = ctypes.c_int
        psize = new_lib.gid_reduce_partials_size
        psize.argtypes = [ctypes.c_longlong, ctypes.c_int]
        psize.restype = ctypes.c_longlong

        def reduce_fns(rows, gids, n_out, order):
            R, M = rows.shape
            segs = rb.gid_segments(gids, n_out)
            bufs = {}
            for rp in {rb.reduce_row_floats(R), -(-R // 4) * 4}:
                bufs[rp] = (torch.empty(max(M * rp, 4), device=dev), torch.empty(max(psize(M, R), 4), device=dev))
            out = torch.empty((R, n_out), device=dev)
            rp0 = rb.reduce_row_floats(R)
            stream = _backend.stream(dev)

            def pass1(rp=rp0):
                _backend.check_launch(scatter(rows.data_ptr(), M, R, rp, order[0].data_ptr(),
                                              bufs[rp][0].data_ptr(), stream), "scatter")
                return bufs[rp][0]

            def pass2(rp=rp0):
                _backend.check_launch(summ(bufs[rp][0].data_ptr(), M, R, rp, order[1].data_ptr(), n_out,
                                           bufs[rp][1].data_ptr(), out.data_ptr(), stream), "segment sums")
                return out

            def both(rp):
                pass1(rp)
                return pass2(rp).clone()

            # the pass-1 layouts: each slot's place (src, the inverse of
            # dst), a slot-major copy in stream order (pass 1 with dst the
            # identity), and a random dst of the same size
            dst = order[0]
            ar = torch.arange(M, device=dev)
            src = torch.empty_like(dst)
            src[dst] = ar
            tr = torch.empty(max(M * rp0, 4), device=dev)
            lay = torch.empty(max(M * rp0, 4), device=dev)
            rand = torch.randperm(M, device=dev, generator=torch.Generator(device=dev).manual_seed(cs.SEED))

            def scatter_to(idx, buf):
                _backend.check_launch(scatter(rows.data_ptr(), M, R, rp0, idx.data_ptr(), buf.data_ptr(), stream),
                                      "scatter")
                return buf

            scatter_to(ar, tr)

            def layout(which, idx):
                _backend.check_launch(layout_fn(which, rows.data_ptr(), M, R, rp0 // 4, idx.data_ptr(), tr.data_ptr(),
                                                lay.data_ptr(), stream), "pass-1 layout")
                return lay

            def inverse():
                src[dst] = ar
                return src

            return {
                "old-path": lambda: old_reduce_fn(rows, *rb.gid_segments(gids, n_out), n_out),
                "old-kernel": lambda: old_reduce_fn(rows, *segs, n_out),
                "new": lambda: rb._reduce_cuda(rows, *order, n_out),
                "new-pass1": pass1,
                "new-pass2": pass2,
                "new-rp4": lambda: both(-(-R // 4) * 4),
                "new-gidsort": lambda: rb.reduce_by_gid(rows, gids, n_out),
                "index_add_": lambda: rb._reduce_plain(rows, gids, n_out),
                "p1-thread": lambda: layout(0, dst),
                "p1-gather-values": lambda: layout(1, src),
                "p1-gather-rows": lambda: layout(2, src),
                "p1-identity": lambda: scatter_to(ar, lay),
                "p1-randperm": lambda: scatter_to(rand, lay),
                "inverse-perm": inverse,
            }

        computes = ("old-path", "old-kernel", "new", "new-rp4", "new-gidsort")
        for name, (rows, gids, n_out, order) in streams.items():
            fns = reduce_fns(rows, gids, n_out, order)
            want1 = fns["new-pass1"]().clone()
            for label in ("p1-thread", "p1-gather-values", "p1-gather-rows"):
                same = bool(torch.equal(fns[label](), want1))
                cs.log(f"pass-1 layout {name} {label}: the scratch equal to pass 1's bit for bit: {same}")
            del want1
            want = fns["index_add_"]()
            scale = rb._reduce_plain(rows.abs(), gids, n_out).amax(dim=1)
            summary["reduce"][name] = {"M": rows.shape[1], "R": rows.shape[0], "n_out": n_out, "variants": {}}
            same = bool(torch.equal(fns["new"](), fns["old-path"]()))
            summary["reduce"][name]["new_equals_old_bits"] = same
            cs.log(f"reduce {name}: this tree's sums equal DIR's bit for bit: {same}")
            for label in computes:
                a, b = fns[label](), fns[label]()
                diff = (a - want).abs()
                ok = not bool((diff > cs.REDUCE_TOL * scale[:, None]).any())
                det = bool(torch.equal(a, b))
                cs.log(f"reduce {name} {label}: vs index_add_ {'within' if ok else 'PAST'} the gate, max abs "
                       f"{float(diff.max()):.3e}; two launches equal: {det}")
                summary["reduce"][name]["variants"][label] = dict(within_gate=ok, deterministic=det,
                                                                  max_abs=float(diff.max()))

        # timing in turns
        times = {k: [] for k in vs}
        rtimes = {name: {} for name in streams}
        order_b = list(vs)
        for rnd in range(args.rounds):
            for label in (order_b if rnd % 2 == 0 else order_b[::-1]):
                source = vs[label][1]
                fn = rt._tiled_bwd_cuda if "tiled" in source else rb._bwd_cuda
                a = targs if "tiled" in source else bargs
                times[label].append(swapped(_backend, source, libs[label],
                                            lambda: cs.cuda_ms(torch, lambda: fn(*a), args.reps)))
            for name, (rows, gids, n_out, order) in streams.items():
                fns = reduce_fns(rows, gids, n_out, order)
                labels = list(fns)
                for label in (labels if rnd % 2 == 0 else labels[::-1]):
                    if label == "new-pass2":
                        fns["new-pass1"]()
                    rtimes[name].setdefault(label, []).append(cs.cuda_ms(torch, fns[label], args.reps))
    for label, ts_ in times.items():
        med = statistics.median(ts_)
        summary["variants"][label].update(ms=ts_, median_ms=med)
        cs.log(f"time bwd {label}: median {med:.3f} ms over {len(ts_)} rounds of {args.reps} "
               f"({', '.join(f'{t:.3f}' for t in ts_)})")
    for name, per in rtimes.items():
        for label, ts_ in per.items():
            med = statistics.median(ts_)
            summary["reduce"][name]["variants"].setdefault(label, {}).update(ms=ts_, median_ms=med)
            cs.log(f"time reduce {name} {label}: median {med:.3f} ms over {len(ts_)} rounds of {args.reps} "
                   f"({', '.join(f'{t:.3f}' for t in ts_)})")
    cs.log(f"card: {smi}")
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
