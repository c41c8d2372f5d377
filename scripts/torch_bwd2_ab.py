#!/usr/bin/env python3
"""Variants of the port's 2DGS backward kernel, timed on the same inputs on
one CUDA card (gsplat_tpu_torch, csrc/raster.cuh::bwd_2dgs).

    python3 scripts/torch_bwd2_ab.py --parent DIR [--rounds 3] [--reps 5]

DIR is a checkout of the tree to compare with (for example the parent
commit unpacked with `git archive` into build/parent). The script:

  1. builds this tree's kernels (gsplat_tpu_torch._backend) and each
     variant of the binned and tiled 2DGS backward with nvcc, one process
     each, all started together, into build/bwd2_ab/<variant>/, and prints
     ptxas's registers and spills and the SHFL count in the SASS of each
     variant's bwd_2dgs instantiations (cuobjdump);
  2. trains Runner2DGS 12 steps on chip_smoke.py's training scene (garden
     scene_grid=5, 1920x1080, tile 16, RGB+ED) and takes view 0's binned
     stream and its tiled stream (isect_tiles) as the inputs: chip_smoke's
     "2DGS train shapes";
  3. holds every variant that computes the rows against the plain version
     by chip_smoke.py's 2DGS backward gates, with the count of slots past
     the per-slot tolerance; checks that DIR's 2DGS forwards and this
     tree's give the same bits (all five outputs), and that the surfel
     sigma, expf and the alpha product give the same bits built with and
     without -fmad=false (and as DIR's surfel.cuh) on 2^24 seeded
     (pixel, entry) pairs of the stream;
  4. times the variants in turns, `--rounds` rounds of `--reps` launches
     each (CUDA events), the order reversed every other round, and prints
     each variant's median.

Variants (`old` = DIR's csrc, `new` = this tree's); the ablations compute
wrong rows and are timed only:
  old            DIR's kernel as it builds there (-fmad=false)
  old-noreduce   DIR's kernel without its warp shuffles and slot writes
                 (each row value kept live by a compare and a store that
                 never happens)
  old-fmad       DIR's kernel built without -fmad=false (its decisions
                 then differ from the forward's: timed only)
  new            this tree's kernel
  new-noreduce   this tree's kernel without warp_transpose_sum and the
                 slot writes
  new-P2         2 pixels a thread (kBwd2Pix)
  new-B32        staging 32 entries a batch (this tree: 64)
  new-r128       held to 128 registers a thread (__launch_bounds__ with
                 512 threads an SM)
  new-vjp-fma    the cross-product VJP and the ray-transform rows' px / py
                 terms contracted to multiply-adds (this tree rounds them
                 op by op)
  new-nofmad     this tree's kernel built with -fmad=false
and the tiled backward as old-tiled, new-tiled and new-tiled-B32.
Lines go to stdout; a JSON summary to build/bwd2_ab/summary.json.
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

OUT = os.path.join(ROOT, "build", "bwd2_ab")

# (source, text, replacement) edits that make the ablations; each text must
# occur exactly once
OLD_NOREDUCE = [
    ("raster.cuh",
     "        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);\n"
     "        if (lane == 0) dst[r] = v;",
     "        if (v == 1.2345e-30f) dst[r] = v;"),
    ("raster.cuh", "for (int i = threadIdx.x; i < nr * nb; i += blockDim.x) {",
     "for (int i = threadIdx.x; i < 0; i += blockDim.x) {"),
]
NEW_NOREDUCE = [
    ("raster.cuh", "        warp_transpose_sum(acc);",
     "        {\n          float s_ = 0.0f;\n#pragma unroll\n          for (int r_ = 1; r_ < R; ++r_) s_ += acc[r_];\n"
     "          acc[0] += s_;\n        }"),
    ("raster.cuh", "for (int i = threadIdx.x; i < nr * nb; i += blockDim.x) {",
     "for (int i = threadIdx.x; i < 0; i += blockDim.x) {"),
]
P2 = [("raster.cuh", "constexpr int kBwd2Pix = 4;", "constexpr int kBwd2Pix = 2;")]
R128 = [("raster.cuh", "__launch_bounds__(TS * TS / P)", "__launch_bounds__(TS * TS / P, 512 / (TS * TS / P))")]
# the cross-product VJP and the ray-transform rows' px / py terms contracted
# to multiply-adds
_VJP_RN = """            const float vc2 = -__fadd_rn(__fmul_rn(s[k].u, v_u), __fmul_rn(s[k].v, v_v)) * rcz;
            const float* hu = s[k].hu;
            const float* hv = s[k].hv;
            const float vhu[3] = {__fsub_rn(__fmul_rn(hv[1], vc2), __fmul_rn(hv[2], vc1)),
                                  __fsub_rn(__fmul_rn(hv[2], vc0), __fmul_rn(hv[0], vc2)),
                                  __fsub_rn(__fmul_rn(hv[0], vc1), __fmul_rn(hv[1], vc0))};
            const float vhv[3] = {__fsub_rn(__fmul_rn(vc1, hu[2]), __fmul_rn(vc2, hu[1])),
                                  __fsub_rn(__fmul_rn(vc2, hu[0]), __fmul_rn(vc0, hu[2])),
                                  __fsub_rn(__fmul_rn(vc0, hu[1]), __fmul_rn(vc1, hu[0]))};"""
_VJP_FMA = """            const float vc2 = -(s[k].u * v_u + s[k].v * v_v) * rcz;
            const float* hu = s[k].hu;
            const float* hv = s[k].hv;
            const float vhu[3] = {hv[1] * vc2 - hv[2] * vc1, hv[2] * vc0 - hv[0] * vc2,
                                  hv[0] * vc1 - hv[1] * vc0};
            const float vhv[3] = {vc1 * hu[2] - vc2 * hu[1], vc2 * hu[0] - vc0 * hu[2],
                                  vc0 * hu[1] - vc1 * hu[0]};"""
VJP_FMA = [
    ("raster.cuh", _VJP_RN, _VJP_FMA),
    ("raster.cuh", "              acc[8 + c] += __fadd_rn(__fmul_rn(px, vhu[c]), __fmul_rn(py, vhv[c]));",
     "              acc[8 + c] += px * vhu[c] + py * vhv[c];"),
]
B32 = [("rasterize_2dgs_bwd.cu", "raster::Streamed<64> st", "raster::Streamed<32> st")]
B32_TILED = [("rasterize_2dgs_tiled_bwd.cu", "raster::Gathered<64> st", "raster::Gathered<32> st")]

PROBE = r"""
#include "surfel.cuh"
__global__ void probe(const float* ent, long long M, const float* pxy, int n, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long j = (long long)pxy[3 * i + 2];
  float m[9];
  for (int k = 0; k < 9; ++k) m[k] = ent[(2 + k) * M + j];
  const SurfelSigma s = surfel_sigma(m, ent[j], ent[M + j], pxy[3 * i], pxy[3 * i + 1]);
  const float eneg = expf(-s.sig);
  out[3 * i] = s.sig;
  out[3 * i + 1] = eneg;
  out[3 * i + 2] = __fmul_rn(ent[11 * M + j], eneg);
}
extern "C" int probe_launch(const void* ent, long long M, const void* pxy, int n, void* out) {
  probe<<<(n + 255) / 256, 256>>>((const float*)ent, M, (const float*)pxy, n, (float*)out);
  return (int)cudaGetLastError();
}
"""


def variants(parent_csrc, csrc):
    """label -> (csrc dir, source, flags, edits, computes the rows)"""
    nofmad = ("-fmad=false",)
    return {
        "old": (parent_csrc, "rasterize_2dgs_bwd", nofmad, [], True),
        "old-noreduce": (parent_csrc, "rasterize_2dgs_bwd", nofmad, OLD_NOREDUCE, False),
        "old-fmad": (parent_csrc, "rasterize_2dgs_bwd", (), [], False),
        "new": (csrc, "rasterize_2dgs_bwd", (), [], True),
        "new-noreduce": (csrc, "rasterize_2dgs_bwd", (), NEW_NOREDUCE, False),
        "new-P2": (csrc, "rasterize_2dgs_bwd", (), P2, True),
        "new-B32": (csrc, "rasterize_2dgs_bwd", (), B32, True),
        "new-r128": (csrc, "rasterize_2dgs_bwd", (), R128, True),
        "new-vjp-fma": (csrc, "rasterize_2dgs_bwd", (), VJP_FMA, True),
        "new-nofmad": (csrc, "rasterize_2dgs_bwd", nofmad, [], True),
        "old-tiled": (parent_csrc, "rasterize_2dgs_tiled_bwd", nofmad, [], True),
        "new-tiled": (csrc, "rasterize_2dgs_tiled_bwd", (), [], True),
        "new-tiled-B32": (csrc, "rasterize_2dgs_tiled_bwd", (), B32_TILED, True),
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


def shfl_counts(so):
    """{kernel: SHFL instructions in its SASS} of the bwd_2dgs
    instantiations in `so` (cuobjdump beside nvcc)."""
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
    return {n: counts[k] for n, k in zip(names, counts) if "bwd_2dgs" in n}


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
    from gsplat_tpu_torch.ops import rasterize_tiled as rt
    from gsplat_tpu_torch.ops.isect import isect_tiles
    from gsplat_tpu_torch.simple_trainer_2dgs import Runner2DGS

    parent_csrc = os.path.join(os.path.abspath(args.parent), "gsplat_tpu_torch", "csrc")
    vs = variants(parent_csrc, _backend.CSRC)
    os.makedirs(OUT, exist_ok=True)
    probe_src = os.path.join(OUT, "probe.cu")
    open(probe_src, "w").write(PROBE)
    probes = {"new -fmad=false": (_backend.CSRC, ("-fmad=false",)), "new": (_backend.CSRC, ()),
              "old -fmad=false": (parent_csrc, ("-fmad=false",))}

    def build_probe(item):
        label, (inc, flags) = item
        out = os.path.join(OUT, "probe-" + label.replace(" ", "").replace("=", "") + ".so")
        cmd = [_backend._nvcc()] + list(_backend._COMMON_FLAGS) + list(flags) + ["-I", inc, "-o", out, probe_src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the probe {label}:\n{proc.stderr}")
        return out

    # the parent's forwards, for the bit check
    fwd_parent = {"rasterize_2dgs_fwd": (parent_csrc, "rasterize_2dgs_fwd", ("-fmad=false",), [], True),
                  "rasterize_2dgs_tiled_fwd": (parent_csrc, "rasterize_2dgs_tiled_fwd", ("-fmad=false",), [], True)}
    with ThreadPoolExecutor(max_workers=len(vs) + len(probes) + len(fwd_parent) + 1) as pool:
        f_all = pool.submit(_backend.build_all)
        f_vs = {k: pool.submit(build_variant, (k, v)) for k, v in vs.items()}
        f_fp = {k: pool.submit(build_variant, ("parent-" + k, v)) for k, v in fwd_parent.items()}
        f_pr = {k: pool.submit(build_probe, (k, v)) for k, v in probes.items()}
        f_all.result()
        built = {k: f.result() for k, f in f_vs.items()}
        fwd_libs = {k: ctypes.CDLL(f.result()[0]) for k, f in f_fp.items()}
        probe_libs = {k: ctypes.CDLL(f.result()) for k, f in f_pr.items()}
    summary = {"card": smi, "variants": {}}
    for label, (so, log) in built.items():
        regs = [r for r in cs.ptxas_report(log) if "bwd_2dgs" in r[0]]
        shfl = shfl_counts(so)
        summary["variants"][label] = {"ptxas": {k: f"{v}; {sp}" for k, v, sp in regs}, "shfl": shfl}
        for k, v, sp in regs:
            cs.log(f"ptxas {label} {k}: {v}; {sp}; SHFL in SASS {shfl.get(k, 'n/a')}")
    libs = {label: ctypes.CDLL(so) for label, (so, _) in built.items()}

    dev = torch.device("cuda")
    scene = cs.train_scene(torch, rasterization, dev)
    runner, _ = cs.train_runner(
        torch, Runner2DGS, scene, "binned", ("emit", "rasterize_2dgs_fwd", "rasterize_2dgs_bwd", "gid_reduce"),
        "2DGS", normal_start=0, dist_start=0,
    )
    W, H, ts = cs.MAIN_W, cs.MAIN_H, runner.cfg.tile_size
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 4)
    view = runner.trainset[0]
    vm = torch.linalg.inv(view["camtoworld"])[None]
    K = view["K"][None]
    with torch.no_grad():
        s = cs.shade_2dgs(rendering, torch, runner.params, runner.live, vm, K, W, H, runner.cfg.sh_degree, "RGB+ED")
        D = s.colors.shape[-1]
        L = D + 3
        plan, slab = cs.emit_plan_2dgs(binning, r2, s, ts, W, H, runner.isect_capacity)
        T = (-(-W // ts)) * (-(-H // ts))
        bk = binning.sort_entries(binning._emit_cuda(plan), plan.packed, plan.nf, T, slab)
        fargs = (bk.entries, bk.offs, bk.cnts, 1, W, H, ts)
        ko = r2._fwd2_cuda(*fargs)
        cot = cs.cotangents_2dgs(torch, gen, ko[1], L)
        bargs = (bk.entries, bk.offs, bk.cnts, ko[1], ko[2], ko[0][..., D - 1].contiguous(), *cot, 1, W, H, ts)
        st = cs.tiled_stream_2dgs(torch, rt, r2, isect_tiles, s, ts, W, H, int(bk.n_isects))
        tfargs = (st[0], L, st[1], st[2], st[3], 1, W, H, ts)
        tko = r2t._tiled2_fwd_cuda(*tfargs)
        targs = (st[0], L, st[1], st[2], st[3], tko[1], tko[2], tko[0][..., D - 1].contiguous(), *cot, 1, W, H, ts)

        # the forwards: this tree's binaries against DIR's, bit for bit
        for name, fn, fa in (("rasterize_2dgs_fwd", r2._fwd2_cuda, fargs),
                             ("rasterize_2dgs_tiled_fwd", r2t._tiled2_fwd_cuda, tfargs)):
            mine = fn(*fa)
            keep = _backend._LIBS[name]
            _backend._LIBS[name] = fwd_libs[name]
            theirs = fn(*fa)
            _backend._LIBS[name] = keep
            same = [bool(torch.equal(a, b)) for a, b in zip(mine, theirs)]
            cs.log(f"{name}: this tree's outputs (features, T, last, distortion, median) equal to DIR's bit "
                   f"for bit: {same}")
            summary[name + "_bits_equal"] = same

        # the decision arithmetic under both flag settings
        n = 1 << 24
        M = bk.entries.shape[1]
        g = torch.Generator(device=dev).manual_seed(cs.SEED + 9)
        j = torch.randint(0, M, (n,), generator=g, device=dev)
        d = (torch.rand((n, 2), generator=g, device=dev) - 0.5) * 40.0
        pxy = torch.stack([torch.floor(bk.entries[0, j] + d[:, 0]) + 0.5,
                           torch.floor(bk.entries[1, j] + d[:, 1]) + 0.5, j.float()], dim=1).contiguous()
        outs = {}
        for label, lib in probe_libs.items():
            fn = lib.probe_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            o = torch.empty((n, 3), device=dev)
            _backend.check_launch(fn(bk.entries.data_ptr(), M, pxy.data_ptr(), n, o.data_ptr()), "probe")
            torch.cuda.synchronize()
            outs[label] = o.view(torch.int32)
        ref = outs["new -fmad=false"]
        for label, o in outs.items():
            diff = int((o != ref).any(dim=1).sum())
            cs.log(f"decision probe ({n} pairs, sigma / expf / alpha bits): {label} differs from "
                   f"'new -fmad=false' at {diff} pairs")
            summary[f"probe {label}"] = diff

        # each variant against the plain version, over the whole frame and
        # on chip_smoke's 256 seeded tiles (where a row's max is smaller)
        sub = cs.tile_subset(torch, bk, cs.TILE_SUBSET, cs.SEED + 1)
        ko_s = r2._fwd2_cuda(sub.entries, sub.offs, sub.cnts, 1, W, H, ts)
        sargs = (sub.entries, sub.offs, sub.cnts, ko_s[1], ko_s[2], ko_s[0][..., D - 1].contiguous(), *cot,
                 1, W, H, ts)
        tsub = (*st[:3], cs.subset_counts(torch, st[3], cs.TILE_SUBSET, cs.SEED + 1))
        tko_s = r2t._tiled2_fwd_cuda(tsub[0], L, tsub[1], tsub[2], tsub[3], 1, W, H, ts)
        tsargs = (tsub[0], L, tsub[1], tsub[2], tsub[3], tko_s[1], tko_s[2], tko_s[0][..., D - 1].contiguous(),
                  *cot, 1, W, H, ts)
        inputs = {False: (bargs, sargs), True: (targs, tsargs)}
        plains = {key: [r2t._tiled2_bwd_plain(*x) if key else r2._bwd2_plain(*x) for x in val]
                  for key, val in inputs.items()}
        for label, (_, source, _, _, rows_ok) in vs.items():
            if not rows_ok:
                continue
            tiled = "tiled" in source
            fn = r2t._tiled2_bwd_cuda if tiled else r2._bwd2_cuda
            keep = _backend._LIBS[source]
            _backend._LIBS[source] = libs[label]
            outs = [fn(*x) for x in inputs[tiled]]
            det = bool(torch.equal(outs[0], fn(*inputs[tiled][0])))
            _backend._LIBS[source] = keep
            for where, rows, (plain, pairs) in zip(("frame", "256 tiles"), outs, plains[tiled]):
                n_past, worst, worst_row = 0, 0.0, -1
                for r in range(plain.shape[0]):
                    diff = (rows[r] - plain[r]).abs()
                    scale = float(plain[r].abs().max())
                    n_past += int((diff > cs.BWD2_RTOL * plain[r].abs() + cs.BWD2_ATOL * scale).sum())
                    if scale > 0 and float(diff.max()) / (cs.BWD2_MAX * scale) > worst:
                        worst, worst_row = float(diff.max()) / (cs.BWD2_MAX * scale), r
                try:
                    cs.gate_bwd2(torch, rows, plain, pairs, f"variant {label} {where}")
                    verdict = "gates hold"
                except AssertionError as e:
                    verdict = f"GATE FAILS ({e})"
                cs.log(f"variant {label} vs plain, {where}: {verdict}; {n_past} of {plain.numel()} values past "
                       f"the per-slot tolerance; largest |diff| / (1e-2 row max) {worst:.3f} (row {worst_row}); "
                       f"two launches equal: {det}")
                summary["variants"][label][where] = dict(verdict=verdict, past_tol=n_past, cap_use=worst,
                                                         cap_row=worst_row, deterministic=det)
        del plains

        # timing in turns
        times = {k: [] for k in vs}
        order = list(vs)
        for rnd in range(args.rounds):
            for label in (order if rnd % 2 == 0 else order[::-1]):
                source = vs[label][1]
                keep = _backend._LIBS[source]
                _backend._LIBS[source] = libs[label]
                if "tiled" in source:
                    ms = cs.cuda_ms(torch, lambda: r2t._tiled2_bwd_cuda(*targs), args.reps)
                else:
                    ms = cs.cuda_ms(torch, lambda: r2._bwd2_cuda(*bargs), args.reps)
                _backend._LIBS[source] = keep
                times[label].append(ms)
    for label, ts_ in times.items():
        med = statistics.median(ts_)
        summary["variants"][label].update(ms=ts_, median_ms=med)
        cs.log(f"time {label}: median {med:.3f} ms over {len(ts_)} rounds of {args.reps} ({', '.join(f'{t:.3f}' for t in ts_)})")
    cs.log(f"card: {smi}")
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
