#!/usr/bin/env python3
"""The port's binning (emit, sort and the payload gather) and its 3DGS
forward kernel against another tree's, on the same inputs on one CUDA card
(gsplat_tpu_torch: csrc/emit.cu, csrc/emit_gather.cu,
csrc/raster.cuh::fwd_3dgs).

    python3 scripts/torch_emit_fwd3_ab.py --parent DIR [--rounds 3] [--reps 5]

DIR is a checkout of the tree to compare with, one whose emit kernel still
writes the payload rows (for example the parent commit unpacked with `git
archive` into build/parent). The script:

  1. builds this tree's kernels (gsplat_tpu_torch._backend), DIR's emit and
     3DGS forwards, and each forward variant below with nvcc, one process
     each, all started together, into build/emit_fwd3_ab/<variant>/, and
     prints ptxas's registers and spills of each variant's fwd_3dgs
     instantiations and the SASS instructions of the compositing loop
     (cuobjdump) of the one the inputs launch (D = 3, tile 16), per (pixel,
     entry) pair;
  2. trains Runner and Runner2DGS 12 steps each on chip_smoke.py's training
     scene (garden scene_grid=5, 1920x1080, tile 16) and takes view 0 of
     each: chip_smoke's "train shapes" and "2DGS train shapes"; and camera
     0 of chip_smoke's 3DGS serving frame (phase 4) and of both 2DGS
     serving scenes (phase 7: the fixture's splats as surfels, and the
     trained surfels);
  3. binning, on each input: DIR's path (its emit kernel writing keys, gids
     and the payload rows [NF, M], then its sort_entries: one stable key
     sort, the rows permuted, the tail zeroed) against this tree's (emit of
     keys and gids, the same sort, the gather kernel): every field of the
     `Binned` (entries, gids, offs, cnts, n_isects, dst, seg_starts) must
     be equal bit for bit; the peak device memory of each path; then each
     part timed in turns (the payload's packing, emit, the sort, the gather
     alone and index_select with its transpose, one PyTorch call for the
     gather's rows);
  4. the 3DGS forward, on the binned and the tiled (isect_tiles) streams of
     the 3DGS inputs: every variant's image (before any background), T_final
     and last must equal DIR's kernel's bit for bit, and this tree's kernel
     is held to the plain version by chip_smoke.py's forward gates on 256
     seeded tiles; then the variants timed in turns, each median beside
     the thread-instruction issue slots per evaluated pair that its time
     allowed (132 SMs x 128 lanes a cycle at the SM clock sampled by
     nvidia-smi meanwhile; the evaluated pairs from the plain version).

Timing: `--rounds` rounds of `--reps` launches each (CUDA events), the
order reversed every other round. Forward variants (`old` = DIR's csrc,
`new` = this tree's), all computing DIR's bits:
  old, old-tiled          DIR's binned / tiled 3DGS forward (one pixel a
                          thread, every entry evaluated, scalar shared loads
                          at stride B on the binned stream)
  new, new-tiled          this tree's
  new-P1, -P2, -P4        1, 2 or 4 pixels of a column a thread (kFwd3Pix;
                          this tree: 1), also as new-tiled-P1, -P2, -P4
  new-noskip,             every warp evaluates every entry (the reach bits
  new-tiled-noskip        are still computed)
  new-noreach,            every warp evaluates every entry, no reach bits
  new-tiled-noreach       computed
  new-scalar,             the staged rows read one value a shared load
  new-tiled-scalar        (volatile) instead of as float4
  new-B128, -B512         128- or 512-entry batches (this tree: 256), also
                          as new-tiled-B128, -B512
  new-occ<n>,             __launch_bounds__ asking for n threads an SM
  new-tiled-occ<n>        (65536 / n registers a thread)
  tiled-on-binned         this tree's tiled forward over the *binned*
                          stream: the plan's packed rows, ids = the sorted
                          gids, the binned offs and cnts (what a binned
                          backend that never writes `entries` would pay;
                          not shipped)
Lines go to stdout; a JSON summary to build/emit_fwd3_ab/summary.json.
"""

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from torch_fwd2_ab import Clocks  # noqa: E402  (this script's directory)

OUT = os.path.join(ROOT, "build", "emit_fwd3_ab")


def pixels(p):
    return [("raster.cuh", "constexpr int kFwd3Pix = 1;", f"constexpr int kFwd3Pix = {p};")]


def occupancy(threads_an_sm):
    """__launch_bounds__ asking for blocks enough to hold `threads_an_sm`
    threads an SM (65536 / threads_an_sm registers a thread at most)"""
    return [("raster.cuh", "__launch_bounds__(TS * TS / P)\nfwd_3dgs(",
             f"__launch_bounds__(TS * TS / P, {threads_an_sm} / (TS * TS / P))\nfwd_3dgs(")]


def batch(source, stage, b):
    return [(source + ".cu", f"raster::{stage}<256> st", f"raster::{stage}<{b}> st")]


# every warp walks every entry: the reach bits computed, the ballots all set
NOSKIP = [("raster.cuh", "__ballot_sync(0xffffffffu, (m >> w) & 1u);", "__ballot_sync(0xffffffffu, j < nb);")]
# no reach computed at all: every bit set
NOREACH = [("raster.cuh", "const unsigned m = j < nb ? warp_reach<TS, NW, 1>(sm + j * rs, th, tw) : 0u;",
            "const unsigned m = j < nb ? ~0u : 0u;")]
# the staged rows read one value a load (volatile stops the compiler from
# merging neighbouring floats into vector loads)
SCALAR = [("raster.cuh",
           "__device__ __forceinline__ float4 row4(const float* e, int q) {\n"
           "  return reinterpret_cast<const float4*>(e)[q];\n}",
           "__device__ __forceinline__ float4 row4(const float* e, int q) {\n"
           "  const volatile float* v = e + 4 * q;\n"
           "  return make_float4(v[0], v[1], v[2], v[3]);\n}")]

# DIR's emit: keys, gids and the payload rows [NF, M] (its C entry point)
OLD_EMIT_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2
                 + [ctypes.c_void_p] * 4)
# DIR's binned forward took a background pointer (null here)
OLD_FWD_ARGS = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                + [ctypes.c_void_p] * 5)
NEW_FWD_ARGS = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                + [ctypes.c_void_p] * 4)
TILED_FWD_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_void_p] * 2
                  + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4)


def variants(parent_csrc, csrc):
    """label -> (csrc dir, source, edits)"""
    b, t = "rasterize_fwd", "rasterize_tiled_fwd"
    out = {"old": (parent_csrc, b, []), "old-tiled": (parent_csrc, t, []),
           "old-emit": (parent_csrc, "emit", [])}
    for pre, src, stage in (("new", b, "Streamed"), ("new-tiled", t, "Gathered")):
        out.update({
            pre: (csrc, src, []),
            pre + "-P1": (csrc, src, pixels(1)),
            pre + "-P2": (csrc, src, pixels(2)),
            pre + "-P4": (csrc, src, pixels(4)),
            pre + "-noskip": (csrc, src, NOSKIP),
            pre + "-noreach": (csrc, src, NOREACH),
            pre + "-scalar": (csrc, src, SCALAR),
            pre + "-B128": (csrc, src, batch(src, stage, 128)),
            pre + "-B512": (csrc, src, batch(src, stage, 512)),
        })
        for occ in (1536, 2048):
            out[f"{pre}-occ{occ}"] = (csrc, src, occupancy(occ))
    return out


def build_variant(args):
    """Copy `csrc`, apply the edits, nvcc `source` with its flags in this
    tree's _backend. Returns (.so path, ptxas log)."""
    from gsplat_tpu_torch import _backend

    label, (csrc, source, edits) = args
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
    cmd = [_backend._nvcc()] + list(_backend._COMMON_FLAGS) + list(_backend.KERNELS[source]) + [
        "-o", out, os.path.join(work, source + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {label}:\n{proc.stderr}")
    return out, proc.stderr


def cfn(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    smi = cs.phase_device()
    import torch
    from gsplat_tpu_torch import _backend, rasterization, rendering, splats_from_numpy
    from gsplat_tpu_torch.ops import binning, rasterize_2dgs_binned as r2, rasterize_binned as rb
    from gsplat_tpu_torch.ops import rasterize_tiled as rt
    from gsplat_tpu_torch.ops.isect import isect_tiles
    from gsplat_tpu_torch.simple_trainer import Runner
    from gsplat_tpu_torch.simple_trainer_2dgs import Runner2DGS

    parent_csrc = os.path.join(os.path.abspath(args.parent), "gsplat_tpu_torch", "csrc")
    vs = variants(parent_csrc, _backend.CSRC)
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(vs) + 1) as pool:
        f_all = pool.submit(_backend.build_all)
        f_vs = {k: pool.submit(build_variant, (k, v)) for k, v in vs.items()}
        f_all.result()
        built = {k: f.result() for k, f in f_vs.items()}
    summary = {"card": smi, "variants": {}, "inputs": {}}
    for label, (so, log) in built.items():
        if label == "old-emit":
            continue
        regs = [r for r in cs.ptxas_report(log) if "fwd_3dgs" in r[0]]
        if label.startswith("old"):
            # DIR's one-pixel-a-thread kernel: fwd_3dgs<Stage, DMAX>
            loops = cs.sass_loops(so, "fwd_3dgs")
            kernel = next((k for k in loops if ", 4>" in k), None)
            n, P = loops.get(kernel), 1
            per_pair = n
        else:
            kernel, n, P, per_pair = cs.fwd3_sass_per_pair(so, 3, cs.MAIN_TILE)
        summary["variants"][label] = {"ptxas": {k: f"{v}; {sp}" for k, v, sp in regs},
                                      "sass": {"kernel": kernel, "loop": n, "P": P, "per_pair": per_pair}}
        for k, v, sp in regs:
            cs.log(f"ptxas {label} {k}: {v}; {sp}")
        cs.log(f"SASS {label} {kernel}: {n} instructions in the compositing loop for {P} pixels, "
               f"{per_pair if per_pair is None else round(per_pair, 1)} a pair")
    libs = {label: ctypes.CDLL(so) for label, (so, _) in built.items()}
    old_emit = cfn(libs["old-emit"], "emit_launch", OLD_EMIT_ARGS)

    dev = torch.device("cuda")
    W, H, ts = cs.MAIN_W, cs.MAIN_H, cs.MAIN_TILE
    T = (-(-W // ts)) * (-(-H // ts))
    scene = cs.train_scene(torch, rasterization, dev)
    runner3, _ = cs.train_runner(
        torch, Runner, scene, "binned", ("emit", "emit_gather", "rasterize_fwd", "rasterize_bwd", "gid_reduce"),
        "3DGS")
    runner2, _ = cs.train_runner(
        torch, Runner2DGS, scene, "binned",
        ("emit", "emit_gather", "rasterize_2dgs_fwd", "rasterize_2dgs_bwd", "gid_reduce"),
        "2DGS", normal_start=0, dist_start=0)
    arrays, viewmats, Ks, W0, _ = cs.splat_arrays(cs.MAIN_GRID, 3, cs.SEED)
    Ks = Ks.copy()
    Ks[:, :2, :] *= W / W0
    vm0, K0 = torch.as_tensor(viewmats[:1], device=dev), torch.as_tensor(Ks[:1], device=dev)
    fixture = splats_from_numpy(arrays, device=dev)

    def view0(runner):
        v = runner.trainset[0]
        return torch.linalg.inv(v["camtoworld"])[None], v["K"][None]

    # name -> (3DGS?, view, K, (splats, live), capacity or None: probed)
    cams = {
        "3DGS train view 0": (True, *view0(runner3), (runner3.params, runner3.live), runner3.isect_capacity),
        "3DGS serving camera 0": (True, vm0, K0, fixture, None),
        "2DGS train view 0": (False, *view0(runner2), (runner2.params, runner2.live), runner2.isect_capacity),
        "2DGS serving, fixture surfels": (False, vm0, K0, fixture, None),
        "2DGS serving, trained surfels": (False, vm0, K0, (runner2.params, runner2.live), None),
    }

    def old_emit_sort(plan, slab, rows_old):
        """DIR's emit kernel and sort_entries (its code, as it was): the
        payload rows written per entry and permuted by the sort."""
        CN = plan.counts.shape[0]
        NF, M = rows_old.shape[0], plan.n_emit
        keys = torch.empty(M, dtype=torch.int64, device=dev)
        gids = torch.empty(M, dtype=torch.int32, device=dev)
        feats = torch.empty((NF, M), dtype=torch.float32, device=dev)
        if M:
            woff = plan.starts[:-1].contiguous()
            code = old_emit(plan.tminx.data_ptr(), plan.tminy.data_ptr(), plan.rw.data_ptr(),
                            plan.counts.data_ptr(), woff.data_ptr(), plan.depth.data_ptr(), rows_old.data_ptr(),
                            CN, plan.N, NF, plan.n_tiles, plan.tile_width, plan.tile_size, int(plan.cull), M,
                            plan.sentinel, keys.data_ptr(), gids.data_ptr(), feats.data_ptr(), _backend.stream(dev))
            _backend.check_launch(code, "old emit")
        return keys, gids, feats

    def old_sort(ops, starts):
        keys, gids, feats = ops
        keys_s, perm = torch.sort(keys, stable=True)
        gids_s = gids[perm]
        entries = feats[:, perm]
        bounds = torch.searchsorted(
            keys_s, torch.arange(T + 1, device=keys.device, dtype=torch.int64) << 32).to(torch.int32)
        n_isects = bounds[-1].to(torch.int64)
        pos = torch.arange(keys.shape[0], device=keys.device)
        entries = torch.where(pos[None, :] < n_isects, entries, 0.0)
        return binning.Binned(entries=entries, gids=gids_s, offs=bounds[:-1], cnts=bounds[1:] - bounds[:-1],
                              n_isects=n_isects, slab_required=0, dst=perm, seg_starts=starts)

    def binning_parts(plan, slab, fin, rows_old, starts, bn):
        """{part: a call timing it} of DIR's and this tree's binning on one plan."""
        ops_old = old_emit_sort(plan, slab, rows_old)
        keys, gids = ops_old[:2]
        gargs, ids = cs.gather_args(torch, plan, bn)
        return {
            "payload DIR (stack)": lambda: torch.stack(fin).to(torch.float32).contiguous(),
            "payload new (pack_rows)": lambda: binning.pack_rows(fin),
            "emit DIR": lambda: old_emit_sort(plan, slab, rows_old),
            "emit new": lambda: binning._emit_cuda(plan),
            "sort DIR": lambda: old_sort(ops_old, starts),
            "emit+sort DIR": lambda: old_sort(old_emit_sort(plan, slab, rows_old), starts),
            "sort new (sort, searchsorted, gather)": lambda: binning.sort_entries(
                (keys, gids), plan.packed, plan.nf, T, slab, starts),
            "emit+sort new": lambda: binning.sort_entries(binning._emit_cuda(plan), plan.packed, plan.nf, T, slab,
                                                          starts),
            "gather new": lambda: binning._gather_cuda(*gargs),
            "index_select + transpose": lambda: torch.index_select(plan.packed, 0, ids)[:, :plan.nf].t().contiguous(),
        }

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    bin_times, fwd_inputs = {}, {}
    with torch.no_grad():
        for name, (is3, vm, K, (splats, live), cap) in cams.items():
            if is3:
                s = cs.shade(rendering, torch, splats, live, vm, K, W, H, 3)
                mk = lambda c, s=s: cs.emit_plan(binning, s, ts, W, H, c)  # noqa: E731
                rows = [s.mean_x, s.mean_y, *s.conics, s.opacities, *s.colors.unbind(-1)]
            else:
                s = cs.shade_2dgs(rendering, torch, splats, live, vm, K, W, H, 3, "RGB+ED")
                mk = lambda c, s=s: cs.emit_plan_2dgs(binning, r2, s, ts, W, H, c)  # noqa: E731
                mx, my = s.means2d[..., 0], s.means2d[..., 1]
                rows = r2.surfel_payload(mx, my, s.ray_transforms.reshape(s.ray_transforms.shape[:2] + (9,)),
                                         s.opacities, s.colors, s.normals)
            if cap is None:
                cap = mk(512)[1] + 1024
            plan, slab = mk(cap)
            fin = [binning._fin(r).reshape(-1) for r in rows]
            rows_old = torch.stack(fin).to(torch.float32).contiguous()  # DIR's [NF, CN] payload
            starts = binning.segment_starts(plan)
            bo, mem_old = peak(lambda: old_sort(old_emit_sort(plan, slab, rows_old), starts))
            bn, mem_new = peak(lambda: binning.sort_entries(binning._emit_cuda(plan), plan.packed, plan.nf, T, slab,
                                                            starts))
            same = {f: bool(torch.equal(getattr(bo, f), getattr(bn, f)))
                    for f in ("entries", "gids", "offs", "cnts", "n_isects", "dst", "seg_starts")}
            info = {"entries_emitted": plan.n_emit, "n_isects": int(bn.n_isects), "nf": plan.nf,
                    "binned_bits_equal": same, "peak_bytes_old": mem_old, "peak_bytes_new": mem_new}
            cs.log(f"{name}: {plan.n_emit} entries emitted, {int(bn.n_isects)} kept, {plan.nf} rows; Binned fields "
                   f"equal to DIR's bit for bit: {same}; binning's peak device memory above its inputs: DIR "
                   f"{mem_old} bytes, this tree {mem_new}")
            if not all(same.values()):
                raise AssertionError(f"{name}: the Binned differs from DIR's: {same}")
            del bo
            parts = binning_parts(plan, slab, fin, rows_old, starts, bn)
            bin_times[name] = (parts, {k: [] for k in parts})
            summary["inputs"][name] = info
            if is3:
                st = cs.tiled_stream(torch, rt, isect_tiles, s, ts, W, H, max(cap, 16 * plan.counts.shape[0]))
                fwd_inputs[name + ", binned"] = ("binned", (bn.entries, bn.offs, bn.cnts))
                fwd_inputs[name + ", tiled"] = ("tiled", (st[0], st[1], st[2], st[3]))
                fwd_inputs[name + ", binned via the tiled kernel"] = ("tiled-on-binned",
                                                                     (plan.packed, bn.gids, bn.offs, bn.cnts))
            del bn
        del runner2

        def fwd(label, kind, fa):
            """DIR's or this tree's forward `label` on one input: (image, T, last)."""
            img = torch.empty((1, H, W, 3), dtype=torch.float32, device=dev)
            T_out = torch.empty((1, H, W), dtype=torch.float32, device=dev)
            last = torch.empty((1, H, W), dtype=torch.int32, device=dev)
            th, tw = -(-H // ts), -(-W // ts)
            tail = [1, th, tw, ts, W, H, 3]
            outs = [img.data_ptr(), T_out.data_ptr(), last.data_ptr(), _backend.stream(dev)]
            if kind == "binned":
                e, offs, cnts = fa
                head = [e.data_ptr(), e.shape[1], offs.data_ptr(), cnts.data_ptr()]
                if label == "old":
                    code = cfn(libs[label], "rasterize_fwd_launch", OLD_FWD_ARGS)(*head, *tail, None, *outs)
                else:
                    code = cfn(libs[label], "rasterize_fwd_launch", NEW_FWD_ARGS)(*head, *tail, *outs)
            else:
                packed, ids, offs, cnts = fa
                code = cfn(libs[label], "rasterize_tiled_fwd_launch", TILED_FWD_ARGS)(
                    packed.data_ptr(), packed.shape[1], ids.data_ptr(), offs.data_ptr(), cnts.data_ptr(),
                    *tail, *outs)
            _backend.check_launch(code, label)
            return img, T_out, last

        fwd_labels = {
            "binned": [k for k, v in vs.items() if v[1] == "rasterize_fwd"],
            "tiled": [k for k, v in vs.items() if v[1] == "rasterize_tiled_fwd"],
            "tiled-on-binned": ["new-tiled"],
        }
        fwd_times = {}
        for name, (kind, fa) in fwd_inputs.items():
            # the tiled kernel over the binned stream is held to DIR's binned forward
            ref_kind, ref_fa = (fwd_inputs[name.replace(" via the tiled kernel", "")] if kind == "tiled-on-binned"
                                else (kind, fa))
            ref_label = "old-tiled" if ref_kind == "tiled" else "old"
            ref = fwd(ref_label, ref_kind, ref_fa)
            if kind == "tiled":
                plain_args = (fa[0], 3, fa[1], fa[2], fa[3], 1, W, H, ts)
                plain = rt._tiled_fwd_plain(*plain_args)
                sub = (fa[0], 3, fa[1], fa[2], cs.subset_counts(torch, fa[3], cs.TILE_SUBSET, cs.SEED), 1, W, H, ts)
                ko, po = rt._tiled_fwd_cuda(*sub), rt._tiled_fwd_plain(*sub)
            elif kind == "binned":
                plain = rb._fwd_plain(*fa, 1, W, H, ts)
                sub = (fa[0], fa[1], cs.subset_counts(torch, fa[2], cs.TILE_SUBSET, cs.SEED), 1, W, H, ts)
                ko, po = rb._fwd_cuda(*sub), rb._fwd_plain(*sub)
            else:
                plain = None
            info = {"bits_equal_to_old": {}}
            if plain is not None:
                pairs = int(plain[3])
                mx, mean, same_last, n_off, _, _ = cs.gate_fwd(torch, ko, po[:3], po[3])
                info.update(evaluated_pairs=pairs, pairs_a_pixel=pairs / (W * H),
                            plain_gates=dict(max_abs=mx, mean_abs=mean, last_equal=same_last))
                cs.log(f"{name}: {pairs} evaluated pairs ({pairs / (W * H):.1f} a pixel); new vs plain on "
                       f"{cs.TILE_SUBSET} seeded tiles max abs {mx:.3e} mean abs {mean:.3e}, last equal at "
                       f"{same_last:.6f}")
                del plain
            for label in fwd_labels[kind]:
                if label.startswith("old"):
                    continue
                same = [bool(torch.equal(a, b)) for a, b in zip(fwd(label, kind, fa), ref)]
                info["bits_equal_to_old"][label] = same
                cs.log(f"{name}: {label} (image, T, last) equal to {ref_label}'s bit for bit: {same}")
                if not all(same):
                    raise AssertionError(f"{name}: {label} does not give DIR's bits: {same}")
            summary["inputs"][name] = info
            fwd_times[name] = {k: [] for k in fwd_labels[kind]}

        with Clocks() as clk:
            for rnd in range(args.rounds):
                for name, (parts, times) in bin_times.items():
                    order = list(parts)
                    for label in (order if rnd % 2 == 0 else order[::-1]):
                        times[label].append(cs.cuda_ms(torch, parts[label], args.reps))
                for name, (kind, fa) in fwd_inputs.items():
                    order = list(fwd_times[name])
                    for label in (order if rnd % 2 == 0 else order[::-1]):
                        fwd_times[name][label].append(cs.cuda_ms(torch, lambda: fwd(label, kind, fa), args.reps))
    busy = [m for m in clk.mhz if m > 0] or [0.0]
    mhz = statistics.median(busy)
    cs.log(f"SM clock during the timed rounds: median {mhz:.0f} MHz over {len(busy)} samples "
           f"({min(busy):.0f}-{max(busy):.0f}); power draw median "
           f"{statistics.median(clk.watts) if clk.watts else float('nan'):.1f} W")
    summary["sm_mhz"] = mhz
    for name, (_, times) in bin_times.items():
        summary["inputs"][name]["ms"] = {}
        for label, ts_ in times.items():
            med = statistics.median(ts_)
            summary["inputs"][name]["ms"][label] = dict(ms=ts_, median_ms=med)
            cs.log(f"time {name}, {label}: median {med:.3f} ms over {len(ts_)} rounds of {args.reps} "
                   f"({', '.join(f'{t:.3f}' for t in ts_)})")
    for name, per in fwd_times.items():
        info = summary["inputs"][name]
        pairs = info.get("evaluated_pairs") or summary["inputs"][name.replace(" via the tiled kernel", "")].get(
            "evaluated_pairs", 1)
        info["ms"] = {}
        for label, ts_ in per.items():
            med = statistics.median(ts_)
            slots = med * 1e-3 * 132 * 128 * mhz * 1e6 / max(pairs, 1)
            info["ms"][label] = dict(ms=ts_, median_ms=med, slots_per_pair=slots)
            sass = summary["variants"][label]["sass"]["per_pair"]
            cs.log(f"time {name}, {label}: median {med:.3f} ms over {len(ts_)} rounds of {args.reps} "
                   f"({', '.join(f'{t:.3f}' for t in ts_)}); {slots:.1f} issue slots an evaluated pair, SASS "
                   f"{sass if sass is None else round(sass, 1)} a pair")
    cs.log(f"card: {smi}")
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
