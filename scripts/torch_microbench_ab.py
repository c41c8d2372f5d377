#!/usr/bin/env python3
"""The slice micro-benchmarks of csrc/mb_slice_shapes.cu (the six
`slice_*` variants, kernel_shapes.py), csrc/mb_fwd_breakdown.cu (the
four `fwd_breakdown_L*` levels, fwd_breakdown.py) and the inner math of
csrc/mb_inner_math.cu (`inner_math_f32`, `inner_math_bf16`,
primitives.py) against another tree's, on the same inputs on one CUDA
card.

    python3 scripts/torch_microbench_ab.py --parent DIR [--rounds 7] [--reps 10] [--check-only]
        [--only SOURCE ...]

DIR is a checkout of the tree to compare with (for example the parent
commit unpacked with `git archive` into build/parent). Each tree's C entry
points `slice_shapes_launch`, `fwd_breakdown_launch` and
`inner_math_launch` are bound by the parameter list in its own source
(`torch_calib_ab.c_params`); a parameter the script does not know (see
`value`) stops it before any launch. The script:

  1. builds DIR's three sources and this tree's with nvcc (this tree's
     flags, all six started together) into build/microbench_ab/{old,new}/
     and prints ptxas's registers, shared memory and spills of each kernel,
     and each inner-math kernel's SASS a term by kind
     (`chip_smoke.sass_mix`);
  2. holds both trees' kernels to the plain versions
     (`kernel_shapes.slice_shapes_plain` at SMALL, EDGE and the script's
     size, by `kernel_shapes.TOL` of each row's largest |value|;
     `fwd_breakdown.fwd_breakdown_plain` on garden grid1 at 648x420, every
     tile, and on the 1080p stream's seeded and edge tiles, by
     `fwd_breakdown.TOL` and `gate_scale`; `primitives.inner_math_plain`
     at SMALL, `INNER_EDGES` and the script's size, f32 by `TOL` of each
     value and bf16 by its gate with `BF16_OF_LARGEST`, which must reject
     the f32 kernel's output), and two launches to the same
     bits, each tree where its entry takes the shape (a refusal is printed:
     the first version's lane variants took P a multiple of 128);
  3. times every variant and level at the script's sizes in `--rounds`
     rounds, the order reversed every other round, each in
     `microbench.split_ms`'s three forms (one call between two events, the
     host's us a call, the card's ms a launch of `--reps` back-to-back
     launches), sampling the SM clock and power meanwhile; prints each
     median beside its bound (the modules' `measure` counts).

With --check-only it stops after step 2; --only builds, checks and times
only the sources named (e.g. mb_inner_math). The card's name and power limit
head the output; a JSON summary goes to build/microbench_ab/summary.json.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from torch_calib_ab import c_params  # noqa: E402  (this script's directory)
from torch_fwd2_ab import Clocks  # noqa: E402

OUT = os.path.join(ROOT, "build", "microbench_ab")
SOURCES = {"mb_slice_shapes": "slice_shapes_launch", "mb_fwd_breakdown": "fwd_breakdown_launch",
           "mb_inner_math": "inner_math_launch"}
SHORT = {"mb_slice_shapes": "slice", "mb_fwd_breakdown": "breakdown", "mb_inner_math": "inner"}


def build(label, name, csrc):
    """nvcc a copy of `csrc`'s `name`.cu with this tree's flags. Returns
    (.so path, ptxas log, source text)."""
    from gsplat_tpu_torch import _backend

    work = os.path.join(OUT, label, name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    src = os.path.join(work, f"{name}.cu")
    shutil.copy(os.path.join(csrc, f"{name}.cu"), src)
    so = os.path.join(work, f"{name}.so")
    cmd = [_backend._nvcc()] + list(_backend._COMMON_FLAGS) + list(_backend.KERNELS[name]) + ["-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {label} {name}:\n{proc.stderr}")
    return so, proc.stderr, open(src).read()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--only", nargs="+", choices=sorted(SOURCES), default=sorted(SOURCES))
    args = ap.parse_args()

    smi = cs.phase_device()
    import torch
    from gsplat_tpu_torch import _backend
    from gsplat_tpu_torch.microbench import bound_ms, compare, rejects, split_ms
    from gsplat_tpu_torch.microbench import fwd_breakdown as fb
    from gsplat_tpu_torch.microbench import kernel_shapes as ks
    from gsplat_tpu_torch.microbench import primitives as pm

    trees = {"old": os.path.join(os.path.abspath(args.parent), "gsplat_tpu_torch", "csrc"), "new": _backend.CSRC}
    os.makedirs(OUT, exist_ok=True)
    jobs = [(label, name, csrc) for label, csrc in trees.items() for name in SOURCES if name in args.only]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = dict(zip([(label, name) for label, name, _ in jobs], pool.map(lambda j: build(*j), jobs)))
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = _backend.stream(dev)
    summary = {"card": smi, "builds": {}, "sass": {}, "checks": {}, "times": {}}

    entries = {}  # "old slice" ... -> (C function, its parameter names)
    for (label, name), (so, log, src) in built.items():
        lib = ctypes.CDLL(so)
        symbol = SOURCES[name]
        params = c_params(src, symbol)
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = [t for t, _ in params], ctypes.c_int
        entries[f"{label} {SHORT[name]}"] = (fn, [n for _, n in params])
        cs.log(f"{label} {symbol}({', '.join(n for _, n in params)})")
        regs = {k: f"{r}; {sp}" for k, r, sp in cs.ptxas_report(log)}
        summary["builds"][f"{label} {name}"] = regs
        for k, v in regs.items():
            cs.log(f"ptxas {label} {name} {k}: {v}")
        if name == "mb_inner_math":
            for k, mix in cs.sass_mix(so, "inner_").items():
                summary["sass"][f"{label} {k}"] = mix
                cs.log(f"SASS {label} {k}, the pixel loop's instructions a term: {mix}")

    def value(name, known):
        if name not in known:
            raise SystemExit(f"the script does not know the C parameter {name!r}")
        got = known[name]
        return got.data_ptr() if torch.is_tensor(got) else got

    def slice_call(label, variant, x, P, NB, T):
        """(call returning the CUDA error, output, what the call holds) of a
        tree's slice kernel with its arguments made beforehand."""
        fn, names = entries[f"{label} slice"]
        out = torch.empty((T, 8, ks.LANES), device=dev)
        sink = torch.empty(1, device=dev)
        ts = int(round(P ** 0.5))
        cluster = ks.slice_plan(variant, P, T, _backend.sm_count(dev.index)).cluster
        known = {"variant": ks.VARIANTS.index(variant), "x": x, "K": x.shape[1], "P": P, "ts": ts, "NB": NB, "T": T,
                 "keep_sink": 0, "cluster": cluster, "out": out, "sink": sink, "stream": stream}
        argv = [value(n, known) for n in names]
        return (lambda: fn(*argv)), out, (sink, x)

    def breakdown_call(label, level, s, plan):
        fn, names = entries[f"{label} breakdown"]
        e, offs, cnts, tw, th = s
        T, P = offs.shape[0], 32 * 32
        out = torch.empty((T, 8, P), device=dev)
        partial = torch.empty(max(plan.slots, 1) * (8 * P if level == 3 else 1), device=dev)
        known = {"level": level, "entries": e, "M": e.shape[1], "NF": e.shape[0], "offs": offs, "cnts": cnts, "T": T,
                 "tw": tw, "th": th, "ts": 32, "items": plan.items, "n_items": plan.items.shape[0],
                 "finish": plan.finish, "n_finish": plan.finish.shape[0], "partial": partial, "out": out,
                 "stream": stream}
        argv = [value(n, known) for n in names]
        return (lambda: fn(*argv)), out, (partial, plan, s)

    def inner_call(label, e, P, bf16):
        fn, names = entries[f"{label} inner"]
        NB, R, K = e.shape
        out = torch.empty((NB, 1, K), device=dev)
        known = {"e": e, "NB": NB, "R": R, "K": K, "P": P, "bf16": int(bf16), "zero": 0.0, "out": out,
                 "stream": stream}
        argv = [value(n, known) for n in names]
        return (lambda: fn(*argv)), out, e

    def held(tag, call, out, want, tol, scale, rows=None):
        """Two launches to the same bits and `compare` of the output (its
        `rows`) against plain; None where the entry refuses the shape."""
        code = call()
        if code != 0:
            cs.log(f"{tag}: refused (CUDA error {code})")
            summary["checks"][tag] = f"refused ({code})"
            return None
        first = out.clone()
        _backend.check_launch(call(), tag)
        torch.cuda.synchronize()
        if not torch.equal(first, out):
            raise AssertionError(f"{tag}: two launches differ at {int((first != out).sum())} values")
        err = compare(tag, out if rows is None else out[rows], want, tol, scale)
        summary["checks"][tag] = err
        cs.log(f"{tag}: the same bits twice, max abs {err:.3e} against plain")
        return err

    # 2. every kernel against plain, and two launches to the same bits
    streams = {}
    if "mb_slice_shapes" in args.only:
        for sz_name, sz in (("SMALL", ks.SMALL), ("EDGE", ks.EDGE), ("the script's size", ks.DEFAULTS)):
            x, P, NB, T = ks._x(sz["k"]), sz["ts"] ** 2, sz["nb"], sz["tiles"]
            for v in ks.VARIANTS:
                want = ks.slice_shapes_plain(v, x, P, NB, T)
                for label in trees:
                    call, out, _ = slice_call(label, v, x, P, NB, T)
                    held(f"{label} slice_{v} at {sz_name}", call, out, want, ks.TOL, ks.row_scale(want))
    if "mb_fwd_breakdown" in args.only:
        for where, args_ in (("grid1 648x420", (1, 648, 420, 32)), ("1080p", fb.PRODUCTION)):
            e, offs, cnts, tw, th, _, _ = fb.stream(*args_)
            if where == "1080p":
                g = torch.Generator().manual_seed(0)
                seeded = torch.randperm(offs.shape[0], generator=g)[:fb.TILE_SUBSET]
                tiles = torch.unique(torch.cat([seeded, fb.edge_tiles(offs, cnts)])).to(dev)
            else:
                tiles = torch.arange(offs.shape[0], device=dev)
            s = (e, offs, cnts, tw, th)
            streams[where] = s
            for level in range(4):
                plan = fb.breakdown_plan(level, offs, cnts, e.shape[1])
                want = fb.fwd_breakdown_plain(level, e, offs, cnts, tw, th, 32, tiles=tiles)
                scale = fb.gate_scale(level, want, e, offs, cnts, tw, th, 32, tiles)
                for label in trees:
                    call, out, _ = breakdown_call(label, level, s, plan)
                    held(f"{label} fwd_breakdown_L{level} at {where}", call, out, want, fb.TOL[level], scale, tiles)
    g = torch.Generator(device="cuda").manual_seed(9)
    if "mb_inner_math" in args.only:
        edges = [(f"edge P {s[0]}, K {s[1]}, NB {s[2]}", s) for s in pm.INNER_EDGES]
        inner_shapes = [("SMALL", pm.SMALL["e5"])] + edges + [("the script's size", pm.SIZES["e5"])]
        for where, (P, K, NB) in inner_shapes:
            e = pm.e5_input(NB, K, lambda *sh: torch.rand(*sh, device="cuda", generator=g))
            want32 = pm.inner_math_plain(e, P)
            want16 = pm.inner_math_plain(e, P, torch.bfloat16)
            scale16 = pm.bf16_scale(want16)
            for label in trees:
                for kernel, bf16, want, scale in (("inner_math_f32", False, want32, want32.abs()),
                                                  ("inner_math_bf16", True, want16, scale16)):
                    tag = f"{label} {kernel} at {where}"
                    call, out, _ = inner_call(label, e, P, bf16)
                    if held(tag, call, out, want, pm.TOL[kernel], scale) is None:
                        continue
                    # the worst value's error over its gate (1: at the gate)
                    share = float(((out - want).abs() / (pm.TOL[kernel] * scale)).nan_to_num(0.0).max())
                    summary["checks"][f"{tag}, share of the gate"] = share
                    cs.log(f"{tag}: at worst {share:.4f} of the gate")
                    if not bf16 and where == "the script's size":
                        summary["checks"][f"{label} rejects inner_math_f32's output at the bf16 gate"] = rejects(
                            "inner_math_bf16's gate", out, want16, pm.TOL["inner_math_bf16"], scale16)
    if args.check_only:
        with open(os.path.join(OUT, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return

    # 3. alternating rounds at the script's sizes, beside each bound
    calls, bounds, keep = {}, {}, []
    if "mb_slice_shapes" in args.only:
        sz = ks.DEFAULTS
        x, P, NB, T = ks._x(sz["k"]), sz["ts"] ** 2, sz["nb"], sz["tiles"]
        for v in ks.VARIANTS:
            pairs = ks.needed_pairs(v, sz["k"], P, NB, T)
            bounds[f"slice_{v}"] = bound_ms(flops=ks.FLOPS_PER_PAIR[v] * pairs, ex2=pairs if v == "fwd_mix" else 0)
            for label in trees:
                call, out, hold = slice_call(label, v, x, P, NB, T)
                keep.append((out, hold))
                calls[(label, f"slice_{v}")] = call
    if "mb_fwd_breakdown" in args.only:
        e, offs, cnts, tw, th = streams["1080p"]
        for level in range(4):
            nbytes, flops, ex2 = fb.work(level, e, offs, cnts, 32)
            bounds[f"fwd_breakdown_L{level}"] = bound_ms(nbytes=nbytes, flops=flops, ex2=ex2)
            plan = fb.breakdown_plan(level, offs, cnts, e.shape[1])
            for label in trees:
                call, out, hold = breakdown_call(label, level, streams["1080p"], plan)
                keep.append((out, hold))
                calls[(label, f"fwd_breakdown_L{level}")] = call
    if "mb_inner_math" in args.only:
        P, K, NB = pm.SIZES["e5"]
        e = pm.e5_input(NB, K, lambda *sh: torch.rand(*sh, device="cuda", generator=g))
        ex2, flops = pm.inner_math_ops(e, P)
        for kernel, bf16 in (("inner_math_f32", False), ("inner_math_bf16", True)):
            bounds[kernel] = bound_ms(nbytes=4 * (e.numel() + NB * K), flops=flops, ex2=ex2)
            for label in trees:
                call, out, hold = inner_call(label, e, P, bf16)
                keep.append((out, hold))
                calls[(label, kernel)] = call
    for call in calls.values():
        _backend.check_launch(call(), "warm-up")
    torch.cuda.synchronize()
    times = {key: [] for key in calls}
    order = list(calls)
    with Clocks() as clk:
        for r in range(args.rounds):
            for key in (order if r % 2 == 0 else order[::-1]):
                times[key].append(split_ms(calls[key], 1, args.reps))
    mhz = f"SM clock {min(clk.mhz):.0f}-{max(clk.mhz):.0f} MHz (median {statistics.median(clk.mhz):.0f}), " \
          f"power {min(clk.watts):.0f}-{max(clk.watts):.0f} W" if clk.mhz else "SM clock not sampled"
    summary["clock"] = {"mhz": clk.mhz, "watts": clk.watts}
    summary["bounds_ms"] = {k: {"ms": b, "by": by} for k, (b, by) in bounds.items()}
    for (label, kernel), ts in times.items():
        med = {k: statistics.median(t[k] for t in ts) for k in ts[0]}
        summary["times"][f"{label} {kernel}"] = {**med, "rounds": ts}
        b, by = bounds[kernel]
        cs.log(f"{label} {kernel}: device {med['device_ms']:.4f} ms a launch "
               f"({min(t['device_ms'] for t in ts):.4f}-{max(t['device_ms'] for t in ts):.4f}), single call "
               f"{med['single_ms']:.4f} ms, host {med['host_us']:.2f} us a call (medians of {len(ts)} rounds); "
               f"bound {b:.4f} ms ({by}), {b / med['device_ms']:.3f} of it")
    for kernel in bounds:
        old, new = (summary["times"][f"{label} {kernel}"]["device_ms"] for label in trees)
        cs.log(f"{kernel}: {old:.4f} -> {new:.4f} ms a launch ({old / new:.2f}x)")
    cs.log(f"{mhz} during the timed rounds (card: {smi})")
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
