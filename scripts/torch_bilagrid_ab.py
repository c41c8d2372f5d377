#!/usr/bin/env python3
"""The bilateral grid's gradient kernels of csrc/bilagrid_bwd.cu
(`bilagrid_bwd`, the grids', and `bilagrid_lum_bwd`, the luminance's)
against another tree's, on the same inputs on one CUDA card.

    python3 scripts/torch_bilagrid_ab.py --parent DIR [--rounds 7] [--reps 20] [--check-only]

DIR is a checkout of the tree to compare with (for example the parent
commit unpacked with `git archive` into build/parent). Each tree's C entry
points `bilagrid_bwd_launch` and `bilagrid_lum_bwd_launch` are bound by the
parameter list in its own bilagrid_bwd.cu; a parameter the script does not
know (see `value`) stops it before any launch. The script:

  1. builds DIR's bilagrid_bwd.cu and this tree's with nvcc (this tree's
     flags, both started together) into build/bilagrid_ab/{old,new}/ and
     prints ptxas's registers, shared memory and spills of each kernel;
  2. holds both trees' kernels to the plain versions
     (`bilagrid._grid_grad_plain`, `bilagrid._lum_grad`) within
     chip_smoke.GRID_GRAD_TOL of each value's sum of |terms|, and two
     launches to the same bits, at 1080p with 16 x 16 x 8 grids and at
     chip_smoke.GRID_EDGE_SHAPES, each tree where its entry takes the
     shape (a refusal is printed: the first version took Z <= 16);
  3. profiles a round of each tree's entries at 1080p with torch.profiler,
     on each luminance of step 4: the card's time of each kernel by name
     (this tree's grids' gradient is two kernels);
  4. times, at 1080p, each tree's two bare C entries (arguments made
     beforehand) and ``grid_sampler_3d_backward`` for the grids alone and
     for the coordinates alone, in `--rounds` rounds, the order reversed
     every other round, each in `microbench.split_ms`'s three forms (one
     call between two events, the host's us a call, the card's ms a
     launch of `--reps` back-to-back launches), on two luminances:
     chip_smoke's (random colours, the first and last 8 rows black and
     white) and a flat one (every pixel at 0.5, one z level), sampling the
     SM clock and power meanwhile; prints each median beside its bound.

With --check-only it stops after step 2. The card's name and power limit
head the output; a JSON summary goes to build/bilagrid_ab/summary.json.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from torch_calib_ab import c_params  # noqa: E402  (this script's directory)
from torch_fwd2_ab import Clocks  # noqa: E402

OUT = os.path.join(ROOT, "build", "bilagrid_ab")
SYMBOLS = {"grids": "bilagrid_bwd_launch", "lum": "bilagrid_lum_bwd_launch"}


def build(label, csrc):
    """nvcc a copy of `csrc`'s bilagrid_bwd.cu with this tree's flags.
    Returns (.so path, ptxas log, source text)."""
    from gsplat_tpu_torch import _backend

    work = os.path.join(OUT, label)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    src = os.path.join(work, "bilagrid_bwd.cu")
    shutil.copy(os.path.join(csrc, "bilagrid_bwd.cu"), src)
    so = os.path.join(work, "bilagrid_bwd.so")
    cmd = [_backend._nvcc()] + list(_backend._COMMON_FLAGS) + list(_backend.KERNELS["bilagrid_bwd"]) + ["-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {label}:\n{proc.stderr}")
    return so, proc.stderr, open(src).read()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()

    smi = cs.phase_device()
    import torch
    from gsplat_tpu_torch import _backend, bilagrid
    from gsplat_tpu_torch.microbench import bound_ms, compare, split_ms

    trees = {"old": os.path.join(os.path.abspath(args.parent), "gsplat_tpu_torch", "csrc"), "new": _backend.CSRC}
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(trees)) as pool:
        futs = {k: pool.submit(build, k, v) for k, v in trees.items()}
        built = {k: f.result() for k, f in futs.items()}
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = _backend.stream(dev)
    summary = {"card": smi, "builds": {}, "checks": {}, "profile": {}, "times": {}}

    def value(name, x, out, plan, ntiles, partial):
        """The argument named `name` of a gradient kernel's C entry, for the
        inputs `x` (chip_smoke.grid_inputs), the output `out` and this
        tree's plan and scratch."""
        B, Z, Y, X, _ = x["shape"]
        H, W = x["gray"].shape[1:]
        known = {"g": x["g"], "v": x["v"], "gray": x["gray"], "out": out, "B": B, "H": H, "Wd": W, "Z": Z, "Y": Y,
                 "X": X, "stream": stream, "plan": plan, "ntiles": ntiles, "partial": partial}
        if name not in known:
            raise SystemExit(f"the script does not know the C parameter {name!r}")
        got = known[name]
        return got.data_ptr() if torch.is_tensor(got) else got

    kernels = {}  # "old grids" ... -> (C function, its parameter names)
    for label, (so, log, src) in built.items():
        lib = ctypes.CDLL(so)
        for kind, symbol in SYMBOLS.items():
            params = c_params(src, symbol)
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = [t for t, _ in params], ctypes.c_int
            kernels[f"{label} {kind}"] = (fn, [n for _, n in params])
            cs.log(f"{label} {symbol}({', '.join(n for _, n in params)})")
        regs = {k: f"{r}; {sp}" for k, r, sp in cs.ptxas_report(log)}
        summary["builds"][label] = {"ptxas": regs}
        for k, v in regs.items():
            cs.log(f"ptxas {label} {k}: {v}")

    def prepare(tag, x):
        """A call of kernel `tag` on inputs `x` with its arguments made
        beforehand: (call returning the CUDA error, output, the tensors whose
        pointers the call holds)."""
        fn, names = kernels[tag]
        B, Z, Y, X, _ = x["shape"]
        H, W = x["gray"].shape[1:]
        out = torch.empty(x["shape"] if tag.endswith("grids") else (B, H, W), device=dev)
        plan, ntiles = bilagrid._tiles(dev, B, H, W, Z, Y, X)
        partial = torch.empty((ntiles, 4, Z, 12), device=dev)
        argv = [value(n, x, out, plan, ntiles, partial) for n in names]
        return (lambda: fn(*argv)), out, (plan, partial)

    # 2. every kernel against plain, and two launches to the same bits
    shapes = [(1, cs.MAIN_H, cs.MAIN_W, 8, 16, 16)] + list(cs.GRID_EDGE_SHAPES)
    for i, shape in enumerate(shapes):
        x = cs.grid_inputs(torch, *shape, cs.SEED + 21 + i)
        g, v, gray, gshape = x["g"], x["v"], x["gray"], x["shape"]
        want = {"grids": bilagrid._grid_grad_plain(v, gray, gshape), "lum": bilagrid._lum_grad(g, gray, v)}
        scale = {"grids": bilagrid._grid_grad_plain(v.abs(), gray, gshape),
                 "lum": v.abs().sum(-1) * (2 * (gshape[1] - 1) * float(g.abs().max()))}
        where = "B{} {}x{}, grids Z{} Y{} X{}".format(shape[0], shape[2], shape[1], *shape[3:])
        for tag in kernels:
            call, out, _ = prepare(tag, x)
            code = call()
            if code != 0:
                cs.log(f"{tag} at {where}: refused (CUDA error {code})")
                summary["checks"][f"{tag} {where}"] = f"refused ({code})"
                continue
            first = out.clone()
            _backend.check_launch(call(), tag)
            torch.cuda.synchronize()
            if not torch.equal(first, out):
                raise AssertionError(f"{tag} at {where}: two launches differ at {int((first != out).sum())} values")
            kind = tag.split()[1]
            err = compare(f"{tag} at {where}", out, want[kind], cs.GRID_GRAD_TOL, scale=scale[kind])
            summary["checks"][f"{tag} {where}"] = err
            cs.log(f"{tag} at {where}: the same bits twice, max abs {err:.3e} against plain")
        del x, want, scale
    if args.check_only:
        with open(os.path.join(OUT, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return

    B, H, W = 1, cs.MAIN_H, cs.MAIN_W
    base = cs.grid_inputs(torch, B, H, W, 8, 16, 16, cs.SEED + 21)
    flat = dict(base, gray=torch.full_like(base["gray"], 0.5))
    lums = {"random": base, "flat": flat}
    # the bounds: v and gray read, the gradient written (chip_smoke's)
    n_v, n_px, n_g = base["v"].numel(), base["gray"].numel(), base["g"].numel()
    bounds = {"grids": bound_ms(nbytes=4 * (n_v + n_px + n_g), flops=2 * 96 * B * H * W),
              "lum": bound_ms(nbytes=4 * (n_v + 2 * n_px + n_g), flops=2 * 108 * B * H * W)}
    calls, keep = {}, []
    for lum, x in lums.items():
        for tag in kernels:
            call, out, held = prepare(tag, x)
            keep.append((out, held))
            calls[(lum, tag)] = call
        g5 = x["g"].permute(0, 4, 1, 2, 3)
        coords, go = bilagrid._coords(x["gray"]), x["v"].permute(0, 3, 1, 2)[:, :, None]
        keep.append((g5, coords, go))
        calls[(lum, "grid_sampler_3d_backward grids")] = (
            lambda go=go, g5=g5, coords=coords: torch.ops.aten.grid_sampler_3d_backward(
                go, g5, coords, 0, 1, True, [True, False]))
        calls[(lum, "grid_sampler_3d_backward coords")] = (
            lambda go=go, g5=g5, coords=coords: torch.ops.aten.grid_sampler_3d_backward(
                go, g5, coords, 0, 1, True, [False, True]))

    # 3. the card's time of each kernel by name, a profiled round a luminance
    from torch.profiler import ProfilerActivity, profile

    for key, call in calls.items():
        call()
    torch.cuda.synchronize()
    for lum in lums:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for key, call in calls.items():
                if key[0] == lum:
                    for _ in range(5):
                        call()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            if dev_us and ev.count and ("bilagrid" in ev.key or "grid_sampler_3d_backward_kernel" in ev.key):
                summary["profile"][f"{lum} {ev.key}"] = {"count": ev.count, "device_us": dev_us / ev.count}
                name = re.sub(r"\(.*", "", ev.key.replace("(anonymous namespace)::", "").replace("void ", ""))
                cs.log(f"profile, {lum} luminance: {name}: {ev.count} launches, {dev_us / ev.count:.2f} us of the "
                       "card each")
    if not summary["profile"]:
        cs.log("profile: no device time in the trace")

    # 4. alternating rounds
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
    for (lum, tag), ts in times.items():
        med = {k: statistics.median(t[k] for t in ts) for k in ts[0]}
        summary["times"][f"{lum} {tag}"] = {**med, "rounds": ts}
        kind = "grids" if "grids" in tag else "lum"
        b, by = bounds[kind]
        cs.log(f"{lum} luminance, {tag}: device {med['device_ms']:.4f} ms a launch "
               f"({min(t['device_ms'] for t in ts):.4f}-{max(t['device_ms'] for t in ts):.4f}), single call "
               f"{med['single_ms']:.4f} ms, host {med['host_us']:.2f} us a call (medians of {len(ts)} rounds); "
               f"bound {b:.4f} ms ({by}), {b / med['device_ms']:.3f} of it")
    cs.log(f"{mhz} during the timed rounds (card: {smi})")
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
