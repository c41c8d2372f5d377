#!/usr/bin/env python3
"""The calibration products of csrc/mb_calib.cu (`sgemm`, `tf32_mma`)
against another tree's, on the same inputs on one CUDA card.

    python3 scripts/torch_calib_ab.py --parent DIR [--rounds 7] [--reps 10]

DIR is a checkout of the tree to compare with (for example the parent
commit unpacked with `git archive` into build/parent). Each tree's C entry
points `sgemm_launch` and `tf32_mma_launch` are bound by the parameter list
in its own mb_calib.cu; a parameter the script does not know (see `value`)
stops it before any launch. The script:

  1. builds DIR's mb_calib.cu and this tree's with nvcc (this tree's
     flags, both started together) into build/calib_ab/{old,new}/, and
     prints ptxas's registers and spills of each product kernel and, from
     the SASS (cuobjdump), the loops that hold its FFMA (sgemm) or its
     tensor-core instruction (HGMMA for a wgmma kernel, HMMA otherwise);
  2. holds every product to its plain version (vpu_calib.sgemm_plain /
     tf32_mma_plain) at vpu_calib.SMALL and at the script's size
     ([512, 1024] @ [1024, 512], 256 repeats) by vpu_calib.TOL, and shows
     each gate rejecting the other precision's output;
  3. times them at the script's size in `--rounds` rounds of `--reps`
     launches each (CUDA events, ms a launch), the order reversed every
     other round, beside one ``torch.bmm`` of the 256 repeats (batch
     stride 0) with TF32 off and on, sampling the SM clock and power with
     nvidia-smi meanwhile; prints each median with its share of the bound
     (vpu_calib's: 2 M N K B flops at 67 TFLOP/s f32, 495 TF32).

The card's name and power limit head the output; a JSON summary goes to
build/calib_ab/summary.json.
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
from torch_fwd2_ab import Clocks  # noqa: E402  (this script's directory)

OUT = os.path.join(ROOT, "build", "calib_ab")
PRODUCTS = ("sgemm", "tf32_mma")


def build(label, csrc):
    """nvcc a copy of `csrc`'s mb_calib.cu with this tree's flags. Returns
    (.so path, ptxas log, source text)."""
    from gsplat_tpu_torch import _backend

    work = os.path.join(OUT, label)
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(csrc, work)
    src = os.path.join(work, "mb_calib.cu")
    so = os.path.join(work, "mb_calib.so")
    cmd = [_backend._nvcc()] + list(_backend._COMMON_FLAGS) + list(_backend.KERNELS["mb_calib"]) + ["-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {label}:\n{proc.stderr}")
    return so, proc.stderr, open(src).read()


def c_params(src, symbol):
    """[(ctypes type, parameter name)] of `extern "C" int symbol(...)` in
    the source text `src`."""
    m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src)
    if m is None:
        raise SystemExit(f"no extern \"C\" int {symbol}(...) in the source")
    params = []
    for p in " ".join(m.group(1).split()).split(","):
        decl, name = p.strip().rsplit(None, 1)
        decl += "*" * name.count("*")
        name = name.lstrip("*")
        if "*" in decl:
            t = ctypes.c_void_p
        elif decl.endswith("long long"):
            t = ctypes.c_longlong
        elif decl.endswith("int"):
            t = ctypes.c_int
        elif decl.endswith("float"):
            t = ctypes.c_float
        else:
            raise SystemExit(f"{symbol}: parameter {p.strip()!r} of a type the script does not bind")
        params.append((t, name))
    return params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    smi = cs.phase_device()
    import torch
    from gsplat_tpu_torch import _backend
    from gsplat_tpu_torch.microbench import compare, rejects
    from gsplat_tpu_torch.microbench import vpu_calib as vc

    trees = {"old": os.path.join(os.path.abspath(args.parent), "gsplat_tpu_torch", "csrc"), "new": _backend.CSRC}
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(trees)) as pool:
        futs = {k: pool.submit(build, k, v) for k, v in trees.items()}
        built = {k: f.result() for k, f in futs.items()}

    dev = torch.device("cuda")
    scratch = {}

    def value(name, product, x, y, repeats, out):
        """The argument named `name` of a product's C entry, for out = x @ y
        `repeats` times: the shapes, the operands, the repeats a block loops
        (reps), the tile's columns (bn), the pre-passes' scratch (At, xs,
        ys) and the stream."""
        (m, k), n = x.shape, y.shape[1]
        shapes = {"At": (k, m), "xs": (m, k), "ys": (n, k)}
        if name in shapes:
            key = (name, shapes[name])
            if key not in scratch:
                scratch[key] = torch.empty(shapes[name], device=dev)
            return scratch[key].data_ptr()
        plain = {"A": x.data_ptr(), "B": y.data_ptr(), "M": m, "N": n, "K": k, "repeats": repeats,
                 "reps": min(vc.GEMM_REPS, repeats), "zero": 0.0, "C": out.data_ptr(),
                 "stream": _backend.stream(dev)}
        if name in plain:
            return plain[name]
        if name == "bn":
            return vc.gemm_plan(product, m, n, k, repeats).tile[1]
        raise SystemExit(f"{product}: the script does not know the C parameter {name!r}")

    kernels = {}  # "old-sgemm" ... -> (product, run(x, y, repeats, out) -> rc)
    summary = {"card": smi, "builds": {}, "checks": {}, "times": {}}
    for label, (so, log, src) in built.items():
        lib = ctypes.CDLL(so)
        for product in PRODUCTS:
            params = c_params(src, f"{product}_launch")
            fn = getattr(lib, f"{product}_launch")
            fn.argtypes, fn.restype = [t for t, _ in params], ctypes.c_int
            names = [n for _, n in params]
            kernels[f"{label}-{product}"] = (product, lambda x, y, repeats, out, fn=fn, names=names, product=product:
                                             fn(*(value(n, product, x, y, repeats, out) for n in names)))
            cs.log(f"{label} {product}_launch({', '.join(names)})")
        regs = {k: f"{r}; {sp}" for k, r, sp in cs.ptxas_report(log) if "gemm" in k or "mma" in k}
        loops = cs.repeat_loops(so, {"sgemm": "FFMA", "tf32_mma": "HGMMA" if "wgmma" in src else "HMMA"})
        summary["builds"][label] = {"ptxas": regs, "loops": loops}
        for k, v in regs.items():
            cs.log(f"ptxas {label} {k}: {v}")
        cs.log(f"SASS {label}: loops (length, FFMA / HGMMA / HMMA in it) {loops}")

    # 2. every product against plain, both sizes; each gate rejects the other precision
    for small in (True, False):
        _, x, y = vc.inputs(small)
        repeats = vc.SMALL[3] if small else vc.B
        want = {"sgemm": vc.sgemm_plain(x, y), "tf32_mma": vc.tf32_mma_plain(x, y)}
        size = "small" if small else "script"
        for label, (product, run) in kernels.items():
            out = torch.empty((x.shape[0], y.shape[1]), device=dev)
            _backend.check_launch(run(x, y, repeats, out), label)
            torch.cuda.synchronize()
            other = PRODUCTS[1 - PRODUCTS.index(product)]
            err = compare(f"{label} ({size})", out, want[product], vc.TOL[product])
            rej = rejects(f"{label} at {other}'s gate ({size})", out, want[other], vc.TOL[other])
            summary["checks"][f"{label} {size}"] = {"max_abs_err": err, "other_gate_worst": rej}
            cs.log(f"{label} against plain ({size}'s size): max abs {err:.3e}; {other}'s gate rejects it "
                   f"(worst {rej:.3e} of its scale)")

    # 3. alternating rounds at the script's size
    _, x, y = vc.inputs(False)
    xb, yb = x.expand(vc.B, -1, -1), y.expand(vc.B, -1, -1)
    outs = {label: torch.empty((x.shape[0], y.shape[1]), device=dev) for label in kernels}
    calls = {label: (lambda run=run, label=label: run(x, y, vc.B, outs[label])) for label, (_, run) in
             kernels.items()}

    def bmm(switch):
        def call():
            with switch():
                torch.bmm(xb, yb)
            return 0
        return call

    calls["bmm-f32"] = bmm(_backend.full_f32_matmul)
    calls["bmm-tf32"] = bmm(_backend.tf32_matmul)
    for c in calls.values():  # warm-up (and cuBLAS's handle)
        c()
    torch.cuda.synchronize()
    times = {label: [] for label in calls}
    order = list(calls)
    with Clocks() as clk:
        for r in range(args.rounds):
            for label in (order if r % 2 == 0 else order[::-1]):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    rc = calls[label]()
                end.record()
                torch.cuda.synchronize()
                _backend.check_launch(rc, label)
                times[label].append(start.elapsed_time(end) / args.reps)
    flops = vc.gemm_flops(x, y, vc.B)
    bounds = {"f32": vc.bound_ms(flops=flops)[0], "tf32": vc.bound_ms(tf32_flops=flops)[0]}
    mhz = f"SM clock {min(clk.mhz):.0f}-{max(clk.mhz):.0f} MHz (median {statistics.median(clk.mhz):.0f}), " \
          f"power {min(clk.watts):.0f}-{max(clk.watts):.0f} W" if clk.mhz else "SM clock not sampled"
    summary["clock"] = {"mhz": clk.mhz, "watts": clk.watts}
    for label, ts in times.items():
        prec = "tf32" if "tf32" in label else "f32"
        med = statistics.median(ts)
        summary["times"][label] = {"median_ms": med, "rounds_ms": ts, "bound_ms": bounds[prec],
                                   "share_of_bound": bounds[prec] / med, "flop_per_s": flops / med * 1e3}
        cs.log(f"{label}: median {med:.4f} ms over {len(ts)} rounds of {args.reps} ({min(ts):.4f}-{max(ts):.4f}), "
               f"{flops / med * 1e3:.4g} flop/s, {bounds[prec] / med:.3f} of its {bounds[prec]:.4f} ms bound")
    cs.log(f"{mhz} during the timed rounds (card: {smi})")
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
