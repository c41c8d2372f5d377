#!/usr/bin/env python3
"""The gathers of csrc/mb_gather.cu (`gather_rows`, `gather_window`)
against another tree's, on the same inputs on one CUDA card.

    python3 scripts/torch_gather_ab.py --parent DIR [--rounds 7] [--wrapper-rounds 3] [--check-only]

DIR is a checkout of the tree to compare with (for example the parent
commit unpacked with `git archive` into build/parent). Each tree's C entry
points `gather_rows_launch` and `gather_window_launch` are bound by the
parameter list in its own mb_gather.cu; a parameter the script does not
know (see `value`) stops it before any launch. The script:

  1. builds DIR's mb_gather.cu and this tree's with nvcc (this tree's
     flags, both started together) into build/gather_ab/{old,new}/ and
     prints ptxas's registers and spills of each gather kernel;
  2. holds both trees' kernels to the plain versions
     (`primitives.gather_rows_plain` / `gather_window_plain`) bit for bit
     at the scripts' shapes, at check's small ones and at the edge shapes
     of this tree's `primitives.gather_edges()` (ragged widths, the S
     where the lane group narrows, the parent's largest S, NB = 0, K = 0,
     a table one float off 16-byte alignment);
  3. times the bare C entries (the launch arguments made beforehand) at
     the shapes of PERF.md's rows 15-17 in `--rounds` alternating rounds
     beside one ``torch.gather`` on int64 indices made beforehand, each in
     `microbench.split_ms`'s three forms: one call between two events, the
     host's microseconds a call, and the card's ms a launch of
     back-to-back launches; the SM clock and power are sampled
     meanwhile;
  4. compares the whole wrapper path, which runs through each tree's own
     launch path (`_backend`), in `--wrapper-rounds` rounds of alternating
     subprocesses (old, new, new, old, ...): each runs this script with
     ``--wrappers TREE``, which imports TREE's package and times its
     `primitives` wrappers in the same three forms (with this tree's
     `split_ms`), the pieces of its launch path alone, and the two reads
     of the current stream (`torch.cuda.current_stream(dev).cuda_stream`
     and the raw handle query, whose values must agree on the default
     stream and on a side stream).

With --check-only it stops after step 2. The card's name and power limit
head the output; a JSON summary goes to build/gather_ab/summary.json.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "gather_ab")
SYMBOLS = {"rows": "gather_rows_launch", "window": "gather_window_launch"}
HOST_REPS = {"g1": 20, "e1b": 100, "e1": 200}  # calls a host / device sample takes


def timing_module():
    """This tree's microbench/__init__.py (torch only, no relative imports)
    as a module of its own, so that a subprocess can time another tree's
    package with it."""
    path = os.path.join(ROOT, "gsplat_tpu_torch", "microbench", "__init__.py")
    spec = importlib.util.spec_from_file_location("gather_ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(pm, torch):
    """{label: (wrapper, plain, library, tab, idx, host reps)}: rows 15-17
    of PERF.md through `pm` (a tree's primitives), inputs from its own
    seeded `inputs` (the same in both trees)."""
    x = pm.inputs(False)
    tab1, idx1 = x["e1"]
    F = tab1.shape[0]
    return {
        "row15 gather_rows g1": (pm.gather_rows, pm.gather_rows_plain, lambda t, i: torch.gather(t, 1, i),
                                 *x["g1"], HOST_REPS["g1"]),
        "row16 gather_window e1 [8, 512]": (pm.gather_window, pm.gather_window_plain,
                                            lambda t, i: torch.gather(t[None], 2, i), tab1,
                                            idx1[None].contiguous(), HOST_REPS["e1"]),
        "row16 gather_rows e1 [1, 8, 512]": (pm.gather_rows, pm.gather_rows_plain,
                                             lambda t, i: torch.gather(t, 1, i), tab1[None].contiguous(),
                                             (idx1 % F)[None].contiguous(), HOST_REPS["e1"]),
        "row17 gather_window e1b": (pm.gather_window, pm.gather_window_plain,
                                    lambda t, i: torch.gather(t.expand(i.shape[0], -1, -1), 2, i), *x["e1b"],
                                    HOST_REPS["e1b"]),
    }


def wrappers_main(tree, out_path, runs):
    """`--wrappers TREE`: TREE's wrappers, torch.gather and the launch
    path's pieces, timed in this process; JSON to `out_path`."""
    tm = timing_module()
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import gsplat_tpu_torch
    from gsplat_tpu_torch import _backend
    from gsplat_tpu_torch.microbench import primitives as pm
    from gsplat_tpu_torch.ops.rasterize_binned import _check

    assert os.path.abspath(gsplat_tpu_torch.__file__).startswith(os.path.abspath(tree)), gsplat_tpu_torch.__file__
    dev = torch.device("cuda", torch.cuda.current_device())
    res = {"tree": tree, "split": {}, "pieces_us": {}}
    by = cases(pm, torch)
    for label, (fn, plain, lib, tab, idx, reps) in by.items():
        if not torch.equal(fn(tab, idx), plain(tab, idx)):
            raise AssertionError(f"{tree}: {label} differs from its plain version")
        i64 = idx.long()
        res["split"][label] = tm.split_ms(lambda: fn(tab, idx), runs, reps)
        res["split"][label + " torch.gather"] = tm.split_ms(lambda: lib(tab, i64), runs, reps)
        del i64
    # the launch path's pieces at row 16's [1, 8, 512], host us a call
    tab, idx = by["row16 gather_rows e1 [1, 8, 512]"][3:5]
    args = getattr(pm, "_ROWS_ARGS", None)
    n = 20000

    def per_call(f):
        import time
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        return (time.perf_counter() - t0) / n * 1e6

    NB, S, L = tab.shape
    pieces = {
        "common_device": lambda: _backend.common_device(tab, idx),
        "check": lambda: _check("gather_rows", dev, [(tab, torch.float32, None), (idx, torch.int32, (NB, S, L))]),
        "torch.empty_like": lambda: torch.empty_like(tab),
        # the parent's wrapper makes its argtypes list each call
        "kernel()": (lambda: _backend.kernel("mb_gather", "gather_rows_launch", args)) if args is not None else
        (lambda: _backend.kernel("mb_gather", "gather_rows_launch",
                                 [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)),
        "_backend.stream": lambda: _backend.stream(dev),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
    }
    for k, f in pieces.items():
        f()
        res["pieces_us"][k] = per_call(f)
    side = torch.cuda.Stream()
    same = [torch.cuda.current_stream(dev).cuda_stream == torch._C._cuda_getCurrentRawStream(dev.index)
            == _backend.stream(dev)]
    with torch.cuda.stream(side):
        same.append(side.cuda_stream == torch._C._cuda_getCurrentRawStream(dev.index) == _backend.stream(dev))
    res["stream_reads_agree"] = same
    with open(out_path, "w") as f:
        json.dump(res, f)


def build(label, csrc):
    """nvcc a copy of `csrc`'s mb_gather.cu with this tree's flags. Returns
    (.so path, ptxas log, source text)."""
    from gsplat_tpu_torch import _backend

    work = os.path.join(OUT, label)
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(csrc, work)
    src = os.path.join(work, "mb_gather.cu")
    so = os.path.join(work, "mb_gather.so")
    cmd = [_backend._nvcc()] + list(_backend._COMMON_FLAGS) + list(_backend.KERNELS["mb_gather"]) + ["-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {label}:\n{proc.stderr}")
    return so, proc.stderr, open(src).read()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--wrapper-rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--wrappers", help=argparse.SUPPRESS)
    ap.add_argument("--json", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.wrappers:
        return wrappers_main(args.wrappers, args.json, args.runs)
    if not args.parent:
        ap.error("--parent DIR is required")

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from torch_calib_ab import c_params
    from torch_fwd2_ab import Clocks

    smi = cs.phase_device()
    import torch
    from gsplat_tpu_torch import _backend
    from gsplat_tpu_torch.microbench import compare, split_ms
    from gsplat_tpu_torch.microbench import primitives as pm

    parent = os.path.abspath(args.parent)
    trees = {"old": os.path.join(parent, "gsplat_tpu_torch", "csrc"), "new": _backend.CSRC}
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(trees) + 1) as pool:
        futs = {k: pool.submit(build, k, v) for k, v in trees.items()}
        own = pool.submit(_backend._build, "mb_gather")  # the wrapper subprocesses' library
        built = {k: f.result() for k, f in futs.items()}
        own.result()
    dev = torch.device("cuda", torch.cuda.current_device())
    summary = {"card": smi, "builds": {}, "checks": {}, "times": {}, "wrappers": {}}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def value(name, kind, tab, idx, out):
        """The argument named `name` of a gather's C entry: the tensors, their
        shapes, the stream, and this tree's plan (`dims`)."""
        if kind == "rows":
            NB, S, L = tab.shape
            shape = {"NB": NB, "S": S, "L": L}
        else:
            (F, W), (NB, _, K) = tab.shape, idx.shape
            shape = {"NB": NB, "F": F, "W": W, "K": K}
        plain = {"tab": tab.data_ptr(), "idx": idx.data_ptr(), "out": out.data_ptr(), "stream": _backend.stream(dev),
                 **shape}
        if name in plain:
            return plain[name]
        if name == "dims":
            aligned = all(t.data_ptr() % 16 == 0 for t in (tab, idx, out))
            p = pm.gather_plan(f"gather_{kind}", tuple(shape.values()), sms, aligned=aligned)
            return pm.dims_array(f"gather_{kind}", tuple(shape.values()), p)
        raise SystemExit(f"gather_{kind}: the script does not know the C parameter {name!r}")

    kernels = {}  # "old rows" ... -> (kind, C function, its parameter names)
    for label, (so, log, src) in built.items():
        lib = ctypes.CDLL(so)
        for kind, symbol in SYMBOLS.items():
            params = c_params(src, symbol)
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = [t for t, _ in params], ctypes.c_int
            names = [n for _, n in params]
            kernels[f"{label} {kind}"] = (kind, fn, names)
            cs.log(f"{label} {symbol}({', '.join(names)})")
        regs = {k: f"{r}; {sp}" for k, r, sp in cs.ptxas_report(log) if "gather" in k}
        summary["builds"][label] = {"ptxas": regs}
        for k, v in regs.items():
            cs.log(f"ptxas {label} {k}: {v}")

    def launch(tag, tab, idx, out):
        kind, fn, names = kernels[tag]
        return fn(*(value(n, kind, tab, idx, out) for n in names))

    def run_checked(tag, tab, idx):
        out = torch.empty(idx.shape, device=dev)
        _backend.check_launch(launch(tag, tab, idx, out), tag)
        return out

    # 2. every kernel against plain, bit for bit
    shapes = {"rows": {}, "window": {}}
    x = pm.inputs(False)
    small = pm.inputs(True)
    tab1, idx1 = x["e1"]
    shapes["rows"]["g1"] = x["g1"]
    shapes["rows"]["small g1"] = small["g1"]
    shapes["rows"]["e1 [1, 8, 512]"] = (tab1[None].contiguous(), (idx1 % tab1.shape[0])[None].contiguous())
    shapes["window"]["e1b"] = x["e1b"]
    shapes["window"]["small e1b"] = small["e1b"]
    shapes["window"]["e1 [8, 512]"] = (tab1, idx1[None].contiguous())
    for name, where, tab, idx in pm.edge_inputs():
        shapes[name.split("_")[1]][where] = (tab, idx)
    for kind, by in shapes.items():
        want_fn = pm.gather_rows_plain if kind == "rows" else pm.gather_window_plain
        for where, (tab, idx) in by.items():
            want = want_fn(tab, idx)
            for tag, (k, _, _) in kernels.items():
                if k != kind:
                    continue
                compare(f"{tag} at {where}", run_checked(tag, tab, idx), want)
                summary["checks"][f"{tag} {where}"] = 0.0
            cs.log(f"gather_{kind} at {where} {list(idx.shape)}: every kernel equals plain")
            del want
    if args.check_only:
        with open(os.path.join(OUT, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return

    # 3. the bare C entries in alternating rounds
    rows = {"row15 g1": ("rows", *x["g1"], HOST_REPS["g1"]),
            "row16 rows [1, 8, 512]": ("rows", *shapes["rows"]["e1 [1, 8, 512]"], HOST_REPS["e1"]),
            "row16 window [8, 512]": ("window", *shapes["window"]["e1 [8, 512]"], HOST_REPS["e1"]),
            "row17 e1b": ("window", *x["e1b"], HOST_REPS["e1b"])}
    library = {"rows": lambda t, i: torch.gather(t, 1, i),
               "window": lambda t, i: torch.gather(t.expand(i.shape[0], -1, -1), 2, i)}
    calls, keep = {}, []  # keep: the outputs whose raw pointers the calls hold
    for where, (kind, tab, idx, reps) in rows.items():
        out = torch.empty(idx.shape, device=dev)
        keep.append(out)
        for tag, (k, fn, names) in kernels.items():
            if k == kind:
                argv = [value(n, kind, tab, idx, out) for n in names]
                calls[(where, tag)] = (lambda fn=fn, argv=argv: fn(*argv), reps)
        i64 = idx.long()
        calls[(where, "torch.gather")] = (lambda lib=library[kind], tab=tab, i64=i64: lib(tab, i64), reps)
    times = {key: [] for key in calls}
    order = list(calls)
    with Clocks() as clk:
        for r in range(args.rounds):
            for key in (order if r % 2 == 0 else order[::-1]):
                fn, reps = calls[key]
                times[key].append(split_ms(fn, 1, reps))
    mhz = f"SM clock {min(clk.mhz):.0f}-{max(clk.mhz):.0f} MHz (median {statistics.median(clk.mhz):.0f}), " \
          f"power {min(clk.watts):.0f}-{max(clk.watts):.0f} W" if clk.mhz else "SM clock not sampled"
    summary["clock"] = {"mhz": clk.mhz, "watts": clk.watts}
    for (where, tag), ts in times.items():
        med = {k: statistics.median(t[k] for t in ts) for k in ts[0]}
        summary["times"][f"{where} {tag}"] = {**med, "rounds": ts}
        cs.log(f"{where} {tag}: device {med['device_ms']:.4f} ms a launch, single call {med['single_ms']:.4f} ms, "
               f"host {med['host_us']:.2f} us a call (medians of {len(ts)} rounds; device "
               f"{min(t['device_ms'] for t in ts):.4f}-{max(t['device_ms'] for t in ts):.4f})")
    cs.log(f"{mhz} during the timed rounds (card: {smi})")

    # 4. the wrapper paths, each tree's in its own subprocess, alternating
    runs = {"old": [], "new": []}
    for r in range(args.wrapper_rounds):
        for label in (("old", "new") if r % 2 == 0 else ("new", "old")):
            path = os.path.join(OUT, f"wrappers-{label}-{r}.json")
            tree = parent if label == "old" else ROOT
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--wrappers", tree, "--json", path,
                                   "--runs", str(args.runs)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"--wrappers {tree} failed:\n{proc.stdout}\n{proc.stderr}")
            with open(path) as f:
                runs[label].append(json.load(f))
    for label, rs in runs.items():
        if not all(all(r["stream_reads_agree"]) for r in rs):
            raise AssertionError(f"{label}: the stream reads disagree")
        split = {k: {m: statistics.median(r["split"][k][m] for r in rs) for m in rs[0]["split"][k]}
                 for k in rs[0]["split"]}
        pieces = {k: statistics.median(r["pieces_us"][k] for r in rs) for k in rs[0]["pieces_us"]}
        summary["wrappers"][label] = {"split": split, "pieces_us": pieces, "runs": rs}
        for k, v in split.items():
            cs.log(f"wrapper {label} {k}: single call {v['single_ms']:.4f} ms, device {v['device_ms']:.4f} ms a "
                   f"launch, host {v['host_us']:.2f} us a call (medians of {len(rs)} subprocesses)")
        cs.log(f"wrapper {label} launch path pieces (host us a call): "
               + ", ".join(f"{k} {v:.3f}" for k, v in pieces.items()))
    cs.log(f"card: {smi}")
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
