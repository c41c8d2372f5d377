"""Hopper micro-benchmarks: the counterparts of the TPU micro-benchmarks in
``scripts/exp_*.py``, which are on no path of either package but tell a
kernel's redesign where its time goes.

- `vpu_calib` (scripts/exp_vpu_calib.py): the card's f32 multiply-add rate
  (``fma_chain``) and matrix rates, f32 on the CUDA cores (``sgemm``) and
  TF32 on the tensor cores (``tf32_mma``); csrc/mb_calib.cu.
- `fwd_breakdown` (scripts/exp_fwd_breakdown.py): the binned forward's
  work at four levels over the port's binned stream; csrc/mb_fwd_breakdown.cu.
- `kernel_shapes` (scripts/exp_mxu_kernel_shapes.py): six per-slice
  building blocks of the rasterizers; csrc/mb_slice_shapes.cu.
- `primitives` (scripts/exp_r2_primitives.py e1, e4, e5 and
  scripts/exp_r2_batch2.py g1): gathers and the sigma / exp inner math in
  f32 and bf16; csrc/mb_gather.cu, csrc/mb_inner_math.cu.

Each module holds its kernels' wrappers (CUDA tensors launch the kernel and
count it in ``_backend.LAUNCHES``; CPU tensors take the plain version),
their plain versions, and on the card, at its TPU script's sizes and with
its tolerances, ``check(small)`` (each kernel against its plain version,
and each gate shown to reject a wrong result) and ``measure(runs)`` (one
timed row a kernel). ``scripts/torch_exp_*.py`` and ``chip_smoke.py``
call those two. This module holds what the modules share: the card's
data-sheet peaks the bounds use (`bound_ms`), CUDA-event timing
(`median_ms`; `split_ms` parts a call's time into the card's and the
host's), the card's name and power limit (`card`), the
kernel-against-plain gate (`compare`, `rejects`, `format_errors`), a measured kernel's
printed line (`report_line`) and the scripts' `main`.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, List

import torch

# H100 SXM (NVIDIA data sheet, dense, at 700 W): HBM bytes/s, f32 flop/s
# outside the tensor cores (one multiply-add is two), TF32 tensor-core
# flop/s; the SFU's MUFU.EX2 issue rate is 16 a clock an SM (CUDA
# programming guide, throughput of exp2f / __expf for compute capability
# 9.0) at the 1,980 MHz boost clock over 132 SMs
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F32_FMAS = PEAK_F32_FLOPS / 2
PEAK_TF32_FLOPS = 495e12
PEAK_EX2_PER_S = 132 * 16 * 1.98e9


def bound_ms(nbytes: float = 0.0, flops: float = 0.0, tf32_flops: float = 0.0, ex2: float = 0.0):
    """(the least ms the card could take, what bounds it): the larger of
    the bytes over HBM's rate and each kind of operation over its peak."""
    times = {
        "bytes": nbytes / PEAK_BYTES_PER_S,
        "operations": max(flops / PEAK_F32_FLOPS, tf32_flops / PEAK_TF32_FLOPS, ex2 / PEAK_EX2_PER_S),
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def median_ms(fn: Callable[[], object], runs: int = 7, warmup: int = 2) -> float:
    """Median over `runs` of the CUDA-event ms of one call of `fn`, after
    `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times: List[float] = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def split_ms(fn: Callable[[], object], runs: int = 7, reps: int = 100) -> dict:
    """Three times of `fn`, each the median over `runs`:

    - ``single_ms``: one call between two CUDA events (`median_ms`), which
      holds the host's enqueue of the call where the card waits for it;
    - ``host_us``: host microseconds a call, a ``time.perf_counter`` around
      `reps` calls that are only enqueued;
    - ``device_ms``: the card's ms a launch, two events around `reps`
      back-to-back calls enqueued behind a ``torch.cuda._sleep`` that
      outlasts their enqueue, so the card runs them without a gap."""
    single = median_ms(fn, runs)
    hosts: List[float] = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        hosts.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    host_us = sorted(hosts)[len(hosts) // 2]
    # the sleep's cycles: three times the enqueue at 2 GHz (the boost clock)
    cycles = int(max(1e5, 3 * max(hosts) * 1e-6 * reps * 2e9))
    devs: List[float] = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        devs.append(start.elapsed_time(end) / reps)
    return {"single_ms": single, "host_us": host_us, "device_ms": sorted(devs)[len(devs) // 2]}


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them; raises
    without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the micro-benchmarks time a CUDA card; none is available")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _worst(diff: torch.Tensor, scale) -> float:
    """The largest diff / scale (0 where both are 0, inf where only the
    scale is)."""
    return float(torch.nan_to_num(diff / scale, nan=0.0, posinf=float("inf")).max())


def compare(what: str, got: torch.Tensor, want: torch.Tensor, tol: float = 0.0, scale=None) -> float:
    """Max |got - want|; raises if it is above `tol` x the largest |want|
    (`tol` 0: equal bits), or, given `scale` (a tensor of want's shape,
    e.g. each value's sum of |terms| or its row's largest |value|), above
    `tol` x `scale` anywhere."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} against {tuple(want.shape)}")
    if tol == 0.0:
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: {int((got != want).sum())} values differ from the plain version")
        return 0.0
    diff = (got.detach().float() - want.detach().float()).abs()
    err = float(diff.max()) if got.numel() else 0.0
    if scale is not None:
        bad = int((diff > tol * scale).sum())
        if bad:
            worst = _worst(diff, scale)
            raise AssertionError(f"{what}: {bad} values off by more than {tol:g} x their scale (at worst "
                                 f"{worst:.3e} x it; max abs {err:.3e})")
        return err
    top = float(want.detach().float().abs().max()) if want.numel() else 0.0
    if not err <= tol * top:
        raise AssertionError(f"{what}: max abs {err:.3e} above {tol:g} x the largest |plain| {top:.3e}")
    return err


def rejects(what: str, wrong: torch.Tensor, want: torch.Tensor, tol: float, scale=None) -> float:
    """`compare`'s gate on a deliberately wrong result (another precision's
    kernel, one value perturbed), which the gate must reject: its worst
    error over the gate's scale (the largest |want|, or `scale`), to set
    beside `tol`; raises if the gate passes it."""
    try:
        compare(what, wrong, want, tol, scale)
    except AssertionError:
        diff = (wrong.detach().float() - want.detach().float()).abs()
        return _worst(diff, scale if scale is not None else want.detach().float().abs().max())
    raise AssertionError(f"{what}: the gate passes a wrong result")


def format_errors(errs: dict) -> str:
    """`check`'s result as text: each kernel's max abs error, and each
    rejected wrong result's worst error over its gate's scale."""
    return ", ".join(f"{k}: worst {v:.3e} of its gate's scale" if k.startswith("rejects ") else f"{k} max abs {v:.3e}"
                     for k, v in errs.items())


def report_line(r: dict, smi: str) -> str:
    """One measured kernel's line: ms, its rate beside the data sheet's
    where it has one, the bound, the plain version's and the library's ms,
    and the card."""
    rate = ""
    if r.get("rate") is not None:
        rate = f", {r['rate']:.4g} {r['unit']}"
        if r.get("peak"):
            rate += f" against the data sheet's {r['peak']:.4g} ({r['rate'] / r['peak']:.3f})"
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    line = (f"{r['name']}: {r['ms']:.4f} ms ({r['work']}){rate}; bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"plain {r['plain_ms']:.4f} ms; library {lib}{_split(r, '')} (card: {smi})")
    if "e1_ms" in r:  # e1's one-block take_along_axis through the same kernel
        line += (f"\n  e1's [8, 512] take_along_axis through it: {r['e1_ms']:.4f} ms, bound "
                 f"{r['e1_bound_ms']:.6f} ms (bytes), plain {r['e1_plain_ms']:.4f} ms, library "
                 f"{r['e1_library_ms']:.4f} ms{_split(r, 'e1_')}")
    return line


def _split(r: dict, pre: str) -> str:
    """`split_ms`'s other two forms of a row where it has them: the
    kernel's, and the library's where the row times a library call."""
    if f"{pre}device_ms" not in r:
        return ""
    lib = f"{pre}library_device_ms" in r
    dev = f" (library {r[pre + 'library_device_ms']:.4f})" if lib else ""
    host = f" (library {r[pre + 'library_host_us']:.2f})" if lib else ""
    return f"; device ms a launch {r[pre + 'device_ms']:.4f}{dev}, host us a call {r[pre + 'host_us']:.2f}{host}"


def main(mod, doc: str, argv=None, sizes=None) -> None:
    """A script's run of `mod` on the card: its name and power limit, then
    `mod.check` at a small size and at its script's, then `mod.measure`'s
    rows (and `mod.describe` of the info where `measure` returns one). `sizes`: the
    script's command-line sizes, {name: default}, passed on as `sizes=`."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    for k, v in (sizes or {}).items():
        ap.add_argument(f"--{k}", type=int, default=v)
    ap.add_argument("--runs", type=int, default=7)
    args = ap.parse_args(argv)
    kw = {"sizes": {k: getattr(args, k) for k in sizes}} if sizes else {}
    smi = card()
    print(smi, flush=True)
    for small in (True, False):
        errs = mod.check(small, **kw)
        print(f"kernels against plain ({'small' if small else 'the script'}'s size): {format_errors(errs)}",
              flush=True)
    rows = mod.measure(args.runs, **kw)
    rows, info = rows if isinstance(rows, tuple) else (rows, None)
    for r in rows:
        print(report_line(r, smi), flush=True)
    if info is not None:
        print(f"{mod.describe(info)} (card: {smi})", flush=True)
