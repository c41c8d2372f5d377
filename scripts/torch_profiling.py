"""Frames per second and device memory of `rasterization` (port of
profiling/main.py).

Forward and forward + backward throughput of the port's `rasterization`
on the garden fixture over resolutions and scene grids, with the peak
device memory (``torch.cuda.max_memory_allocated``) and the kernels each
case launched. ``--backend auto`` is the function's own choice without a
capacity (the tiled backend at scene scale, the oracle on small
problems); ``binned`` and ``tiled`` take their capacity from a first
render of the case, as the trainer's probe does. Runs on the card unless
``--cpu`` asks for the CPU.

    python scripts/torch_profiling.py --scene-grid 5 --resolutions 1080p
    python scripts/torch_profiling.py --backend binned --resolutions 720p 1080p
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gsplat_tpu_torch import _backend, load_test_data, rasterization  # noqa: E402
from gsplat_tpu_torch.ops.isect import suggest_capacity  # noqa: E402

RESOLUTIONS = {
    "360p": (640, 360),
    "720p": (1280, 720),
    "1080p": (1920, 1080),
    "4k": (3840, 2160),
}
TILE_SIZE = 16


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_case(args, width, height, scene_grid, device):
    means, quats, scales, opacities, colors, viewmats, Ks, w0, _ = load_test_data(scene_grid=scene_grid)
    Ks = Ks.copy()
    Ks[:, :2, :] *= width / w0
    C = args.batch
    viewmats = np.tile(viewmats[:1], (C, 1, 1))
    Ks = np.tile(Ks[:1], (C, 1, 1))
    ins = [torch.as_tensor(x, device=device) for x in (means, quats, scales, opacities, colors, viewmats, Ks)]

    backend, capacity = args.backend, None
    if backend in ("binned", "tiled"):
        with torch.no_grad():
            meta = rasterization(*ins, width, height, backend=backend, tile_size=TILE_SIZE,
                                 isect_capacity=512 if backend == "binned" else max(1 << 20, 16 * C * len(means)))[2]
        capacity = (int(meta["slab_required"]) + 1024 if backend == "binned"
                    else suggest_capacity(int(meta["n_isects"])))

    def fwd(x):
        with torch.no_grad():
            return rasterization(x, *ins[1:], width, height, backend=backend, isect_capacity=capacity,
                                 tile_size=TILE_SIZE)

    leaves = [t.clone().requires_grad_(True) for t in ins[:5]]

    def fwd_bwd(x):
        out, alphas, _ = rasterization(x, *leaves[1:], *ins[5:], width, height, backend=backend,
                                       isect_capacity=capacity, tile_size=TILE_SIZE)
        return torch.autograd.grad(out.sum() + alphas.sum(), [x] + leaves[1:])

    def measure(fn, iters, x):
        fn(x)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        _sync(device)
        return (time.perf_counter() - t0) / iters

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            measure(fwd_bwd, 2, leaves[0])
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, f"trace_{width}x{height}_grid{scene_grid}.json")
        prof.export_chrome_trace(path)
        print(f"trace written to {path}", file=sys.stderr)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _backend.reset_launch_counts()
    t_fwd = measure(fwd, args.iters, ins[0])
    t_bwd = measure(fwd_bwd, args.iters, leaves[0])
    launches = {k: v for k, v in _backend.launch_counts().items() if v}
    mem = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else float("nan")
    return {
        "resolution": f"{width}x{height}",
        "scene_grid": scene_grid,
        "n_gaussians": int(ins[0].shape[0]),
        "batch": C,
        "backend": backend,
        "mem_gb": round(mem, 2),
        "fps_fwd": round(1.0 / t_fwd, 1),
        "fps_fwd_bwd": round(1.0 / t_bwd, 1),
        "pixels_per_s": round(C * width * height / t_bwd),
        "launches": launches,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--resolutions", nargs="*", default=["1080p"],
                    help=f"names ({', '.join(RESOLUTIONS)}) or WxH")
    ap.add_argument("--scene-grid", type=int, nargs="*", default=[5])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--trace", default="", help="write a torch.profiler chrome trace of 2 fwd+bwd to this dir")
    ap.add_argument("--backend", default="auto", choices=["auto", "tiled", "binned", "oracle"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = _backend.resolve_device("cpu" if args.cpu else "cuda")

    rows = []
    for grid in args.scene_grid:
        for res in args.resolutions:
            w, h = RESOLUTIONS[res] if res in RESOLUTIONS else map(int, res.split("x"))
            row = bench_case(args, w, h, grid, device)
            rows.append(row)
            print(row, flush=True)

    keys = list(rows[0].keys())
    print("\n" + "\t".join(keys))
    for r in rows:
        print("\t".join(str(r[k]) for k in keys))
    return rows


if __name__ == "__main__":
    main()
