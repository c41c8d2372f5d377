#!/usr/bin/env python3
"""Drive the PyTorch port's forward render path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the script exits
non-zero (there is no CPU fallback):

  1. device: the card's name and power limit (nvidia-smi);
  2. build: both kernels (csrc/emit.cu, csrc/rasterize_fwd.cu), one nvcc
     process each, into build/gsplat_tpu_torch/;
  3. kernel vs plain on the card: garden scene_grid=1 at its native 648x420,
     3 cameras, tile sizes 16 and 32, sh_degree 0 and 3: the emit kernel's
     stream must equal its plain version's, and the forward kernel's image
     and alpha must agree with its plain version's within max abs 2e-4 (an
     entry at the T ~ 1e-4 termination boundary can flip when the product
     is rounded in another order) and mean abs 1e-6; the binned render must
     agree with the oracle render on a small subsample;
  4. main path: garden scene_grid=5 (2,794,625 Gaussians) at 1920x1080,
     one camera per frame, tile size 16, sh_degree 3 with seeded shN,
     through splats_from_numpy and rasterization(backend="binned"), a few
     frames over the 3 fixture cameras; launch counts, frame and stage
     times, finiteness, the device's busy time and idle share in one
     profiled frame, frame time at tile sizes 8/16/32; then each kernel
     against its plain version at these shapes, and the `kernels` line with
     times and bounds;
  5. the result line.
"""

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
FWD_MAX_ABS = 2e-4
FWD_MEAN_ABS = 1e-6
MAIN_TILE = 16
MAIN_GRID = 5
MAIN_W, MAIN_H = 1920, 1080
SEED = 0


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps):
    """Mean ms per call over `reps` calls, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_by_kernel(torch, fn):
    """Kernel times on the card over one call of `fn`, from torch.profiler:
    {kernel name: ms}, summed over launches (empty if the profiler saw no
    device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def splat_arrays(grid, sh_degree, seed):
    """The garden fixture as a trained checkpoint would hold it (the JAX
    trainer's `splat/` layout): log-scales, logit-opacities, sh0 from the
    colours and seeded higher-order SH."""
    from gsplat_tpu_torch import load_test_data

    means, quats, scales, opac, colors, viewmats, Ks, W, H = load_test_data(scene_grid=grid)
    n = means.shape[0]
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2 - 1
    arrays = {
        "splat/means": means,
        "splat/quats": quats,
        "splat/scales": np.log(scales),
        "splat/opacities": np.log(opac / np.clip(1.0 - opac, 1e-6, None)),
        "splat/sh0": colors[:, None, :],
        "splat/shN": (0.1 * rng.standard_normal((n, k, 3))).astype(np.float32),
        "live": np.ones(n, bool),
    }
    return arrays, viewmats, Ks, W, H


def render_args(torch, splats):
    """The JAX trainer's render transform (Runner.render)."""
    return (
        splats["means"], splats["quats"], torch.exp(splats["scales"]),
        torch.sigmoid(splats["opacities"]),
        torch.cat([splats["sh0"], splats["shN"]], dim=1),
    )


def shade(rendering, torch, splats, live, viewmats, Ks, W, H, sh_degree):
    means, quats, scales, opac, colors = render_args(torch, splats)
    return rendering.project_and_shade(
        means, quats, scales, opac, colors, viewmats, Ks, W, H,
        sh_degree=sh_degree, masks=live,
    )


def emit_plan(binning, s, ts, W, H, capacity):
    tw, th = -(-W // ts), -(-H // ts)
    return binning.plan_emit(
        s.mean_x, s.mean_y, *s.conics, s.opacities, s.colors, s.radii,
        s.depths, ts, tw, th, capacity,
    )


def compare_emit(torch, binning, plan, slab, T):
    """Emit kernel vs plain on one plan: raw and sorted streams equal.
    Returns (the kernel's sorted stream, max abs difference of its entries
    from the plain version's)."""
    raw_k = binning._emit_cuda(plan)
    raw_p = binning._emit_plain(plan)
    for a, b, what in zip(raw_k, raw_p, ("keys", "gids", "feats")):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"emit kernel {what} differ from plain at {bad} places")
    bk = binning.sort_entries(raw_k, T, slab)
    bp = binning.sort_entries(raw_p, T, slab)
    for f in ("entries", "gids", "offs", "cnts", "n_isects"):
        if not torch.equal(getattr(bk, f), getattr(bp, f)):
            raise AssertionError(f"sorted stream field {f} differs between emit kernel and plain")
    err = float((bk.entries - bp.entries).abs().max()) if bk.entries.numel() else 0.0
    return bk, err


def compare_fwd(torch, rb, bk, C, W, H, ts, entries=None, bg=None):
    """Forward kernel vs plain on one stream (its entries, or `entries` in
    their place). Returns (max abs, mean abs, share of pixels with equal
    `last`, count of values off by > 1e-5, evaluated pairs)."""
    entries = bk.entries if entries is None else entries
    args = (entries, bk.offs, bk.cnts, C, W, H, ts, bg)
    img_k, T_k, last_k = rb._fwd_cuda(*args)
    img_p, T_p, last_p, pairs = rb._fwd_plain(*args)
    d = torch.cat([(img_k - img_p).abs().reshape(-1), (T_k - T_p).abs().reshape(-1)])
    max_abs, mean_abs = float(d.max()), float(d.mean())
    n_off = int((d > 1e-5).sum())
    if not (torch.isfinite(img_k).all() and torch.isfinite(T_k).all()):
        raise AssertionError("forward kernel output is not finite")
    if max_abs > FWD_MAX_ABS or mean_abs > FWD_MEAN_ABS:
        raise AssertionError(
            f"forward kernel vs plain: max abs {max_abs:.3e} (limit {FWD_MAX_ABS}), "
            f"mean abs {mean_abs:.3e} (limit {FWD_MEAN_ABS}), {n_off} values off by > 1e-5"
        )
    same_last = float((last_k == last_p).float().mean())
    return max_abs, mean_abs, same_last, n_off, pairs


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card only", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from gsplat_tpu_torch import _backend

    t0 = time.perf_counter()
    _backend.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s (emit.cu, rasterize_fwd.cu)")
    for name, text in _backend.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_kernel_vs_plain():
    import torch
    from gsplat_tpu_torch import rendering, splats_from_numpy
    from gsplat_tpu_torch.ops import binning, rasterize_binned as rb

    dev = torch.device("cuda")
    arrays, viewmats, Ks, W, H = splat_arrays(1, 3, SEED)
    splats, live = splats_from_numpy(arrays, device=dev)
    vm = torch.as_tensor(viewmats, device=dev)
    K = torch.as_tensor(Ks, device=dev)
    C = vm.shape[0]
    with torch.no_grad():
        for ts in (16, 32):
            for deg in (0, 3):
                s = shade(rendering, torch, splats, live, vm, K, W, H, deg)
                plan, slab = emit_plan(binning, s, ts, W, H, capacity=1 << 30)
                T = C * (-(-W // ts)) * (-(-H // ts))
                bk, _ = compare_emit(torch, binning, plan, slab, T)
                mx, mean, same_last, n_off, _ = compare_fwd(torch, rb, bk, C, W, H, ts)
                log(f"kernel vs plain grid1 {W}x{H} C={C} ts={ts} sh={deg}: "
                    f"n_isects {int(bk.n_isects)}, emit equal, fwd max abs {mx:.3e} "
                    f"mean abs {mean:.3e} ({n_off} values > 1e-5), last equal at {same_last:.6f} of pixels")
                if ts == 16 and deg == 3:
                    # wider channel counts (the kernel's 8-, 16- and 32-wide
                    # accumulators) on this stream: random channel rows and
                    # a random background
                    gen = torch.Generator(device=dev).manual_seed(SEED)
                    M = bk.entries.shape[1]
                    for D in (8, 16, 32):
                        ent = torch.cat([bk.entries[:6], torch.rand((D, M), generator=gen, device=dev)])
                        bg = torch.rand((C, D), generator=gen, device=dev)
                        mx, mean, same_last, n_off, _ = compare_fwd(torch, rb, bk, C, W, H, ts, ent, bg)
                        log(f"kernel vs plain grid1 ts={ts} D={D} with background: fwd max abs {mx:.3e} "
                            f"mean abs {mean:.3e} ({n_off} values > 1e-5), last equal at {same_last:.6f} of pixels")

        # binned (kernels) vs oracle on a small subsample, as the repo's
        # golden test cuts the garden: every 15th Gaussian, cameras / 4
        sub = {k: v[::15] for k, v in splats.items()}
        f = 4
        Ks4 = K.clone()
        Ks4[:, :2, :] /= f
        args = render_args(torch, sub)
        bg = torch.full((C, 3), 0.2, device=dev)
        out = {}
        for backend in ("binned", "oracle"):
            out[backend] = rendering.rasterization(
                *args, vm, Ks4, W // f, H // f, sh_degree=3, backgrounds=bg,
                backend=backend, isect_capacity=1 << 20,
            )
        d_img = float((out["binned"][0] - out["oracle"][0]).abs().max())
        d_a = float((out["binned"][1] - out["oracle"][1]).abs().max())
        if max(d_img, d_a) > FWD_MAX_ABS:
            raise AssertionError(f"binned vs oracle: image {d_img:.3e}, alpha {d_a:.3e}")
        log(f"binned vs oracle ({sub['means'].shape[0]} Gaussians, {W // f}x{H // f}, C={C}): "
            f"max abs image {d_img:.3e} alpha {d_a:.3e}")


def phase_main_path(smi):
    import torch
    from gsplat_tpu_torch import _backend, rasterization, rendering, splats_from_numpy
    from gsplat_tpu_torch.ops import binning, rasterize_binned as rb
    from gsplat_tpu_torch.ops.projection import fully_fused_projection_soa

    dev = torch.device("cuda")
    deg = 3
    arrays, viewmats, Ks, W0, _ = splat_arrays(MAIN_GRID, deg, SEED)
    Ks = Ks.copy()
    Ks[:, :2, :] *= MAIN_W / W0
    W, H, ts = MAIN_W, MAIN_H, MAIN_TILE
    splats, live = splats_from_numpy(arrays, device=dev)
    N = splats["means"].shape[0]
    vms = [torch.as_tensor(viewmats[i : i + 1], device=dev) for i in range(len(viewmats))]
    Kss = [torch.as_tensor(Ks[i : i + 1], device=dev) for i in range(len(Ks))]

    def frame(i, capacity, tile=ts):
        return rasterization(
            *render_args(torch, splats), vms[i], Kss[i], W, H, sh_degree=deg,
            masks=live, tile_size=tile, backend="binned", isect_capacity=capacity,
        )

    with torch.no_grad():
        # capacity from a first call's slab_required, over all cameras
        capacity = max(frame(i, 512)[2]["slab_required"] for i in range(len(vms))) + 1024
        torch.cuda.synchronize()

        _backend.reset_launch_counts()
        frames, frames_dev = [], []
        for rep in range(2):
            for i in range(len(vms)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                img, alpha, meta = frame(i, capacity)
                end.record()
                torch.cuda.synchronize()
                frames.append((time.perf_counter() - t0) * 1e3)
                frames_dev.append(start.elapsed_time(end))
                if not (torch.isfinite(img).all() and torch.isfinite(alpha).all()):
                    raise AssertionError(f"camera {i}: non-finite output")
                if tuple(img.shape) != (1, H, W, 3) or tuple(alpha.shape) != (1, H, W, 1):
                    raise AssertionError(f"camera {i}: shapes {tuple(img.shape)} {tuple(alpha.shape)}")
                if meta["slab_required"] > capacity:
                    raise AssertionError(f"camera {i}: truncated ({meta['slab_required']} > {capacity})")
                if rep == 0:
                    log(f"frame cam {i}: n_isects {int(meta['n_isects'])}, slab_required "
                        f"{meta['slab_required']}, alpha mean {float(alpha.mean()):.4f}, "
                        f"image mean {float(img.mean()):.4f}, finite")
        launches = _backend.launch_counts()
        log(f"main path: N={N}, {W}x{H}, ts={ts}, sh_degree={deg}, capacity {capacity}, "
            f"{len(frames)} frames, ms/frame host {', '.join(f'{t:.2f}' for t in frames)}; "
            f"CUDA events {', '.join(f'{t:.2f}' for t in frames_dev)}")
        log(f"launches in the main path: {launches}")
        for name, count in launches.items():
            if count == 0:
                raise AssertionError(f"kernel {name} was not launched on the main path")

        # stage times (CUDA events), camera 0, same inputs as the frames
        s = shade(rendering, torch, splats, live, vms[0], Kss[0], W, H, deg)
        plan, slab = emit_plan(binning, s, ts, W, H, capacity)
        T = (-(-W // ts)) * (-(-H // ts))
        ops = binning._emit_cuda(plan)
        bk = binning.sort_entries(ops, T, slab)
        reps = 10
        args0 = render_args(torch, splats)
        stage = {
            "projection+SH": cuda_ms(torch, lambda: shade(rendering, torch, splats, live, vms[0], Kss[0], W, H, deg), reps),
            "of it: render transform (exp, sigmoid, cat)": cuda_ms(torch, lambda: render_args(torch, splats), reps),
            "of it: projection": cuda_ms(torch, lambda: fully_fused_projection_soa(*args0[:3], vms[0], Kss[0], W, H), reps),
            "emit (plan + kernel)": cuda_ms(torch, lambda: binning._emit_cuda(emit_plan(binning, s, ts, W, H, capacity)[0]), reps),
            "sort": cuda_ms(torch, lambda: binning.sort_entries(ops, T, slab), reps),
            "forward kernel": cuda_ms(torch, lambda: rb._fwd_cuda(bk.entries, bk.offs, bk.cnts, 1, W, H, ts), reps),
            "frame": cuda_ms(torch, lambda: frame(0, capacity), reps),
        }
        log("stage ms (CUDA events, camera 0): " + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()))

        # device busy time of one frame (kernels on one stream do not
        # overlap, so their sum is the busy time); idle share against the
        # unprofiled frame time above
        kern = device_time_by_kernel(torch, lambda: frame(0, capacity))
        if kern:
            busy = sum(kern.values())
            top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
            log(f"profiled frame (camera 0): {len(kern)} kernel names, device busy {busy:.3f} ms, "
                f"idle share {1.0 - busy / stage['frame']:.3f} of {stage['frame']:.3f} ms; top: "
                + "; ".join(f"{name[:48]} {ms:.3f}" for name, ms in top))
        else:
            log("profiled frame (camera 0): the profiler saw no device events; busy time not measured")

        # the tile size, chosen on the card: frame time per tile size
        sweep = []
        for tile in (8, 16, 32):
            cap = frame(0, 512, tile)[2]["slab_required"] + 1024
            sweep.append(f"ts={tile} {cuda_ms(torch, lambda: frame(0, cap, tile), 5):.3f}")
        log("tile-size sweep, frame ms (CUDA events, camera 0): " + ", ".join(sweep))

        # each kernel alone, against its plain version, at these shapes
        emit_ms = cuda_ms(torch, lambda: binning._emit_cuda(plan), reps)
        emit_plain_ms = cuda_ms(torch, lambda: binning._emit_plain(plan), 2)
        bk, emit_err = compare_emit(torch, binning, plan, slab, T)
        log(f"emit kernel vs plain at {W}x{H}: equal (max abs {emit_err:.3e})")
        fwd_ms = cuda_ms(torch, lambda: rb._fwd_cuda(bk.entries, bk.offs, bk.cnts, 1, W, H, ts), reps)
        fwd_plain_ms = cuda_ms(torch, lambda: rb._fwd_plain(bk.entries, bk.offs, bk.cnts, 1, W, H, ts), 1)
        mx, mean, same_last, n_off, pairs = compare_fwd(torch, rb, bk, 1, W, H, ts)
        log(f"forward kernel vs plain at {W}x{H}: max abs {mx:.3e}, mean abs {mean:.3e} "
            f"({n_off} values > 1e-5), last equal at {same_last:.6f} of pixels")

        # bounds: bytes each input read once and each output written once,
        # over HBM rate; operations this run's data needs over f32 peak.
        # The emit kernel reads only `counts` for an id that emits nothing
        # (culled, masked or truncated); a live id also reads its rectangle,
        # write offset, depth and NF payload rows.
        CN = plan.counts.shape[0]
        NF = plan.payload.shape[0]
        M = plan.n_emit
        live_ids = int((plan.counts > 0).sum())
        emit_bytes = live_ids * (5 * 4 + 8 + 4 * NF) + (CN - live_ids) * 4 + M * (8 + 4 + 4 * NF)
        emit_bound = emit_bytes / PEAK_BYTES_PER_S * 1e3
        D = NF - 6
        n_isects = int(bk.n_isects)
        fwd_bytes = n_isects * NF * 4 + 2 * T * 4 + H * W * (4 * D + 4 + 4)
        fwd_ops = pairs * (18 + 2 * D)
        fwd_bound_bytes = fwd_bytes / PEAK_BYTES_PER_S * 1e3
        fwd_bound_ops = fwd_ops / PEAK_F32_FLOPS * 1e3
        log(f"emit: {live_ids} of {CN} (camera, Gaussian) ids live, {M} entries, {emit_bytes} bytes; forward: {n_isects} entries, {pairs} "
            f"evaluated (pixel, entry) pairs, {fwd_ops} flops, {fwd_bytes} bytes")
        kernels = [
            {
                "name": "emit", "route": "cuda", "source": "gsplat_tpu_torch/csrc/emit.cu",
                "replaces": "gsplat_tpu/ops/binning.py:74", "launches": launches["emit"],
                "max_abs_err": emit_err, "ms": emit_ms, "plain_ms": emit_plain_ms,
                "bound_ms": emit_bound, "bound_by": "bytes", "library_ms": None,
            },
            {
                "name": "rasterize_fwd", "route": "cuda",
                "source": "gsplat_tpu_torch/csrc/rasterize_fwd.cu",
                "replaces": "gsplat_tpu/ops/rasterize_binned.py:61",
                "launches": launches["rasterize_fwd"], "max_abs_err": mx, "ms": fwd_ms,
                "plain_ms": fwd_plain_ms, "bound_ms": max(fwd_bound_bytes, fwd_bound_ops),
                "bound_by": "operations" if fwd_bound_ops >= fwd_bound_bytes else "bytes",
                "library_ms": None,
            },
        ]
        log(f"card: {smi}")
        log(json.dumps({"kernels": kernels}))


def main():
    smi = phase_device()
    import torch

    phase_build()
    phase_kernel_vs_plain()
    phase_main_path(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
