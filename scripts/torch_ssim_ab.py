"""SSIM's filter on the card: the port's two separable 11-tap depthwise
passes (gsplat_tpu_torch/losses.py) against one 11x11 depthwise
convolution, the form the port used before.

    python3 scripts/torch_ssim_ab.py [--width 1920] [--height 1080] [--rounds 7] [--out FILE]

At a training frame's shape ([1, H, W, 3] images, the loss's SSIM term,
cuDNN with TF32 off as chip_smoke.py trains), each variant's forward and
backward (the gradient w.r.t. the rendered image) is timed with CUDA events
in alternating rounds (the median of --rounds, 10 calls a round, after a
warm-up), and profiled once for its kernels' device time. Each variant's
SSIM and gradient are held against a float64 SSIM of the same inputs.
Prints one JSON object (also written to --out) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from gsplat_tpu_torch import losses  # noqa: E402


def ssim_one_conv(torch, img0, img1, window_size=11, sigma=1.5):
    """SSIM with each filter as one 11x11 depthwise convolution."""
    import torch.nn.functional as F

    g = torch.as_tensor(losses._gaussian_1d(window_size, sigma), device=img0.device, dtype=img0.dtype)
    win = torch.outer(g, g)
    C = img0.shape[-1]

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), win.expand(C, 1, window_size, window_size), groups=C).permute(0, 2, 3, 1)

    c1, c2 = 0.01**2, 0.03**2
    mu0, mu1 = filt(img0), filt(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = filt(img0 * img0) - mu00
    s11 = filt(img1 * img1) - mu11
    s01 = filt(img0 * img1) - mu01
    return (((2 * mu01 + c1) * (2 * s01 + c2)) / ((mu00 + mu11 + c1) * (s00 + s11 + c2))).mean()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_ssim_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (1, a.height, a.width, 3)
    gt = torch.rand(shape, generator=gen, device=dev)
    # a render near the target, as late in training
    base = (gt + 0.1 * torch.randn(shape, generator=gen, device=dev)).clamp(0, 1)
    variants = {"separable (port)": losses.ssim, "one 11x11 conv": lambda x, y: ssim_one_conv(torch, x, y)}

    x64 = base.double().requires_grad_(True)
    v64 = ssim_one_conv(torch, x64, gt.double())
    (g64,) = torch.autograd.grad(v64, x64)

    def step(fn):
        x = base.detach().clone().requires_grad_(True)
        (1.0 - fn(x, gt)).backward()
        return x

    res = {"card": smi, "shape": list(shape), "variants": {}}
    for name, fn in variants.items():
        x = base.detach().clone().requires_grad_(True)
        v = fn(x, gt)
        (g,) = torch.autograd.grad(v, x)
        kern = chip_smoke.device_time_by_kernel(torch, lambda: step(fn))
        res["variants"][name] = {
            "ssim_err_vs_f64": abs(float(v) - float(v64)),
            "grad_max_abs_err_vs_f64": float((g.double() - g64).abs().max()),
            "grad_max_abs_f64": float(g64.abs().max()),
            "device_ms_by_kernel": {k[:80]: ms for k, ms in sorted(kern.items(), key=lambda kv: -kv[1])[:8]},
            "device_ms": sum(kern.values()) if kern else None,
            "ms_rounds": [],
        }
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(a.rounds):
        for name, fn in variants.items():
            step(fn)
            torch.cuda.synchronize()
            start.record()
            for _ in range(10):
                step(fn)
            end.record()
            torch.cuda.synchronize()
            res["variants"][name]["ms_rounds"].append(start.elapsed_time(end) / 10)
    for v in res["variants"].values():
        v["ms_median"] = sorted(v["ms_rounds"])[len(v["ms_rounds"]) // 2]
    line = json.dumps(res)
    print(line, flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
