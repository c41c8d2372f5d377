"""Fit random Gaussians to one image with Adam on the MSE (port of
examples/image_fitting.py).

    python -m gsplat_tpu_torch.image_fitting --max-steps 2000 [--img-path IMG]

As the JAX example: an identity camera at z = 8 with a 90-degree field of
view, means uniform in [-1, 1]^3, log-scales of uniform(0.3, 1.3), normal
quaternions, opacity logits 1, colour logits uniform in [0, 1], sigmoid
colours; the default target is the RGB gradient with a white centre
square. The backend is binned on the card and the oracle on the CPU
(``--backend`` picks another).
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ._backend import resolve_device
from .rendering import rasterization


def make_target(height: int, width: int, path: Optional[str] = None) -> np.ndarray:
    """[H, W, 3] float32 in [0, 1]: the image at `path` (a PNG, or any
    format PIL reads), else the gradient with a white centre square."""
    if path:
        from .datasets.image_io import load_image

        return load_image(path).astype(np.float32) / 255.0
    img = np.zeros((height, width, 3), np.float32)
    img[..., 0] = np.linspace(0, 1, width)[None, :]
    img[..., 1] = np.linspace(0, 1, height)[:, None]
    img[..., 2] = 1.0
    img[height // 4 : 3 * height // 4, width // 4 : 3 * width // 4] = 1.0
    return img


def init_params(num_points: int, generator: Optional[torch.Generator] = None, device="cuda") -> Dict[str, torch.Tensor]:
    """The initial values, drawn on the CPU from `generator`."""
    n, bd = num_points, 2.0
    arrays = {
        "means": bd * (torch.rand((n, 3), generator=generator) - 0.5),
        "scales": torch.log(torch.rand((n, 3), generator=generator) + 0.3),
        "quats": torch.randn((n, 4), generator=generator),
        "opacities": torch.ones((n,)),  # logits: sigmoid ~0.73
        "colors": torch.rand((n, 3), generator=generator),
    }
    device = resolve_device(device)
    return {k: v.to(device) for k, v in arrays.items()}


def fit(
    target: torch.Tensor,  # [H, W, 3]
    params: Dict[str, torch.Tensor],
    max_steps: int,
    lr: float = 0.01,
    backend: str = "",
    log_every: int = 100,
) -> Dict:
    """Adam on the MSE of the render against `target`, from `params`, on
    the target's device. Returns {"params", "losses" (per step), "image"
    (the last step's render), "seconds"}."""
    device = target.device
    H, W = target.shape[:2]
    backend = backend or ("binned" if device.type == "cuda" else "oracle")
    N = params["means"].shape[0]
    isect_capacity = 4 * N * 16 if backend != "oracle" else None
    focal = 0.5 * W / math.tan(0.5 * math.pi / 2.0)
    viewmats = torch.eye(4, device=device)[None].clone()
    viewmats[0, 2, 3] = 8.0
    Ks = torch.tensor([[[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]]], dtype=torch.float32, device=device)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(params.values(), lr=lr, eps=1e-8)
    losses, img = [], None
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it in range(max_steps):
        render, _, _ = rasterization(
            params["means"], params["quats"], torch.exp(params["scales"]),
            torch.sigmoid(params["opacities"]), torch.sigmoid(params["colors"]),
            viewmats, Ks, W, H, backend=backend, isect_capacity=isect_capacity,
        )
        img = render[0]
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(loss.detach())
        if log_every and (it % log_every == 0 or it == max_steps - 1):
            print(f"step {it}: mse={float(losses[-1]):.6f}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"params": {k: v.detach() for k, v in params.items()}, "losses": [float(x) for x in losses],
            "image": img.detach(), "seconds": seconds}


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> Dict:
    """The JAX example's command line. Returns fit's output with "psnr0"
    and "psnr" (of the first and last step's MSE) and "steps_per_s"."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--num-points", type=int, default=2000)
    ap.add_argument("--max-steps", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--backend", default="", choices=["", "oracle", "binned", "tiled"])
    ap.add_argument("--img-path", type=str, default=None)
    ap.add_argument("--save-path", type=str, default=None, help="write the last render here as a PNG")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    device = resolve_device(device)
    target = torch.as_tensor(make_target(args.height, args.width, args.img_path), device=device)
    params = init_params(args.num_points, torch.Generator().manual_seed(args.seed), device)
    out = fit(target, params, args.max_steps, args.lr, args.backend)
    out["psnr0"] = -10 * math.log10(out["losses"][0])
    out["psnr"] = -10 * math.log10(out["losses"][-1])
    out["steps_per_s"] = args.max_steps / out["seconds"]
    print(f"done: {args.max_steps} steps in {out['seconds']:.1f}s ({out['steps_per_s']:.1f} steps/s), "
          f"PSNR {out['psnr0']:.2f} -> {out['psnr']:.2f}")
    if args.save_path:
        from .datasets.image_io import write_png

        write_png(args.save_path, (torch.clamp(out["image"], 0, 1) * 255).to(torch.uint8).cpu().numpy())
        print("saved", args.save_path)
    return out


if __name__ == "__main__":
    main()
