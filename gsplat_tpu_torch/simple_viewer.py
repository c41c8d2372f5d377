"""Offline viewer: render trained splats along a camera path into PNG
frames (port of examples/simple_viewer.py).

    python -m gsplat_tpu_torch.simple_viewer --ckpt results/garden/ckpt_7000.npz \\
        --data-dir data/garden --output-dir renders/ --n-frames 60
    python -m gsplat_tpu_torch.simple_viewer --scene-grid 5 --traj ellipse --n-frames 8

The splats come from a checkpoint (the trainer's ``splat/`` keys or the
viewer's unprefixed ones, through `splats_from_numpy`) or, without
``--ckpt``, from the garden fixture (``--scene-grid`` replicates it). The
cameras are a COLMAP scene's (``--data-dir``), the fixture's, or an orbit
around the splats; the path through them is interpolated or an ellipse
(`datasets.traj`). Each frame is ``frame_{i:04d}.png`` (the port's own PNG
writer); with ``--video`` the frames also go into ``traj.mp4`` through
imageio where it can be imported and write one, else into
``traj_frames.npz``. Renders through the binned backend, its budget from
a first render, on the card unless ``--cpu`` or ``main(device="cpu")``
asks for the CPU (there the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ._backend import resolve_device
from .checkpoint import splats_from_numpy
from .datasets.image_io import write_png
from .datasets.traj import generate_ellipse_path_z, generate_interpolated_path
from .rendering import rasterization

PROBE_CAPACITY = 512  # the first render's binned budget: it reports what a frame needs


class SplatRenderer:
    """Renders checkpoint-layout splats (log-scales, logit opacities,
    ``sh0`` / ``shN``; or ``colors`` [N, 3], rendered as they are, as the
    interactive viewer's fixture is) as the JAX trainer's ``Runner.render``
    does, through the binned backend on the splats' device. The
    intersection budget starts from a probe render and grows to any
    frame's ``slab_required`` + 1024, that frame rendered again: no frame
    is truncated."""

    def __init__(self, splats: Dict[str, torch.Tensor], live: Optional[torch.Tensor], sh_degree: Optional[int]):
        self.means, self.quats = splats["means"], splats["quats"]
        self.scales = torch.exp(splats["scales"])
        self.opacities = torch.sigmoid(splats["opacities"])
        if "colors" in splats:
            self.colors, self.sh_degree = splats["colors"], None
        else:
            self.colors = torch.cat([splats["sh0"], splats["shN"]], dim=1)
            # the degree the checkpoint carries caps the requested one
            deg_avail = int(np.sqrt(self.colors.shape[1])) - 1
            self.sh_degree = None if sh_degree is None else min(sh_degree, deg_avail)
        self.live = live
        self.capacity = PROBE_CAPACITY

    @torch.no_grad()
    def __call__(self, viewmats: torch.Tensor, Ks: torch.Tensor, width: int, height: int, render_mode: str = "RGB"):
        """(render_colors, render_alphas, meta) of the cameras."""
        while True:
            out = rasterization(
                self.means, self.quats, self.scales, self.opacities, self.colors, viewmats, Ks, width, height,
                sh_degree=self.sh_degree, masks=self.live, render_mode=render_mode, backend="binned",
                isect_capacity=self.capacity,
            )
            need = int(out[2]["slab_required"])
            if need <= self.capacity:
                return out
            self.capacity = need + 1024


def load_splats(ckpt: Optional[str], scene_grid: int, device):
    """(splats, live, fixture cameras or None): a checkpoint's arrays, or
    the garden fixture in the checkpoint layout."""
    if ckpt:
        with np.load(ckpt) as blob:
            arrays = {k: blob[k] for k in blob.files}
        splats, live = splats_from_numpy(arrays, device=device)
        return splats, live, None
    from ._helper import load_test_data

    means, quats, scales, opacities, colors_rgb, viewmats, Ks, w, h = load_test_data(scene_grid=scene_grid)
    print(f"fixture: {means.shape[0]} Gaussians (grid {scene_grid})", flush=True)
    # the checkpoint layout holds log-scales and logit opacities: the
    # fixture's linear values are inverted so one render path serves both
    arrays = {
        "means": means, "quats": quats, "scales": np.log(scales),
        "opacities": np.log(opacities / np.clip(1.0 - opacities, 1e-6, None)),
        "sh0": colors_rgb[:, None, :], "shN": np.zeros((means.shape[0], 0, 3), np.float32),
    }
    splats, live = splats_from_numpy(arrays, device=device)
    return splats, live, (np.linalg.inv(viewmats).astype(np.float32), Ks[0], w, h)


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=None, help="ckpt_*.npz to view; omitted: the garden test fixture")
    ap.add_argument("--scene-grid", type=int, default=1,
                    help="replicate the fixture scene into an odd NxN grid (only without --ckpt)")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--data-factor", type=int, default=4)
    ap.add_argument("--output-dir", default="renders")
    ap.add_argument("--n-frames", type=int, default=60)
    ap.add_argument("--traj", default="interp", choices=["interp", "ellipse"])
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--video", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> str:
    """Render the frames; returns the output directory. ``--cpu`` or
    ``device="cpu"`` runs on the CPU."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else device)
    splats, live, fixture_cams = load_splats(args.ckpt, args.scene_grid, device)

    if args.data_dir:
        from .datasets import Parser

        parser = Parser(args.data_dir, factor=args.data_factor, normalize=True)
        c2w_all = parser.camtoworlds
        K = parser.Ks_dict[parser.camera_ids[0]]
        W, H = parser.imsize_dict[parser.camera_ids[0]]
    elif fixture_cams is not None:
        c2w_all, K, W, H = fixture_cams
    else:
        # orbit around the live splats' median
        pts = splats["means"] if live is None else splats["means"][live]
        pts = pts.cpu().numpy()
        center = np.median(pts, axis=0)
        r = 2.0 * np.median(np.abs(pts - center))
        c2w_all = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
        for i, th in enumerate(np.linspace(0, 2 * np.pi, 8, endpoint=False)):
            c2w_all[i, :3, 3] = center + r * np.array([np.cos(th), np.sin(th), 0.3])
        W = H = 512
        K = np.array([[400.0, 0, W / 2], [0, 400.0, H / 2], [0, 0, 1]], np.float32)
    if args.width:
        K = np.array(K, np.float32)
        K[0] *= args.width / W
        K[1] *= (args.height or args.width) / H
        W, H = args.width, args.height or args.width

    if args.traj == "ellipse":
        poses = generate_ellipse_path_z(c2w_all[:, :3, :], n_frames=args.n_frames)
    else:
        poses = generate_interpolated_path(
            c2w_all[:: max(len(c2w_all) // 8, 1), :3, :], n_interp=max(args.n_frames // 7, 1)
        )[: args.n_frames]
    c2w = np.tile(np.eye(4, dtype=np.float32), (len(poses), 1, 1))
    c2w[:, :3, :4] = poses

    os.makedirs(args.output_dir, exist_ok=True)
    render = SplatRenderer(splats, live, args.sh_degree)
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=device)[None]
    frames = []
    for i in range(len(c2w)):
        viewmat = torch.linalg.inv(torch.as_tensor(c2w[i : i + 1], device=device))
        rgb, _, _ = render(viewmat, Kt, W, H)
        img = (torch.clamp(rgb[0], 0, 1) * 255).to(torch.uint8).cpu().numpy()
        write_png(os.path.join(args.output_dir, f"frame_{i:04d}.png"), img)
        frames.append(img)
        print(f"rendered frame {i + 1}/{len(c2w)}", flush=True)

    if args.video:
        out = os.path.join(args.output_dir, "traj.mp4")
        try:
            import imageio.v2 as imageio

            imageio.mimwrite(out, frames, fps=24)
            print(f"wrote {out}")
        except (ImportError, ValueError) as e:  # no imageio, or no mp4 writer for it
            out = out.replace(".mp4", "_frames.npz")
            np.savez_compressed(out, frames=np.stack(frames))
            print(f"mp4 writer unavailable ({str(e).splitlines()[0]}); wrote {out}")
    return args.output_dir


if __name__ == "__main__":
    main()
