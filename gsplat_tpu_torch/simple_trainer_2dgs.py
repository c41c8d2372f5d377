"""2DGS (surfel) trainer with the normal-consistency and distortion losses
(port of examples/simple_trainer_2dgs.py).

    python -m gsplat_tpu_torch.simple_trainer_2dgs --data-dir DIR --data-factor 1

`Runner2DGS` is the 3DGS `Runner` (pose, appearance and bilateral-grid
modules, the depth loss, pool growth, checkpoints and resume, the COLMAP
scene and its result directory) with the render hooks swapped for
``rasterization_2dgs`` (``render_mode="RGB+ED"``: the normal-consistency
loss needs the expected depth, which is also the depth loss's) and the two
geometry losses added after their warm-ups. Every render of the runner
goes through the surfel rasterizer, so the intersection-capacity probe
sizes the budget from a surfel render: a 2DGS stream is many times longer
than a 3DGS one of the same points (no tight cull). It trains with the
default strategy only, as the JAX 2DGS trainer does. With
``cfg.distributed`` the surfel render goes through
``rasterization_2dgs(distributed=True)`` (``packed``: the packed exchange)
and its six images are gathered into the whole batch, so the geometry
losses read the whole normals, normals from depth and distortion, as the
JAX trainer's do under its mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .rendering import rasterization_2dgs
from .simple_trainer import Config, Runner, parse_config, run_main


class Runner2DGS(Runner):
    """The 3DGS runner with the 2DGS render path and geometry losses. Runs
    on CUDA unless ``device="cpu"`` (the kernels' plain versions)."""

    def __init__(
        self,
        cfg: Config,
        train_views: Sequence[Mapping],
        points: Optional[np.ndarray],
        points_rgb: Optional[np.ndarray],
        scene_scale: float,
        val_views: Sequence[Mapping] = (),
        device="cuda",
        group=None,
        normal_lambda: float = 5e-2,
        dist_lambda: float = 1e-2,
        normal_start: int = 7000,
        dist_start: int = 3000,
    ):
        if cfg.strategy_name != "default":
            raise ValueError(f"Runner2DGS trains with the default strategy only, got {cfg.strategy_name!r}")
        self.normal_lambda = normal_lambda
        self.dist_lambda = dist_lambda
        self.normal_start = normal_start
        self.dist_start = dist_start
        # the JAX trainer caps the surfel tile at 16
        cfg = dataclasses.replace(cfg, tile_size=min(cfg.tile_size, 16))
        super().__init__(cfg, train_views, points, points_rgb, scene_scale, val_views, device, group)

    def _render_2dgs(self, viewmats, Ks, width, height, colors, sh_degree, capacity,
                     carrier=None, distloss=False, packed=False, whole=True):
        """`rasterization_2dgs`'s 7-tuple; distributed, its six images of the
        whole batch on every rank (``whole=False``: the rank's block) and
        the rank's meta."""
        cfg = self.cfg
        p = self.params
        out = rasterization_2dgs(
            p["means"], p["quats"], torch.exp(p["scales"]), torch.sigmoid(p["opacities"]), colors,
            viewmats, Ks, width, height,
            sh_degree=sh_degree, near_plane=cfg.near_plane, far_plane=cfg.far_plane,
            densify_carrier=carrier, masks=self.live, tile_size=cfg.tile_size,
            backend=self.backend, isect_capacity=capacity, render_mode="RGB+ED",
            distloss=distloss, **self._dist_kwargs(packed),
        )
        if not whole:
            return out
        C = viewmats.shape[0]
        return tuple(self._whole(x, C, height) for x in out[:6]) + (out[6],)

    def _rasterize(self, viewmats, Ks, width, height, colors, sh_degree, capacity, carrier=None,
                   render_mode="RGB", packed=False, whole=True):
        """Surfel render for the probe, `render` and `eval`: (rgb, alphas,
        meta)."""
        out = self._render_2dgs(viewmats, Ks, width, height, colors, sh_degree, capacity, carrier, packed=packed,
                                whole=whole)
        return out[0][..., :3], out[1], out[6]

    def _raster_train(self, step, viewmats, Ks, width, height, colors, sh_degree, carrier):
        render, alphas, normals, normals_depth, distort, _, meta = self._render_2dgs(
            viewmats, Ks, width, height, colors, sh_degree, self.isect_capacity, carrier,
            distloss=step >= self.dist_start, packed=self.cfg.packed,
        )
        geom = {"normals": normals, "normals_depth": normals_depth, "distort": distort}
        return render[..., :3], alphas, render[..., -1:], meta, geom

    def _geom_losses(self, step, loss, geom, alphas):
        if step >= self.normal_start:
            # normal consistency against the depth-derived normals, which the
            # trainer (not the rasterizer) modulates by alpha
            normals_depth = geom["normals_depth"] * alphas.detach()
            n = geom["normals"] / torch.clamp_min(
                torch.linalg.norm(geom["normals"], dim=-1, keepdim=True), 1e-6
            )
            ncons = 1.0 - (n * normals_depth).sum(dim=-1)
            loss = loss + self.normal_lambda * ncons.mean()
        if step >= self.dist_start:
            loss = loss + self.dist_lambda * geom["distort"].mean()
        return loss

    @torch.no_grad()
    def eval_geometry(self, step: int) -> Dict:
        """Mean normal-consistency error and distortion over the validation
        views."""
        ncs, dists = [], []
        for view in self.valset:
            pixels, camtoworlds, Ks = self._as_batch([view])
            H, W = pixels.shape[1:3]
            colors, sh = self._colors(camtoworlds, None, self.cfg.sh_degree)
            _, alphas, normals, normals_depth, distort, _, _ = self._render_2dgs(
                torch.linalg.inv(camtoworlds), Ks, W, H, colors, sh, self.isect_capacity
            )
            n = normals / torch.clamp_min(torch.linalg.norm(normals, dim=-1, keepdim=True), 1e-6)
            ncs.append(float((1.0 - (n * normals_depth * alphas).sum(dim=-1)).mean()))
            dists.append(float(distort.mean()))
        stats = {
            "step": step,
            "normal_consistency": float(np.mean(ncs)) if ncs else float("nan"),
            "distortion": float(np.mean(dists)) if dists else float("nan"),
        }
        self._log(f"EVAL_GEOM {stats}")
        return stats


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> Runner2DGS:
    """The JAX 2DGS trainer's ``main``: train from the COLMAP scene, then
    ``eval`` and ``eval_geometry`` at ``max_steps`` (with
    ``--distributed``, as one rank, as `simple_trainer.main`). Returns the
    Runner."""
    cfg = parse_config(argv)

    def finish(runner):
        runner.eval(cfg.max_steps)
        runner.eval_geometry(cfg.max_steps)

    return run_main(Runner2DGS, cfg, device, finish)


if __name__ == "__main__":
    main()
