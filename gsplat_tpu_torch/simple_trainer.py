"""Gaussian-splatting trainer over in-memory views (port of the training
step of examples/simple_trainer.py).

A view is a dict with the keys the JAX package's ``Dataset.__getitem__``
returns: ``image`` (float [H, W, 3] in [0, 1]), ``camtoworld`` [4, 4],
``K`` [3, 3] and ``image_id``. The initial points come as arrays (what
the JAX package's COLMAP ``Parser`` reads from disk): ``points`` [N, 3],
``points_rgb`` uint8 [N, 3] and the scene scale.

One step renders through ``rasterization`` with the ``means2d_carrier``
and ``masks=live``, composites the background, takes ``train_loss`` plus
the opacity and scale regularisers, runs ``backward`` (on the binned or
tiled backend: its backward and the gradient-reduce kernels), steps one
``SelectiveAdam`` per parameter with visibility = any camera's radii > 0,
and hands the carrier's gradient to ``DefaultStrategy.step_post_backward``
(or the means' learning rate to ``MCMCStrategy.step_post_backward``).
The pool has a fixed capacity and a ``live`` mask, as in the JAX trainer;
the intersection capacity comes from a probe render and grows from
``slab_required`` (the binned backend) or ``n_isects`` (the tiled one). With ``strategy_name="mcmc"`` the pool holds
``round_up(cap_max, 4096)`` slots and ``MCMCStrategy`` relocates, grows
and perturbs it with the means' current learning rate.

Not ported yet: the COLMAP datasets and the command line, the pose,
appearance and bilateral-grid modules, the depth loss, pool growth, and
multi-GPU training. The 2DGS trainer (simple_trainer_2dgs.py)
overrides the render and geometry-loss hooks of `Runner`.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ._backend import resolve_device
from .losses import psnr as psnr_fn
from .losses import ssim as ssim_fn
from .losses import train_loss
from .modules import knn_distances, rgb_to_sh
from .optimizers import SelectiveAdam
from .rendering import rasterization
from .strategy import DefaultStrategy, MCMCStrategy
from .strategy.mcmc import check_pool


@dataclass
class Config:
    """The JAX trainer's ``Config`` fields that this path reads."""

    max_steps: int = 30_000
    eval_steps: List[int] = field(default_factory=lambda: [7_000, 30_000])
    batch_size: int = 1
    init_type: str = "sfm"  # or "random"
    init_num_pts: int = 100_000
    init_extent: float = 3.0
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    init_opa: float = 0.1
    init_scale: float = 1.0
    ssim_lambda: float = 0.2
    near_plane: float = 0.01
    far_plane: float = 1e10
    antialiased: bool = False
    camera_model: str = "pinhole"
    backend: str = "binned"  # or "tiled", or "oracle" (O(N * pixels) memory: toy scenes)
    random_bkgd: bool = False
    white_bkgd: bool = False
    opacity_reg: float = 0.0
    scale_reg: float = 0.0
    means_lr: float = 1.6e-4
    scales_lr: float = 5e-3
    quats_lr: float = 1e-3
    opacities_lr: float = 5e-2
    sh0_lr: float = 2.5e-3
    shN_lr: float = 2.5e-3 / 20
    strategy_name: str = "default"  # or "mcmc"
    # DefaultStrategy's
    grow_grad2d: float = 0.0002
    refine_start_iter: int = 500
    refine_stop_iter: int = 15_000
    refine_every: int = 100
    reset_every: int = 3000
    absgrad: bool = False
    # MCMCStrategy's
    cap_max: int = 1_000_000
    noise_lr: float = 5e5
    pool_headroom: float = 2.0  # capacity = N0 * headroom, rounded up to 4096
    isect_headroom: float = 1.5
    isect_capacity_init: int = 0  # 0: from the probe render
    tile_size: int = 16  # the port's measured best on the H100 (PERF.md)
    steps_scaler: float = 1.0
    seed: int = 42

    def scale_steps(self):
        """Scale the step counts by ``steps_scaler``, as the JAX trainer's
        command line does before it builds the Runner."""
        if self.steps_scaler != 1.0:
            s = self.steps_scaler
            self.max_steps = int(self.max_steps * s)
            self.eval_steps = [int(v * s) for v in self.eval_steps]
            self.refine_start_iter = int(self.refine_start_iter * s)
            self.refine_stop_iter = int(self.refine_stop_iter * s)
            self.reset_every = int(self.reset_every * s)
            self.refine_every = int(self.refine_every * s)
            self.sh_degree_interval = int(self.sh_degree_interval * s)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def create_splats(
    cfg: Config,
    points: Optional[np.ndarray],  # [N, 3] (sfm init)
    points_rgb: Optional[np.ndarray],  # [N, 3] uint8 (sfm init)
    scene_scale: float,
    cap: int,
    device="cuda",
):
    """Initial splats from the points (or random ones) in a `cap`-slot pool,
    as the JAX trainer's ``create_splats``: kNN scales, logit ``init_opa``,
    random quaternions, sh0 from the colours, zero shN. Dead slots hold
    log-scale and opacity logit -10. Returns (params: dict of leaf tensors
    that require grad, live [cap] bool)."""
    device = resolve_device(device)
    if cfg.init_type == "sfm":
        rgbs = points_rgb.astype(np.float32) / 255.0
    else:
        rng = np.random.default_rng(cfg.seed)
        points = cfg.init_extent * scene_scale * (
            rng.random((cfg.init_num_pts, 3)).astype(np.float32) * 2 - 1
        )
        rgbs = rng.random((cfg.init_num_pts, 3)).astype(np.float32)

    n0 = points.shape[0]
    if n0 > cap:
        raise ValueError(f"{n0} initial points do not fit in a pool of {cap} slots")
    dist = knn_distances(points, k=4)[:, 1:]  # exclude self
    dist_avg = np.sqrt(np.mean(dist**2, axis=-1))
    scales = np.log(np.clip(dist_avg, 1e-7, None) * cfg.init_scale)[:, None]
    scales = np.repeat(scales, 3, axis=1)

    K = (cfg.sh_degree + 1) ** 2
    rng = np.random.default_rng(cfg.seed)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n0] = x
        return out

    arrays = {
        "means": pad(points),
        "scales": pad(scales.astype(np.float32), fill=-10.0),
        "quats": pad(rng.standard_normal((n0, 4)).astype(np.float32), fill=1.0),
        "opacities": pad(
            np.full((n0,), float(np.log(cfg.init_opa / (1 - cfg.init_opa))), np.float32),
            fill=-10.0,
        ),
        "sh0": pad(rgb_to_sh(rgbs)[:, None, :].astype(np.float32)),
        "shN": np.zeros((cap, K - 1, 3), np.float32),
    }
    params = {
        k: torch.as_tensor(v, device=device).requires_grad_(True) for k, v in arrays.items()
    }
    live = torch.arange(cap, device=device) < n0
    return params, live


class Runner:
    """The JAX trainer's ``Runner`` for the default or the MCMC strategy, on
    in-memory views. Runs on CUDA unless ``device="cpu"`` (the kernels'
    plain versions)."""

    def __init__(
        self,
        cfg: Config,
        train_views: Sequence[Mapping],
        points: Optional[np.ndarray],
        points_rgb: Optional[np.ndarray],
        scene_scale: float,
        val_views: Sequence[Mapping] = (),
        device="cuda",
    ):
        if cfg.backend not in ("binned", "tiled", "oracle"):
            raise ValueError(f"backend must be 'binned', 'tiled' or 'oracle', got {cfg.backend!r}")
        if cfg.strategy_name not in ("default", "mcmc"):
            raise ValueError(f"strategy_name must be 'default' or 'mcmc', got {cfg.strategy_name!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.trainset = list(train_views)
        self.valset = list(val_views)
        self.scene_scale = scene_scale * 1.1
        n0 = points.shape[0] if cfg.init_type == "sfm" else cfg.init_num_pts
        if cfg.strategy_name == "mcmc":
            cap = _round_up(cfg.cap_max, 4096)
            check_pool(cap)
        else:
            cap = _round_up(int(n0 * cfg.pool_headroom), 4096)
        self.params, self.live = create_splats(cfg, points, points_rgb, scene_scale, cap, self.device)
        if cfg.strategy_name == "mcmc":
            self.strategy = MCMCStrategy(
                cap_max=cfg.cap_max,
                noise_lr=cfg.noise_lr,
                refine_start_iter=cfg.refine_start_iter,
                refine_stop_iter=int(25_000 * cfg.steps_scaler),
                refine_every=cfg.refine_every,
            )
        else:
            self.strategy = DefaultStrategy(
                grow_grad2d=cfg.grow_grad2d,
                refine_start_iter=cfg.refine_start_iter,
                refine_stop_iter=cfg.refine_stop_iter,
                refine_every=cfg.refine_every,
                reset_every=cfg.reset_every,
                absgrad=cfg.absgrad,
            )
        self.strategy_state = self.strategy.initialize_state(
            cap, scene_scale=self.scene_scale, device=self.device
        )
        self._build_optimizers()
        self.isect_capacity = None
        if cfg.backend != "oracle":
            self.isect_capacity = _round_up(cfg.isect_capacity_init or int(4e6), 4096)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def _build_optimizers(self):
        cfg = self.cfg
        means_lr0 = cfg.means_lr * self.scene_scale

        def means_lr(count):
            # exponential decay to 1% over max_steps; `count` is the
            # optimizer's step count after its increment
            return means_lr0 * 0.01 ** (count / cfg.max_steps)

        lrs = {
            "means": means_lr,
            "scales": cfg.scales_lr,
            "quats": cfg.quats_lr,
            "opacities": cfg.opacities_lr,
            "sh0": cfg.sh0_lr,
            "shN": cfg.shN_lr,
        }
        self.optimizers = {
            k: SelectiveAdam([self.params[k]], lr=lrs[k], eps=1e-15) for k in self.params
        }

    def _rasterize(self, camtoworlds, Ks, width, height, sh_degree, capacity, carrier=None):
        cfg = self.cfg
        p = self.params
        return rasterization(
            p["means"], p["quats"], torch.exp(p["scales"]), torch.sigmoid(p["opacities"]),
            torch.cat([p["sh0"], p["shN"]], dim=1),
            torch.linalg.inv(camtoworlds), Ks, width, height,
            sh_degree=sh_degree, near_plane=cfg.near_plane, far_plane=cfg.far_plane,
            rasterize_mode="antialiased" if cfg.antialiased else "classic",
            backend=cfg.backend, isect_capacity=capacity, means2d_carrier=carrier,
            masks=self.live, tile_size=cfg.tile_size, absgrad=cfg.absgrad,
            camera_model=cfg.camera_model,
        )

    def _raster_train(self, step, camtoworlds, Ks, width, height, sh_degree, carrier):
        """The training step's render. Returns (rgb, alphas, meta, geom),
        `geom` holding what `_geom_losses` reads; the 2DGS runner overrides
        both."""
        render, alphas, meta = self._rasterize(
            camtoworlds, Ks, width, height, sh_degree, self.isect_capacity, carrier
        )
        return render, alphas, meta, {}

    def _geom_losses(self, step, loss, geom, alphas):
        """Geometry loss terms added to the photometric loss (none here)."""
        return loss

    def _as_batch(self, views: Sequence[Mapping]):
        """(pixels [B,H,W,3], camtoworlds [B,4,4], Ks [B,3,3]) on the device;
        a view's arrays may be numpy arrays or tensors."""
        def stack(key):
            return torch.stack([
                torch.as_tensor(v[key], dtype=torch.float32, device=self.device) for v in views
            ])

        return stack("image"), stack("camtoworld"), stack("K")

    def probe_isect_capacity(self) -> None:
        """Size the intersection budget from one truncated render of the
        first view (its ``slab_required``, or on the tiled backend its
        ``n_isects``, is computed before truncation), as the JAX trainer
        does."""
        if self.cfg.backend == "oracle" or self.cfg.isect_capacity_init > 0:
            return
        pixels, camtoworlds, Ks = self._as_batch(self.trainset[:1])
        H, W = pixels.shape[1:3]
        with torch.no_grad():
            _, _, meta = self._rasterize(camtoworlds, Ks, W, H, self.cfg.sh_degree, 4096)
        need = int(meta.get("slab_required", meta["n_isects"]))
        if need > 0:
            self.isect_capacity = _round_up(
                max(int(need * self.cfg.isect_headroom * 1.5), 65536), 4096
            )

    def _grow_isect(self, need: int) -> None:
        """Grow the intersection budget when a step's ``slab_required`` (on
        the tiled backend ``n_isects``) comes within 80% of it (at least
        doubling, as the JAX trainer)."""
        cap = self.isect_capacity
        if cap is None or need <= 0.8 * cap:
            return
        if need > cap:
            print(f"[isect] need {need} exceeded capacity {cap}; this step was truncated")
        self.isect_capacity = _round_up(max(int(need * self.cfg.isect_headroom), 2 * cap), 4096)

    def data_index(self, step: int, slot: int) -> int:
        """The view of batch slot `slot` at `step`: one permutation of the
        views per epoch, as the JAX trainer draws it."""
        flat = step * self.cfg.batch_size + slot
        epoch, pos = divmod(flat, len(self.trainset))
        perm = np.random.default_rng(self.cfg.seed + 7919 * epoch).permutation(len(self.trainset))
        return int(perm[pos])

    def train_step(self, step: int) -> Dict:
        """One training step. Returns {"loss" (a 0-d tensor on the device),
        "image_ids", "refined", "slab_required"}; "slab_required" is the
        capacity the step needed (``n_isects`` on the tiled backend, 0 on
        the oracle)."""
        cfg = self.cfg
        views = [self.trainset[self.data_index(step, i)] for i in range(cfg.batch_size)]
        pixels, camtoworlds, Ks = self._as_batch(views)
        B, H, W = pixels.shape[:3]
        sh_degree = min(step // cfg.sh_degree_interval, cfg.sh_degree)
        cap = self.live.shape[0]

        carrier = torch.zeros((B, cap, 2), device=self.device, requires_grad=True)
        render, alphas, meta, geom = self._raster_train(
            step, camtoworlds, Ks, W, H, sh_degree, carrier
        )
        if cfg.random_bkgd:
            render = render + torch.rand((1, 1, 1, 3), generator=self.generator, device=self.device) * (1.0 - alphas)
        elif cfg.white_bkgd:
            render = render + (1.0 - alphas)
        loss = train_loss(render, pixels, cfg.ssim_lambda)
        loss = self._geom_losses(step, loss, geom, alphas)
        live = self.live
        if cfg.opacity_reg > 0.0:
            op = torch.where(live, torch.sigmoid(self.params["opacities"]), 0.0)
            loss = loss + cfg.opacity_reg * op.sum() / live.sum()
        if cfg.scale_reg > 0.0:
            sc = torch.where(live[:, None], torch.exp(self.params["scales"]), 0.0)
            loss = loss + cfg.scale_reg * sc.sum() / (3 * live.sum())
        loss.backward()

        visibility = (meta["radii"] > 0).any(dim=0)  # [cap]
        for opt in self.optimizers.values():
            opt.step(visibility)
            opt.zero_grad(set_to_none=True)
        if isinstance(self.strategy, MCMCStrategy):
            lr = cfg.means_lr * self.scene_scale * 0.01 ** (step / cfg.max_steps)
            refined = self.strategy.step_post_backward(
                self.params, self.live, self.optimizers, self.strategy_state, step, lr,
                generator=self.generator,
            )
        else:
            # n_cameras is the batch: the reference normalises the
            # densification gradients per camera and multiplies by the batch
            refined = self.strategy.step_post_backward(
                self.params, self.live, self.optimizers, self.strategy_state, step,
                {"radii": meta["radii"], "width": W, "height": H, "n_cameras": B},
                carrier.grad, generator=self.generator,
            )
        need = int(meta.get("slab_required", meta.get("n_isects", 0)))
        self._grow_isect(need)
        return {
            "loss": loss.detach(),
            "image_ids": [v["image_id"] for v in views],
            "refined": refined,
            "slab_required": need,
        }

    def train(self, log_every: int = 100) -> List[Dict]:
        """Probe the intersection budget, then ``max_steps`` steps with
        evaluations at ``eval_steps``. Returns each step's output."""
        self.probe_isect_capacity()
        t0 = time.time()
        outs = []
        for step in range(self.cfg.max_steps):
            outs.append(self.train_step(step))
            if step % log_every == 0:
                print(
                    f"step {step}: loss={float(outs[-1]['loss']):.4f} "
                    f"n_live={int(self.live.sum())} ({time.time() - t0:.0f}s)"
                )
            if step + 1 in self.cfg.eval_steps and self.valset:
                print("EVAL", self.eval(step + 1))
        return outs

    @torch.no_grad()
    def render(self, camtoworlds, Ks, width, height, sh_degree=None):
        sh = self.cfg.sh_degree if sh_degree is None else sh_degree
        return self._rasterize(camtoworlds, Ks, width, height, sh, self.isect_capacity)

    @torch.no_grad()
    def eval(self, step: int) -> Dict:
        """PSNR and SSIM over the validation views."""
        psnrs, ssims = [], []
        t0 = time.time()
        for view in self.valset:
            pixels, camtoworlds, Ks = self._as_batch([view])
            H, W = pixels.shape[1:3]
            render, alphas, _ = self.render(camtoworlds, Ks, W, H)
            if self.cfg.white_bkgd:
                render = render + (1.0 - alphas)
            render = torch.clamp(render, 0.0, 1.0)
            psnrs.append(float(psnr_fn(render, pixels)))
            ssims.append(float(ssim_fn(render, pixels)))
        return {
            "step": step,
            "psnr": float(np.mean(psnrs)) if psnrs else math.nan,
            "ssim": float(np.mean(ssims)) if ssims else math.nan,
            "num_GS": int(self.live.sum()),
            "per_image_s": (time.time() - t0) / max(len(self.valset), 1),
        }
