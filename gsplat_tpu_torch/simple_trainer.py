"""Gaussian-splatting trainer (port of examples/simple_trainer.py).

    python -m gsplat_tpu_torch.simple_trainer default --data-dir DIR --data-factor 1
    python -m gsplat_tpu_torch.simple_trainer mcmc --data-dir DIR --cap-max 1000000

The command line (`parse_config`, `main`) is the JAX trainer's: every
``Config`` field is a flag, the positional argument picks the strategy,
and ``scale_steps()`` applies ``--steps-scaler``. `Runner.from_colmap`
reads a COLMAP directory (``datasets.Parser`` / ``Dataset``, the split
``image % test_every``) and writes the JAX trainer's results into
``result_dir``: ``cfg.json``, ``stats.jsonl`` every 100 steps,
``val_step{N}.json`` at ``eval_steps``, ``ckpt_{N}.npz`` and
``splats_{N}.ply`` at ``save_steps``, and with ``render_traj`` a
fly-through (an mp4 where imageio can write one, else ``_frames.npz``).
With ``compression="png"`` each save also compresses the live splats
(`compression.PngCompression`) into ``compression_{N}/``, evaluates the
round trip and writes ``compression_{N}/report.json``; with
``lpips_weights`` (an ``.npz`` or a torch checkpoint, `lpips.load_lpips_params`)
the evaluation adds ``"lpips"`` (``lpips_net`` alex or vgg).
The `Runner` constructor itself takes in-memory views, each a dict with
the keys ``Dataset`` items have (``image`` float [H, W, 3] in [0, 1],
``camtoworld`` [4, 4], ``K`` [3, 3], ``image_id``; ``points`` /
``depths`` for the depth loss).

One step renders through ``rasterization`` with the ``means2d_carrier``
and ``masks=live`` (``render_mode="RGB+ED"`` with the depth loss), after
the pose module's correction of the cameras and with the appearance
module's colours where those are on; masks the render with a view's
pixel mask, slices the bilateral grid, composites the background, takes
``train_loss`` plus the depth, grid-TV and regulariser terms, runs
``backward`` (on the binned or tiled backend: its backward and
gradient-reduce kernels), steps one ``SelectiveAdam`` per splat parameter
(visibility = any camera's radii > 0) and the aux modules' optimizers
(``AdamW`` for pose and appearance, ``Adam`` for the grid), and hands the
carrier's gradient to ``DefaultStrategy`` (or the means' learning rate to
``MCMCStrategy``). After the step the pool grows when its live share
passes ``pool_grow_at`` (default strategy), and the intersection budget
when a step's ``slab_required`` (tiled: ``n_isects``) nears it. Every
random draw of a step comes from a generator seeded by (seed, step), so a
resumed run draws what the uninterrupted one drew.

Multi-GPU training (``distributed``, with ``packed`` the packed exchange)
computes the JAX trainer's global step under its ``P("gauss")`` mesh with
one process a rank:

    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m gsplat_tpu_torch.simple_trainer default --distributed ...

Rank r holds rows ``[r*cap/n, (r+1)*cap/n)`` of the pool: the splats,
``live``, the Adam moments and the strategy's per-slot state. Every rank
builds the whole batch, renders it through
``rasterization(distributed=True)`` and gathers the ranks' blocks into the
whole batch (`distributed.gather_blocks`, whose backward hands each rank
its own block's gradient), so every rank computes JAX's loss on the whole
batch; the regularisers sum over the whole pool. The pose and appearance
modules act before the exchange, so their gradients are summed over the
ranks; the bilateral grid acts after the gather and its gradient is
already whole on every rank. Adam, the densification statistics, the
opacity reset and MCMC's noise act on each rank's rows; a refine and a
pool growth run the single-device code on the whole pool on rank 0 and
scatter the rows back. Rank 0 alone writes the result directory, and a
checkpoint is the single-device one (`save` gathers, `load` slices).

Every ``tb_every`` steps (and at each evaluation) the trainer logs the
JAX trainer's TensorBoard scalars into ``result_dir/tb`` through
``torch.utils.tensorboard``: ``train/loss``, ``train/num_GS``,
``train/n_isects``, ``train/mem_params_mb`` and, with ``tb_save_image``,
``train/render`` (the step's first view beside its render); ``val/psnr``,
``val/ssim``, ``val/lpips`` and ``val/num_GS``. Where TensorBoard cannot be
imported the options write nothing, as in the JAX trainer; the port does
not depend on it. The 2DGS trainer (simple_trainer_2dgs.py)
overrides the render and geometry-loss hooks of `Runner`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ._backend import resolve_device
from .bilagrid import BilateralGrid
from .checkpoint import aux_modules_from_numpy, splats_from_numpy
from .distributed import all_sum, broadcast_generator, gather_blocks, gather_rows, scatter_rows, shard_rows, world
from .losses import psnr as psnr_fn
from .losses import ssim as ssim_fn
from .losses import train_loss
from .modules import AppearanceOptModule, CameraOptModule, knn_distances, rgb_to_sh
from .optimizers import SelectiveAdam
from .rendering import rasterization
from .strategy import DefaultStrategy, MCMCStrategy
from .strategy.mcmc import check_pool
from .utils import save_ply

P_MAX = 4096  # a view's points read by the depth loss
# the fields run_compression compresses, in the JAX trainer's order
COMPRESSED_KEYS = ("means", "scales", "quats", "opacities", "sh0", "shN")


@dataclass
class Config:
    """The JAX trainer's ``Config``: its fields, names and defaults, but
    ``tile_size`` (16, the port's measured best on the H100)."""

    data_dir: str = "data/360_v2/garden"
    data_factor: int = 4
    result_dir: str = "results/garden"
    test_every: int = 8
    max_steps: int = 30_000
    eval_steps: List[int] = field(default_factory=lambda: [7_000, 30_000])
    save_steps: List[int] = field(default_factory=lambda: [7_000, 30_000])
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
    # auto: binned on the card, the oracle (O(N * pixels) memory: toy
    # scenes) on the CPU; or binned, tiled, oracle
    backend: str = "auto"
    random_bkgd: bool = False
    white_bkgd: bool = False
    # an LPIPS weights file (.npz or a torch checkpoint): eval adds "lpips";
    # a missing file is reported and eval scores without it, as in JAX
    lpips_weights: str = ""
    lpips_net: str = "alex"
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
    # aux modules
    pose_opt: bool = False
    pose_opt_lr: float = 1e-5
    pose_opt_reg: float = 1e-6
    # read nowhere, as in the JAX trainer (which only makes a key for it)
    pose_noise: float = 0.0
    app_opt: bool = False
    app_opt_lr: float = 1e-3
    app_opt_reg: float = 1e-6
    app_embed_dim: int = 16
    app_feature_dim: int = 32
    use_bilateral_grid: bool = False
    bilateral_grid_lr: float = 2e-3
    bilateral_tv_lambda: float = 10.0
    depth_loss: bool = False
    depth_lambda: float = 1e-2
    # multi-GPU training: the pool sharded by rows over a torch.distributed
    # group, one process a rank
    distributed: bool = False
    # with distributed: the packed exchange (each rank's visible rows in a
    # pack_capacity buffer, grown from meta["pack_required"])
    packed: bool = False
    resume: str = ""  # a ckpt_*.npz to resume from
    render_traj: bool = False
    render_traj_path: str = "interp"  # or "ellipse"
    compression: str = ""  # "png": compress the live splats at every save
    tb_every: int = 100  # TensorBoard scalars every this many steps (0: none)
    tb_save_image: bool = False  # with them the step's first view and its render
    # pool management
    pool_headroom: float = 2.0  # initial capacity = N0 * headroom, rounded up to 4096
    pool_grow_at: float = 0.9  # grow the pool when the live share passes this
    isect_headroom: float = 1.5
    pool_grow_max: float = 8.0  # at most this factor per growth
    isect_capacity_init: int = 0  # 0: from the probe render
    steps_scaler: float = 1.0
    tile_size: int = 16
    seed: int = 42

    def scale_steps(self):
        """Scale the step counts by ``steps_scaler``, as the command line
        does before it builds the Runner."""
        if self.steps_scaler != 1.0:
            s = self.steps_scaler
            self.max_steps = int(self.max_steps * s)
            self.eval_steps = [int(v * s) for v in self.eval_steps]
            self.save_steps = [int(v * s) for v in self.save_steps]
            self.refine_start_iter = int(self.refine_start_iter * s)
            self.refine_stop_iter = int(self.refine_stop_iter * s)
            self.reset_every = int(self.reset_every * s)
            self.refine_every = int(self.refine_every * s)
            self.sh_degree_interval = int(self.sh_degree_interval * s)


def parse_config(argv: Optional[Sequence[str]] = None) -> Config:
    """The JAX trainer's command line: a flag per field, the strategy as
    the positional argument, then ``scale_steps()``."""
    cfg = Config()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("strategy", nargs="?", default="default", choices=["default", "mcmc"])
    for f_ in cfg.__dataclass_fields__.values():
        if f_.name == "strategy_name":
            continue
        flag = "--" + f_.name.replace("_", "-")
        value = getattr(cfg, f_.name)
        if isinstance(value, bool):
            ap.add_argument(flag, action="store_true", default=value)
        elif isinstance(value, list):
            ap.add_argument(flag, type=int, nargs="*", default=value)
        else:
            ap.add_argument(flag, type=type(value), default=value)
    for k, v in vars(ap.parse_args(argv)).items():
        setattr(cfg, "strategy_name" if k == "strategy" else k, v)
    cfg.scale_steps()
    return cfg


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def check_distributed(cfg: Config, n: int) -> None:
    """Raise ValueError where the JAX trainer's asserts refuse a
    configuration on a mesh of `n` devices (examples/simple_trainer.py
    :401-413, :666-669)."""
    B = cfg.batch_size
    if B % n and n % B:
        raise ValueError(
            f"batch_size ({B}) and the world size ({n}) must divide one another: whole cameras a rank when "
            "batch >= world size, tile-row strips of each camera when batch < world size"
        )
    if cfg.packed and B % n:
        raise ValueError(f"--packed needs whole cameras a rank (batch_size {B} % world size {n} == 0)")
    if cfg.packed and cfg.app_opt:
        raise ValueError("--packed needs SH colours (no --app-opt): per-camera colours do not ride the packed exchange")


def init_distributed(device="cuda"):
    """For ``--distributed``: this process's device and the default
    process group from the environment ``torch.distributed.run`` sets
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK``, gloo for
    ``device="cpu"``. A group already initialised is kept. Returns
    (device, whether this call initialised the group)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_available() and dist.is_initialized():
        return dev, False
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "--distributed needs a process group: start one process a card with python -m "
            "torch.distributed.run --nproc_per_node=N (which sets RANK, WORLD_SIZE and LOCAL_RANK), or call "
            "torch.distributed.init_process_group(...) first"
        )
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return dev, True


def step_seed(seed: int, step: int) -> int:
    """The seed of a step's random draws: a function of (seed, step) only."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


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
    random quaternions, sh0 from the colours and zero shN (with
    ``app_opt``: colour logits and random features instead). Dead slots
    hold log-scale and opacity logit -10. Returns (params: dict of leaf
    tensors that require grad, live [cap] bool)."""
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
    }
    if cfg.app_opt:
        rgbs_c = np.clip(rgbs, 1e-3, 1 - 1e-3)
        arrays["colors"] = pad(np.log(rgbs_c / (1 - rgbs_c)))
        arrays["features"] = rng.standard_normal((cap, cfg.app_feature_dim)).astype(np.float32)
    else:
        arrays["sh0"] = pad(rgb_to_sh(rgbs)[:, None, :].astype(np.float32))
        arrays["shN"] = np.zeros((cap, K - 1, 3), np.float32)
    params = {
        k: torch.as_tensor(v, device=device).requires_grad_(True) for k, v in arrays.items()
    }
    live = torch.arange(cap, device=device) < n0
    return params, live


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: the
    appearance module's reductions (its biases' gradients sum over every
    camera and slot) then add in one order whether the colours' gradient
    comes from the rasterizer (a [D, C, N] layout) or through the
    distributed exchange ([C, N, D]), so world size 1 gives the
    single-device bits."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def depth_loss_term(
    depths_map: torch.Tensor,  # [B, H, W, 1] expected depth
    pts: torch.Tensor,  # [B, P, 2] pixel coordinates
    pt_depths: torch.Tensor,  # [B, P], 0 where padded
    depth_lambda: float,
    scene_scale: float,
) -> torch.Tensor:
    """The JAX trainer's disparity L1 at the points' pixels:
    depth_lambda * sum |1/clip(d_pred) - 1/clip(d_gt)| / max(n_valid, 1) *
    scene_scale. The pixel is the coordinate truncated toward zero (JAX's
    ``astype(int32)``), then clipped into the image."""
    B, H, W = depths_map.shape[:3]
    xi = pts[..., 0].to(torch.int32).clamp(0, W - 1).long()
    yi = pts[..., 1].to(torch.int32).clamp(0, H - 1).long()
    d_pred = depths_map[torch.arange(B, device=pts.device)[:, None], yi, xi, 0]  # [B, P]
    valid = pt_depths > 0
    disp = torch.where(valid, 1.0 / torch.clamp_min(d_pred, 1e-6), 0.0)
    disp_gt = torch.where(valid, 1.0 / torch.clamp_min(pt_depths, 1e-6), 0.0)
    n_valid = torch.clamp_min(valid.sum(), 1)
    return depth_lambda * (disp - disp_gt).abs().sum() / n_valid * scene_scale


class Runner:
    """The JAX trainer's ``Runner``, for the default or the MCMC strategy,
    on in-memory views (`from_colmap` for a COLMAP directory). Runs on
    CUDA unless ``device="cpu"`` (the kernels' plain versions).

    With ``cfg.distributed`` it is one rank of multi-GPU training over
    ``group`` (the default process group when None; without an
    initialised one the constructor raises): every rank passes the same
    arguments, ``device`` its own card, and holds its rows of the pool
    (``params``, ``live``, the optimizers' and the strategy's state);
    `set_state` and `load` take the whole pool and keep the rank's rows."""

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
    ):
        if cfg.backend not in ("auto", "binned", "tiled", "oracle"):
            raise ValueError(f"backend must be 'auto', 'binned', 'tiled' or 'oracle', got {cfg.backend!r}")
        if cfg.strategy_name not in ("default", "mcmc"):
            raise ValueError(f"strategy_name must be 'default' or 'mcmc', got {cfg.strategy_name!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = group
        self.world_size, self.rank = 1, 0
        if cfg.distributed:
            self.world_size, self.rank = world(group)
            check_distributed(cfg, self.world_size)
        self.backend = cfg.backend
        if cfg.backend == "auto":
            self.backend = "binned" if self.device.type == "cuda" else "oracle"
        self.trainset = train_views
        self.valset = val_views
        self.parser = None  # set by from_colmap
        self.result_dir = None  # set by from_colmap: no files are written without one
        self.scene_scale = scene_scale * 1.1
        n0 = points.shape[0] if cfg.init_type == "sfm" else cfg.init_num_pts
        if cfg.strategy_name == "mcmc":
            cap = _round_up(cfg.cap_max, 4096)
            check_pool(cap)
        else:
            cap = _round_up(int(n0 * cfg.pool_headroom), 4096)
        self._check_pool_rows(cap)
        params, live = create_splats(cfg, points, points_rgb, scene_scale, cap, self.device)
        self.params = {k: self._own_rows(v.detach()).requires_grad_(True) for k, v in params.items()}
        self.live = self._own_rows(live)
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
            self.live.shape[0], scene_scale=self.scene_scale, device=self.device
        )
        self._build_optimizers()

        n_imgs = len(self.trainset)
        self.aux = {}
        if cfg.pose_opt:
            self.aux["pose"] = CameraOptModule(n_imgs, device=self.device)
        if cfg.app_opt:
            self.aux["app"] = AppearanceOptModule(
                n_imgs, cfg.app_feature_dim, embed_dim=cfg.app_embed_dim, sh_degree=cfg.sh_degree,
                device=self.device, generator=torch.Generator().manual_seed(cfg.seed + 1),
            )
        if cfg.use_bilateral_grid:
            self.aux["bilagrid"] = BilateralGrid(n_imgs, device=self.device)
        self._build_aux_optimizers()

        self.isect_capacity = None
        if self.backend != "oracle":
            self.isect_capacity = _round_up(cfg.isect_capacity_init or int(4e6), 4096)
        # the packed exchange's visible rows a (camera, rank), grown from
        # meta["pack_required"] as the JAX trainer grows it
        self.pack_capacity = 4096
        self._live_hist = []  # (step, n_live) whenever the count changed, for the growth projection
        self._resumed_budget = False  # True once `load` restored a checkpoint's intersection budget
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._lpips_params = None  # loaded from cfg.lpips_weights at the first eval

    @property
    def distributed(self) -> bool:
        return self.cfg.distributed

    @property
    def pool_size(self) -> int:
        """The pool's capacity; each rank holds ``pool_size / world_size``
        of its rows."""
        return self.live.shape[0] * self.world_size

    def n_live(self) -> int:
        """The live count of the whole pool (every rank's rows)."""
        return int(self._all_sum(self.live.sum()))

    def _all_sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_sum(x, self.group) if self.distributed else x

    def _check_pool_rows(self, cap: int) -> None:
        if cap % self.world_size:
            raise ValueError(f"a pool of {cap} slots does not split into rows over {self.world_size} ranks "
                             "(capacity % world size must be 0)")

    def _own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a whole-pool tensor (their own copy)."""
        return shard_rows(x, self.group).clone() if self.distributed else x

    def _log(self, msg: str) -> None:
        if self.rank == 0:
            print(msg)

    @property
    def _writes(self) -> bool:
        """Whether this process writes the result directory: rank 0's."""
        return self.result_dir is not None and self.rank == 0

    @property
    def _tb(self):
        """The TensorBoard writer into ``result_dir/tb``, made at first use
        (the JAX trainer's ``_tb``); None with ``tb_every`` 0, in a process
        that writes no results, or where ``torch.utils.tensorboard`` cannot
        be imported."""
        if not hasattr(self, "_tb_writer"):
            self._tb_writer = None
            if self.cfg.tb_every > 0 and self._writes:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb_writer = SummaryWriter(log_dir=os.path.join(self.result_dir, "tb"))
                except ImportError:
                    pass
        return self._tb_writer

    def _tb_on(self) -> bool:
        """Whether any rank writes TensorBoard logs: every rank then takes
        part in the collectives that gather what rank 0 logs."""
        if not self.distributed:
            return self._tb is not None
        on = torch.tensor([self._tb is not None], dtype=torch.int32, device=self.device)
        return bool(self._all_sum(on).item())

    def _log_tb(self, step: int, out: Dict) -> None:
        """The JAX trainer's train/* scalars (and with ``tb_save_image`` the
        step's first view beside its render after the step) at ``step``."""
        cfg = self.cfg
        n_live = self.n_live()
        row_bytes = sum(p.element_size() * p[0].numel() for p in self.params.values())
        image = None
        if cfg.tb_save_image:
            pixels, camtoworlds, Ks = self._as_batch([self.trainset[self.data_index(step, 0)]])
            H, W = pixels.shape[1:3]
            rgb, _, _ = self.render(camtoworlds[:1], Ks[:1], W, H)
            image = torch.cat([pixels[0], rgb[0].clamp(0, 1)], dim=1).cpu().numpy()
        tb = self._tb
        if tb is None:
            return
        tb.add_scalar("train/loss", float(out["loss"]), step)
        tb.add_scalar("train/num_GS", n_live, step)
        tb.add_scalar("train/n_isects", int(out["slab_required"]), step)
        tb.add_scalar("train/mem_params_mb", row_bytes * self.pool_size / 2**20, step)
        if image is not None:
            tb.add_image("train/render", image, step, dataformats="HWC")
        tb.flush()

    @classmethod
    def from_colmap(cls, cfg: Config, device="cuda", **kwargs) -> "Runner":
        """A Runner on the COLMAP scene at ``cfg.data_dir`` (normalised, the
        split ``image % test_every``), writing its results into
        ``cfg.result_dir`` (rank 0's, where distributed), starting with
        ``cfg.json``. ``kwargs`` go to the constructor (``group``; the 2DGS
        runner's loss weights and warm-ups)."""
        from .datasets import Dataset, Parser

        parser = Parser(cfg.data_dir, factor=cfg.data_factor, normalize=True, test_every=cfg.test_every)
        trainset = Dataset(parser, split="train", load_depths=cfg.depth_loss)
        valset = Dataset(parser, split="val")
        runner = cls(cfg, trainset, parser.points, parser.points_rgb, parser.scene_scale, valset, device=device,
                     **kwargs)
        runner.parser = parser
        runner.result_dir = cfg.result_dir
        if runner._writes:
            os.makedirs(cfg.result_dir, exist_ok=True)
            with open(os.path.join(cfg.result_dir, "cfg.json"), "w") as f:
                json.dump({k: v for k, v in vars(runner.cfg).items()
                           if isinstance(v, (int, float, str, bool, list, type(None)))}, f, indent=1, default=str)
        n_live = runner.n_live()
        runner._log(f"scene scale: {runner.scene_scale:.3f}; {len(trainset)} train / {len(valset)} val images; "
                    f"initialized {n_live} splats in a {runner.pool_size}-slot pool"
                    + (f" over {runner.world_size} ranks" if runner.distributed else ""))
        return runner

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
            "colors": cfg.sh0_lr,
            "features": cfg.sh0_lr,
        }
        self.optimizers = {
            k: SelectiveAdam([self.params[k]], lr=lrs[k], eps=1e-15) for k in self.params
        }

    def _build_aux_optimizers(self):
        cfg = self.cfg
        self.aux_optimizers = {}
        for name, m in self.aux.items():
            if name == "bilagrid":
                self.aux_optimizers[name] = torch.optim.Adam(m.parameters(), lr=cfg.bilateral_grid_lr, eps=1e-8)
            else:
                lr, reg = (cfg.pose_opt_lr, cfg.pose_opt_reg) if name == "pose" else (cfg.app_opt_lr, cfg.app_opt_reg)
                self.aux_optimizers[name] = torch.optim.AdamW(m.parameters(), lr=lr, weight_decay=reg, eps=1e-8)

    def set_state(self, params: Mapping[str, np.ndarray], live: np.ndarray,
                  aux_params: Optional[Mapping[str, Mapping[str, np.ndarray]]] = None) -> None:
        """Start from the given splats (the JAX trainer's ``params`` as numpy
        arrays, same keys), live mask and aux-module parameters: the pool
        takes their capacity, the optimizers and the strategy start anew.
        Distributed, every rank passes the whole pool and keeps its rows."""
        self._check_pool_rows(np.shape(live)[0])
        splats, live_t = splats_from_numpy({**params, "live": live}, device=self.device)
        if set(splats) != set(self.params):
            raise KeyError(f"params hold {sorted(splats)}, the runner {sorted(self.params)}")
        self.params = {k: self._own_rows(splats[k]).requires_grad_(True) for k in self.params}
        self.live = self._own_rows(live_t)
        self.strategy_state = self.strategy.initialize_state(
            self.live.shape[0], scene_scale=self.scene_scale, device=self.device
        )
        self._build_optimizers()
        if aux_params:
            feature_dim = self.params["features"].shape[1] if "features" in self.params else None
            self.aux = aux_modules_from_numpy(aux_params, feature_dim, device=self.device)
            self._build_aux_optimizers()

    def _colors(self, camtoworlds, image_ids, sh_degree):
        """(colors, sh_degree for rasterization): the appearance module's
        per-camera colours (sh_degree None) or the SH coefficients."""
        p = self.params
        if self.cfg.app_opt:
            dirs = p["means"][None, :, :] - camtoworlds[:, None, :3, 3]
            colors = self.aux["app"](p["features"], image_ids, dirs, sh_degree)
            return _ContiguousGrad.apply(torch.sigmoid(colors + p["colors"][None])), None
        return torch.cat([p["sh0"], p["shN"]], dim=1), sh_degree

    def _dist_kwargs(self, packed: bool = False) -> Dict:
        """The rendering functions' multi-GPU arguments: none on one device;
        the group, and with ``packed`` the packed exchange at the current
        ``pack_capacity``. The training step takes ``cfg.packed``; the
        probe, `render` and `eval` render dense, as JAX's do."""
        if not self.distributed:
            return {}
        kw = {"distributed": True, "group": self.group}
        if packed:
            kw.update(packed=True, pack_capacity=self.pack_capacity)
        return kw

    def _whole(self, x, C: int, height: int):
        """The whole batch's ``[C, H, W, X]`` from this rank's block of a
        distributed render (`distributed.gather_blocks`: differentiable, each
        rank's backward takes its own block's gradient); ``x`` itself on
        one device."""
        if not self.distributed:
            return x
        return gather_blocks(x, C, height, self.cfg.tile_size, self.group)

    def _rasterize(self, viewmats, Ks, width, height, colors, sh_degree, capacity, carrier=None,
                   render_mode="RGB", packed=False, whole=True):
        """(render, alphas, meta) of the cameras; distributed, the whole
        batch on every rank (``whole=False``: the rank's block) and the
        rank's meta."""
        cfg = self.cfg
        p = self.params
        render, alphas, meta = rasterization(
            p["means"], p["quats"], torch.exp(p["scales"]), torch.sigmoid(p["opacities"]), colors,
            viewmats, Ks, width, height,
            sh_degree=sh_degree, near_plane=cfg.near_plane, far_plane=cfg.far_plane,
            rasterize_mode="antialiased" if cfg.antialiased else "classic", render_mode=render_mode,
            backend=self.backend, isect_capacity=capacity, means2d_carrier=carrier,
            masks=self.live, tile_size=cfg.tile_size, absgrad=cfg.absgrad,
            camera_model=cfg.camera_model, **self._dist_kwargs(packed),
        )
        if whole:
            C = viewmats.shape[0]
            render, alphas = self._whole(render, C, height), self._whole(alphas, C, height)
        return render, alphas, meta

    def _raster_train(self, step, viewmats, Ks, width, height, colors, sh_degree, carrier):
        """The training step's render: distributed, the whole batch on every
        rank. Returns (rgb, alphas, depths or None, meta, geom), `geom`
        holding what `_geom_losses` reads; the 2DGS runner overrides both."""
        depth = self.cfg.depth_loss
        render, alphas, meta = self._rasterize(
            viewmats, Ks, width, height, colors, sh_degree, self.isect_capacity, carrier,
            render_mode="RGB+ED" if depth else "RGB", packed=self.cfg.packed,
        )
        if depth:
            return render[..., :-1], alphas, render[..., -1:], meta, {}
        return render, alphas, None, meta, {}

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
        if self.backend == "oracle" or self.cfg.isect_capacity_init > 0:
            return
        # distributed: one copy of the view a rank, so that each rank renders
        # the whole view and the maximum over ranks is a rank's budget for
        # it (JAX :876-883)
        pixels, camtoworlds, Ks = self._as_batch([self.trainset[0]] * self.world_size)
        H, W = pixels.shape[1:3]
        with torch.no_grad():
            colors, sh = self._colors(camtoworlds, None, self.cfg.sh_degree)
            _, _, meta = self._rasterize(torch.linalg.inv(camtoworlds), Ks, W, H, colors, sh, 4096, whole=False)
        need = int(meta.get("slab_required", meta["n_isects"]))
        if need > 0:
            self.isect_capacity = _round_up(
                max(int(need * self.cfg.isect_headroom * 1.5), 65536), 4096
            )
            self._log(f"[isect] probed slab_required={need} -> capacity {self.isect_capacity}")

    def _grow_isect(self, need: int) -> None:
        """Grow the intersection budget when a step's ``slab_required`` (on
        the tiled backend ``n_isects``) comes within 80% of it (at least
        doubling, as the JAX trainer)."""
        cap = self.isect_capacity
        if cap is None or need <= 0.8 * cap:
            return
        if need > cap:
            self._log(f"[isect] need {need} exceeded capacity {cap}; this step was truncated")
        self.isect_capacity = _round_up(max(int(need * self.cfg.isect_headroom), 2 * cap), 4096)
        self._log(f"[isect] n_isects={need} -> capacity {self.isect_capacity}")

    def _projected_final_live(self, step: Optional[int], n_live: int) -> Optional[float]:
        """The live count at densification stop, extrapolated log-linearly
        from the growth history's recent window (the last ~5 records); None
        without a usable history (the JAX trainer's projection)."""
        cfg = self.cfg
        stop = min(cfg.refine_stop_iter, cfg.max_steps)
        hist = self._live_hist
        if step is None or step >= stop or not hist:
            return None
        s0, l0 = hist[-min(len(hist), 6)]
        if l0 <= 0 or n_live <= l0 or step <= s0:
            return None
        rate = (n_live / l0) ** (1.0 / (step - s0))  # per-step factor
        return n_live * rate ** (stop - step)

    def _pool_tensors(self) -> Dict[str, torch.Tensor]:
        """The pool's per-slot tensors (this rank's rows) by their checkpoint
        names: ``splat/{name}``, ``adam/{name}/{moment}``, ``live`` and
        ``strategy/{key}``."""
        n = self.live.shape[0]

        def per_slot(v):
            return isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == n

        out = {}
        for k, p in self.params.items():
            out[f"splat/{k}"] = p.detach()
            out.update({f"adam/{k}/{name}": v for name, v in self.optimizers[k].state.get(p, {}).items()
                        if per_slot(v)})
        out["live"] = self.live
        out.update({f"strategy/{k}": v for k, v in self.strategy_state.items() if per_slot(v)})
        return out

    @torch.no_grad()
    def _set_pool(self, pool: Mapping[str, torch.Tensor]) -> None:
        """Take `pool` (`_pool_tensors`'s names) as the pool: copied in place
        at the pool's size; at another size (a growth) each parameter
        becomes a new leaf tensor that its optimizer takes with its state
        (step count kept)."""
        if pool["live"].shape[0] == self.live.shape[0]:
            for k, v in self._pool_tensors().items():
                v.copy_(pool[k])
            return
        for k, p in list(self.params.items()):
            new = pool[f"splat/{k}"].requires_grad_(True)
            opt = self.optimizers[k]
            state = opt.state.pop(p, None)
            opt.param_groups[0]["params"] = [new]
            if state:
                opt.state[new] = {name: pool.get(f"adam/{k}/{name}", v) for name, v in state.items()}
            self.params[k] = new
        self.live = pool["live"]
        for k in list(self.strategy_state):
            self.strategy_state[k] = pool.get(f"strategy/{k}", self.strategy_state[k])

    def _gather_pool(self) -> Dict[str, Optional[torch.Tensor]]:
        """The whole pool's per-slot tensors on rank 0 (None on the other
        ranks); on one device the pool's own tensors."""
        pool = self._pool_tensors()
        if not self.distributed:
            return pool
        return {k: gather_rows(v, self.group) for k, v in pool.items()}

    def _scatter_pool(self, whole: Mapping[str, Optional[torch.Tensor]], rows: int) -> None:
        """Each rank takes its `rows` rows of rank 0's whole-pool tensors
        (`_set_pool`)."""
        self._set_pool({k: scatter_rows(whole[k], rows, v, self.group) for k, v in self._pool_tensors().items()})

    @torch.no_grad()
    def _on_whole_pool(self, fn) -> None:
        """Distributed: ``fn(params, live, optimizers, state)`` on the whole
        pool, as the single-device strategy code takes it (``optimizers`` a
        dict of the Adam moments, which pool surgery reads as per-slot
        optimizer state). The ranks' rows are gathered to rank 0, ``fn``
        runs there in place with the step generator, and every rank takes
        its rows back and rank 0's generator state, so the ranks draw on
        alike."""
        whole = self._gather_pool()
        if self.rank == 0:
            state = {k: whole.get(f"strategy/{k}", v) for k, v in self.strategy_state.items()}
            fn({k: whole[f"splat/{k}"] for k in self.params}, whole["live"],
               {k: v for k, v in whole.items() if k.startswith("adam/")}, state)
        self._scatter_pool(whole, self.live.shape[0])
        broadcast_generator(self.generator, self.device, self.group)

    @torch.no_grad()
    def _grow_pool(self, new_cap: int) -> None:
        """Pad the pool to `new_cap` slots as the JAX trainer does: zeros for
        the parameters, False for `live`, zeros for the Adam moments and the
        strategy's per-slot state. Each parameter becomes a new leaf
        tensor; its optimizer takes it, with its state (step count kept).
        Distributed, the padding goes on the whole pool on rank 0 and the
        ranks take their new rows (the row blocks move)."""
        def grow(x):
            return torch.cat([x, x.new_zeros((new_cap - x.shape[0],) + tuple(x.shape[1:]))])

        whole = self._gather_pool()
        if not self.distributed:
            self._set_pool({k: grow(v) for k, v in whole.items()})
            return
        if self.rank == 0:
            whole = {k: grow(v) for k, v in whole.items()}
        self._scatter_pool(whole, new_cap // self.world_size)

    def _maybe_grow(self, n_isects: int, step: Optional[int] = None, pack_required: int = 0) -> bool:
        """After a step: record the live count, grow the pool when the
        default strategy's live share passes ``pool_grow_at`` (to the
        projected need x 1.2 / pool_grow_at, at least double, at most
        ``pool_grow_max`` x; double without a projection), pre-scaling the
        intersection budget in the same event, then grow the budget from
        ``n_isects`` and, with ``packed``, the packed exchange's capacity
        from ``pack_required`` (both maxima over the ranks). Distributed,
        the counts are the whole pool's, so every rank decides alike.
        Returns whether the pool grew."""
        cfg = self.cfg
        cap = self.pool_size
        n_live = self.n_live()
        hist = self._live_hist
        if step is not None and n_live > 0 and (not hist or n_live != hist[-1][1]):
            hist.append((step, n_live))
        grew = False
        if cfg.strategy_name != "mcmc" and n_live > cfg.pool_grow_at * cap:
            proj = self._projected_final_live(step, n_live)
            if proj is not None:
                target = min(max(proj * 1.2 / cfg.pool_grow_at, cap * 2.0), cap * cfg.pool_grow_max)
            else:
                target = cap * 2.0
            # a multiple of 4096 that the ranks split evenly
            new_cap = _round_up(int(target), math.lcm(4096, self.world_size))
            self._log(f"[pool] {n_live}/{cap} live -> growing to {new_cap} "
                      f"(projected stop-time live: {int(proj) if proj else 'n/a'})")
            self._grow_pool(new_cap)
            grew = True
            if self.isect_capacity is not None and n_isects > 0:
                need = int(n_isects * (new_cap / cap) * cfg.pool_grow_at * cfg.isect_headroom)
                if need > self.isect_capacity:
                    self.isect_capacity = _round_up(need, 4096)
                    self._log(f"[isect] pre-scaled with pool growth -> capacity {self.isect_capacity}")
        self._grow_isect(n_isects)
        if cfg.packed and pack_required > 0.8 * self.pack_capacity:
            if pack_required > self.pack_capacity:
                self._log(f"[pack] pack_required {pack_required} exceeded capacity {self.pack_capacity}; "
                          "this step was truncated")
            new_pack = _round_up(int(pack_required * cfg.isect_headroom), 512)
            if new_pack > self.pack_capacity:
                self.pack_capacity = new_pack
                self._log(f"[pack] pack_required {pack_required} -> capacity {new_pack}")
        return grew

    def data_index(self, step: int, slot: int) -> int:
        """The view of batch slot `slot` at `step`: one permutation of the
        views per epoch, as the JAX trainer draws it."""
        flat = step * self.cfg.batch_size + slot
        epoch, pos = divmod(flat, len(self.trainset))
        perm = np.random.default_rng(self.cfg.seed + 7919 * epoch).permutation(len(self.trainset))
        return int(perm[pos])

    def _depth_inputs(self, views):
        """Each view's first P_MAX points and depths, zero-padded."""
        B = len(views)
        pts = np.zeros((B, P_MAX, 2), np.float32)
        dep = np.zeros((B, P_MAX), np.float32)
        for bi, v in enumerate(views):
            if "points" in v:
                n = min(len(v["points"]), P_MAX)
                pts[bi, :n] = v["points"][:n]
                dep[bi, :n] = v["depths"][:n]
        return torch.as_tensor(pts, device=self.device), torch.as_tensor(dep, device=self.device)

    def train_step(self, step: int) -> Dict:
        """One training step. Returns {"loss" (a 0-d tensor on the device),
        "depth" (the depth term, or None), "image_ids", "refined",
        "slab_required", "pack_required", "pool_grew"}; "slab_required" is
        the capacity the step needed (``n_isects`` on the tiled backend, 0
        on the oracle), "pack_required" the packed exchange's (0 without
        it). Distributed, every rank calls it with the same step and
        returns the whole step's loss."""
        cfg = self.cfg
        self.generator.manual_seed(step_seed(cfg.seed, step))
        views = [self.trainset[self.data_index(step, i)] for i in range(cfg.batch_size)]
        pixels, camtoworlds, Ks = self._as_batch(views)
        B, H, W = pixels.shape[:3]
        image_ids = torch.tensor([int(v["image_id"]) for v in views], device=self.device)
        sh_degree = min(step // cfg.sh_degree_interval, cfg.sh_degree)
        cap = self.live.shape[0]

        carrier = torch.zeros((B, cap, 2), device=self.device, requires_grad=True)
        c2w = self.aux["pose"](camtoworlds, image_ids) if "pose" in self.aux else camtoworlds
        colors, sh_arg = self._colors(c2w, image_ids, sh_degree)
        render, alphas, depths, meta, geom = self._raster_train(
            step, torch.linalg.inv(c2w), Ks, W, H, colors, sh_arg, carrier
        )
        if any("mask" in v for v in views):
            pm = torch.stack([
                torch.as_tensor(v["mask"], dtype=torch.float32, device=self.device) if "mask" in v
                else torch.ones((H, W), device=self.device) for v in views
            ])[..., None]
            render = render * pm
        if "bilagrid" in self.aux:
            render = self.aux["bilagrid"](render, image_ids)
        if cfg.random_bkgd:
            render = render + torch.rand((1, 1, 1, 3), generator=self.generator, device=self.device) * (1.0 - alphas)
        elif cfg.white_bkgd:
            render = render + (1.0 - alphas)
        loss = train_loss(render, pixels, cfg.ssim_lambda)
        loss = self._geom_losses(step, loss, geom, alphas)
        depth_term = None
        if cfg.depth_loss:
            depth_term = depth_loss_term(depths, *self._depth_inputs(views), cfg.depth_lambda, self.scene_scale)
            loss = loss + depth_term
        if "bilagrid" in self.aux:
            loss = loss + cfg.bilateral_tv_lambda * self.aux["bilagrid"].tv_loss()
        # the regularisers sum over the whole pool: distributed, each rank
        # adds its rows' share over the whole pool's live count
        whole_batch_loss, regs = loss, []
        live = self.live
        if cfg.opacity_reg > 0.0 or cfg.scale_reg > 0.0:
            n_live = self._all_sum(live.sum())
        if cfg.opacity_reg > 0.0:
            op = torch.where(live, torch.sigmoid(self.params["opacities"]), 0.0)
            regs.append(cfg.opacity_reg * op.sum() / n_live)
            loss = loss + regs[-1]
        if cfg.scale_reg > 0.0:
            sc = torch.where(live[:, None], torch.exp(self.params["scales"]), 0.0)
            regs.append(cfg.scale_reg * sc.sum() / (3 * n_live))
            loss = loss + regs[-1]
        loss.backward()
        if self.distributed:
            loss = self._whole_loss(whole_batch_loss, regs)
            self._sum_replicated_grads()

        visibility = (meta["radii"] > 0).any(dim=0)  # [cap]
        for opt in self.optimizers.values():
            opt.step(visibility)
            opt.zero_grad(set_to_none=True)
        for opt in self.aux_optimizers.values():
            opt.step()
            opt.zero_grad(set_to_none=True)
        refined = self._strategy_step(step, meta, carrier.grad, W, H, B)
        need = int(meta.get("slab_required", meta.get("n_isects", 0)))
        pack_required = int(meta.get("pack_required", 0))
        grew = self._maybe_grow(need, step, pack_required)
        return {
            "loss": loss.detach(),
            "depth": None if depth_term is None else depth_term.detach(),
            "image_ids": [int(v["image_id"]) for v in views],
            "refined": refined,
            "slab_required": need,
            "pack_required": pack_required,
            "pool_grew": grew,
        }

    @torch.no_grad()
    def _whole_loss(self, whole_batch_loss, regs):
        """The step's loss over the whole pool: the whole-batch terms, which
        every rank computed alike, plus each regulariser summed over the
        ranks (added in the single-device order)."""
        loss = whole_batch_loss.detach()
        if regs:
            for r in self._all_sum(torch.stack([r.detach() for r in regs])):
                loss = loss + r
        return loss

    @torch.no_grad()
    def _sum_replicated_grads(self) -> None:
        """The gradients of the modules every rank holds a copy of. The pose
        and appearance modules act before the exchange, on each rank's own
        Gaussians, so a rank's gradient holds its shard's share: they are
        summed over the ranks (the SPMD counterpart of the psums JAX's jit
        inserts). The bilateral grid and its TV term act on the whole
        gathered batch, so every rank already holds the whole gradient: it
        is not summed (a sum would be W times it)."""
        for name in ("pose", "app"):
            if name in self.aux:
                for p in self.aux[name].parameters():
                    if p.grad is not None:
                        p.grad = self._all_sum(p.grad)

    def _strategy_step(self, step, meta, carrier_grad, W, H, B) -> bool:
        """The strategy's post-backward work; returns whether it refined.
        Distributed, the per-slot work (statistics, opacity reset, MCMC's
        noise: the rank's rows of the whole pool's draw) stays on each
        rank's rows and a refine runs on the whole pool (`_on_whole_pool`)."""
        cfg = self.cfg
        strat = self.strategy
        kw = {}
        if self.distributed:
            kw["refine"] = lambda _params, _live, _opt, _state, *args: self._on_whole_pool(
                lambda p, live, opt, state: strat.refine(p, live, opt, state, *args))
        if isinstance(strat, MCMCStrategy):
            lr = cfg.means_lr * self.scene_scale * 0.01 ** (step / cfg.max_steps)
            if self.distributed:
                kw["noise"] = lambda: self._own_rows(
                    torch.randn((self.pool_size, 3), generator=self.generator, device=self.device))
            return strat.step_post_backward(
                self.params, self.live, self.optimizers, self.strategy_state, step, lr,
                generator=self.generator, **kw,
            )
        # n_cameras is the batch: the reference normalises the
        # densification gradients per camera and multiplies by the batch
        stats = {"radii": meta["radii"], "width": W, "height": H, "n_cameras": B}
        return strat.step_post_backward(
            self.params, self.live, self.optimizers, self.strategy_state, step, stats, carrier_grad,
            generator=self.generator, **kw,
        )

    def train(self, log_every: int = 100) -> List[Dict]:
        """Resume from ``cfg.resume`` if set, probe the intersection budget
        (unless the checkpoint held one), then the steps up to
        ``max_steps``, with evaluations (and the fly-through) at
        ``eval_steps`` and checkpoints at ``save_steps``. A checkpoint at or
        past ``max_steps`` only renders the fly-through. Returns each
        step's output."""
        cfg = self.cfg
        start_step = self.load(cfg.resume) if cfg.resume else 0
        if not self._resumed_budget:
            self.probe_isect_capacity()
        if start_step >= cfg.max_steps:
            self._log(f"resume step {start_step} >= max_steps: eval-only mode")
            if cfg.render_traj:
                self.render_traj(start_step)
            if cfg.compression:
                self.run_compression(start_step)
            return []
        t0 = time.time()
        outs = []
        for step in range(start_step, cfg.max_steps):
            outs.append(self.train_step(step))
            if step % log_every == 0:
                n_live = self.n_live()
                loss = float(outs[-1]["loss"])
                self._log(f"step {step}: loss={loss:.4f} n_live={n_live} ({time.time() - t0:.0f}s)")
                if self._writes:
                    with open(os.path.join(self.result_dir, "stats.jsonl"), "a") as f:
                        f.write(json.dumps({"step": step, "loss": loss, "n_live": n_live,
                                            "elapsed_s": time.time() - t0}) + "\n")
            if cfg.tb_every > 0 and step % cfg.tb_every == 0 and self._tb_on():
                self._log_tb(step, outs[-1])
            if step + 1 in cfg.eval_steps:
                if len(self.valset):
                    self.eval(step + 1)
                if cfg.render_traj:
                    self.render_traj(step + 1)
            if step + 1 in cfg.save_steps and self.result_dir is not None:
                self.save(step + 1)
                if cfg.compression:
                    self.run_compression(step + 1)
        self._log(f"training done in {(time.time() - t0) / 60:.1f} min")
        return outs

    @torch.no_grad()
    def render(self, camtoworlds, Ks, width, height, sh_degree=None):
        """(rgb, alphas, meta) of the cameras, the appearance module with no
        embedding (``embed_ids=None``) where it is on; distributed, every
        rank calls it and gets the whole images."""
        sh = self.cfg.sh_degree if sh_degree is None else sh_degree
        colors, sh = self._colors(camtoworlds, None, sh)
        return self._rasterize(torch.linalg.inv(camtoworlds), Ks, width, height, colors, sh, self.isect_capacity)

    @torch.no_grad()
    def run_compression(self, step: int) -> Dict:
        """Compress the live splats into ``compression_{step}/``
        (`PngCompression`, its K-means on the runner's device), evaluate
        the round trip (`eval_round_trip`) and write the evaluation with the
        directory's size to ``compression_{step}/report.json``, as the JAX
        trainer's ``run_compression`` does. Distributed, every rank calls
        it. Returns the report."""
        from .compression import PngCompression

        if self.cfg.compression != "png":
            raise ValueError(f"compression must be 'png', got {self.cfg.compression!r}")
        if self.result_dir is None:
            raise ValueError("run_compression needs a result directory (Runner.from_colmap)")
        cdir = os.path.join(self.result_dir, f"compression_{step}")
        size, stats = self.eval_round_trip(PngCompression(device=str(self.device)), cdir, step)
        report = {"step": step, "size_bytes": size, **stats}
        if self._writes:
            with open(os.path.join(cdir, "report.json"), "w") as f:
                json.dump(report, f)
        self._log("COMPRESSION " + json.dumps(report))
        return report

    @torch.no_grad()
    def eval_round_trip(self, comp, cdir: str, step: int):
        """``comp.compress`` the live splats into ``cdir``, put
        ``comp.decompress(cdir)`` into the pool in their place (the first n
        slots live), `eval`, and put the pool back. Distributed, every rank
        calls it: rank 0 compresses the gathered pool and scatters the
        round trip. Returns (the directory's bytes, rank 0's; the
        evaluation)."""
        keys = [k for k in COMPRESSED_KEYS if k in self.params]
        whole = self._gather_pool()
        saved = {k: p.detach().clone() for k, p in self.params.items()}
        saved_live = self.live
        size, restored = 0, {}
        if self.rank == 0:
            live = whole["live"]
            comp.compress(cdir, {k: whole[f"splat/{k}"][live] for k in keys})
            size = sum(os.path.getsize(os.path.join(cdir, f)) for f in os.listdir(cdir))
            cap, back = live.shape[0], comp.decompress(cdir)
            for k, v in back.items():
                restored[k] = torch.zeros((cap,) + v.shape[1:], dtype=torch.float32, device=self.device)
                restored[k][: v.shape[0]] = torch.as_tensor(v, device=self.device)
            restored["live"] = torch.arange(cap, device=self.device) < back["means"].shape[0]
        if self.distributed:
            rows = self.live.shape[0]
            restored = {k: scatter_rows(restored.get(k), rows, self.live if k == "live" else self.params[k].detach(),
                                        self.group) for k in keys + ["live"]}
        for k, v in restored.items():
            if k == "live":
                self.live = v
            else:
                self.params[k].copy_(v)
        try:
            stats = self.eval(step)
        finally:
            for k, v in saved.items():
                self.params[k].copy_(v)
            self.live = saved_live
        return int(size), stats

    def _lpips(self):
        """The LPIPS weights of ``cfg.lpips_weights`` on the runner's device
        (None without them; a missing file is reported at each eval, as the
        JAX trainer does)."""
        if self._lpips_params is None and self.cfg.lpips_weights:
            from .lpips import load_lpips_params

            self._lpips_params = load_lpips_params(self.cfg.lpips_weights, self.cfg.lpips_net, device=self.device)
            if self._lpips_params is None:
                self._log(f"[eval] LPIPS weights not found: {self.cfg.lpips_weights}")
        return self._lpips_params

    @torch.no_grad()
    def eval(self, step: int) -> Dict:
        """PSNR and SSIM (and LPIPS with ``lpips_weights``) over the
        validation views (a view's pixel mask applied to the render);
        written to ``val_step{step}.json``."""
        psnrs, ssims, lpipss = [], [], []
        lpips_params = self._lpips()
        t0 = time.time()
        for view in self.valset:
            pixels, camtoworlds, Ks = self._as_batch([view])
            H, W = pixels.shape[1:3]
            render, alphas, _ = self.render(camtoworlds, Ks, W, H)
            if self.cfg.white_bkgd:
                render = render + (1.0 - alphas)
            if "mask" in view:
                render = render * torch.as_tensor(view["mask"], dtype=torch.float32, device=self.device)[None, :, :, None]
            render = torch.clamp(render, 0.0, 1.0)
            psnrs.append(float(psnr_fn(render, pixels)))
            ssims.append(float(ssim_fn(render, pixels)))
            if lpips_params is not None:
                from .lpips import lpips as lpips_fn

                # alex takes [0, 1] inputs (normalize=True); vgg follows the
                # official 3DGS convention, as the JAX trainer does
                lpipss.append(float(lpips_fn(lpips_params, render, pixels, net_type=self.cfg.lpips_net,
                                             normalize=self.cfg.lpips_net == "alex")))
        stats = {
            "step": step,
            "psnr": float(np.mean(psnrs)) if psnrs else math.nan,
            "ssim": float(np.mean(ssims)) if ssims else math.nan,
            "num_GS": self.n_live(),
            "per_image_s": (time.time() - t0) / max(len(self.valset), 1),
        }
        if lpipss:
            stats["lpips"] = float(np.mean(lpipss))
        self._log("EVAL " + json.dumps(stats))
        if self._writes:
            with open(os.path.join(self.result_dir, f"val_step{step}.json"), "w") as f:
                json.dump(stats, f)
        if self._tb is not None:
            for k in ("psnr", "ssim", "lpips", "num_GS"):
                if k in stats:
                    self._tb.add_scalar(f"val/{k}", stats[k], step)
            self._tb.flush()
        return stats

    @torch.no_grad()
    def render_traj(self, step: int) -> str:
        """A fly-through along a path fit to the scene's cameras (``interp``
        or ``ellipse``), at the first validation view's intrinsics and
        size: ``videos/traj_{path}_{step}.mp4`` where imageio can write an
        mp4, else the frames as ``traj_{path}_{step}_frames.npz``.
        Distributed, every rank renders and rank 0 writes. Returns the path
        written."""
        from .datasets.traj import generate_ellipse_path_z, generate_interpolated_path

        cfg = self.cfg
        if self.parser is None or self.result_dir is None:
            raise ValueError("render_traj needs a COLMAP scene and a result directory (Runner.from_colmap)")
        c2w_all = self.parser.camtoworlds[:, :3, :4]
        if cfg.render_traj_path == "ellipse":
            path = generate_ellipse_path_z(c2w_all, height=float(np.mean(c2w_all[:, 2, 3])))
        else:
            path = generate_interpolated_path(c2w_all, 1)
        data = self.valset[0]
        K = torch.as_tensor(data["K"], dtype=torch.float32, device=self.device)[None]
        H, W = data["image"].shape[:2]
        frames = []
        for c2w34 in path:
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :4] = c2w34
            rgb, alphas, _ = self.render(torch.as_tensor(c2w, device=self.device)[None], K, W, H)
            if cfg.white_bkgd:
                rgb = rgb + (1.0 - alphas)
            frames.append((torch.clamp(rgb[0], 0, 1) * 255).to(torch.uint8).cpu().numpy())
        vdir = os.path.join(self.result_dir, "videos")
        out = os.path.join(vdir, f"traj_{cfg.render_traj_path}_{step}.mp4")
        if not self._writes:
            return out
        os.makedirs(vdir, exist_ok=True)
        try:
            import imageio.v2 as imageio

            imageio.mimwrite(out, frames, fps=30)
            print(f"wrote {out} ({len(frames)} frames)")
        except (ImportError, ValueError) as e:  # no imageio, or no mp4 writer for it
            out = out.replace(".mp4", "_frames.npz")
            np.savez_compressed(out, frames=np.stack(frames))
            print(f"mp4 writer unavailable ({str(e).splitlines()[0]}); wrote {out} ({len(frames)} frames)")
        return out

    def save(self, step: int) -> str:
        """``ckpt_{step}.npz`` and ``splats_{step}.ply`` in the result
        directory. The npz holds ``step``, ``live`` and ``splat/{name}``
        (the JAX trainer's keys, which ``splats_from_numpy`` and the
        viewers read), then the port's own state: ``adam/{name}/...`` (step
        count and moments), ``strategy/{key}``, ``aux/{module}/{param}``,
        ``aux_adam/{module}/{index}/{key}`` and ``pool/isect_capacity``,
        ``pool/live_hist``, ``pool/pack_capacity``. Distributed, every rank
        calls it: the pool's rows are gathered to rank 0, which writes the
        single-device files. Returns the npz's path."""
        def host(x):
            return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        path = os.path.join(self.result_dir, f"ckpt_{step}.npz")
        whole = self._gather_pool()
        if not self._writes:
            return path
        blob = {"step": np.asarray(step), "live": host(whole["live"])}
        blob.update({f"splat/{k}": host(whole[f"splat/{k}"]) for k in self.params})
        for k, opt in self.optimizers.items():
            for name, v in opt.state.get(self.params[k], {}).items():
                blob[f"adam/{k}/{name}"] = host(whole.get(f"adam/{k}/{name}", v))
        for k, v in self.strategy_state.items():
            blob[f"strategy/{k}"] = host(whole.get(f"strategy/{k}", v))
        for name, m in self.aux.items():
            for pn, p in m.named_parameters():
                blob[f"aux/{name}/{pn}"] = host(p)
            for idx, st in self.aux_optimizers[name].state_dict()["state"].items():
                for key, v in st.items():
                    blob[f"aux_adam/{name}/{idx}/{key}"] = host(v)
        blob["pool/isect_capacity"] = np.asarray(self.isect_capacity or 0)
        blob["pool/live_hist"] = np.asarray(self._live_hist, np.int64).reshape(-1, 2)
        blob["pool/pack_capacity"] = np.asarray(self.pack_capacity)
        np.savez(path, **blob)
        save_ply({k: whole[f"splat/{k}"] for k in self.params}, os.path.join(self.result_dir, f"splats_{step}.ply"),
                 live=whole["live"])
        print("saved", path)
        return path

    def load(self, path: str) -> int:
        """Restore a checkpoint written by `save`: the pool takes the
        checkpoint's capacity (it may have grown), then every array is set.
        A checkpoint of the JAX trainer loads its splats, live mask and aux
        parameters (``auxp/``, the JAX tree's leaf order); its optax state
        (``opt/``, ``auxs/``) and strategy state are not read, so it suits
        the evaluation-only mode (``start_step >= max_steps``). Distributed,
        every rank reads the file and keeps its rows. Returns the step to
        resume from."""
        ckpt = np.load(path)
        files = set(ckpt.files)
        arrays = {k[len("splat/"):]: ckpt[k] for k in files if k.startswith("splat/")}
        self.set_state(arrays, ckpt["live"])
        dev = self.device
        whole_cap = ckpt["live"].shape[0]

        def rows(v):  # the rank's rows of a per-slot array
            t = torch.as_tensor(v, device=dev)
            return self._own_rows(t) if t.dim() >= 1 and t.shape[0] == whole_cap else t
        own = any(k.startswith("adam/") for k in files)
        self._resumed_budget = own
        with torch.no_grad():
            if own:
                for k, opt in self.optimizers.items():
                    if f"adam/{k}/step" in files:
                        opt.state[self.params[k]] = {
                            "step": int(ckpt[f"adam/{k}/step"]),
                            "exp_avg": rows(ckpt[f"adam/{k}/exp_avg"]),
                            "exp_avg_sq": rows(ckpt[f"adam/{k}/exp_avg_sq"]),
                        }
                for k in sorted(f for f in files if f.startswith("strategy/")):
                    v = ckpt[k]
                    self.strategy_state[k[len("strategy/"):]] = float(v) if v.ndim == 0 else rows(v)
                for name, m in self.aux.items():
                    for pn, p in m.named_parameters():
                        p.copy_(torch.as_tensor(ckpt[f"aux/{name}/{pn}"]))
                    opt = self.aux_optimizers[name]
                    state = {}
                    prefix = f"aux_adam/{name}/"
                    for k in (f for f in files if f.startswith(prefix)):
                        idx, key = k[len(prefix):].split("/")
                        state.setdefault(int(idx), {})[key] = torch.as_tensor(ckpt[k])
                    opt.load_state_dict({"state": state, "param_groups": opt.state_dict()["param_groups"]})
                cap = int(ckpt["pool/isect_capacity"])
                self.isect_capacity = cap or None
                self._live_hist = [tuple(int(x) for x in r) for r in ckpt["pool/live_hist"]]
                if "pool/pack_capacity" in files:
                    self.pack_capacity = int(ckpt["pool/pack_capacity"])
            else:
                leaves = sorted(k for k in files if k.startswith("auxp/"))
                names = [(m, pn) for m in sorted(self.aux) for pn, _ in sorted(self.aux[m].named_parameters())]
                if leaves and len(leaves) != len(names):
                    raise ValueError(f"{path}: {len(leaves)} aux leaves, the runner's modules have {len(names)}")
                for k, (m, pn) in zip(leaves, names):
                    getattr(self.aux[m], pn).copy_(torch.as_tensor(ckpt[k]))
                self._log(f"{path} is a JAX trainer checkpoint: splats, live mask and aux parameters loaded; its "
                          "optax and strategy state are not read")
        step = int(ckpt["step"]) if "step" in files else 0
        self._log(f"resumed from {path} at step {step} (pool cap {self.pool_size})")
        return step


def run_main(runner_cls, cfg: Config, device, finish):
    """Train ``runner_cls`` from the COLMAP scene of ``cfg``, then
    ``finish(runner)``. With ``cfg.distributed`` this process is one rank:
    its device and process group from `init_distributed` (a group this
    call made is destroyed at the end). Returns the Runner."""
    created = False
    if cfg.distributed:
        device, created = init_distributed(device)
    try:
        runner = runner_cls.from_colmap(cfg, device=device)
        runner.train()
        finish(runner)
    finally:
        if created:
            import torch.distributed as dist

            dist.destroy_process_group()
    return runner


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> Runner:
    """The JAX trainer's ``main``: parse the command line, train from the
    COLMAP scene, evaluate at ``max_steps`` (with ``--distributed``, as one
    rank of the group `init_distributed` joins). Returns the Runner."""
    cfg = parse_config(argv)
    return run_main(Runner, cfg, device, lambda r: r.eval(cfg.max_steps))


if __name__ == "__main__":
    main()
