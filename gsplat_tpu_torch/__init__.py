"""gsplat_tpu_torch: the PyTorch + CUDA (H100) port of gsplat_tpu.

Port slice 1 is the forward render path: ``rasterization()`` on the binned
backend (and the oracle), with hand-written Hopper kernels for the binning
emit and the forward compositing under ``csrc/``. Slice 2 is training on
the binned backend: its backward and per-Gaussian gradient-reduce kernels
behind a ``torch.autograd.Function``, ``means2d_carrier``/``absgrad``, the
losses, ``SelectiveAdam``, ``DefaultStrategy`` and a trainer over
in-memory views (``simple_trainer.Runner``). Slice 3 is 2DGS (surfels):
``rasterization_2dgs`` on the binned backend (and the oracle), with the
2DGS forward and backward kernels, and its trainer
(``simple_trainer_2dgs.Runner2DGS``). Slice 4 is the tiled backend, 3DGS
and 2DGS, forward and backward: ``isect_tiles`` and four kernels that
gather each tile's rows by ``flatten_ids``; ``rasterization(backend="auto")``
reaches it at scene scale without an ``isect_capacity``, and both trainers
take ``backend="tiled"``. Functions run on the device of their input
tensors: CUDA tensors go through the kernels, CPU tensors through each
kernel's plain PyTorch version. MCMC and multi-GPU rendering come in later
slices and raise NotImplementedError until then.
"""

from ._helper import load_test_data
from .version import __version__
from .checkpoint import splats_from_numpy
from .losses import l1, psnr, ssim, train_loss
from .ops import (
    Isect,
    fully_fused_projection,
    fully_fused_projection_2dgs,
    fully_fused_projection_soa,
    isect_offset_encode,
    isect_tiles,
    quat_scale_to_covar_preci,
    rasterize_to_pixels,
    rasterize_to_pixels_2dgs,
    rasterize_to_pixels_2dgs_ref,
    rasterize_to_pixels_2dgs_tiled,
    rasterize_to_pixels_ref,
    rasterize_to_pixels_ref_absgrad,
    rasterize_to_pixels_tiled,
    spherical_harmonics,
    suggest_capacity,
    world_to_cam,
)
from .optimizers import SelectiveAdam
from .rendering import rasterization, rasterization_2dgs
from .simple_trainer import Runner
from .simple_trainer_2dgs import Runner2DGS
from .strategy import DefaultStrategy, Strategy
from .utils import depth_to_normal, depth_to_points

__all__ = [
    "rasterization",
    "rasterization_2dgs",
    "world_to_cam",
    "fully_fused_projection_soa",
    "fully_fused_projection",
    "fully_fused_projection_2dgs",
    "quat_scale_to_covar_preci",
    "rasterize_to_pixels",
    "rasterize_to_pixels_2dgs",
    "rasterize_to_pixels_2dgs_ref",
    "rasterize_to_pixels_ref",
    "rasterize_to_pixels_ref_absgrad",
    "rasterize_to_pixels_tiled",
    "rasterize_to_pixels_2dgs_tiled",
    "Isect",
    "isect_tiles",
    "isect_offset_encode",
    "suggest_capacity",
    "spherical_harmonics",
    "depth_to_points",
    "depth_to_normal",
    "load_test_data",
    "splats_from_numpy",
    "l1",
    "psnr",
    "ssim",
    "train_loss",
    "SelectiveAdam",
    "Runner",
    "Runner2DGS",
    "Strategy",
    "DefaultStrategy",
    "__version__",
]
