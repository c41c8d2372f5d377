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
take ``backend="tiled"``. Slice 9 is the rest of the op API (the packed
projections, ``proj``, ``rasterize_to_indices_in_range``, ``accumulate``,
the utilities) and MCMC training (``compute_relocation``,
``MCMCStrategy``, ``Runner`` with ``strategy_name="mcmc"``), in plain
PyTorch over the same kernels. Slice 10 is the rest of the trainer, plain
PyTorch and numpy over the same kernels: the COLMAP datasets
(``datasets/``: the numpy model reader, normalisation, trajectories, a PNG
reader and writer, ``Parser`` / ``Dataset``, a synthetic-scene writer),
the pose and appearance modules (``modules.py``) and the bilateral grid
(``bilagrid.py``), the depth loss, pool growth, checkpoints and resume,
the trainers' command lines (``python -m gsplat_tpu_torch.simple_trainer``,
``simple_trainer_2dgs``) and ``image_fitting``. Slice 11 is the last of
the TPU kernels, the micro-benchmarks of ``scripts/exp_*.py``
(``microbench/`` over ``csrc/mb_*.cu``), and the bilateral grid's
gradients as kernels (``csrc/bilagrid_bwd.cu``). Slice 12 is multi-GPU
rendering: ``rasterization(distributed=True)`` and
``rasterization_2dgs(distributed=True)`` over a ``torch.distributed``
process group (``distributed.py``: whole cameras, image strips, the packed
exchange), one rank a card. Slices 13-17 redesign kernels already ported:
the calibration products (``csrc/mb_calib.cu``), the gathers and the launch
path (``csrc/mb_gather.cu``, ``_backend.py``), the bilateral grid's
gradients over pixel tiles, the slice micro-benchmarks over the whole card
(``csrc/mb_slice_shapes.cu``, ``csrc/mb_fwd_breakdown.cu``) and the inner
math (``csrc/mb_inner_math.cu``). Slice 18 is multi-GPU training: both
trainers with ``distributed`` (and ``packed``) over a ``torch.distributed``
group, one process a rank, the pool sharded by rows as the JAX trainer's
mesh shards it (``simple_trainer.py``; the collectives in
``distributed.py``). Slice 19 is the apps and extras, plain PyTorch and
numpy over the same kernels: PNG compression (``compression/``:
``PngCompression`` with its K-means in torch, the sort), the LPIPS metric
(``lpips.py``), the profiler (``profile.py``), the trainer's
``compression="png"`` and ``lpips_weights``, and the viewers
(``simple_viewer.py``, ``interactive_viewer.py``). Slice 20 is the
dataset extras, on the host: undistortion and the fisheye mask
(``datasets/undistort.py``), PIL's bilinear resize and cv2's bilinear remap
(``datasets/image_io.py``), a JPEG decoder (``csrc/jpeg_decode.cpp``) and
the native COLMAP reader (``csrc/colmap_native.cpp``,
``datasets/colmap_native.py``), both C++ built with ``g++`` at first use,
and the trainer's TensorBoard logging.

Functions run on the device of their input tensors: CUDA tensors go
through the kernels, CPU tensors through each kernel's plain PyTorch
version; entry points that make tensors run on the card unless asked for
the CPU.
"""

from ._helper import load_test_data
from .version import __version__
from .checkpoint import splats_from_numpy
from .compression import PngCompression
from .losses import l1, psnr, ssim, train_loss
from .ops import (
    Isect,
    accumulate,
    accumulate_2dgs,
    fully_fused_projection,
    fully_fused_projection_2dgs,
    fully_fused_projection_2dgs_packed,
    fully_fused_projection_packed,
    fully_fused_projection_soa,
    isect_offset_encode,
    isect_tiles,
    proj,
    quat_scale_to_covar_preci,
    rasterize_to_indices_in_range,
    rasterize_to_indices_in_range_2dgs,
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
from .relocation import compute_relocation, make_binoms
from .rendering import rasterization, rasterization_2dgs
from .simple_trainer import Runner
from .simple_trainer_2dgs import Runner2DGS
from .strategy import DefaultStrategy, MCMCStrategy, Strategy
from .utils import (
    depth_to_normal,
    depth_to_points,
    get_projection_matrix,
    inverse_log_transform,
    log_transform,
    save_ply,
)

# the reference exports this op under a misspelled name too; keep both so
# code written against it imports unchanged
full_fused_projection_2dgs = fully_fused_projection_2dgs

__all__ = [
    "accumulate",
    "accumulate_2dgs",
    "rasterization",
    "rasterization_2dgs",
    "proj",
    "world_to_cam",
    "fully_fused_projection_soa",
    "fully_fused_projection",
    "fully_fused_projection_packed",
    "fully_fused_projection_2dgs",
    "fully_fused_projection_2dgs_packed",
    "full_fused_projection_2dgs",
    "quat_scale_to_covar_preci",
    "rasterize_to_pixels",
    "rasterize_to_pixels_2dgs",
    "rasterize_to_pixels_2dgs_ref",
    "rasterize_to_indices_in_range",
    "rasterize_to_indices_in_range_2dgs",
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
    "log_transform",
    "inverse_log_transform",
    "get_projection_matrix",
    "save_ply",
    "load_test_data",
    "splats_from_numpy",
    "l1",
    "psnr",
    "ssim",
    "train_loss",
    "SelectiveAdam",
    "Runner",
    "Runner2DGS",
    "compute_relocation",
    "make_binoms",
    "Strategy",
    "DefaultStrategy",
    "MCMCStrategy",
    "PngCompression",
    "__version__",
]
