"""gsplat_tpu_torch: the PyTorch + CUDA (H100) port of gsplat_tpu.

Port slice 1 is the forward render path: ``rasterization()`` on the binned
backend (and the oracle), with hand-written Hopper kernels for the binning
emit and the forward compositing under ``csrc/``. Functions run on the
device of their input tensors: CUDA tensors go through the kernels, CPU
tensors through each kernel's plain PyTorch version. Training, 2DGS, the
tiled backend and multi-GPU rendering come in later slices and raise
NotImplementedError until then.
"""

from ._helper import load_test_data
from .version import __version__
from .checkpoint import splats_from_numpy
from .ops import (
    fully_fused_projection,
    fully_fused_projection_soa,
    quat_scale_to_covar_preci,
    rasterize_to_pixels,
    rasterize_to_pixels_ref,
    spherical_harmonics,
    world_to_cam,
)
from .rendering import rasterization, rasterization_2dgs

__all__ = [
    "rasterization",
    "rasterization_2dgs",
    "world_to_cam",
    "fully_fused_projection_soa",
    "fully_fused_projection",
    "quat_scale_to_covar_preci",
    "rasterize_to_pixels",
    "rasterize_to_pixels_ref",
    "spherical_harmonics",
    "load_test_data",
    "splats_from_numpy",
    "__version__",
]
