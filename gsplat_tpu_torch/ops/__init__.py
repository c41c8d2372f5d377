from .accumulate import accumulate, accumulate_2dgs
from .binning import Binned, bin_gaussians
from .isect import Isect, isect_offset_encode, isect_tiles, suggest_capacity
from .projection import (
    fisheye_proj,
    fully_fused_projection,
    fully_fused_projection_packed,
    fully_fused_projection_soa,
    ortho_proj,
    persp_proj,
    proj,
    quat_scale_to_covar_preci,
    quat_to_rotmat,
    world_to_cam,
)
from .projection_2dgs import (
    fully_fused_projection_2dgs,
    fully_fused_projection_2dgs_packed,
    fully_fused_projection_2dgs_soa,
)
from .rasterize import rasterize_to_pixels, rasterize_to_pixels_2dgs
from .rasterize_2dgs_binned import rasterize_to_pixels_2dgs_binned
from .rasterize_2dgs_ref import rasterize_to_indices_in_range_2dgs, rasterize_to_pixels_2dgs_ref
from .rasterize_2dgs_tiled import rasterize_to_pixels_2dgs_tiled
from .rasterize_binned import rasterize_to_pixels_binned
from .rasterize_ref import (
    rasterize_to_indices_in_range,
    rasterize_to_pixels_ref,
    rasterize_to_pixels_ref_absgrad,
)
from .rasterize_tiled import rasterize_to_pixels_tiled
from .sh import eval_sh_bases, spherical_harmonics

__all__ = [
    "accumulate",
    "accumulate_2dgs",
    "Binned",
    "bin_gaussians",
    "Isect",
    "isect_tiles",
    "isect_offset_encode",
    "suggest_capacity",
    "fully_fused_projection",
    "fully_fused_projection_packed",
    "fully_fused_projection_soa",
    "quat_scale_to_covar_preci",
    "quat_to_rotmat",
    "world_to_cam",
    "persp_proj",
    "ortho_proj",
    "fisheye_proj",
    "proj",
    "fully_fused_projection_2dgs",
    "fully_fused_projection_2dgs_packed",
    "fully_fused_projection_2dgs_soa",
    "rasterize_to_pixels",
    "rasterize_to_pixels_2dgs",
    "rasterize_to_pixels_2dgs_binned",
    "rasterize_to_pixels_2dgs_ref",
    "rasterize_to_pixels_2dgs_tiled",
    "rasterize_to_pixels_binned",
    "rasterize_to_pixels_tiled",
    "rasterize_to_indices_in_range",
    "rasterize_to_indices_in_range_2dgs",
    "rasterize_to_pixels_ref",
    "rasterize_to_pixels_ref_absgrad",
    "spherical_harmonics",
    "eval_sh_bases",
]
