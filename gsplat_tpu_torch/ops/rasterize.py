"""Reference-named rasterizer entry points `rasterize_to_pixels` and
`rasterize_to_pixels_2dgs` over the port's backends (port of
gsplat_tpu/ops/rasterize.py).

Like the JAX package, it takes ``radii``/``depths`` plus a ``capacity`` and
builds the intersection state internally (the binning engine, or
`isect_tiles` for the tiled backend), and returns an ``aux`` dict with the
capacity signals ({"n_isects", "slab_required"} on the binned backend,
{"n_isects"} on the tiled one).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .isect import isect_tiles
from .rasterize_2dgs_binned import rasterize_to_pixels_2dgs_binned
from .rasterize_2dgs_ref import rasterize_to_pixels_2dgs_ref
from .rasterize_2dgs_tiled import rasterize_to_pixels_2dgs_tiled
from .rasterize_binned import rasterize_to_pixels_binned
from .rasterize_ref import rasterize_to_pixels_ref
from .rasterize_tiled import rasterize_to_pixels_tiled

# Largest C*N*H*W the O(N*pix)-memory oracle may be auto-selected for
# (2^28 f32 elements ~= 1 GB of [C, N, H, W] weight tensors).
_ORACLE_AUTO_ELEMS = 1 << 28


def resolve_auto_backend(
    backend: str,
    isect_capacity: Optional[int],
    C: int,
    N: int,
    width: int,
    height: int,
) -> Tuple[str, Optional[int]]:
    """Resolve ``backend="auto"`` to a concrete backend + capacity, exactly
    as the JAX package does: with an explicit ``isect_capacity`` the binned
    engine; without one, the oracle for small problems and the tiled
    pipeline (with a derived budget) for large ones. Explicit ``backend=``
    choices pass through untouched."""
    if backend != "auto":
        return backend, isect_capacity
    if isect_capacity is not None:
        return "binned", isect_capacity
    if C * N * width * height <= _ORACLE_AUTO_ELEMS:
        return "oracle", None
    return "tiled", max(1 << 20, 16 * C * N)


def rasterize_to_pixels(
    means2d: torch.Tensor,  # [C, N, 2] (or (mx, my) [C, N] tuple)
    conics: torch.Tensor,  # [C, N, 3] (or (a, b, c) tuple)
    colors: torch.Tensor,  # [C, N, D]
    opacities: torch.Tensor,  # [C, N]
    radii: torch.Tensor,  # [C, N] i32
    depths: torch.Tensor,  # [C, N]
    image_width: int,
    image_height: int,
    tile_size: int = 16,
    capacity: Optional[int] = None,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """3DGS tile rasterization. Returns (render_colors [C,H,W,D],
    render_alphas [C,H,W,1], aux)."""
    if backend == "auto":
        backend = "binned" if capacity is not None else "oracle"
    if backend in ("binned", "tiled") and capacity is None:
        raise ValueError(
            f"backend={backend!r} needs a `capacity` (intersection budget); "
            "pass one or use backend='oracle'"
        )
    as_arr = lambda x: torch.stack(x, dim=-1) if isinstance(x, (tuple, list)) else x  # noqa: E731
    if backend == "oracle":
        render, alphas = rasterize_to_pixels_ref(
            as_arr(means2d), as_arr(conics), colors, opacities,
            radii, depths, image_width, image_height, tile_size, backgrounds,
        )
        return render, alphas, {}
    if backend == "binned":
        return rasterize_to_pixels_binned(
            means2d, conics, colors, opacities, radii, depths,
            image_width, image_height, tile_size, capacity,
            backgrounds=backgrounds,
        )
    if backend == "tiled":
        isect = isect_tiles(
            means2d, radii, depths, tile_size, -(-image_width // tile_size),
            -(-image_height // tile_size), capacity,
        )
        render, alphas = rasterize_to_pixels_tiled(
            means2d, conics, colors, opacities, image_width, image_height,
            tile_size, isect, backgrounds=backgrounds,
        )
        return render, alphas, {"n_isects": isect.n_isects}
    raise ValueError(f"Unknown backend: {backend}")


def rasterize_to_pixels_2dgs(
    means2d: torch.Tensor,  # [C, N, 2]
    ray_transforms: torch.Tensor,  # [C, N, 3, 3]
    colors: torch.Tensor,  # [C, N, D], the last channel the depth
    normals: torch.Tensor,  # [C, N, 3]
    opacities: torch.Tensor,  # [C, N]
    radii: torch.Tensor,  # [C, N] i32
    depths: torch.Tensor,  # [C, N]
    image_width: int,
    image_height: int,
    tile_size: int = 16,
    capacity: Optional[int] = None,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
    backend: str = "auto",
):
    """2DGS tile rasterization. Returns (render_colors [C,H,W,D],
    render_alphas [C,H,W,1], render_normals [C,H,W,3] in the camera frame,
    render_distort [C,H,W,1], render_median [C,H,W,1], aux)."""
    if backend == "auto":
        backend = "binned" if capacity is not None else "oracle"
    if backend in ("binned", "tiled") and capacity is None:
        raise ValueError(
            f"backend={backend!r} needs a `capacity` (intersection budget); "
            "pass one or use backend='oracle'"
        )
    if backend == "oracle":
        outs = rasterize_to_pixels_2dgs_ref(
            means2d, ray_transforms, colors, normals, opacities, radii,
            depths, image_width, image_height, tile_size, backgrounds,
        )
        return outs + ({},)
    if backend == "binned":
        return rasterize_to_pixels_2dgs_binned(
            means2d, ray_transforms, colors, normals, opacities, radii,
            depths, image_width, image_height, tile_size, capacity,
            backgrounds=backgrounds,
        )
    if backend == "tiled":
        isect = isect_tiles(
            means2d, radii, depths, tile_size, -(-image_width // tile_size),
            -(-image_height // tile_size), capacity,
        )
        outs = rasterize_to_pixels_2dgs_tiled(
            means2d, ray_transforms, colors, normals, opacities, image_width,
            image_height, tile_size, isect, backgrounds=backgrounds,
        )
        return outs + ({"n_isects": isect.n_isects},)
    raise ValueError(f"Unknown backend: {backend}")
