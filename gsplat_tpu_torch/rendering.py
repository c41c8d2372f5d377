"""High-level rasterization API on one device (port of gsplat_tpu/rendering.py).

`rasterization()` for 3DGS: projection, masks, SH colours, render modes,
backgrounds, antialiased compensation and channel chunking are plain torch
(`project_and_shade`); the binned backend runs the binning engine and the
forward kernel (ops/binning.py, ops/rasterize_binned.py), the tiled
backend `isect_tiles` and the tiled forward kernel (ops/isect.py,
ops/rasterize_tiled.py), and the oracle backend the O(N * pixels)
reference. ``backend="auto"`` takes the binned backend when given an
``isect_capacity``, else the oracle on small problems and the tiled
backend, with a derived budget, at scene scale (`resolve_auto_backend`).
All three differentiate: training on the binned and tiled backends goes
through their backward and gradient-reduce kernels, and
``means2d_carrier``/``absgrad`` give the screen-space gradients that
densification reads. `rasterization_2dgs()` renders 2DGS surfels on the
same three backends: 2DGS projection, SH, render modes, the distortion and
median outputs, normals from depth (utils.py), and the 2DGS forward and
backward kernels of the binned and tiled backends
(ops/rasterize_2dgs_binned.py, ops/rasterize_2dgs_tiled.py). Both take
``distributed=True`` (with ``packed=True`` and a ``pack_capacity``, the
packed exchange) to render over the ranks of a ``torch.distributed``
process group (distributed.py).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ._backend import common_device
from .ops.projection import fully_fused_projection_soa
from .ops.projection_2dgs import fully_fused_projection_2dgs
from .ops.isect import isect_tiles
from .ops.rasterize import resolve_auto_backend
from .ops.rasterize_2dgs_binned import rasterize_to_pixels_2dgs_binned
from .ops.rasterize_2dgs_ref import rasterize_to_pixels_2dgs_ref
from .ops.rasterize_2dgs_tiled import rasterize_to_pixels_2dgs_tiled
from .ops.rasterize_binned import rasterize_to_pixels_binned
from .ops.rasterize_ref import rasterize_to_pixels_ref, rasterize_to_pixels_ref_absgrad
from .ops.rasterize_tiled import rasterize_to_pixels_tiled
from .ops.sh import spherical_harmonics
from .utils import depth_to_normal

RENDER_MODES = ("RGB", "D", "ED", "RGB+D", "RGB+ED")


class Shaded(NamedTuple):
    """Per-(camera, Gaussian) rasterizer inputs, each [C, N] (colors
    [C, N, X]), and the backgrounds extended to the render mode."""

    mean_x: torch.Tensor
    mean_y: torch.Tensor
    conics: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    opacities: torch.Tensor
    colors: torch.Tensor
    radii: torch.Tensor
    depths: torch.Tensor
    backgrounds: Optional[torch.Tensor]


def project_and_shade(
    means, quats, scales, opacities, colors, viewmats, Ks, width, height,
    near_plane=0.01, far_plane=1e10, radius_clip=0.0, eps2d=0.3,
    sh_degree=None, backgrounds=None, render_mode="RGB",
    rasterize_mode="classic", camera_model="pinhole", covars=None, masks=None,
) -> Shaded:
    """Everything of `rasterization()` before the rasterizer: projection,
    masks, compensation, colours (SH +0.5 and clamp) and the depth
    channel."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode must be one of {RENDER_MODES}, got {render_mode!r}")
    if rasterize_mode not in ("classic", "antialiased"):
        raise ValueError(f"unknown rasterize_mode {rasterize_mode!r}")
    N = means.shape[0]
    C = viewmats.shape[0]
    proj = fully_fused_projection_soa(
        means, quats, scales, viewmats, Ks, width, height,
        eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
        radius_clip=radius_clip,
        calc_compensations=(rasterize_mode == "antialiased"),
        camera_model=camera_model, covars=covars,
    )
    radii = proj["radii"]
    depths = proj["depth"]
    if masks is not None:
        # dead pool slots are culled exactly like frustum-culled Gaussians
        radii = torch.where(masks[None, :], radii, 0)

    opacities_cn = opacities[None, :].expand(C, N)
    if "compensation" in proj:
        opacities_cn = opacities_cn * proj["compensation"]

    if sh_degree is None:
        if colors.dim() == 2:
            colors_cn = colors[None].expand(C, N, colors.shape[-1])
        else:
            colors_cn = colors
    else:
        camtoworlds = torch.linalg.inv(viewmats)  # [C, 4, 4]
        dirs = means[None, :, :] - camtoworlds[:, None, :3, 3]  # [C, N, 3]
        if colors.dim() == 3:
            shs = colors[None].expand((C,) + tuple(colors.shape))
        else:
            shs = colors
        colors_cn = spherical_harmonics(sh_degree, dirs, shs, masks=radii > 0)
        # the +0.5 offset and clamp of the reference's Inria-style colours;
        # maximum (not clamp_min) so a colour exactly at 0 (a black point's
        # initial sh0) passes half its gradient, as the JAX package's clip
        colors_cn = torch.maximum(colors_cn + 0.5, colors_cn.new_zeros(()))

    if render_mode in ("RGB+D", "RGB+ED"):
        colors_cn = torch.cat([colors_cn, depths[..., None]], dim=-1)
        if backgrounds is not None:
            backgrounds = torch.cat(
                [backgrounds, backgrounds.new_zeros((C, 1))], dim=-1
            )
    elif render_mode in ("D", "ED"):
        colors_cn = depths[..., None]
        if backgrounds is not None:
            backgrounds = backgrounds.new_zeros((C, 1))

    return Shaded(
        mean_x=proj["mean_x"],
        mean_y=proj["mean_y"],
        conics=(proj["conic_a"], proj["conic_b"], proj["conic_c"]),
        opacities=opacities_cn,
        colors=colors_cn,
        radii=radii,
        depths=depths,
        backgrounds=backgrounds,
    )


def rasterization(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3]
    opacities: torch.Tensor,  # [N]
    colors: torch.Tensor,  # [(C,) N, D] or [(C,) N, K, 3]
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps2d: float = 0.3,
    sh_degree: Optional[int] = None,
    tile_size: int = 16,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
    render_mode: str = "RGB",
    rasterize_mode: str = "classic",  # or "antialiased"
    channel_chunk: int = 32,
    camera_model: str = "pinhole",
    covars: Optional[torch.Tensor] = None,  # [N, 3, 3]
    backend: str = "auto",
    isect_capacity: Optional[int] = None,
    means2d_carrier: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,  # [N] bool, False = skip (dead pool slot)
    absgrad: bool = False,
    packed: bool = False,
    sparse_grad: bool = False,
    distributed: bool = False,
    group=None,  # a torch.distributed process group; None is the default one
    pack_capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Rasterize N 3D Gaussians to C image planes, on the device of the
    inputs.

    Returns (render_colors [C, H, W, X], render_alphas [C, H, W, 1], meta).
    X = D (+1 if render_mode includes depth).

    ``means2d_carrier`` (zeros [C, N, 2], requires grad) is added to the
    projected means, so its gradient is the loss gradient w.r.t. them (the
    densification statistic). With ``absgrad=True`` it is not added;
    its gradient is instead the reference's absgrad statistic, |per-tile
    gradient| summed over tiles. The rendered output is the same either way.
    ``packed`` and ``sparse_grad`` are accepted and have no effect on one
    device, as in the JAX package.

    ``distributed=True`` renders over the ranks of ``group`` (the default
    process group when None; `torch.distributed.init_process_group` must
    have run, or the call raises): each rank passes its shard of the
    Gaussians and gets its block of the image back
    (`distributed.rasterization_distributed`, whose docstring states the
    per-rank contract). ``packed=True`` there exchanges only the visible
    (camera, Gaussian) rows, in a ``pack_capacity`` buffer per camera and
    rank (`distributed.rasterization_distributed_packed`).
    """
    if distributed:
        if covars is not None:
            raise ValueError("covars is not supported on the distributed path")
        from .distributed import rasterization_distributed, rasterization_distributed_packed

        common = dict(
            group=group, sh_degree=sh_degree, near_plane=near_plane, far_plane=far_plane,
            radius_clip=radius_clip, eps2d=eps2d, tile_size=tile_size, backgrounds=backgrounds,
            render_mode=render_mode, rasterize_mode=rasterize_mode, backend=backend,
            isect_capacity=isect_capacity, masks=masks, means2d_carrier=means2d_carrier,
            absgrad=absgrad, camera_model=camera_model,
        )
        per_cam = colors.dim() == 3 and sh_degree is None
        if packed:
            if pack_capacity is None:
                raise ValueError(
                    "the packed distributed exchange needs pack_capacity (grow it "
                    "from meta['pack_required'])"
                )
            if per_cam:
                raise ValueError("per-camera colors are not supported in the packed exchange")
            return rasterization_distributed_packed(
                means, quats, scales, opacities, colors, viewmats, Ks, width, height, pack_capacity, **common
            )
        return rasterization_distributed(
            means, quats, scales, opacities, colors, viewmats, Ks, width, height,
            per_camera_colors=per_cam, **common,
        )
    common_device(
        means, quats, scales, opacities, colors, viewmats, Ks, backgrounds,
        covars, masks, means2d_carrier,
    )
    C = viewmats.shape[0]
    backend, isect_capacity = resolve_backend(
        backend, isect_capacity, C, means.shape[0], width, height
    )

    s = project_and_shade(
        means, quats, scales, opacities, colors, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
        eps2d=eps2d, sh_degree=sh_degree, backgrounds=backgrounds,
        render_mode=render_mode, rasterize_mode=rasterize_mode,
        camera_model=camera_model, covars=covars, masks=masks,
    )
    mean_x, mean_y = s.mean_x, s.mean_y
    abs_c = None
    if means2d_carrier is not None:
        if absgrad:
            abs_c = (means2d_carrier[..., 0], means2d_carrier[..., 1])
        else:
            mean_x = mean_x + means2d_carrier[..., 0]
            mean_y = mean_y + means2d_carrier[..., 1]
    meta: Dict = {
        "radii": s.radii,
        "depths": s.depths,
        "width": width,
        "height": height,
        "tile_size": tile_size,
        "n_cameras": C,
    }
    render_colors, render_alphas, aux = rasterize_shaded(
        backend, (mean_x, mean_y), s.conics, s.colors, s.opacities, s.radii,
        s.depths, width, height, tile_size, isect_capacity, s.backgrounds,
        abs_c, channel_chunk,
    )
    if backend == "oracle":
        meta["means2d"] = aux["means2d"]
    else:
        meta.update(
            {
                "tile_width": math.ceil(width / tile_size),
                "tile_height": math.ceil(height / tile_size),
                "n_isects": aux["n_isects"],
                # the budget used: n_isects (tiled) or slab_required
                # (binned) above it means truncation
                "isect_capacity": isect_capacity,
            }
        )
        if backend == "binned":
            meta["slab_required"] = aux["slab_required"]
    if render_mode in ("ED", "RGB+ED"):
        render_colors = expected_depth(render_colors, render_alphas)
    return render_colors, render_alphas, meta


def resolve_backend(backend, isect_capacity, C, N, width, height):
    """`resolve_auto_backend`, then a known backend and, for the binned and
    tiled backends, a capacity: (backend, isect_capacity)."""
    backend, isect_capacity = resolve_auto_backend(
        backend, isect_capacity, C, N, width, height
    )
    if backend not in ("oracle", "binned", "tiled"):
        raise ValueError(f"Unknown backend: {backend}")
    if backend != "oracle" and isect_capacity is None:
        raise ValueError(f"backend={backend!r} needs isect_capacity")
    return backend, isect_capacity


def expected_depth(render, alphas):
    """The last channel (accumulated depth) divided by the alpha."""
    return torch.cat(
        [render[..., :-1], render[..., -1:] / torch.clamp_min(alphas, 1e-10)], dim=-1
    )


def rasterize_shaded(
    backend, means2d, conics, colors, opacities, radii, depths, width, height,
    tile_size, isect_capacity, backgrounds=None, abs_carrier=None,
    channel_chunk=None,
):
    """The 3DGS rasterizer on projected rows (``means2d`` as (mean_x,
    mean_y), ``conics`` as (a, b, c), each [C, N]) on a resolved backend,
    ``channel_chunk`` channels a call (None: one call). ``abs_carrier``
    (x, y) takes the absgrad statistic. Returns (render, alphas, aux): aux
    holds ``n_isects`` and ``slab_required`` on the binned backend,
    ``n_isects`` on the tiled one and the stacked ``means2d`` on the
    oracle."""
    aux: Dict = {}
    if backend == "oracle":
        m2 = aux["means2d"] = torch.stack(list(means2d), dim=-1)
        con = torch.stack(list(conics), dim=-1)

        def _fn(col, bg):
            if abs_carrier is not None:
                if bg is None:
                    bg = col.new_zeros((col.shape[0], col.shape[-1]))
                return rasterize_to_pixels_ref_absgrad(
                    m2, con, col, opacities, radii, depths, width, height,
                    tile_size, bg, torch.stack(list(abs_carrier), dim=-1),
                )
            return rasterize_to_pixels_ref(
                m2, con, col, opacities, radii, depths, width, height, tile_size, bg,
            )

    elif backend == "tiled":
        isect = isect_tiles(
            means2d, radii, depths, tile_size, math.ceil(width / tile_size),
            math.ceil(height / tile_size), isect_capacity,
        )
        aux["n_isects"] = isect.n_isects

        def _fn(col, bg):
            return rasterize_to_pixels_tiled(
                means2d, conics, col, opacities, width, height, tile_size, isect,
                backgrounds=bg, abs_carrier=abs_carrier,
            )

    else:

        def _fn(col, bg):
            r, a, aux_b = rasterize_to_pixels_binned(
                means2d, conics, col, opacities, radii, depths, width, height,
                tile_size, capacity=isect_capacity, backgrounds=bg,
                abs_carrier=abs_carrier,
            )
            aux.update(aux_b)
            return r, a

    render, alphas = _rasterize_chunked(_fn, channel_chunk, colors, backgrounds)
    return render, alphas, aux


def _rasterize_chunked(fn, channel_chunk, colors, backgrounds):
    """Rasterize channels in chunks of `channel_chunk` (None: one call)."""
    D = colors.shape[-1]
    if channel_chunk is None or D <= channel_chunk:
        return fn(colors, backgrounds)
    out_c, out_a = [], None
    n_chunks = (D + channel_chunk - 1) // channel_chunk
    for i in range(n_chunks):
        sl = slice(i * channel_chunk, (i + 1) * channel_chunk)
        bg = backgrounds[..., sl] if backgrounds is not None else None
        rc, ra = fn(colors[..., sl], bg)
        out_c.append(rc)
        if out_a is None:
            out_a = ra
    return torch.cat(out_c, dim=-1), out_a


class Shaded2DGS(NamedTuple):
    """Per-(camera, Gaussian) surfel rasterizer inputs and the backgrounds
    extended to the render mode."""

    means2d: torch.Tensor  # [C, N, 2]
    ray_transforms: torch.Tensor  # [C, N, 3, 3]
    normals: torch.Tensor  # [C, N, 3] camera frame
    opacities: torch.Tensor  # [C, N]
    colors: torch.Tensor  # [C, N, X]
    radii: torch.Tensor  # [C, N] i32
    depths: torch.Tensor  # [C, N]
    backgrounds: Optional[torch.Tensor]


def project_and_shade_2dgs(
    means, quats, scales, opacities, colors, viewmats, Ks, width, height,
    near_plane=0.01, far_plane=1e10, radius_clip=0.0, sh_degree=None,
    backgrounds=None, render_mode="RGB", masks=None,
) -> Shaded2DGS:
    """Everything of `rasterization_2dgs()` before the rasterizer: 2DGS
    projection, masks, colours (SH +0.5 and clamp) and the depth channel,
    which is appended for RGB+D / RGB+ED and replaces the colours for D /
    ED (plain RGB gets nothing extra)."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode must be one of {RENDER_MODES}, got {render_mode!r}")
    N = means.shape[0]
    C = viewmats.shape[0]
    radii, means2d, depths, ray_transforms, normals = fully_fused_projection_2dgs(
        means, quats, scales, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
    )
    if masks is not None:
        radii = torch.where(masks[None, :], radii, 0)

    if sh_degree is None:
        colors_cn = colors[None].expand(C, N, colors.shape[-1]) if colors.dim() == 2 else colors
    else:
        camtoworlds = torch.linalg.inv(viewmats)
        dirs = means[None, :, :] - camtoworlds[:, None, :3, 3]
        shs = colors[None].expand((C,) + tuple(colors.shape)) if colors.dim() == 3 else colors
        colors_cn = spherical_harmonics(sh_degree, dirs, shs, masks=radii > 0)
        colors_cn = torch.maximum(colors_cn + 0.5, colors_cn.new_zeros(()))

    if render_mode in ("RGB+D", "RGB+ED"):
        colors_cn = torch.cat([colors_cn, depths[..., None]], dim=-1)
        if backgrounds is not None:
            backgrounds = torch.cat([backgrounds, backgrounds.new_zeros((C, 1))], dim=-1)
    elif render_mode in ("D", "ED"):
        colors_cn = depths[..., None]
        if backgrounds is not None:
            backgrounds = backgrounds.new_zeros((C, 1))

    return Shaded2DGS(
        means2d=means2d,
        ray_transforms=ray_transforms,
        normals=normals,
        opacities=opacities[None, :].expand(C, N),
        colors=colors_cn,
        radii=radii,
        depths=depths,
        backgrounds=backgrounds,
    )


def rasterization_2dgs(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3]
    opacities: torch.Tensor,  # [N]
    colors: torch.Tensor,  # [(C,) N, D] or [(C,) N, K, 3]
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    sh_degree: Optional[int] = None,
    tile_size: int = 16,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
    render_mode: str = "RGB",
    distloss: bool = False,
    depth_mode: str = "expected",
    backend: str = "oracle",
    isect_capacity: Optional[int] = None,
    densify_carrier: Optional[torch.Tensor] = None,  # [C, N, 2] zeros
    masks: Optional[torch.Tensor] = None,  # [N] bool, False = skip (dead pool slot)
    packed: bool = False,
    sparse_grad: bool = False,
    distributed: bool = False,
    group=None,  # a torch.distributed process group; None is the default one
    pack_capacity: Optional[int] = None,
):
    """Rasterize 2D Gaussians (surfels) to C image planes, on the device of
    the inputs.

    Returns (render_colors [C,H,W,X], render_alphas [C,H,W,1],
    render_normals [C,H,W,3] in the world frame, normals_from_depth
    [C,H,W,3] (None unless render_mode has a depth channel),
    render_distort [C,H,W,1], render_median [C,H,W,1], meta).

    As in the JAX package, the distortion and the median read the LAST
    channel as the depth, so in plain RGB mode they are computed from the
    blue channel. ``distloss=False`` returns the distortion as zeros with
    no gradient. ``densify_carrier`` (zeros [C, N, 2], requires grad) is
    added to the projected means; its gradient is the screen-space
    gradient the densification strategies read. ``packed`` and
    ``sparse_grad`` are accepted and have no effect on one device.
    ``distributed=True`` (and ``packed=True`` with a ``pack_capacity``)
    renders over the ranks of ``group`` as `rasterization` does
    (`distributed.rasterization_2dgs_distributed`,
    `distributed.rasterization_2dgs_distributed_packed`).
    """
    if distributed:
        from .distributed import rasterization_2dgs_distributed, rasterization_2dgs_distributed_packed

        common = dict(
            group=group, sh_degree=sh_degree, near_plane=near_plane, far_plane=far_plane,
            radius_clip=radius_clip, tile_size=tile_size, backgrounds=backgrounds,
            render_mode=render_mode, distloss=distloss, depth_mode=depth_mode, backend=backend,
            isect_capacity=isect_capacity, masks=masks, densify_carrier=densify_carrier,
        )
        per_cam = colors.dim() == 3 and sh_degree is None
        if packed:
            if pack_capacity is None:
                raise ValueError(
                    "the packed distributed exchange needs pack_capacity (grow it "
                    "from meta['pack_required'])"
                )
            if per_cam:
                raise ValueError("per-camera colors are not supported in the packed exchange")
            return rasterization_2dgs_distributed_packed(
                means, quats, scales, opacities, colors, viewmats, Ks, width, height, pack_capacity, **common
            )
        return rasterization_2dgs_distributed(
            means, quats, scales, opacities, colors, viewmats, Ks, width, height,
            per_camera_colors=per_cam, **common,
        )
    check_depth_mode(depth_mode)
    common_device(
        means, quats, scales, opacities, colors, viewmats, Ks, backgrounds,
        densify_carrier, masks,
    )
    N = means.shape[0]
    C = viewmats.shape[0]
    backend, isect_capacity = resolve_backend(backend, isect_capacity, C, N, width, height)

    s = project_and_shade_2dgs(
        means, quats, scales, opacities, colors, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
        sh_degree=sh_degree, backgrounds=backgrounds, render_mode=render_mode,
        masks=masks,
    )
    means2d = s.means2d
    if densify_carrier is not None:
        means2d = means2d + densify_carrier
    meta: Dict = {
        "radii": s.radii,
        "depths": s.depths,
        "width": width,
        "height": height,
        "n_cameras": C,
        "normals": s.normals,
    }
    *out, aux = rasterize_shaded_2dgs(
        backend, means2d, s.ray_transforms, s.colors, s.normals, s.opacities,
        s.radii, s.depths, width, height, tile_size, isect_capacity, s.backgrounds,
    )
    if backend != "oracle":
        meta["n_isects"] = aux["n_isects"]
        if backend == "binned":
            meta["slab_required"] = aux["slab_required"]
        meta["isect_capacity"] = isect_capacity
    return postprocess_2dgs(*out, viewmats, Ks, render_mode, depth_mode, distloss) + (meta,)


def check_depth_mode(depth_mode):
    if depth_mode not in ("expected", "median"):
        raise ValueError(f"Unknown depth_mode: {depth_mode}")


def rasterize_shaded_2dgs(
    backend, means2d, ray_transforms, colors, normals, opacities, radii, depths,
    width, height, tile_size, isect_capacity, backgrounds=None,
):
    """The 2DGS rasterizer on projected surfel rows on a resolved backend
    (``means2d`` [C, N, 2] or (mean_x, mean_y), ``ray_transforms``
    [C, N, 3, 3] or its 9 [C, N] rows). Returns (render, alphas, normals,
    distort, median, aux), aux as `rasterize_shaded`'s (empty on the
    oracle)."""
    if backend == "binned":
        *out, aux = rasterize_to_pixels_2dgs_binned(
            means2d, ray_transforms, colors, normals, opacities, radii, depths,
            width, height, tile_size, capacity=isect_capacity, backgrounds=backgrounds,
        )
        return (*out, aux)
    if backend == "tiled":
        isect = isect_tiles(
            means2d, radii, depths, tile_size, math.ceil(width / tile_size),
            math.ceil(height / tile_size), isect_capacity,
        )
        out = rasterize_to_pixels_2dgs_tiled(
            means2d, ray_transforms, colors, normals, opacities, width, height,
            tile_size, isect, backgrounds=backgrounds,
        )
        return (*out, {"n_isects": isect.n_isects})
    if isinstance(means2d, (tuple, list)):
        means2d = torch.stack(list(means2d), dim=-1)
    if isinstance(ray_transforms, (tuple, list)):
        ray_transforms = torch.stack(list(ray_transforms), dim=-1).reshape(
            ray_transforms[0].shape + (3, 3)
        )
    out = rasterize_to_pixels_2dgs_ref(
        means2d, ray_transforms, colors, normals, opacities, radii, depths,
        width, height, tile_size, backgrounds,
    )
    return (*out, {})


def postprocess_2dgs(
    render_colors, render_alphas, render_normals, render_distort, render_median,
    viewmats, Ks, render_mode, depth_mode, distloss, normals_fn=None,
):
    """Everything of `rasterization_2dgs()` after the rasterizer: the
    expected-depth division, normals from the expected or median depth
    (``normals_fn(depth)``; by default `depth_to_normal` in the cameras of
    ``viewmats``), the distortion zeroed without distloss, and the rendered
    normals into the world frame. Returns the 6 images of
    `rasterization_2dgs`."""
    if render_mode in ("ED", "RGB+ED"):
        render_colors = expected_depth(render_colors, render_alphas)

    # normals from the expected or median depth, for the normal-consistency
    # loss; the caller modulates them by alpha
    normals_from_depth = None
    if render_mode in ("RGB+D", "RGB+ED"):
        depth_for_normal = render_colors[..., -1:] if depth_mode == "expected" else render_median
        if normals_fn is None:
            normals_from_depth = depth_to_normal(depth_for_normal, torch.linalg.inv(viewmats), Ks)
        else:
            normals_from_depth = normals_fn(depth_for_normal)

    if not distloss:
        render_distort = torch.zeros_like(render_distort.detach())

    # rendered normals into the world frame
    R_wc = viewmats[:, :3, :3].transpose(-1, -2)
    render_normals = torch.einsum("cij,chwj->chwi", R_wc, render_normals)

    return (
        render_colors,
        render_alphas,
        render_normals,
        normals_from_depth,
        render_distort,
        render_median,
    )
