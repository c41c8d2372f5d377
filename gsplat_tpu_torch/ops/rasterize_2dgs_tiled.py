"""Tiled 2DGS (surfel) rasterizer over the `isect_tiles` stream (port of
gsplat_tpu/ops/rasterize_2dgs_tiled.py).

The surfel rows (``rasterize_2dgs_binned.surfel_payload``: mx, my, the
ray transform M00..M22, opacity, the D colours with the depth last, the 3
normals) are packed once as ``[C*N, F]`` (ops/binning.py::pack_rows)
and the kernels gather the rows each (camera, tile) range names. The
forward kernel (csrc/rasterize_2dgs_tiled_fwd.cu; `_tiled2_fwd_plain` is
its plain version) composites the features, T, `last`, the distortion and
the median; the backward kernel (csrc/rasterize_2dgs_tiled_bwd.cu;
`_tiled2_bwd_plain`) writes one row of per-entry gradients per stream slot,
which the gid reduce kernel (ops/rasterize_binned.py::reduce_by_gid) sums
per Gaussian. Per-pixel math, the distortion's prefixes rebuilt from the
totals in the backward, and the median's lack of a gradient are those of
ops/rasterize_2dgs_binned.py. The background is added outside the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from .. import _backend
from .isect import Isect
from .rasterize_2dgs_binned import MAX_CHANNELS, NFIX, _bwd2_plain, _dims, _fwd2_plain, surfel_payload
from .rasterize_binned import TILE_SIZES, _check, reduce_by_gid
from .rasterize_tiled import _kernel_checks, gather_stream, pack_rows, stream_ranges


def _check_L(L: int, what: str) -> None:
    if not 4 <= L <= MAX_CHANNELS + 3:
        raise ValueError(f"the tiled 2DGS {what} kernel takes 1..{MAX_CHANNELS} colour channels, got {L - 3}")


def _tiled2_fwd_plain(
    packed: torch.Tensor,  # [C*N, F] f32
    L: int,
    ids: torch.Tensor,  # [M] i32
    offs: torch.Tensor,  # [T] i32
    cnts: torch.Tensor,  # [T] i32
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
):
    """Plain torch version of the forward kernel: gather the stream, then
    the binned 2DGS plain compositing. Returns (features [C,H,W,L],
    T_final, last (absolute stream index or -1), distortion, median,
    n_pairs)."""
    entries = gather_stream(packed, NFIX + L, ids)
    return _fwd2_plain(entries, offs, cnts, n_cams, image_width, image_height, tile_size)


_FWD_ARGS = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]  # packed, F, ids
    + [ctypes.c_void_p] * 2  # offs, cnts
    + [ctypes.c_int] * 7  # C, th, tw, ts, W, H, L
    + [ctypes.c_void_p] * 6  # features, T, last, distortion, median, stream
)


def _tiled2_fwd_cuda(
    packed: torch.Tensor,
    L: int,
    ids: torch.Tensor,
    offs: torch.Tensor,
    cnts: torch.Tensor,
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
):
    """Launch csrc/rasterize_2dgs_tiled_fwd.cu: one block per (camera,
    tile), one thread per pixel, rows gathered by `ids`. Returns
    (features, T_final, last, distortion, median) as `_tiled2_fwd_plain`
    does. An empty stream launches nothing."""
    _check_L(L, "forward")
    th, tw = _dims(image_width, image_height, tile_size)
    T = n_cams * th * tw
    _kernel_checks("tiled 2DGS forward", packed, NFIX + L, ids, offs, cnts, T, tile_size)
    dev = packed.device
    img = (n_cams, image_height, image_width)
    if T == 0 or ids.shape[0] == 0:
        zeros = lambda *s: torch.zeros(img + s, dtype=torch.float32, device=dev)  # noqa: E731
        return (zeros(L), torch.ones(img, dtype=torch.float32, device=dev),
                torch.full(img, -1, dtype=torch.int32, device=dev), zeros(), zeros())
    feat = torch.empty(img + (L,), dtype=torch.float32, device=dev)
    T_out = torch.empty(img, dtype=torch.float32, device=dev)
    last = torch.empty(img, dtype=torch.int32, device=dev)
    dist = torch.empty(img, dtype=torch.float32, device=dev)
    med = torch.empty(img, dtype=torch.float32, device=dev)
    fn = _backend.kernel("rasterize_2dgs_tiled_fwd", "rasterize_2dgs_tiled_fwd_launch", _FWD_ARGS)
    code = fn(
        packed.data_ptr(), packed.shape[1], ids.data_ptr(), offs.data_ptr(), cnts.data_ptr(),
        n_cams, th, tw, tile_size, image_width, image_height, L,
        feat.data_ptr(), T_out.data_ptr(), last.data_ptr(), dist.data_ptr(), med.data_ptr(),
        _backend.stream(dev),
    )
    _backend.check_launch(code, "rasterize_2dgs_tiled_fwd")
    _backend.LAUNCHES["rasterize_2dgs_tiled_fwd"] += 1
    return feat, T_out, last, dist, med


def _tiled2_bwd_plain(
    packed: torch.Tensor,  # [C*N, F] f32
    L: int,
    ids: torch.Tensor,  # [M] i32
    offs: torch.Tensor,  # [T] i32
    cnts: torch.Tensor,  # [T] i32
    T_fin: torch.Tensor,  # [C, H, W] the forward's T_final
    last: torch.Tensor,  # [C, H, W] i32 the forward's last accepted index
    wm_tot: torch.Tensor,  # [C, H, W] the forward's composited depth channel
    v_feat: torch.Tensor,  # [C, H, W, L] cotangent of the features
    v_T: torch.Tensor,  # [C, H, W] cotangent of T_final
    v_dist: torch.Tensor,  # [C, H, W] cotangent of the distortion
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
):
    """Plain torch version of the backward kernel: gather the stream, then
    the binned 2DGS plain backward. Returns (rows [12 + L, M], (n_eval,
    n_acc))."""
    entries = gather_stream(packed, NFIX + L, ids)
    return _bwd2_plain(entries, offs, cnts, T_fin, last, wm_tot, v_feat, v_T, v_dist,
                       n_cams, image_width, image_height, tile_size)


_BWD_ARGS = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]  # packed, F, ids, M
    + [ctypes.c_void_p] * 2  # offs, cnts
    + [ctypes.c_int] * 7  # C, th, tw, ts, W, H, L
    + [ctypes.c_void_p] * 8  # T_final, last, wm_tot, v_feat, v_T, v_dist, rows, stream
)


def _tiled2_bwd_cuda(
    packed: torch.Tensor,
    L: int,
    ids: torch.Tensor,
    offs: torch.Tensor,
    cnts: torch.Tensor,
    T_fin: torch.Tensor,
    last: torch.Tensor,
    wm_tot: torch.Tensor,
    v_feat: torch.Tensor,
    v_T: torch.Tensor,
    v_dist: torch.Tensor,
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
) -> torch.Tensor:
    """Launch csrc/rasterize_2dgs_tiled_bwd.cu: one block per (camera,
    tile), one thread per pixel, rows gathered by `ids`. Returns rows
    [12 + L, M] as `_tiled2_bwd_plain` does. An empty stream launches
    nothing."""
    _check_L(L, "backward")
    th, tw = _dims(image_width, image_height, tile_size)
    T = n_cams * th * tw
    _kernel_checks("tiled 2DGS backward", packed, NFIX + L, ids, offs, cnts, T, tile_size)
    dev = packed.device
    img = (n_cams, image_height, image_width)
    _check("tiled 2DGS backward", dev, [
        (T_fin, torch.float32, img), (last, torch.int32, img), (wm_tot, torch.float32, img),
        (v_feat, torch.float32, img + (L,)), (v_T, torch.float32, img), (v_dist, torch.float32, img),
    ])
    M = ids.shape[0]
    rows = torch.zeros((NFIX + L, M), dtype=torch.float32, device=dev)
    if T == 0 or M == 0:
        return rows
    fn = _backend.kernel("rasterize_2dgs_tiled_bwd", "rasterize_2dgs_tiled_bwd_launch", _BWD_ARGS)
    code = fn(
        packed.data_ptr(), packed.shape[1], ids.data_ptr(), M, offs.data_ptr(), cnts.data_ptr(),
        n_cams, th, tw, tile_size, image_width, image_height, L,
        T_fin.data_ptr(), last.data_ptr(), wm_tot.data_ptr(), v_feat.data_ptr(),
        v_T.data_ptr(), v_dist.data_ptr(), rows.data_ptr(), _backend.stream(dev),
    )
    _backend.check_launch(code, "rasterize_2dgs_tiled_bwd")
    _backend.LAUNCHES["rasterize_2dgs_tiled_bwd"] += 1
    return rows


def _raster_2dgs_tiled_fwd(
    mean_x, mean_y, Ms, opacities, colors, normals, ids, offs, cnts,
    image_width: int, image_height: int, tile_size: int,
):
    """Pack the surfel rows, then composite. Returns (features [C,H,W,L],
    T_final, last, distortion, median, packed)."""
    device = _backend.common_device(mean_x, mean_y, Ms, opacities, colors, normals, ids)
    if tile_size not in TILE_SIZES:
        raise ValueError(f"tile_size must be one of {TILE_SIZES}, got {tile_size}")
    if not 1 <= colors.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"1..{MAX_CHANNELS} colour channels per call, got {colors.shape[-1]}")
    packed = pack_rows(surfel_payload(mean_x, mean_y, Ms, opacities, colors, normals))
    L = colors.shape[-1] + 3
    args = (packed, L, ids, offs, cnts, mean_x.shape[0], image_width, image_height, tile_size)
    if _backend.use_kernel(device):
        outs = _tiled2_fwd_cuda(*args)
    else:
        outs = _tiled2_fwd_plain(*args)[:5]
    return (*outs, packed)


class _Tiled2DGS(torch.autograd.Function):
    """pack -> tiled 2DGS forward kernel, with the tiled 2DGS backward
    kernel and the reduce kernel (in ``order``, the stream's gid order, as
    `_TiledRaster`) as its gradient (JAX: the custom VJP
    `_raster_entries_2dgs` and its gather's VJP). Returns the features
    without background, T_final, the distortion and the median (which has
    no gradient)."""

    @staticmethod
    def forward(ctx, mean_x, mean_y, Ms, opacities, colors, normals, ids, offs, cnts, order, geom):
        feat, T_out, last, dist, med, packed = _raster_2dgs_tiled_fwd(
            mean_x, mean_y, Ms, opacities, colors, normals, ids, offs, cnts, *geom,
        )
        D = colors.shape[-1]
        ctx.save_for_backward(packed, ids, offs, cnts, T_out, last, feat[..., D - 1].contiguous())
        ctx.geom = geom
        ctx.n_gauss = mean_x.shape[1]
        ctx.L = D + 3
        ctx.order = order
        ctx.mark_non_differentiable(med)
        return feat, T_out, dist, med

    @staticmethod
    @once_differentiable
    def backward(ctx, v_feat, v_T, v_dist, _v_med):
        packed, ids, offs, cnts, T_out, last, wm_tot = ctx.saved_tensors
        C = T_out.shape[0]
        L = ctx.L
        D = L - 3
        N = ctx.n_gauss

        def dense(v, shape):
            return torch.zeros(shape, dtype=torch.float32, device=T_out.device) if v is None else v.contiguous()

        args = (
            packed, L, ids, offs, cnts, T_out, last, wm_tot, dense(v_feat, T_out.shape + (L,)),
            dense(v_T, T_out.shape), dense(v_dist, T_out.shape), C, *ctx.geom,
        )
        if _backend.use_kernel(packed.device):
            rows = _tiled2_bwd_cuda(*args)
        else:
            rows, _ = _tiled2_bwd_plain(*args)
        red = reduce_by_gid(rows, ids, C * N, order=ctx.order)  # [12 + L, C * N]
        v_feat_g = red[NFIX:].T.reshape(C, N, L)
        return (
            red[0].reshape(C, N), red[1].reshape(C, N), red[2:11].T.reshape(C, N, 9),
            red[11].reshape(C, N), v_feat_g[..., :D], v_feat_g[..., D:],
            None, None, None, None, None,
        )


def rasterize_to_pixels_2dgs_tiled(
    means2d,  # [C, N, 2] or (mean_x, mean_y) [C, N] tuple
    ray_transforms,  # [C, N, 3, 3] or a tuple of the 9 [C, N] rows
    colors: torch.Tensor,  # [C, N, D], the last channel the depth
    normals: torch.Tensor,  # [C, N, 3]
    opacities: torch.Tensor,  # [C, N]
    image_width: int,
    image_height: int,
    tile_size: int,
    isect: Isect,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
):
    """Rasterize surfels over the `isect_tiles` stream. Returns
    (render_colors [C,H,W,D], render_alphas [C,H,W,1], render_normals
    [C,H,W,3] in the camera frame, render_distort [C,H,W,1], render_median
    [C,H,W,1]). Semantics identical to rasterize_to_pixels_2dgs_ref. With
    grad mode on and an input that requires grad, the call goes through
    `_Tiled2DGS` (backward and reduce kernels)."""
    if isinstance(means2d, (tuple, list)):
        mean_x, mean_y = means2d
    else:
        mean_x, mean_y = means2d[..., 0], means2d[..., 1]
    if isinstance(ray_transforms, (tuple, list)):
        Ms = torch.stack(list(ray_transforms), dim=-1)
    else:
        Ms = ray_transforms.reshape(ray_transforms.shape[:-2] + (9,))
    D = colors.shape[-1]
    ins = (mean_x, mean_y, Ms, opacities, colors, normals)
    ids = isect.flatten_ids
    offs, cnts = stream_ranges(isect)
    geom = (image_width, image_height, tile_size)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        feat, T_out, dist, med = _Tiled2DGS.apply(*ins, ids, offs, cnts, isect.order, geom)
    else:
        feat, T_out, _, dist, med, _ = _raster_2dgs_tiled_fwd(*ins, ids, offs, cnts, *geom)
    render = feat[..., :D]
    if backgrounds is not None:
        render = render + T_out[..., None] * backgrounds[:, None, None, :]
    return render, (1.0 - T_out)[..., None], feat[..., D:], dist[..., None], med[..., None]
