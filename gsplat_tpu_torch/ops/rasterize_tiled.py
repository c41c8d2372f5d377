"""Tiled rasterizer: forward compositing and its backward over the
`isect_tiles` stream (port of gsplat_tpu/ops/rasterize_tiled.py).

`ops/isect.py` builds the depth-sorted stream of (camera, Gaussian, tile)
entries: each (camera, tile) owns a range of ``flatten_ids``. The
per-Gaussian values are packed once as rows of F floats (`pack_rows`:
``[C*N, F]``, F a multiple of 8) and the kernels gather the rows their
range names; no ``[F, M]`` entry stream is written. The forward kernel
(csrc/rasterize_tiled_fwd.cu; `_tiled_fwd_plain` is its plain version)
composites each (camera, tile) range into its pixels. Semantics are those
of ops/rasterize_ref.py (the oracle) and of the binned backend.

Gradients go through `_TiledRaster`, a torch.autograd.Function over
pack -> forward -> (backward -> gid reduce): the backward kernel
(csrc/rasterize_tiled_bwd.cu; `_tiled_bwd_plain`) writes one row of
per-entry gradients per stream slot, and the gid reduce kernel
(ops/rasterize_binned.py::reduce_by_gid) sums the slots of each Gaussian
in the gid order that `isect_tiles`'s sort already gives (`Isect.order`),
where JAX's gather VJP is a scatter-add. The background is added outside
the kernels, as in JAX.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .. import _backend
from .binning import ROW_ALIGN, pack_rows
from .isect import Isect
from .rasterize_binned import (
    MAX_CHANNELS,
    TILE_SIZES,
    _bwd_plain,
    _check,
    _fwd_plain,
    _split,
    reduce_by_gid,
)

def stream_ranges(isect: Isect) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offs, cnts) [C*th*tw] i32: each (camera, tile)'s range of the stream."""
    offs = isect.offsets.reshape(-1).to(torch.int32).contiguous()
    cnts = (isect.ends - isect.offsets).reshape(-1).to(torch.int32).contiguous()
    return offs, cnts


def gather_stream(packed: torch.Tensor, nf: int, ids: torch.Tensor) -> torch.Tensor:
    """The plain versions' [nf, M] entry stream: packed[ids, :nf] transposed."""
    return packed[ids.to(torch.int64), :nf].T.contiguous()


def _tiled_fwd_plain(
    packed: torch.Tensor,  # [C*N, F] f32
    D: int,
    ids: torch.Tensor,  # [M] i32
    offs: torch.Tensor,  # [T] i32
    cnts: torch.Tensor,  # [T] i32
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
):
    """Plain torch version of the forward kernel: gather the stream, then
    the binned backend's plain compositing. Returns (image [C,H,W,D] without
    background, T_final [C,H,W], last [C,H,W] i32 absolute stream index or
    -1, n_pairs)."""
    entries = gather_stream(packed, 6 + D, ids)
    return _fwd_plain(entries, offs, cnts, n_cams, image_width, image_height, tile_size)


def _kernel_checks(what, packed, nf, ids, offs, cnts, T, tile_size):
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel takes CUDA tensors, got {dev}")
    if tile_size not in TILE_SIZES:
        raise ValueError(f"tile_size must be one of {TILE_SIZES}, got {tile_size}")
    F = packed.shape[1]
    if F % ROW_ALIGN or F < nf:
        raise ValueError(f"packed rows of {F} floats: expected a multiple of {ROW_ALIGN} >= {nf}")
    _check(what, dev, [(packed, torch.float32, None), (ids, torch.int32, (ids.shape[0],)),
                       (offs, torch.int32, (T,)), (cnts, torch.int32, (T,))])


_FWD_ARGS = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]  # packed, F, ids
    + [ctypes.c_void_p] * 2  # offs, cnts
    + [ctypes.c_int] * 7  # C, th, tw, ts, W, H, D
    + [ctypes.c_void_p] * 4  # image, T, last, stream
)


def _tiled_fwd_cuda(
    packed: torch.Tensor,
    D: int,
    ids: torch.Tensor,
    offs: torch.Tensor,
    cnts: torch.Tensor,
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
):
    """Launch csrc/rasterize_tiled_fwd.cu: one block per (camera, tile), one
    thread per pixel, rows gathered by `ids`. Returns (image [C,H,W,D]
    without background, T_final [C,H,W], last [C,H,W] i32). An empty stream
    launches nothing."""
    if not 1 <= D <= MAX_CHANNELS:
        raise ValueError(f"the tiled forward kernel takes 1..{MAX_CHANNELS} channels, got {D}")
    th = -(-image_height // tile_size)
    tw = -(-image_width // tile_size)
    T = n_cams * th * tw
    _kernel_checks("tiled forward", packed, 6 + D, ids, offs, cnts, T, tile_size)
    dev = packed.device
    shape = (n_cams, image_height, image_width)
    if T == 0 or ids.shape[0] == 0:
        return (torch.zeros(shape + (D,), dtype=torch.float32, device=dev),
                torch.ones(shape, dtype=torch.float32, device=dev),
                torch.full(shape, -1, dtype=torch.int32, device=dev))
    img = torch.empty(shape + (D,), dtype=torch.float32, device=dev)
    T_out = torch.empty(shape, dtype=torch.float32, device=dev)
    last = torch.empty(shape, dtype=torch.int32, device=dev)
    fn = _backend.kernel("rasterize_tiled_fwd", "rasterize_tiled_fwd_launch", _FWD_ARGS)
    code = fn(
        packed.data_ptr(), packed.shape[1], ids.data_ptr(), offs.data_ptr(), cnts.data_ptr(),
        n_cams, th, tw, tile_size, image_width, image_height, D,
        img.data_ptr(), T_out.data_ptr(), last.data_ptr(), _backend.stream(dev),
    )
    _backend.check_launch(code, "rasterize_tiled_fwd")
    _backend.LAUNCHES["rasterize_tiled_fwd"] += 1
    return img, T_out, last


def _tiled_bwd_plain(
    packed: torch.Tensor,  # [C*N, F] f32
    D: int,
    ids: torch.Tensor,  # [M] i32
    offs: torch.Tensor,  # [T] i32
    cnts: torch.Tensor,  # [T] i32
    T_fin: torch.Tensor,  # [C, H, W] f32, the forward's T_final
    last: torch.Tensor,  # [C, H, W] i32, the forward's last accepted index
    v_img: torch.Tensor,  # [C, H, W, D] cotangent of the image (no background)
    v_T: torch.Tensor,  # [C, H, W] cotangent of T_final
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
    absgrad: bool = False,
):
    """Plain torch version of the backward kernel: gather the stream, then
    the binned backend's plain backward. Returns (rows [6 + D (+2), M],
    (n_eval, n_acc))."""
    entries = gather_stream(packed, 6 + D, ids)
    return _bwd_plain(entries, offs, cnts, T_fin, last, v_img, v_T, n_cams,
                      image_width, image_height, tile_size, absgrad)


_BWD_ARGS = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]  # packed, F, ids, M
    + [ctypes.c_void_p] * 2  # offs, cnts
    + [ctypes.c_int] * 7  # C, th, tw, ts, W, H, D
    + [ctypes.c_void_p] * 4  # T_final, last, v_img, v_T
    + [ctypes.c_int]  # absgrad
    + [ctypes.c_void_p] * 2  # rows, stream
)


def _tiled_bwd_cuda(
    packed: torch.Tensor,
    D: int,
    ids: torch.Tensor,
    offs: torch.Tensor,
    cnts: torch.Tensor,
    T_fin: torch.Tensor,
    last: torch.Tensor,
    v_img: torch.Tensor,
    v_T: torch.Tensor,
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
    absgrad: bool = False,
) -> torch.Tensor:
    """Launch csrc/rasterize_tiled_bwd.cu: one block per (camera, tile), one
    thread per pixel, rows gathered by `ids`. Returns rows [6 + D (+2), M]
    as `_tiled_bwd_plain` does. An empty stream launches nothing."""
    if not 1 <= D <= MAX_CHANNELS:
        raise ValueError(f"the tiled backward kernel takes 1..{MAX_CHANNELS} channels, got {D}")
    th = -(-image_height // tile_size)
    tw = -(-image_width // tile_size)
    T = n_cams * th * tw
    _kernel_checks("tiled backward", packed, 6 + D, ids, offs, cnts, T, tile_size)
    dev = packed.device
    img_shape = (n_cams, image_height, image_width)
    _check("tiled backward", dev, [
        (T_fin, torch.float32, img_shape), (last, torch.int32, img_shape),
        (v_img, torch.float32, img_shape + (D,)), (v_T, torch.float32, img_shape),
    ])
    M = ids.shape[0]
    rows = torch.zeros((6 + D + (2 if absgrad else 0), M), dtype=torch.float32, device=dev)
    if T == 0 or M == 0:
        return rows
    fn = _backend.kernel("rasterize_tiled_bwd", "rasterize_tiled_bwd_launch", _BWD_ARGS)
    code = fn(
        packed.data_ptr(), packed.shape[1], ids.data_ptr(), M, offs.data_ptr(), cnts.data_ptr(),
        n_cams, th, tw, tile_size, image_width, image_height, D,
        T_fin.data_ptr(), last.data_ptr(), v_img.data_ptr(), v_T.data_ptr(), int(absgrad),
        rows.data_ptr(), _backend.stream(dev),
    )
    _backend.check_launch(code, "rasterize_tiled_bwd")
    _backend.LAUNCHES["rasterize_tiled_bwd"] += 1
    return rows


def _raster_tiled_fwd(
    mean_x, mean_y, con_a, con_b, con_c, opacities, colors, ids, offs, cnts,
    image_width: int, image_height: int, tile_size: int,
):
    """Pack, then composite. Returns (image [C,H,W,D] without background,
    T_final [C,H,W], last [C,H,W], packed)."""
    device = _backend.common_device(mean_x, mean_y, con_a, con_b, con_c, opacities, colors, ids)
    if tile_size not in TILE_SIZES:
        raise ValueError(f"tile_size must be one of {TILE_SIZES}, got {tile_size}")
    D = colors.shape[-1]
    if not 1 <= D <= MAX_CHANNELS:
        raise ValueError(
            f"1..{MAX_CHANNELS} channels per call, got {D}: split them "
            "(rasterization's channel_chunk does)"
        )
    packed = pack_rows([mean_x, mean_y, con_a, con_b, con_c, opacities, *colors.unbind(-1)])
    args = (packed, D, ids, offs, cnts, mean_x.shape[0], image_width, image_height, tile_size)
    if _backend.use_kernel(device):
        img, T_out, last = _tiled_fwd_cuda(*args)
    else:
        img, T_out, last, _ = _tiled_fwd_plain(*args)
    return img, T_out, last, packed


class _TiledRaster(torch.autograd.Function):
    """pack -> tiled forward kernel, with the tiled backward kernel and the
    reduce kernel as its gradient (JAX: the custom VJP `_raster_packed`).
    ``order`` is the stream's gid order for the reduce (`Isect.order`, or
    None to sort the gids). Returns the image without background and
    T_final; the caller adds the background."""

    @staticmethod
    def forward(ctx, mean_x, mean_y, con_a, con_b, con_c, opacities, colors,
                abs_x, abs_y, ids, offs, cnts, order, geom):
        image_width, image_height, tile_size = geom
        img, T_out, last, packed = _raster_tiled_fwd(
            mean_x, mean_y, con_a, con_b, con_c, opacities, colors, ids, offs, cnts,
            image_width, image_height, tile_size,
        )
        ctx.save_for_backward(packed, ids, offs, cnts, T_out, last)
        ctx.geom = geom
        ctx.n_gauss = mean_x.shape[1]
        ctx.D = colors.shape[-1]
        ctx.absgrad = abs_x is not None
        ctx.order = order
        return img, T_out

    @staticmethod
    @once_differentiable
    def backward(ctx, v_img, v_T):
        packed, ids, offs, cnts, T_out, last = ctx.saved_tensors
        image_width, image_height, tile_size = ctx.geom
        C = T_out.shape[0]
        D = ctx.D
        N = ctx.n_gauss
        if v_img is None:
            v_img = torch.zeros(T_out.shape + (D,), dtype=torch.float32, device=T_out.device)
        if v_T is None:
            v_T = torch.zeros_like(T_out)
        args = (
            packed, D, ids, offs, cnts, T_out, last, v_img.contiguous(), v_T.contiguous(),
            C, image_width, image_height, tile_size, ctx.absgrad,
        )
        if _backend.use_kernel(packed.device):
            rows = _tiled_bwd_cuda(*args)
        else:
            rows, _ = _tiled_bwd_plain(*args)
        red = reduce_by_gid(rows, ids, C * N, order=ctx.order)
        grads = [red[r].reshape(C, N) for r in range(6)]
        v_colors = red[6 : 6 + D].T.reshape(C, N, D)
        if ctx.absgrad:
            v_abs = [red[6 + D].reshape(C, N), red[7 + D].reshape(C, N)]
        else:
            v_abs = [None, None]
        return (*grads, v_colors, *v_abs, None, None, None, None, None)


def rasterize_to_pixels_tiled(
    means2d,  # [C, N, 2] or (mean_x, mean_y) [C, N] tuple
    conics,  # [C, N, 3] or (a, b, c) tuple
    colors: torch.Tensor,  # [C, N, D]
    opacities: torch.Tensor,  # [C, N]
    image_width: int,
    image_height: int,
    tile_size: int,
    isect: Isect,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
    abs_carrier=None,  # (x, y) [C, N] zeros; its gradient is the per-tile absgrad
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterize the `isect_tiles` stream. Returns (render_colors [C,H,W,D],
    render_alphas [C,H,W,1]). Semantics identical to
    rasterize_to_pixels_ref. With grad mode on and an input that requires
    grad, the call goes through `_TiledRaster` (backward and reduce
    kernels); the gradient of ``abs_carrier`` is then the reference's
    absgrad statistic, the sum over tiles of |per-tile d mean2d|. Without a
    gradient it is the forward alone."""
    mean_x, mean_y, con_a, con_b, con_c = _split(means2d, conics)
    ins = (mean_x, mean_y, con_a, con_b, con_c, opacities, colors)
    abs_x, abs_y = abs_carrier if abs_carrier is not None else (None, None)
    ids = isect.flatten_ids
    offs, cnts = stream_ranges(isect)
    geom = (image_width, image_height, tile_size)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins + (abs_x, abs_y) if t is not None):
        img, T_out = _TiledRaster.apply(*ins, abs_x, abs_y, ids, offs, cnts, isect.order, geom)
    else:
        img, T_out, _, _ = _raster_tiled_fwd(*ins, ids, offs, cnts, *geom)
    if backgrounds is not None:
        img = img + T_out[..., None] * backgrounds[:, None, None, :]
    return img, (1.0 - T_out)[..., None]
