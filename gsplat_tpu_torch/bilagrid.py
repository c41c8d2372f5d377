"""Bilateral-grid colour correction (port of gsplat_tpu/bilagrid.py).

Per-image learnable 3D grids of 3x4 affine colour transforms, sliced at
(x, y, luminance) with trilinear interpolation ("Bilateral Guided Radiance
Field Processing", SIGGRAPH 2024), the total-variation regulariser and the
evaluation-time affine fit ``color_correct``.

The slice's forward is ``F.grid_sample`` (trilinear, corners aligned), as
the JAX package leaves its gather to XLA. Its gradient goes through
`_GridSlice`: with respect to the grids, the kernel csrc/bilagrid_bwd.cu on
the card (`_grid_grad_plain` is its plain version, for CPU tensors), a
gather that sums each node's pixels in a fixed order, so two runs of a step
give the same bits (``grid_sample``'s own backward adds into the cells with
atomics); with respect to the pixels' luminance, a second kernel of the
same source, per pixel, from the eight corners as the JAX package
differentiates its lerps (`_lum_grad` is its plain version;
``grid_sample``'s border rule would give 0 where the luminance sits on the
bottom node). The luminance is clipped to [0, 1] with JAX's
gradient at the ends: half of it where it equals 0 or 1.
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import _backend
from ._backend import resolve_device
from .modules import take_rows
from .ops.rasterize_binned import _check

RGB2GRAY = (0.299, 0.587, 0.114)


def _corners(t: torch.Tensor, g: int):
    """The JAX package's lower and upper node and fraction along an axis of
    `g` nodes at normalised coordinates `t` in [0, 1]."""
    c = t * (g - 1)
    i0 = torch.clamp(torch.floor(c).to(torch.int64), 0, g - 1)
    return i0, torch.clamp_max(i0 + 1, g - 1), c - i0


def _grid_grad_plain(v: torch.Tensor, gray: torch.Tensor, grid_shape) -> torch.Tensor:
    """Plain version of csrc/bilagrid_bwd.cu: the gradient [B, Z, Y, X, 12]
    of the trilinear slice with respect to the (gathered) grids, for the
    slice's cotangent ``v`` [B, H, W, 12] at pixel centres and luminance
    ``gray`` [B, H, W]: each of the eight corners' weights times ``v``,
    scattered into the cells corner by corner and pixel by pixel
    (``index_add_``, a fixed order on the CPU), each product rounded in the
    JAX package's order ((v wz) wy) wx."""
    B, Z, Y, X, NC = grid_shape
    H, Wd = v.shape[1:3]
    dev, dt = v.device, v.dtype
    x0, x1, fx = _corners((torch.arange(Wd, device=dev, dtype=dt) + 0.5) / Wd, X)
    y0, y1, fy = _corners((torch.arange(H, device=dev, dtype=dt) + 0.5) / H, Y)
    z0, z1, fz = _corners(gray, Z)
    bz = torch.arange(B, device=dev)[:, None, None] * Z
    out = torch.zeros(B * Z * Y * X * NC, device=dev, dtype=dt)
    lanes = torch.arange(NC, device=dev)
    for zi, wz in ((z0, 1 - fz), (z1, fz)):
        for yi, wy in ((y0, 1 - fy), (y1, fy)):
            for xi, wx in ((x0, 1 - fx), (x1, fx)):
                cell = ((bz + zi) * Y + yi[None, :, None]) * X + xi[None, None, :]  # [B, H, W]
                val = ((v * wz[..., None]) * wy[None, :, None, None]) * wx[None, None, :, None]
                out.index_add_(0, (cell[..., None] * NC + lanes).reshape(-1), val.reshape(-1))
    return out.reshape(B, Z, Y, X, NC)


_GRID_GRAD_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2


def _grid_grad_cuda(v: torch.Tensor, gray: torch.Tensor, grid_shape) -> torch.Tensor:
    """Launch csrc/bilagrid_bwd.cu: one block per (image, y node, x node),
    the same bits on every launch. Same output as `_grid_grad_plain`."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"the bilateral grid's gradient kernel takes CUDA tensors, got {dev}")
    B, Z, Y, X, NC = grid_shape
    H, Wd = v.shape[1:3]
    if NC != 12 or not 1 <= Z <= 16:
        raise ValueError(f"the kernel takes grids [B, Z <= 16, Y, X, 12], got {tuple(grid_shape)}")
    _check("grid gradient", dev, [(v, torch.float32, (B, H, Wd, NC)), (gray, torch.float32, (B, H, Wd))])
    out = torch.empty(tuple(grid_shape), dtype=torch.float32, device=dev)
    fn = _backend.kernel("bilagrid_bwd", "bilagrid_bwd_launch", _GRID_GRAD_ARGS)
    code = fn(v.data_ptr(), gray.data_ptr(), B, H, Wd, Z, Y, X, out.data_ptr(), _backend.stream(dev))
    _backend.check_launch(code, "bilagrid_bwd")
    _backend.LAUNCHES["bilagrid_bwd"] += 1
    return out


def grid_grad(v: torch.Tensor, gray: torch.Tensor, grid_shape) -> torch.Tensor:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if _backend.use_kernel(_backend.common_device(v, gray)):
        return _grid_grad_cuda(v, gray, grid_shape)
    return _grid_grad_plain(v, gray, grid_shape)


def _coords(gray: torch.Tensor) -> torch.Tensor:
    """grid_sample's coordinates [B, 1, H, W, 3] in [-1, 1] of the pixel
    centres (x, y) and the luminance ``gray`` [B, H, W]."""
    B, H, Wd = gray.shape
    u = (torch.arange(Wd, dtype=gray.dtype, device=gray.device) + 0.5) / Wd
    v = (torch.arange(H, dtype=gray.dtype, device=gray.device) + 0.5) / H
    xyz = torch.stack([u[None, None, :].expand(B, H, Wd), v[None, :, None].expand(B, H, Wd), gray], dim=-1)
    return (xyz * 2.0 - 1.0)[:, None]


def _lum_grad(g: torch.Tensor, gray: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of csrc/bilagrid_bwd.cu's luminance kernel: the
    slice's gradient [B, H, W] with respect to the luminance
    ``gray`` [B, H, W], for the cotangent ``v`` [B, H, W, 12]: (Z - 1)
    times v . (c1 - c0), c0 and c1 the bilinear (x, y) slices of the two z
    levels around the pixel (the JAX package's lerps, whose fz = gz - z0)."""
    B, Z, Y, X, NC = g.shape
    H, Wd = gray.shape[1:]
    dev, dt = gray.device, gray.dtype
    x0, x1, fx = _corners((torch.arange(Wd, device=dev, dtype=dt) + 0.5) / Wd, X)
    y0, y1, fy = _corners((torch.arange(H, device=dev, dtype=dt) + 0.5) / H, Y)
    z0, z1, _ = _corners(gray, Z)
    flat = g.reshape(B, Z * Y * X, NC)
    fx, fy = fx[None, None, :, None], fy[None, :, None, None]

    def level(z):
        def at(y, x):
            idx = (z * Y + y[None, :, None]) * X + x[None, None, :]  # [B, H, W]
            return torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, NC)).reshape(B, H, Wd, NC)

        return (at(y0, x0) * (1 - fx) + at(y0, x1) * fx) * (1 - fy) + (at(y1, x0) * (1 - fx) + at(y1, x1) * fx) * fy

    return (v * (level(z1) - level(z0))).sum(dim=-1) * (Z - 1)


_LUM_GRAD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2


def _lum_grad_cuda(g: torch.Tensor, gray: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch csrc/bilagrid_bwd.cu's luminance kernel: a thread per pixel.
    Same output as `_lum_grad`."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"the bilateral grid's luminance gradient kernel takes CUDA tensors, got {dev}")
    B, Z, Y, X, NC = g.shape
    H, Wd = gray.shape[1:]
    _check("luminance gradient", dev, [(g, torch.float32, (B, Z, Y, X, 12)), (v, torch.float32, (B, H, Wd, 12)),
                                       (gray, torch.float32, (B, H, Wd))])
    out = torch.empty((B, H, Wd), dtype=torch.float32, device=dev)
    fn = _backend.kernel("bilagrid_bwd", "bilagrid_lum_bwd_launch", _LUM_GRAD_ARGS)
    code = fn(g.data_ptr(), v.data_ptr(), gray.data_ptr(), B, H, Wd, Z, Y, X, out.data_ptr(), _backend.stream(dev))
    _backend.check_launch(code, "bilagrid_lum_bwd")
    _backend.LAUNCHES["bilagrid_lum_bwd"] += 1
    return out


def lum_grad(g: torch.Tensor, gray: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, `_lum_grad` for CPU tensors."""
    if _backend.use_kernel(_backend.common_device(g, gray, v)):
        return _lum_grad_cuda(g, gray, v)
    return _lum_grad(g, gray, v)


class _GridSlice(torch.autograd.Function):
    """affine [B, H, W, 12] = the trilinear slice of grids [B, Z, Y, X, 12]
    at the pixel centres and ``gray`` [B, H, W]: grid_sample's forward, the
    grids' gradient by `grid_grad`, the luminance's by `lum_grad`."""

    @staticmethod
    def forward(ctx, g, gray):
        affine = F.grid_sample(g.permute(0, 4, 1, 2, 3), _coords(gray), mode="bilinear", padding_mode="border",
                               align_corners=True)
        ctx.save_for_backward(g, gray)
        return affine[:, :, 0].permute(0, 2, 3, 1)  # [B, H, W, 12]

    @staticmethod
    def backward(ctx, v):
        g, gray = ctx.saved_tensors
        v = v.contiguous()
        d_g = grid_grad(v, gray.contiguous(), g.shape) if ctx.needs_input_grad[0] else None
        d_gray = lum_grad(g.contiguous(), gray.contiguous(), v) if ctx.needs_input_grad[1] else None
        return d_g, d_gray


def slice_grid(grids: torch.Tensor, image_ids: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Apply each image's grid (``grids`` [n, W, Y, X, 12], rows by
    ``image_ids`` [B] as `modules.take_rows` reads them) to its rendered
    ``rgb`` [B, H, W, 3]: the affine transform trilinearly interpolated at
    the pixel's (x, y) centre and its luminance, the grid's corners at 0
    and 1 (`_GridSlice`; the JAX package's clipped corner indices and
    lerps)."""
    g = take_rows(grids, image_ids)  # [B, W, Y, X, 12]
    B, H, Wd = rgb.shape[:3]
    coef = torch.tensor(RGB2GRAY, dtype=torch.float32, device=rgb.device)
    lum = (rgb * coef).sum(dim=-1)  # [B, H, W]
    # jnp.clip's gradient: half of it where the luminance equals 0 or 1
    gray = torch.minimum(torch.maximum(lum, torch.zeros_like(lum)), torch.ones_like(lum))
    A = _GridSlice.apply(g, gray).reshape(B, H, Wd, 3, 4)
    return (A[..., :3] * rgb[..., None, :]).sum(dim=-1) + A[..., 3]


def total_variation_loss(grids: torch.Tensor) -> torch.Tensor:
    """Mean squared differences along each grid axis, summed."""
    return sum(torch.mean(torch.diff(grids, dim=axis) ** 2) for axis in (1, 2, 3))


def color_correct(img: torch.Tensor, ref: torch.Tensor, num_iters: int = 5, eps: float = 0.5 / 255) -> torch.Tensor:
    """Least-squares affine colour fit of `img` to `ref` (ridge-regularised
    normal equations), clipped to [0, 1]. ``num_iters`` and ``eps`` are
    taken and unused, as in the JAX package."""
    shape = img.shape
    x = img.reshape(-1, 3)
    A = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], dim=1)  # [P, 4]
    AtA = A.T @ A + 1e-4 * torch.eye(4, dtype=x.dtype, device=x.device)
    M = torch.linalg.solve(AtA, A.T @ ref.reshape(-1, 3))  # [4, 3]
    return torch.clamp((A @ M).reshape(shape), 0.0, 1.0)


class BilateralGrid(nn.Module):
    """``n`` identity-affine grids [n, grid_w, grid_y, grid_x, 12]:
    ``forward(rgb [B, H, W, 3], image_ids [B])`` slices them."""

    def __init__(self, n: int, grid_x: int = 16, grid_y: int = 16, grid_w: int = 8, device="cuda"):
        super().__init__()
        ident = torch.zeros(12)
        ident[0] = ident[5] = ident[10] = 1.0  # rows of [I | 0]
        grids = ident.repeat(n, grid_w, grid_y, grid_x, 1)
        self.grids = nn.Parameter(grids.to(resolve_device(device)))

    @classmethod
    def from_numpy(cls, params: Mapping[str, np.ndarray], device="cuda") -> "BilateralGrid":
        n, gw, gy, gx, _ = params["grids"].shape
        m = cls(n, gx, gy, gw, device=device)
        with torch.no_grad():
            m.grids.copy_(torch.tensor(np.asarray(params["grids"], np.float32)))
        return m

    def forward(self, rgb: torch.Tensor, image_ids: torch.Tensor) -> torch.Tensor:
        return slice_grid(self.grids, image_ids, rgb)

    def tv_loss(self) -> torch.Tensor:
        return total_variation_loss(self.grids)
