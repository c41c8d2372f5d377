"""Bilateral-grid colour correction (port of gsplat_tpu/bilagrid.py).

Per-image learnable 3D grids of 3x4 affine colour transforms, sliced at
(x, y, luminance) with trilinear interpolation ("Bilateral Guided Radiance
Field Processing", SIGGRAPH 2024), the total-variation regulariser and the
evaluation-time affine fit ``color_correct``.

The slice's forward is ``F.grid_sample`` (trilinear, corners aligned), as
the JAX package leaves its gather to XLA. Its gradient goes through
`_GridSlice`: with respect to the grids, the kernel csrc/bilagrid_bwd.cu on
the card (`_grid_grad_plain` is its plain version, for CPU tensors), one
pass over `grad_plan`'s pixel tiles and a sum of each node's tile partials
in a fixed order, so two runs of a step give the same bits
(``grid_sample``'s own backward adds into the cells with atomics); with
respect to the pixels' luminance, a second kernel of the same source over
the same tiles, from the eight corners as the JAX package differentiates
its lerps (`_lum_grad` is its plain version;
``grid_sample``'s border rule would give 0 where the luminance sits on the
bottom node). The luminance is clipped to [0, 1] with JAX's
gradient at the ends: half of it where it equals 0 or 1.
"""

from __future__ import annotations

import ctypes
import functools
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


# the grid gradient kernels' layout (csrc/bilagrid_bwd.cu): blocks of
# GRAD_THREADS threads, each warp's chunks of 32 pixels copied into
# GRAD_STAGES stages of shared memory, about GRAD_TILES_PER_SM tiles an SM
# (a few waves of blocks)
GRAD_THREADS = 256
GRAD_WARPS = GRAD_THREADS // 32
GRAD_TILES_PER_SM = 16
GRAD_STAGES = 2
GRAD_PLAN_HEADER = 4
SMEM_LIMIT = 232448  # shared memory a block may take on the H100


def grad_smem(Z: int):
    """Shared bytes a block takes: (the grids' gradient, the luminance's).
    Each warp of both keeps GRAD_STAGES chunks in flight (a chunk: 32
    pixels' v and gray). The grids' adds each warp's pixels' x-and-z
    weights [32, 2, 2] and its sums [Z + 1, 12, 4] (a level past the top
    takes the upper weight of a pixel whose two levels coincide); the
    luminance's the tile's node window of level differences [Z, 4 corners,
    12] at a pitch of 52 floats a level."""
    stages = GRAD_STAGES * (32 * 12 + 32)
    return GRAD_WARPS * 4 * (stages + 32 * 4 + (Z + 1) * 48), 4 * (GRAD_WARPS * stages + 52 * Z)


def _lower_nodes(n: int, g: int) -> np.ndarray:
    """Each of `n` pixels' lower node along an axis of `g` nodes, rounded as
    `_corners` and the kernels round: ((i + 0.5) / n) (g - 1) in float32,
    floored and clipped."""
    t = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)
    return np.clip(np.floor(t * np.float32(g - 1)), 0, g - 1).astype(np.int64)


def _runs(n: int, g: int):
    """The runs of pixels along an axis that share their lower node:
    (starts, lengths, nodes), and for each of the `g` nodes the two
    (run * 2 + slot) that reach it, slot 0 the run's lower node and slot
    1 its upper one (-1 where fewer), in ascending order."""
    lo = _lower_nodes(n, g)
    starts = np.flatnonzero(np.diff(lo, prepend=-1)) if n else np.zeros(0, np.int64)
    lengths = np.diff(np.append(starts, n))
    nodes = lo[starts]
    reach = np.full((g, 2), -1, np.int64)
    for k in range(g):
        hits = sorted([r * 2 for r in np.flatnonzero(nodes == k)]
                      + [r * 2 + 1 for r in np.flatnonzero(np.minimum(nodes + 1, g - 1) == k)])
        reach[k, :len(hits)] = hits
    return starts, lengths, reach


@functools.lru_cache(maxsize=64)
def grad_plan(B: int, H: int, W: int, Z: int, Y: int, X: int, sms: int = 132) -> np.ndarray:
    """The tiles both gradient kernels of csrc/bilagrid_bwd.cu take, for
    images [B, H, W] and grids [B, Z, Y, X, 12] on a card of `sms` SMs, as
    one read-only int32 array:

    - a header of GRAD_PLAN_HEADER ints: tiles an image Ti, column runs
      Rx, row runs Ry, 0;
    - B x Ti tiles (b * H + h0, w0, rows, columns), image by image, row
      run by row run, column run by column run, then down the run's rows;
    - for each x node, the two (column run * 2 + slot) that reach it (-1
      where fewer; `_runs`), then the same for each y node;
    - for the Ry x Rx cells of an image, the index of each cell's first
      tile within the image, and Ti.

    A run is the pixels along an axis whose lower node is the same, with
    the kernels' rounding (`_lower_nodes`), so a tile's pixels all have the
    same (x, y) corners: a node window of 2 x 2 nodes x Z levels. Each
    cell is cut along its rows into as many tiles as give about
    GRAD_TILES_PER_SM x `sms` tiles in all. Cached by shape. Raises
    ValueError where the kernels cannot take the shape: a block's shared
    memory for Z (`grad_smem`; Z <= 130), or indices past 32-bit ints."""
    if min(B, H, W) < 0 or min(Z, Y, X) < 1:
        raise ValueError(f"images [B, H, W] >= 0 and grids Z, Y, X >= 1, got {(B, H, W)} and {(Z, Y, X)}")
    if max(grad_smem(Z)) > SMEM_LIMIT:
        raise ValueError(f"Z = {Z} levels take {max(grad_smem(Z))} bytes of shared memory a block, above "
                         f"{SMEM_LIMIT}")
    ry0, rh, yreach = _runs(H, Y)
    rx0, cw, xreach = _runs(W, X)
    cells = len(ry0) * len(rx0)
    split = max(1, -(-GRAD_TILES_PER_SM * sms // max(1, B * cells)))
    tiles, first = [], []
    for h0, n in zip(ry0, rh):
        k = min(split, n)
        rows = n // k + (np.arange(k) < n % k)
        starts = h0 + np.concatenate([[0], np.cumsum(rows)[:-1]])
        for w0, m in zip(rx0, cw):
            first.append(len(tiles))
            tiles += [(h, w0, r, m) for h, r in zip(starts, rows)]
    Ti = len(tiles)
    first.append(Ti)
    img = np.asarray(tiles, np.int64).reshape(Ti, 4)
    all_tiles = np.concatenate([img + np.array([b * H, 0, 0, 0]) for b in range(B)]) if B else img[:0]
    plan = np.concatenate([[Ti, len(rx0), len(ry0), 0], all_tiles.reshape(-1), xreach.reshape(-1),
                           yreach.reshape(-1), first])
    if plan.max(initial=0) >= 2 ** 31 or B * Z * Y * X * 12 >= 2 ** 29:
        raise ValueError(f"images {(B, H, W)} and grids {(Z, Y, X)} take indices past 32-bit ints")
    out = plan.astype(np.int32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=64)
def _tiles(device: torch.device, B: int, H: int, W: int, Z: int, Y: int, X: int):
    """(`grad_plan` for the SMs of `device`, a CUDA tensor's device, copied
    to it once, its number of tiles)."""
    plan = grad_plan(B, H, W, Z, Y, X, _backend.sm_count(device.index))
    return torch.from_numpy(plan.copy()).to(device), B * int(plan[0])


_GRID_GRAD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3


def _grid_grad_cuda(v: torch.Tensor, gray: torch.Tensor, grid_shape) -> torch.Tensor:
    """Launch csrc/bilagrid_bwd.cu's grids' gradient over `grad_plan`'s
    tiles: each tile's partial sums, then each node's sum of them in the
    plan's order, the same bits on every launch. Same output as
    `_grid_grad_plain`."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"the bilateral grid's gradient kernel takes CUDA tensors, got {dev}")
    B, Z, Y, X, NC = grid_shape
    H, Wd = v.shape[1:3]
    if NC != 12:
        raise ValueError(f"the kernel takes grids [B, Z, Y, X, 12], got {tuple(grid_shape)}")
    _check("grid gradient", dev, [(v, torch.float32, (B, H, Wd, NC)), (gray, torch.float32, (B, H, Wd))])
    plan, ntiles = _tiles(dev, B, H, Wd, Z, Y, X)
    if v.data_ptr() % 16:  # the kernels read v in 16-byte vectors
        v = v.clone()
    partial = torch.empty((ntiles, 4, Z, NC), dtype=torch.float32, device=dev)
    out = torch.empty(tuple(grid_shape), dtype=torch.float32, device=dev)
    fn = _backend.kernel("bilagrid_bwd", "bilagrid_bwd_launch", _GRID_GRAD_ARGS)
    code = fn(v.data_ptr(), gray.data_ptr(), plan.data_ptr(), ntiles, B, H, Wd, Z, Y, X, partial.data_ptr(),
              out.data_ptr(), _backend.stream(dev))
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


_LUM_GRAD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2


def _lum_grad_cuda(g: torch.Tensor, gray: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch csrc/bilagrid_bwd.cu's luminance kernel: a block per tile of
    `grad_plan`, its node window in shared memory. Same output as
    `_lum_grad`."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"the bilateral grid's luminance gradient kernel takes CUDA tensors, got {dev}")
    B, Z, Y, X, NC = g.shape
    H, Wd = gray.shape[1:]
    _check("luminance gradient", dev, [(g, torch.float32, (B, Z, Y, X, 12)), (v, torch.float32, (B, H, Wd, 12)),
                                       (gray, torch.float32, (B, H, Wd))])
    plan, ntiles = _tiles(dev, B, H, Wd, Z, Y, X)
    if v.data_ptr() % 16:
        v = v.clone()
    out = torch.empty((B, H, Wd), dtype=torch.float32, device=dev)
    fn = _backend.kernel("bilagrid_bwd", "bilagrid_lum_bwd_launch", _LUM_GRAD_ARGS)
    code = fn(g.data_ptr(), v.data_ptr(), gray.data_ptr(), plan.data_ptr(), ntiles, B, H, Wd, Z, Y, X,
              out.data_ptr(), _backend.stream(dev))
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
