"""Bilateral-grid colour correction (port of gsplat_tpu/bilagrid.py).

Per-image learnable 3D grids of 3x4 affine colour transforms, sliced at
(x, y, luminance) with trilinear interpolation ("Bilateral Guided Radiance
Field Processing", SIGGRAPH 2024), the total-variation regulariser and the
evaluation-time affine fit ``color_correct``.

The slice is ``F.grid_sample`` (trilinear, corners aligned), as the JAX
package leaves its gather to XLA; there is no kernel. Its gradient with
respect to the grids accumulates with atomic adds on the card (the CPU's
is in a fixed order), so two runs of a step on the card can differ in the
grids' last bits.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ._backend import resolve_device
from .modules import take_rows

RGB2GRAY = (0.299, 0.587, 0.114)


def slice_grid(grids: torch.Tensor, image_ids: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Apply each image's grid (``grids`` [n, W, Y, X, 12], rows by
    ``image_ids`` [B] as `modules.take_rows` reads them) to its rendered
    ``rgb`` [B, H, W, 3]: the affine transform trilinearly interpolated at
    the pixel's (x, y) centre and its luminance, the grid's corners at 0
    and 1 (``grid_sample`` with ``align_corners``; the JAX package's
    clipped corner indices and lerps)."""
    g = take_rows(grids, image_ids)  # [B, W, Y, X, 12]
    B, H, Wd = rgb.shape[:3]
    u = (torch.arange(Wd, dtype=torch.float32, device=rgb.device) + 0.5) / Wd
    v = (torch.arange(H, dtype=torch.float32, device=rgb.device) + 0.5) / H
    coef = torch.tensor(RGB2GRAY, dtype=torch.float32, device=rgb.device)
    gray = torch.clamp((rgb * coef).sum(dim=-1), 0.0, 1.0)  # [B, H, W]
    xyz = torch.stack([u[None, None, :].expand(B, H, Wd), v[None, :, None].expand(B, H, Wd), gray], dim=-1)
    affine = F.grid_sample(
        g.permute(0, 4, 1, 2, 3), (xyz * 2.0 - 1.0)[:, None], mode="bilinear", padding_mode="border",
        align_corners=True,
    )  # [B, 12, 1, H, W]
    A = affine[:, :, 0].permute(0, 2, 3, 1).reshape(B, H, Wd, 3, 4)
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
