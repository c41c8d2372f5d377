"""Depth maps to world points and normals (port of the depth part of
gsplat_tpu/utils.py)."""

from __future__ import annotations

import torch


def depth_to_points(
    depths: torch.Tensor,  # [..., H, W, 1]
    camtoworlds: torch.Tensor,  # [..., 4, 4]
    Ks: torch.Tensor,  # [..., 3, 3]
    z_depth: bool = True,
) -> torch.Tensor:
    """Depth maps -> world-space 3D points [..., H, W, 3]."""
    if depths.shape[-1] != 1:
        raise ValueError(f"depths must end in a channel of 1, got shape {tuple(depths.shape)}")
    height, width = depths.shape[-3:-1]
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=depths.device),
        torch.arange(width, dtype=torch.float32, device=depths.device),
        indexing="ij",
    )
    fx = Ks[..., 0, 0][..., None, None]
    fy = Ks[..., 1, 1][..., None, None]
    cx = Ks[..., 0, 2][..., None, None]
    cy = Ks[..., 1, 2][..., None, None]
    dirs = torch.stack(
        [(x - cx + 0.5) / fx, (y - cy + 0.5) / fy, torch.ones_like(x + cx)], dim=-1
    )  # [..., H, W, 3]
    directions = torch.einsum("...ij,...hwj->...hwi", camtoworlds[..., :3, :3], dirs)
    origins = camtoworlds[..., :3, -1]
    if not z_depth:
        directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True).clamp_min(1e-12)
    return origins[..., None, None, :] + depths * directions


def depth_to_normal(
    depths: torch.Tensor,
    camtoworlds: torch.Tensor,
    Ks: torch.Tensor,
    z_depth: bool = True,
) -> torch.Tensor:
    """Depth maps -> finite-difference surface normals [..., H, W, 3], zero
    on the one-pixel border."""
    points = depth_to_points(depths, camtoworlds, Ks, z_depth=z_depth)
    dx = points[..., 2:, 1:-1, :] - points[..., :-2, 1:-1, :]
    dy = points[..., 1:-1, 2:, :] - points[..., 1:-1, :-2, :]
    normals = torch.linalg.cross(dx, dy, dim=-1)
    normals = normals / torch.linalg.norm(normals, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.nn.functional.pad(normals, (0, 0, 1, 1, 1, 1))
