"""Library utilities (port of gsplat_tpu/utils.py): the log transforms,
depth maps to world points and normals, the OpenGL projection matrix and
the binary PLY writer."""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ._backend import resolve_device


def log_transform(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def inverse_log_transform(y: torch.Tensor) -> torch.Tensor:
    return torch.sign(y) * torch.expm1(torch.abs(y))


def depth_to_points(
    depths: torch.Tensor,  # [..., H, W, 1]
    camtoworlds: torch.Tensor,  # [..., 4, 4]
    Ks: torch.Tensor,  # [..., 3, 3]
    z_depth: bool = True,
    row0: int = 0,
) -> torch.Tensor:
    """Depth maps -> world-space 3D points [..., H, W, 3]. The maps' rows
    are the image's rows [row0, row0 + H) (a strip of a taller image)."""
    if depths.shape[-1] != 1:
        raise ValueError(f"depths must end in a channel of 1, got shape {tuple(depths.shape)}")
    height, width = depths.shape[-3:-1]
    y, x = torch.meshgrid(
        torch.arange(row0, row0 + height, dtype=torch.float32, device=depths.device),
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
    row0: int = 0,
) -> torch.Tensor:
    """Depth maps -> finite-difference surface normals [..., H, W, 3], zero
    on the one-pixel border (rows as in `depth_to_points`)."""
    points = depth_to_points(depths, camtoworlds, Ks, z_depth=z_depth, row0=row0)
    dx = points[..., 2:, 1:-1, :] - points[..., :-2, 1:-1, :]
    dy = points[..., 1:-1, 2:, :] - points[..., 1:-1, :-2, :]
    normals = torch.linalg.cross(dx, dy, dim=-1)
    normals = normals / torch.linalg.norm(normals, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.nn.functional.pad(normals, (0, 0, 1, 1, 1, 1))


def get_projection_matrix(znear, zfar, fovX, fovY, device="cuda") -> torch.Tensor:
    """OpenGL-style projection matrix [4, 4], on the card unless the caller
    asks for the CPU (``device="cpu"``)."""
    tan_y = math.tan(fovY / 2)
    tan_x = math.tan(fovX / 2)
    top, right = tan_y * znear, tan_x * znear
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return torch.as_tensor(P, device=resolve_device(device))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_ply(
    splats: Dict[str, torch.Tensor],
    path: str,
    live: Optional[torch.Tensor] = None,
) -> int:
    """Write splats to a binary little-endian PLY, the JAX package's layout:
    x y z, nx ny nz (zeros), f_dc_*, f_rest_* (channel-major), opacity,
    scale_0-2, rot_0-3, all float32.

    Keys: means [N,3], scales [N,3], quats [N,4], opacities [N], sh0
    [N,1,3], shN [N,B,3] (tensors or arrays). ``live`` filters a pool's
    free slots; rows with a NaN or Inf are dropped. Returns the number of
    points written."""
    data = {k: _host(v) for k, v in splats.items()}
    if live is not None:
        keep = _host(live)
        data = {k: v[keep] for k, v in data.items()}

    means = data["means"]
    scales = data["scales"]
    quats = data["quats"]
    opacities = data["opacities"].reshape(-1)
    n = means.shape[0]
    sh0 = data.get("sh0", np.zeros((n, 1, 3), np.float32))
    shN = data.get("shN", np.zeros((n, 0, 3), np.float32))
    sh0 = sh0.transpose(0, 2, 1).reshape(n, -1)
    shN = shN.transpose(0, 2, 1).reshape(n, -1)

    cols = [means, scales, quats, opacities[:, None], sh0, shN]
    keep = np.ones(n, bool)
    for c in cols:
        keep &= np.isfinite(c).all(axis=1)
    means, scales, quats, opacities = means[keep], scales[keep], quats[keep], opacities[keep]
    sh0, shN = sh0[keep], shN[keep]
    num = means.shape[0]

    props = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(sh0.shape[1])]
        + [f"f_rest_{i}" for i in range(shN.shape[1])]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    payload = np.concatenate(
        [means, np.zeros_like(means), sh0, shN, opacities[:, None], scales, quats], axis=1
    ).astype("<f4")

    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {num}\n".encode())
        for p in props:
            f.write(f"property float {p}\n".encode())
        f.write(b"end_header\n")
        f.write(payload.tobytes())
    return num
