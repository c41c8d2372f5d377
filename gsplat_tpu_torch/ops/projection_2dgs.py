"""2DGS (surfel) projection in plain PyTorch (port of
gsplat_tpu/ops/projection_2dgs.py): ray-transform matrices, normals, AABB.

The same component formulation as ops/projection.py: the per-Gaussian 3x3
ray transform M = (K [RS_c | t])^T is carried as 9 separate [C, N]
tensors, and every product is written out in the JAX package's order, so
the two packages round the same operations. Gradients come from autograd.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .._backend import common_device
from .projection import _quat_to_rot_components, compact_valid


def fully_fused_projection_2dgs_soa(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3]
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps: float = 1e-6,
) -> Dict[str, torch.Tensor]:
    """SoA fused 2DGS projection. Returns a dict with radii (int32 [C, N]),
    mean_x, mean_y, depth, m00..m22 (the ray transform M, row-major) and
    normal_x/y/z, all [C, N]."""
    common_device(means, quats, scales, viewmats, Ks)
    r = _quat_to_rot_components(quats)  # 9 x [N]
    s = [scales[:, k] for k in range(3)]
    rs = {(i, k): r[(i, k)] * s[k] for i in range(3) for k in range(3)}
    m = [means[:, i] for i in range(3)]

    w = {(i, j): viewmats[:, i, j][:, None] for i in range(3) for j in range(3)}
    t = [viewmats[:, i, 3][:, None] for i in range(3)]
    # camera-frame means [C, N]
    mc = [sum(w[(i, j)] * m[j][None, :] for j in range(3)) + t[i] for i in range(3)]
    rs_c = {
        (i, k): sum(w[(i, j)] * rs[(j, k)][None, :] for j in range(3))
        for i in range(3)
        for k in range(3)
    }
    # the normal is the scaled third column of RS in the camera frame,
    # flipped to face the camera
    nrm = [rs_c[(i, 2)] for i in range(3)]
    cos = -(nrm[0] * mc[0] + nrm[1] * mc[1] + nrm[2] * mc[2])
    flip = torch.where(cos > 0, 1.0, -1.0)
    nrm = [n * flip for n in nrm]

    # T_cl columns: RS_cl[:, 0], RS_cl[:, 1], means_c; M = (K T_cl)^T
    fx = Ks[:, 0, 0][:, None]
    fy = Ks[:, 1, 1][:, None]
    cx = Ks[:, 0, 2][:, None]
    cy = Ks[:, 1, 2][:, None]

    def col(k):
        if k < 2:
            return [rs_c[(0, k)], rs_c[(1, k)], rs_c[(2, k)]]
        return mc

    M = {}
    for k in range(3):
        c0, c1, c2 = col(k)
        M[(k, 0)] = fx * c0 + cx * c2
        M[(k, 1)] = fy * c1 + cy * c2
        M[(k, 2)] = c2

    # AABB from the dual conic, test = (1, 1, -1) summed over M's rows
    d = M[(0, 2)] ** 2 + M[(1, 2)] ** 2 - M[(2, 2)] ** 2
    valid = torch.abs(d) > eps
    dsafe = torch.where(valid, d, 1.0)
    f = [1.0 / dsafe, 1.0 / dsafe, -1.0 / dsafe]
    mean_x = sum(M[(r_, 0)] * M[(r_, 2)] * f[r_] for r_ in range(3))
    mean_y = sum(M[(r_, 1)] * M[(r_, 2)] * f[r_] for r_ in range(3))
    ext_x = torch.sqrt(
        torch.clamp_min(mean_x**2 - sum(M[(r_, 0)] ** 2 * f[r_] for r_ in range(3)), 0.0)
    )
    ext_y = torch.sqrt(
        torch.clamp_min(mean_y**2 - sum(M[(r_, 1)] ** 2 * f[r_] for r_ in range(3)), 0.0)
    )
    radius = torch.ceil(3.0 * torch.maximum(ext_x, ext_y))

    depth = mc[2]
    ok = valid & (depth > near_plane) & (depth < far_plane)
    if radius_clip > 0.0:
        ok = ok & (radius > radius_clip)
    inside = (
        (mean_x + radius > 0)
        & (mean_x - radius < width)
        & (mean_y + radius > 0)
        & (mean_y - radius < height)
    )
    radius = torch.where(ok & inside, radius, 0.0)

    out = {
        "radii": radius.detach().to(torch.int32),
        "mean_x": mean_x,
        "mean_y": mean_y,
        "depth": depth,
        "normal_x": nrm[0],
        "normal_y": nrm[1],
        "normal_z": nrm[2],
    }
    for k in range(3):
        for i in range(3):
            out[f"m{k}{i}"] = M[(k, i)]
    return out


def fully_fused_projection_2dgs_packed(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3]
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    capacity: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
):
    """Packed (COO) fused 2DGS projection with a static capacity: the 3DGS
    packed projection's compaction (`compact_valid`) over the surfel rows.

    Returns (camera_ids [cap] i32, gaussian_ids [cap] i32, radii [cap] i32,
    means2d [cap, 2], depths [cap], ray_transforms [cap, 3, 3], normals
    [cap, 3], nnz [] i32); slots past nnz have ids -1 and radii 0, and past
    ``capacity`` the highest flat indices are dropped."""
    soa = fully_fused_projection_2dgs_soa(
        means, quats, scales, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
    )
    keys = ["mean_x", "mean_y", "depth"] + [f"m{k}{i}" for k in range(3) for i in range(3)]
    keys += [f"normal_{a}" for a in ("x", "y", "z")]
    cam, gau, radii, rows, nnz = compact_valid(soa["radii"], [soa[k] for k in keys], capacity)
    cap = radii.shape[0]
    means2d = torch.stack(rows[0:2], dim=-1)
    ray_transforms = torch.stack(rows[3:12], dim=-1).reshape(cap, 3, 3)
    normals = torch.stack(rows[12:15], dim=-1)
    return cam, gau, radii, means2d, rows[2], ray_transforms, normals, nnz


def fully_fused_projection_2dgs(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    viewmats: torch.Tensor,
    Ks: torch.Tensor,
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference-shaped wrapper: returns (radii [C,N] i32, means2d [C,N,2],
    depths [C,N], ray_transforms M [C,N,3,3], normals [C,N,3])."""
    soa = fully_fused_projection_2dgs_soa(
        means, quats, scales, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
    )
    means2d = torch.stack([soa["mean_x"], soa["mean_y"]], dim=-1)
    M = torch.stack(
        [soa[f"m{k}{i}"] for k in range(3) for i in range(3)], dim=-1
    ).reshape(soa["depth"].shape + (3, 3))
    normals = torch.stack([soa["normal_x"], soa["normal_y"], soa["normal_z"]], dim=-1)
    return soa["radii"], means2d, soa["depth"], M, normals
