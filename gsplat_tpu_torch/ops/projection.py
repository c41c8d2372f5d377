"""Gaussian projection math in plain PyTorch (port of gsplat_tpu/ops/projection.py).

Same component (structure-of-arrays) formulation as the JAX package: every
intermediate of the fused path is a [C, N] or [N] tensor and the symmetric
3x3 products are expanded componentwise, so the two packages round the same
operations in the same order. On the card these are elementwise PyTorch
ops; the JAX package left them to XLA's fusion too, so there is no kernel
here. Gradients come from autograd.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .._backend import common_device


def normalize_quat(quats: torch.Tensor) -> torch.Tensor:
    """L2-normalize quaternions [..., 4] (wxyz)."""
    return quats / torch.linalg.norm(quats, dim=-1, keepdim=True).clamp_min(1e-12)


def _quat_to_rot_components(quats: torch.Tensor):
    """Normalized quaternion [..., 4] -> 9 rotation components, each [...]."""
    quats = normalize_quat(quats)
    w, x, y, z = quats.unbind(-1)
    return {
        (0, 0): 1 - 2 * (y * y + z * z),
        (0, 1): 2 * (x * y - w * z),
        (0, 2): 2 * (x * z + w * y),
        (1, 0): 2 * (x * y + w * z),
        (1, 1): 1 - 2 * (x * x + z * z),
        (1, 2): 2 * (y * z - w * x),
        (2, 0): 2 * (x * z - w * y),
        (2, 1): 2 * (y * z + w * x),
        (2, 2): 1 - 2 * (x * x + y * y),
    }


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """Quaternion (wxyz, not necessarily normalized) -> rotation matrix [..., 3, 3]."""
    r = _quat_to_rot_components(quats)
    rows = [r[(i, j)] for i in range(3) for j in range(3)]
    return torch.stack(rows, dim=-1).reshape(quats.shape[:-1] + (3, 3))


_SYM = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


def _covar_components(quats: torch.Tensor, scales: torch.Tensor) -> Dict:
    """Sigma = R diag(s^2) R^T as 6 symmetric components, each [...]."""
    r = _quat_to_rot_components(quats)
    s2 = [scales[..., k] ** 2 for k in range(3)]
    return {
        (i, j): sum(r[(i, k)] * r[(j, k)] * s2[k] for k in range(3))
        for (i, j) in _SYM
    }


def _sym_get(c: Dict, i: int, j: int):
    return c[(i, j)] if i <= j else c[(j, i)]


def quat_scale_to_covar_preci(
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3]
    compute_covar: bool = True,
    compute_preci: bool = True,
    triu: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Covariance R S S^T R^T and/or precision from quaternion + scale."""

    def _build(s_pow):
        comps = _covar_components(quats, scales**s_pow)
        if triu:
            return torch.stack([comps[ij] for ij in _SYM], dim=-1)
        rows = [_sym_get(comps, i, j) for i in range(3) for j in range(3)]
        return torch.stack(rows, dim=-1).reshape(quats.shape[:-1] + (3, 3))

    covars = _build(1.0) if compute_covar else None
    precis = _build(-1.0) if compute_preci else None
    return covars, precis


def world_to_cam(
    means: torch.Tensor,  # [N, 3]
    covars: torch.Tensor,  # [N, 3, 3]
    viewmats: torch.Tensor,  # [C, 4, 4]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-frame Gaussians -> camera frame for each of C cameras."""
    R = viewmats[:, :3, :3]  # [C, 3, 3]
    t = viewmats[:, :3, 3]  # [C, 3]
    means_c = torch.einsum("cij,nj->cni", R, means) + t[:, None, :]
    covars_c = torch.einsum("cij,njk,clk->cnil", R, covars, R)
    return means_c, covars_c


def _world_to_cam_components(mx, my, mz, cov: Dict, viewmats: torch.Tensor):
    """Transform means + symmetric covariance into each camera frame.

    mx/my/mz: [N]; cov: 6 components [N]; viewmats [C, 4, 4].
    Returns (mc = 3 x [C, N], cc = 6 components [C, N]).
    """
    w = {
        (i, j): viewmats[:, i, j][:, None] for i in range(3) for j in range(3)
    }  # each [C, 1]
    t = [viewmats[:, i, 3][:, None] for i in range(3)]
    m = [mx[None, :], my[None, :], mz[None, :]]
    mc = [sum(w[(i, j)] * m[j] for j in range(3)) + t[i] for i in range(3)]
    # tmp[i][k] = sum_l w_il * cov_lk ; cc_ij = sum_k tmp[i][k] * w_jk
    tmp = [
        [sum(w[(i, l)] * _sym_get(cov, l, k)[None, :] for l in range(3)) for k in range(3)]
        for i in range(3)
    ]
    cc = {
        (i, j): sum(tmp[i][k] * w[(j, k)] for k in range(3)) for (i, j) in _SYM
    }
    return mc, cc


def _persp_components(mc, cc, Ks, width, height):
    """Pinhole EWA: camera-frame (means, covar comps) -> 2D mean + 2x2 covar,
    with the +-30% frustum-margin Jacobian clamp. All tensors [C, N]."""
    tx, ty, tz = mc
    tz = torch.where(tz == 0.0, 1e-8, tz)
    tz2 = tz * tz

    fx = Ks[:, 0, 0][:, None]
    fy = Ks[:, 1, 1][:, None]
    cx = Ks[:, 0, 2][:, None]
    cy = Ks[:, 1, 2][:, None]
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy

    lim_x_pos = (width - cx) / fx + 0.3 * tan_fovx
    lim_x_neg = cx / fx + 0.3 * tan_fovx
    lim_y_pos = (height - cy) / fy + 0.3 * tan_fovy
    lim_y_neg = cy / fy + 0.3 * tan_fovy
    txc = tz * torch.clamp(tx / tz, min=-lim_x_neg, max=lim_x_pos)
    tyc = tz * torch.clamp(ty / tz, min=-lim_y_neg, max=lim_y_pos)

    # J rows: (j00, 0, j02), (0, j11, j12)
    j00 = fx / tz
    j02 = -fx * txc / tz2
    j11 = fy / tz
    j12 = -fy * tyc / tz2

    c00, c01, c02 = cc[(0, 0)], cc[(0, 1)], cc[(0, 2)]
    c11, c12, c22 = cc[(1, 1)], cc[(1, 2)], cc[(2, 2)]
    cov00 = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    cov01 = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    cov11 = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)

    mean_x = fx * tx / tz + cx
    mean_y = fy * ty / tz + cy
    return mean_x, mean_y, cov00, cov01, cov11


def _ortho_components(mc, cc, Ks, width, height):
    """Orthographic projection."""
    tx, ty, _ = mc
    fx = Ks[:, 0, 0][:, None]
    fy = Ks[:, 1, 1][:, None]
    cx = Ks[:, 0, 2][:, None]
    cy = Ks[:, 1, 2][:, None]
    cov00 = fx * fx * cc[(0, 0)]
    cov01 = fx * fy * cc[(0, 1)]
    cov11 = fy * fy * cc[(1, 1)]
    return tx * fx + cx, ty * fy + cy, cov00, cov01, cov11


def _fisheye_components(mc, cc, Ks, width, height):
    """Equidistant fisheye."""
    x, y, z = mc
    fx = Ks[:, 0, 0][:, None]
    fy = Ks[:, 1, 1][:, None]
    cx = Ks[:, 0, 2][:, None]
    cy = Ks[:, 1, 2][:, None]

    eps = 0.0000001
    xy_len = torch.sqrt(x * x + y * y) + eps
    theta = torch.atan2(xy_len, z + eps)
    mean_x = x * fx * theta / xy_len + cx
    mean_y = y * fy * theta / xy_len + cy

    x2 = x * x + eps
    y2 = y * y
    xy = x * y
    x2y2 = x2 + y2
    x2y2z2_inv = 1.0 / (x2y2 + z * z)
    b = torch.atan2(xy_len, z) / xy_len / x2y2
    a = z * x2y2z2_inv / x2y2
    j00 = fx * (x2 * a + y2 * b)
    j01 = fx * xy * (a - b)
    j02 = -fx * x * x2y2z2_inv
    j10 = fy * xy * (a - b)
    j11 = fy * (y2 * a + x2 * b)
    j12 = -fy * y * x2y2z2_inv

    c00, c01, c02 = cc[(0, 0)], cc[(0, 1)], cc[(0, 2)]
    c11, c12, c22 = cc[(1, 1)], cc[(1, 2)], cc[(2, 2)]

    def rowdot(a0, a1, a2, b0, b1, b2):
        # a . Sigma . b for rows a, b of J
        s0 = a0 * c00 + a1 * c01 + a2 * c02
        s1 = a0 * c01 + a1 * c11 + a2 * c12
        s2 = a0 * c02 + a1 * c12 + a2 * c22
        return s0 * b0 + s1 * b1 + s2 * b2

    cov00 = rowdot(j00, j01, j02, j00, j01, j02)
    cov01 = rowdot(j00, j01, j02, j10, j11, j12)
    cov11 = rowdot(j10, j11, j12, j10, j11, j12)
    return mean_x, mean_y, cov00, cov01, cov11


_PROJ_COMPONENT_FNS = {
    "pinhole": _persp_components,
    "ortho": _ortho_components,
    "fisheye": _fisheye_components,
}


def _matrix_proj(fn):
    def wrapped(means, covars, Ks, width, height):
        mc = [means[..., k] for k in range(3)]
        cc = {(i, j): covars[..., i, j] for (i, j) in _SYM}
        mean_x, mean_y, cov00, cov01, cov11 = fn(mc, cc, Ks, width, height)
        means2d = torch.stack([mean_x, mean_y], dim=-1)
        cov2d = torch.stack([cov00, cov01, cov01, cov11], dim=-1).reshape(
            means.shape[:-1] + (2, 2)
        )
        return means2d, cov2d

    return wrapped


# Matrix-shaped projection wrappers, for API parity and tests.
persp_proj = _matrix_proj(_persp_components)
ortho_proj = _matrix_proj(_ortho_components)
fisheye_proj = _matrix_proj(_fisheye_components)


def fully_fused_projection_soa(
    means: torch.Tensor,  # [N, 3]
    quats: Optional[torch.Tensor],  # [N, 4] or None if covars given
    scales: Optional[torch.Tensor],  # [N, 3]
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    calc_compensations: bool = False,
    camera_model: str = "pinhole",
    covars: Optional[torch.Tensor] = None,  # [N, 3, 3]
) -> Dict[str, torch.Tensor]:
    """Fused projection, SoA layout: every output is a [C, N] tensor.

    Returns dict with radii (int32), mean_x, mean_y, depth, conic_a, conic_b,
    conic_c, and compensation (present iff calc_compensations). Culled
    entries have radii == 0.
    """
    common_device(means, quats, scales, viewmats, Ks, covars)
    if camera_model not in _PROJ_COMPONENT_FNS:
        raise ValueError(f"unknown camera_model {camera_model!r}")
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    if covars is not None:
        cov = {(i, j): covars[:, i, j] for (i, j) in _SYM}
    else:
        cov = _covar_components(quats, scales)
    mc, cc = _world_to_cam_components(mx, my, mz, cov, viewmats)
    mean_x, mean_y, cov00, cov01, cov11 = _PROJ_COMPONENT_FNS[camera_model](
        mc, cc, Ks, width, height
    )

    det_orig = cov00 * cov11 - cov01 * cov01
    b00 = cov00 + eps2d
    b11 = cov11 + eps2d
    det = torch.clamp_min(b00 * b11 - cov01 * cov01, 1e-10)

    out: Dict[str, torch.Tensor] = {}
    if calc_compensations:
        out["compensation"] = torch.sqrt(torch.clamp_min(det_orig / det, 0.0))

    inv_det = 1.0 / det
    out["conic_a"] = b11 * inv_det
    out["conic_b"] = -cov01 * inv_det
    out["conic_c"] = b00 * inv_det
    depth = mc[2]
    out["depth"] = depth

    b = (b00 + b11) / 2.0
    v1 = b + torch.sqrt(torch.clamp_min(b * b - det, 0.01))
    radius = torch.ceil(3.0 * torch.sqrt(v1))

    valid = (det > 0) & (depth > near_plane) & (depth < far_plane)
    inside = (
        (mean_x + radius > 0)
        & (mean_x - radius < width)
        & (mean_y + radius > 0)
        & (mean_y - radius < height)
    )
    if radius_clip > 0.0:
        valid = valid & (radius > radius_clip)
    radius = torch.where(valid & inside, radius, 0.0)
    out["radii"] = radius.detach().to(torch.int32)
    out["mean_x"] = mean_x
    out["mean_y"] = mean_y
    return out


def fully_fused_projection(
    means: torch.Tensor,  # [N, 3]
    quats: Optional[torch.Tensor],  # [N, 4] or None if covars given
    scales: Optional[torch.Tensor],  # [N, 3]
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    calc_compensations: bool = False,
    camera_model: str = "pinhole",
    covars: Optional[torch.Tensor] = None,  # [N, 3, 3]
):
    """Fused projection with reference-shaped outputs.

    Returns (radii [C,N] int32, means2d [C,N,2], depths [C,N], conics [C,N,3],
    compensations [C,N] or None). Invalid entries have radii == 0.
    """
    soa = fully_fused_projection_soa(
        means, quats, scales, viewmats, Ks, width, height,
        eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
        radius_clip=radius_clip, calc_compensations=calc_compensations,
        camera_model=camera_model, covars=covars,
    )
    means2d = torch.stack([soa["mean_x"], soa["mean_y"]], dim=-1)
    conics = torch.stack([soa["conic_a"], soa["conic_b"], soa["conic_c"]], dim=-1)
    return (
        soa["radii"],
        means2d,
        soa["depth"],
        conics,
        soa.get("compensation"),
    )


def compact_valid(radii: torch.Tensor, rows: Sequence[torch.Tensor], capacity: int):
    """Move the valid (radii > 0) entries of [C, N] outputs to the front of a
    ``min(capacity, C*N)`` buffer, camera-major and Gaussian-minor, by one
    stable sort on the validity key, as the JAX package's packed
    projections do: the float ``rows`` follow the same permutation (the
    invalid entries after the valid ones, in flat order) and stay
    differentiable. Past ``capacity`` the highest flat indices are dropped.

    Returns (camera_ids [cap] i32, gaussian_ids [cap] i32, radii [cap] i32,
    the permuted rows [cap] each, nnz [] i32 on the device); slots past nnz
    have ids -1 and radii 0."""
    C, N = radii.shape
    flat_radii = radii.reshape(-1)
    valid = flat_radii > 0
    cap = min(capacity, C * N)
    perm = torch.sort((~valid).to(torch.uint8), stable=True).indices[:cap]
    nnz = valid.sum(dtype=torch.int32)
    slot_ok = torch.arange(cap, device=radii.device) < nnz
    camera_ids = torch.where(slot_ok, (perm // N).to(torch.int32), -1)
    gaussian_ids = torch.where(slot_ok, (perm % N).to(torch.int32), -1)
    radii_p = torch.where(slot_ok, flat_radii[perm], 0)
    return camera_ids, gaussian_ids, radii_p, [r.reshape(-1)[perm] for r in rows], nnz


def fully_fused_projection_packed(
    means: torch.Tensor,  # [N, 3]
    quats: Optional[torch.Tensor],  # [N, 4] or None if covars given
    scales: Optional[torch.Tensor],  # [N, 3]
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    capacity: int,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    calc_compensations: bool = False,
    camera_model: str = "pinhole",
    covars: Optional[torch.Tensor] = None,  # [N, 3, 3]
):
    """Packed (COO) fused projection with a static capacity: the valid
    (camera, gaussian) pairs compacted to the front of the buffer by
    `compact_valid`.

    Returns (camera_ids [cap] i32, gaussian_ids [cap] i32, radii [cap] i32,
    means2d [cap, 2], depths [cap], conics [cap, 3], compensations [cap] or
    None, nnz [] i32). If nnz > capacity the highest-flat-index valid
    entries are dropped: call again with a larger capacity. The float
    outputs are differentiable w.r.t. means/quats/scales/covars/viewmats.
    """
    soa = fully_fused_projection_soa(
        means, quats, scales, viewmats, Ks, width, height,
        eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
        radius_clip=radius_clip, calc_compensations=calc_compensations,
        camera_model=camera_model, covars=covars,
    )
    keys = ["mean_x", "mean_y", "depth", "conic_a", "conic_b", "conic_c"]
    if calc_compensations:
        keys.append("compensation")
    cam, gau, radii, rows, nnz = compact_valid(soa["radii"], [soa[k] for k in keys], capacity)
    means2d = torch.stack(rows[0:2], dim=-1)
    conics = torch.stack(rows[3:6], dim=-1)
    compensations = rows[6] if calc_compensations else None
    return cam, gau, radii, means2d, rows[2], conics, compensations, nnz


def proj(
    means: torch.Tensor,  # [C, N, 3] camera-frame
    covars: torch.Tensor,  # [C, N, 3, 3] camera-frame
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    camera_model: str = "pinhole",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame -> 2D projection. Returns (means2d [C,N,2], covars2d
    [C,N,2,2])."""
    fns = {"pinhole": persp_proj, "ortho": ortho_proj, "fisheye": fisheye_proj}
    if camera_model not in fns:
        raise ValueError(f"unknown camera_model {camera_model!r}")
    return fns[camera_model](means, covars, Ks, width, height)
