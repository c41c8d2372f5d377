"""Scene normalization (port of gsplat_tpu/datasets/normalize.py, a copy).

Builds the similarity transform that puts a COLMAP scene into a canonical
frame: gravity-align the world up axis to the mean camera up direction,
recenter on the cameras' focus point, rescale so the median camera sits at
unit distance; plus a PCA alignment of the SfM cloud. Formulated here via a
quaternion rotation-between-vectors (instead of the Rodrigues/skew form)
and einsum axis extraction. numpy-only.
"""

from __future__ import annotations

import numpy as np

_CAM_UP = np.array([0.0, -1.0, 0.0])  # OpenCV convention: -y is up
_CAM_FWD = np.array([0.0, 0.0, 1.0])


def _rotation_between(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Shortest-arc rotation taking unit vector ``src`` onto ``dst``,
    via the half-angle quaternion q = [cos(t/2), sin(t/2)*axis]."""
    d = float(src @ dst)
    if d < -1.0 + 1e-9:
        # antipodal: rotate pi about any axis orthogonal to src
        return np.diag([-1.0, 1.0, 1.0])
    axis = np.cross(src, dst)
    w = 1.0 + d  # = 2 cos^2(t/2); quaternion (w, axis) before normalization
    q = np.concatenate([[w], axis])
    q = q / np.linalg.norm(q)
    qw, qx, qy, qz = q
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


def similarity_from_cameras(
    c2w: np.ndarray, strict_scaling: bool = False, center_method: str = "focus"
) -> np.ndarray:
    """4x4 similarity transform normalizing OpenCV-convention c2w cameras."""
    rot = c2w[:, :3, :3]
    pos = c2w[:, :3, 3]

    # mean camera up direction in world coordinates -> rotate onto _CAM_UP
    up_world = np.einsum("nij,j->ni", rot, _CAM_UP).mean(axis=0)
    up_world = up_world / np.linalg.norm(up_world)
    R_align = _rotation_between(up_world, _CAM_UP)

    pos = np.einsum("ij,nj->ni", R_align, pos)
    if center_method == "focus":
        # closest point to the origin on each (aligned) optical axis; the
        # median of those is the scene's focus
        fwd = np.einsum("ij,njk,k->ni", R_align, rot, _CAM_FWD)
        along = np.einsum("ni,ni->n", fwd, -pos)
        foot = pos + along[:, None] * fwd
        translate = -np.median(foot, axis=0)
    elif center_method == "poses":
        translate = -np.median(pos, axis=0)
    else:
        raise ValueError(f"Unknown center_method {center_method}")

    dist = np.linalg.norm(pos + translate, axis=-1)
    scale = 1.0 / (np.max(dist) if strict_scaling else np.median(dist))

    transform = np.eye(4)
    transform[:3, :3] = scale * R_align
    transform[:3, 3] = scale * translate
    return transform


def align_principal_axes(point_cloud: np.ndarray) -> np.ndarray:
    """Rotate so the cloud's principal axes land on x/y/z (z = least
    variance, i.e. the ground plane normal for mostly-planar scenes)."""
    center = np.median(point_cloud, axis=0)
    x = point_cloud - center
    # covariance about the MEAN (translation-invariant), while the
    # recentering translation uses the outlier-robust median
    y = x - x.mean(axis=0)
    evals, evecs = np.linalg.eigh(y.T @ y / max(len(y) - 1, 1))
    # eigh returns ascending eigenvalues; we want descending variance
    basis = evecs[:, ::-1]
    if np.linalg.det(basis) < 0:
        basis = basis * np.array([-1.0, 1.0, 1.0])
    transform = np.eye(4)
    transform[:3, :3] = basis.T
    transform[:3, 3] = basis.T @ (-center)
    return transform


def transform_points(matrix: np.ndarray, points: np.ndarray) -> np.ndarray:
    return points @ matrix[:3, :3].T + matrix[:3, 3]


def transform_cameras(matrix: np.ndarray, camtoworlds: np.ndarray):
    """Apply a similarity to c2w matrices; rotation re-orthonormalized by
    dividing out the uniform scale."""
    out = np.einsum("ij,njk->nik", matrix, camtoworlds)
    scaling = np.linalg.norm(out[:, 0, :3], axis=1)
    out[:, :3, :3] = out[:, :3, :3] / scaling[:, None, None]
    return out
