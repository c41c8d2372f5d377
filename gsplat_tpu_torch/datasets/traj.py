"""Camera trajectory generation (port of gsplat_tpu/datasets/traj.py, a copy).

Interpolated, ellipse, and spiral paths for rendering fly-through videos.
numpy-only rewrites of the standard nerf-style path generators.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate


def _normalize(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _viewmatrix(lookdir, up, position):
    vec2 = _normalize(lookdir)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def _pad_poses(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def generate_interpolated_path(
    poses: np.ndarray, n_interp: int, spline_degree: int = 5, smoothness: float = 0.03
) -> np.ndarray:
    """Smooth spline through keyframe poses -> [n_interp * (n-1), 3, 4]."""

    def poses_to_points(poses, dist):
        pos = poses[:, :3, -1]
        lookat = poses[:, :3, -1] - dist * poses[:, :3, 2]
        up = poses[:, :3, -1] + dist * poses[:, :3, 1]
        return np.stack([pos, lookat, up], 1)

    def points_to_poses(points):
        return np.array(
            [
                _viewmatrix(p - l, u - p, p)
                for p, l, u in zip(points[:, 0], points[:, 1], points[:, 2])
            ]
        )

    def interp(points, n, k, s):
        sh = points.shape
        pts = np.reshape(points, (sh[0], -1))
        k = min(k, sh[0] - 1)
        tck, _ = scipy.interpolate.splprep(pts.T, k=k, s=s)
        u = np.linspace(0, 1, n, endpoint=False)
        new_points = np.array(scipy.interpolate.splev(u, tck))
        return np.reshape(new_points.T, (n, sh[1], sh[2]))

    points = poses_to_points(poses, dist=0.25)
    new_points = interp(
        points, n_interp * (points.shape[0] - 1), k=spline_degree, s=smoothness
    )
    return points_to_poses(new_points)


def generate_ellipse_path_z(
    poses: np.ndarray,
    n_frames: int = 120,
    variation: float = 0.0,
    phase: float = 0.0,
    height: float = 0.0,
) -> np.ndarray:
    """Ellipse path around the scene at fixed z (traj.py generate_ellipse_path_z)."""
    center = np.mean(poses[:, :3, 3], axis=0)
    offset = np.array([center[0], center[1], height])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)

    theta = np.linspace(0, 2.0 * np.pi, n_frames, endpoint=False)
    positions = np.stack(
        [
            center[0] + sc[0] * np.cos(theta),
            center[1] + sc[1] * np.sin(theta),
            np.full_like(theta, height)
            + variation * sc[2] * np.sin(theta * 2 + phase),
        ],
        axis=-1,
    )
    up = np.array([0.0, 0.0, 1.0])
    lookat = center
    return np.array([_viewmatrix(lookat - p, up, p) for p in positions])


def generate_spiral_path(
    poses: np.ndarray,
    bounds: np.ndarray,
    n_frames: int = 120,
    n_rots: int = 2,
    zrate: float = 0.5,
) -> np.ndarray:
    """LLFF-style forward-facing spiral (traj.py generate_spiral_path)."""
    scale = 1.0 / (bounds.min() * 0.75)
    poses = poses.copy()
    poses[:, :3, 3] *= scale
    bounds = bounds * scale

    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1 / ((1 - dt) / close_depth + dt / inf_depth)

    positions = poses[:, :3, 3]
    radii = np.percentile(np.abs(positions), 90, 0)
    radii = np.concatenate([radii, [1.0]])

    cam2world = _average_pose(poses)
    up = poses[:, :3, 1].mean(0)
    render_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False):
        t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
        position = cam2world @ t
        lookat = cam2world @ [0, 0, -focal, 1.0]
        z_axis = position - lookat
        render_poses.append(_viewmatrix(z_axis, up, position))
    render_poses = np.stack(render_poses, axis=0)
    render_poses[:, :3, 3] /= scale
    return render_poses


def _average_pose(poses):
    position = poses[:, :3, 3].mean(0)
    z_axis = poses[:, :3, 2].mean(0)
    up = poses[:, :3, 1].mean(0)
    return _viewmatrix(z_axis, up, position)  # [3, 4]
