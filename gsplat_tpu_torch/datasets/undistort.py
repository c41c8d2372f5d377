"""Undistortion maps of COLMAP cameras, in numpy (port of the cv2 calls in
gsplat_tpu/datasets/colmap.py:102-156).

`camera_maps` gives, for one camera's intrinsics and distortion
parameters at the dataset's factor, what the JAX `Parser` keeps: the new
intrinsics (before the roi offset), the float32 maps that `remap_bilinear`
samples the image at, the roi (x0, y0, width, height) cropped after the
remap, and for a fisheye camera the validity mask.

- **Pinhole with distortion** (OPENCV, RADIAL, SIMPLE_RADIAL: the
  coefficients k1, k2, p1, p2): `optimal_new_camera_matrix` is
  ``cv2.getOptimalNewCameraMatrix(K, dist, (w, h), 0)`` and
  `undistort_rectify_map` is ``cv2.initUndistortRectifyMap(K, dist, None,
  K_new, (w, h), cv2.CV_32FC1)``, as cv2 5.0 computes them: the new matrix
  maps the inner rectangle of a 9 x 9 grid of the image's points (x = i
  (w - 1) / 8, y = j (h - 1) / 8), undistorted by `undistort_points` (cv2's
  fixed-point iteration, 5 iterations, no tolerance test), onto [0, w - 1] x
  [0, h - 1] (alpha = 0); the roi is the inner rectangle of the same grid
  undistorted into the new camera, rounded to integers and clipped to the
  image. The maps apply the forward model to the new camera's pixel grid
  in float64 and cast to float32.
- **Fisheye** (the ``*FISHEYE`` models, k1..k4): the theta polynomial
  exactly as the JAX package writes it (its float32 grid mixed with
  float64 intrinsics, centred at ``w // 2``, ``h // 2``), so the maps and
  the mask are the same bits; the mask (the map inside the image's
  interior) is cropped to its bounding box, which is the roi.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# cv2's getOptimalNewCameraMatrix: a GRID x GRID grid of the image's points,
# undistorted by UNDISTORT_ITERS fixed-point iterations
GRID = 9
UNDISTORT_ITERS = 5


def undistort_points(uv: np.ndarray, K: np.ndarray, dist: np.ndarray, P: Optional[np.ndarray] = None) -> np.ndarray:
    """Pixels uv [n, 2] of camera K with distortion (k1, k2, p1, p2)
    undistorted as ``cv2.undistortPoints(uv, K, dist, None, P)``: normalized
    coordinates, or pixels of P where given. float64."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    k1, k2, p1, p2 = (float(v) for v in dist[:4])
    x0 = (uv[:, 0] - cx) * (1.0 / fx)
    y0 = (uv[:, 1] - cy) * (1.0 / fy)
    x, y = x0.copy(), y0.copy()
    for _ in range(UNDISTORT_ITERS):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + (k2 * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        # cv2 gives up on a point whose model folds over (icdist < 0)
        bad = icdist < 0
        x = np.where(bad, x0, (x0 - dx) * icdist)
        y = np.where(bad, y0, (y0 - dy) * icdist)
    if P is not None:
        x, y = x * P[0, 0] + P[0, 2], y * P[1, 1] + P[1, 2]
    return np.stack([x, y], axis=1)


def _inner_rect(K, dist, w, h, P=None) -> Tuple[float, float, float, float]:
    """The inscribed rectangle (x, y, width, height) of the undistorted
    grid: the largest x of its left column, the smallest of its right, and
    so on."""
    xs = np.arange(GRID) * (w - 1) / (GRID - 1)
    ys = np.arange(GRID) * (h - 1) / (GRID - 1)
    gx, gy = np.meshgrid(xs, ys)
    p = undistort_points(np.stack([gx.ravel(), gy.ravel()], axis=1), K, dist, P).reshape(GRID, GRID, 2)
    x0, x1 = p[:, 0, 0].max(), p[:, -1, 0].min()
    y0, y1 = p[0, :, 1].max(), p[-1, :, 1].min()
    return float(x0), float(y0), float(x1 - x0), float(y1 - y0)


def optimal_new_camera_matrix(K: np.ndarray, dist: np.ndarray, w: int, h: int):
    """(K_new [3, 3] float64, roi (x0, y0, width, height)) as
    ``cv2.getOptimalNewCameraMatrix(K, dist, (w, h), 0)`` returns them."""
    K = np.asarray(K, np.float64)
    ix, iy, iw, ih = _inner_rect(K, dist, w, h)
    fx, fy = (w - 1) / iw, (h - 1) / ih
    K_new = np.array([[fx, 0.0, -fx * ix], [0.0, fy, -fy * iy], [0.0, 0.0, 1.0]])
    rx, ry, rw, rh = (int(np.rint(v)) for v in _inner_rect(K, dist, w, h, K_new))
    x0, y0 = max(rx, 0), max(ry, 0)
    x1, y1 = min(rx + rw, w), min(ry + rh, h)
    return K_new, (x0, y0, max(x1 - x0, 0), max(y1 - y0, 0))


def undistort_rectify_map(K: np.ndarray, dist: np.ndarray, K_new: np.ndarray, w: int, h: int):
    """(mapx, mapy) float32 [h, w] as ``cv2.initUndistortRectifyMap(K,
    dist, None, K_new, (w, h), cv2.CV_32FC1)``: each pixel of the new
    camera, through the inverse of K_new, the distortion (k1, k2, p1, p2)
    and K, in float64."""
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2 = (float(v) for v in dist[:4])
    ir = np.linalg.inv(np.asarray(K_new, np.float64))
    j = np.arange(w, dtype=np.float64)[None, :]
    i = np.arange(h, dtype=np.float64)[:, None]
    _x = i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]
    _y = i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]
    _w = i * ir[2, 1] + ir[2, 2] + j * ir[2, 0]
    x, y = _x / _w, _y / _w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2.0 * x * y
    kr = 1.0 + (k2 * r2 + k1) * r2
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2.0 * x2)
    yd = y * kr + p1 * (r2 + 2.0 * y2) + p2 * _2xy
    mapx = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    mapy = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return mapx, mapy


def fisheye_maps(K: np.ndarray, dist: np.ndarray, w: int, h: int):
    """(mapx, mapy, mask, roi) of a fisheye camera, the JAX package's theta
    polynomial: mapx = fx x r(theta) + w // 2 on the grid x = (u - cx) / fx
    (likewise y), r = 1 + k1 theta^2 + ... + k4 theta^8, theta = |(x, y)|;
    the mask (the map inside (0, w - 1) x (0, h - 1)) cropped to its
    bounding box, which is the roi."""
    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32), indexing="xy")
    x1 = (gx - cx) / fx
    y1 = (gy - cy) / fy
    theta = np.sqrt(x1**2 + y1**2)
    k1, k2, k3, k4 = (list(dist) + [0.0] * 4)[:4]
    r = 1.0 + k1 * theta**2 + k2 * theta**4 + k3 * theta**6 + k4 * theta**8
    mapx = (fx * x1 * r + w // 2).astype(np.float32)
    mapy = (fy * y1 * r + h // 2).astype(np.float32)
    valid = (mapx > 0) & (mapy > 0) & (mapx < w - 1) & (mapy < h - 1)
    ys, xs = np.nonzero(valid)
    if not len(ys):
        raise ValueError(f"fisheye camera {w}x{h} with k {list(dist)}: no pixel maps inside the image")
    y0, y1_ = ys.min(), ys.max() + 1
    x0, x1_ = xs.min(), xs.max() + 1
    return mapx, mapy, valid[y0:y1_, x0:x1_], (int(x0), int(y0), int(x1_ - x0), int(y1_ - y0))


def camera_maps(K: np.ndarray, dist: np.ndarray, w: int, h: int, fisheye: bool):
    """What the JAX `Parser` keeps for a camera with distortion, at its
    size (w, h) and intrinsics K (float64 of the float32 matrix) after the
    factor: (K_new [3, 3] float64 before the roi offset, mapx, mapy, roi,
    mask or None)."""
    K = np.asarray(K, np.float64)
    if fisheye:
        mapx, mapy, mask, roi = fisheye_maps(K, dist, w, h)
        return K.copy(), mapx, mapy, roi, mask
    d = np.asarray(dist, np.float64)
    K_new, roi = optimal_new_camera_matrix(K, d, w, h)
    mapx, mapy = undistort_rectify_map(K, d, K_new, w, h)
    return K_new, mapx, mapy, roi, None
