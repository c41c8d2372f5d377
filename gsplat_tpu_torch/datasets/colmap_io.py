"""COLMAP binary/text model reader, numpy only (port of
gsplat_tpu/datasets/colmap_io.py).

The sparse-model formats (cameras, images, points3D; .bin and .txt) as the
COLMAP documentation lays them out: little-endian; cameras.bin = [u64
count, {i32 id, i32 model, u64 w, u64 h, f64 params[n]}...]; images.bin
adds qvec/tvec/name/points2D; points3D.bin adds xyz/rgb/error/track.

Differences from the JAX package's reader:
  - ``points3D.bin`` is read in one pass over the file's bytes: the loop
    reads each record's track length (one unpack a record, to find the
    next record), and numpy takes every field of every record at once. A
    scene of a million points reads in about a second.
  - The point readers return the points' ids as an array, not an
    id -> row dict: ``Parser`` looks them up with ``np.searchsorted``.

`read_model` reads a binary model through the native reader
(colmap_native.py, csrc/colmap_native.cpp) as the JAX package does; where
it cannot be built or fails on a file, it warns once, with the reason (a
failed build's compiler output), and reads with the numpy reader here.
``_backend.HOST_CALLS`` counts which reader read each model
(``colmap_native`` or ``colmap_numpy``).
"""

from __future__ import annotations

import os
import struct
import warnings
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}

# one points3D.bin record before its track: id, xyz, rgb, error, track length
POINT_RECORD = np.dtype([
    ("id", "<u8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)), ("err", "<f8"), ("track_len", "<u8"),
])
# one images.bin 2D point: xy, point3D id
POINT2D_RECORD = np.dtype([("xy", "<f8", (2,)), ("id3", "<i8")])


@dataclass
class Camera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific

    @property
    def K(self) -> np.ndarray:
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)

    @property
    def dist_params(self) -> np.ndarray:
        """OpenCV-style (k1, k2, p1, p2) or fisheye (k1..k4)."""
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "PINHOLE"):
            return np.zeros(4)
        if self.model == "SIMPLE_RADIAL":
            return np.array([p[3], 0.0, 0.0, 0.0])
        if self.model == "RADIAL":
            return np.array([p[3], p[4], 0.0, 0.0])
        if self.model in ("OPENCV", "OPENCV_FISHEYE"):
            return np.array([p[4], p[5], p[6], p[7]])
        if self.model == "SIMPLE_RADIAL_FISHEYE":
            return np.array([p[3], 0.0, 0.0, 0.0])
        if self.model == "RADIAL_FISHEYE":
            return np.array([p[3], p[4], 0.0, 0.0])
        return np.asarray(p[4:8]) if len(p) >= 8 else np.zeros(4)

    @property
    def is_fisheye(self) -> bool:
        return "FISHEYE" in self.model


@dataclass
class Image:
    image_id: int
    qvec: np.ndarray  # [4] wxyz
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(fmt, f):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_bin(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            cam_id, model_id, w, h = _read("<iiQQ", f)
            name, np_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{np_params}d", f))
            cams[cam_id] = Camera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_bin(path: str) -> Dict[int, Image]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            vals = _read("<idddddddi", f)
            name = b""
            while True:
                c = f.read(1)
                if c in (b"\x00", b""):
                    break
                name += c
            (n2d,) = _read("<Q", f)
            raw = np.frombuffer(f.read(POINT2D_RECORD.itemsize * n2d), dtype=POINT2D_RECORD)
            imgs[vals[0]] = Image(
                vals[0], np.array(vals[1:5]), np.array(vals[5:8]), vals[8], name.decode("utf-8"),
                raw["xy"].copy(), raw["id3"].copy(),
            )
    return imgs


def read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz [M,3] f32, rgb [M,3] u8, err [M] f32, ids [M] int64)."""
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<Q", buf, 0)
    track_len = struct.Struct("<Q")
    len_at = POINT_RECORD.fields["track_len"][1]
    offsets = [0] * n
    off = 8
    for i in range(n):
        offsets[i] = off
        off += POINT_RECORD.itemsize + 8 * track_len.unpack_from(buf, off + len_at)[0]
    if off != len(buf):
        raise ValueError(f"{path}: {len(buf)} bytes, the records end at {off}")
    raw = np.frombuffer(buf, np.uint8)
    idx = np.asarray(offsets, np.int64)[:, None] + np.arange(POINT_RECORD.itemsize)
    rec = raw[idx].view(POINT_RECORD).reshape(n)
    return (
        rec["xyz"].astype(np.float32).reshape(-1, 3),
        rec["rgb"].reshape(-1, 3).copy(),
        rec["err"].astype(np.float32),
        rec["id"].astype(np.int64),
    )


def read_cameras_txt(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            w, h = int(parts[2]), int(parts[3])
            params = np.array([float(x) for x in parts[4:]])
            cams[cam_id] = Camera(cam_id, model, w, h, params)
    return cams


def read_images_txt(path: str) -> Dict[int, Image]:
    imgs = {}
    with open(path) as f:
        # two lines an image; the second (its 2D points) may be empty
        lines = [l.strip() for l in f if not l.startswith("#")]
    if len(lines) % 2:
        lines.append("")
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        if not parts:
            continue
        obs = lines[i + 1].split()
        xys = np.array(
            [[float(obs[j]), float(obs[j + 1])] for j in range(0, len(obs), 3)]
        ).reshape(-1, 2)
        ids = np.array([int(obs[j + 2]) for j in range(0, len(obs), 3)], np.int64)
        imgs[int(parts[0])] = Image(
            int(parts[0]), np.array([float(x) for x in parts[1:5]]),
            np.array([float(x) for x in parts[5:8]]), int(parts[8]), parts[9], xys, ids,
        )
    return imgs


def read_points3d_txt(path: str):
    xyzs, rgbs, errs, ids = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            ids.append(int(parts[0]))
            xyzs.append([float(x) for x in parts[1:4]])
            rgbs.append([int(x) for x in parts[4:7]])
            errs.append(float(parts[7]))
    return (
        np.array(xyzs, np.float32).reshape(-1, 3),
        np.array(rgbs, np.uint8).reshape(-1, 3),
        np.array(errs, np.float32),
        np.array(ids, np.int64),
    )


_NATIVE_WARNED = []


def read_model_numpy_bin(sparse_dir: str):
    """(cameras, images, points) of a binary model directory, by this
    module's numpy reader."""
    return (
        read_cameras_bin(os.path.join(sparse_dir, "cameras.bin")),
        read_images_bin(os.path.join(sparse_dir, "images.bin")),
        read_points3d_bin(os.path.join(sparse_dir, "points3D.bin")),
    )


def read_model(sparse_dir: str):
    """Read a COLMAP sparse model directory (.bin preferred, .txt
    otherwise): (cameras, images, (xyz, rgb, err, ids)). A binary model
    goes through the native reader; where that fails, the numpy reader
    reads it after a warning (once a process)."""
    from .._backend import HOST_CALLS

    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        from . import colmap_native

        try:
            model = colmap_native.read_model_bin(sparse_dir)
            HOST_CALLS["colmap_native"] += 1
            return model
        except (RuntimeError, OSError) as e:
            if not _NATIVE_WARNED:
                _NATIVE_WARNED.append(str(e))
                warnings.warn(f"the native COLMAP reader failed, reading {sparse_dir} with the numpy reader: {e}",
                              RuntimeWarning, stacklevel=2)
        HOST_CALLS["colmap_numpy"] += 1
        return read_model_numpy_bin(sparse_dir)
    else:
        cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_txt(os.path.join(sparse_dir, "images.txt"))
        pts = read_points3d_txt(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, pts
