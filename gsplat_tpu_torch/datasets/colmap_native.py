"""ctypes bindings of the native COLMAP reader (csrc/colmap_native.cpp; port
of gsplat_tpu/datasets/colmap_native.py).

The library is built with g++ at first use into ``build/gsplat_tpu_torch/``
(`_backend.host_library`). The readers return the structures of the
port's numpy reader (colmap_io.py): cameras and images as its ``Camera`` /
``Image``, the points as (xyz [M, 3] f32, rgb [M, 3] u8, err [M] f32, ids
[M] int64), the same values. Each raises RuntimeError when the library
cannot be built or a file cannot be read; `colmap_io.read_model` then
falls back to the numpy reader with a warning.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Tuple

import numpy as np

from .colmap_io import CAMERA_MODELS, Camera, Image

_P = ctypes.c_char_p
_I64, _I32 = ctypes.c_int64, ctypes.c_int32
_PTR = ctypes.c_void_p
# symbol -> (argtypes, restype)
_SIGNATURES = {
    "cn_points3d_count": ([_P], _I64),
    "cn_points3d_read": ([_P, _I64, _PTR, _PTR, _PTR, _PTR], _I32),
    "cn_images_sizes": ([_P, ctypes.POINTER(_I64), ctypes.POINTER(_I64)], _I32),
    "cn_images_read": ([_P, _I64, _I64, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _PTR, _PTR, _PTR], _I32),
    "cn_cameras_count": ([_P], _I64),
    "cn_cameras_read": ([_P, _I64, _PTR, _PTR, _PTR, _PTR, _I32, _PTR], _I32),
}
MAX_PARAMS = 12
NAME_STRIDE = 512


def _lib():
    from .._backend import host_library

    lib = host_library("colmap_native")
    if lib.cn_points3d_count.argtypes is None:
        for sym, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = args, res
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def read_cameras_bin(path: str) -> Dict[int, Camera]:
    lib = _lib()
    bpath = path.encode()
    n = lib.cn_cameras_count(bpath)
    if n < 0:
        raise RuntimeError(f"{path}: the native reader cannot read it")
    cam_ids = np.empty(n, np.int32)
    model_ids = np.empty(n, np.int32)
    wh = np.empty(2 * n, np.int64)
    params = np.empty(n * MAX_PARAMS, np.float64)
    n_params = np.empty(n, np.int32)
    code = lib.cn_cameras_read(bpath, n, _ptr(cam_ids), _ptr(model_ids), _ptr(wh), _ptr(params), MAX_PARAMS,
                               _ptr(n_params))
    if code:
        raise RuntimeError(f"{path}: the native reader failed with code {code}")
    cams = {}
    for i in range(n):
        name, _ = CAMERA_MODELS[int(model_ids[i])]
        cams[int(cam_ids[i])] = Camera(
            int(cam_ids[i]), name, int(wh[2 * i]), int(wh[2 * i + 1]),
            params[i * MAX_PARAMS : i * MAX_PARAMS + int(n_params[i])].copy(),
        )
    return cams


def read_images_bin(path: str) -> Dict[int, Image]:
    lib = _lib()
    bpath = path.encode()
    n, tot = ctypes.c_int64(), ctypes.c_int64()
    code = lib.cn_images_sizes(bpath, ctypes.byref(n), ctypes.byref(tot))
    if code:
        raise RuntimeError(f"{path}: the native reader failed with code {code}")
    n, tot = n.value, tot.value
    image_ids = np.empty(n, np.int32)
    qvecs = np.empty(4 * n, np.float64)
    tvecs = np.empty(3 * n, np.float64)
    camera_ids = np.empty(n, np.int32)
    names = np.zeros(n * NAME_STRIDE, np.uint8)
    offs = np.empty(n + 1, np.int64)
    xy = np.empty(2 * max(tot, 1), np.float64)
    ids3 = np.empty(max(tot, 1), np.int64)
    code = lib.cn_images_read(bpath, n, tot, _ptr(image_ids), _ptr(qvecs), _ptr(tvecs), _ptr(camera_ids),
                              _ptr(names), NAME_STRIDE, _ptr(offs), _ptr(xy), _ptr(ids3))
    if code:
        raise RuntimeError(f"{path}: the native reader failed with code {code}")
    imgs = {}
    for i in range(n):
        raw = names[i * NAME_STRIDE : (i + 1) * NAME_STRIDE].tobytes()
        lo, hi = int(offs[i]), int(offs[i + 1])
        imgs[int(image_ids[i])] = Image(
            int(image_ids[i]), qvecs[4 * i : 4 * i + 4].copy(), tvecs[3 * i : 3 * i + 3].copy(), int(camera_ids[i]),
            raw.split(b"\x00", 1)[0].decode("utf-8"), xy[2 * lo : 2 * hi].reshape(-1, 2).copy(), ids3[lo:hi].copy(),
        )
    return imgs


def read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(xyz [M,3] f32, rgb [M,3] u8, err [M] f32, ids [M] int64)."""
    lib = _lib()
    bpath = path.encode()
    n = lib.cn_points3d_count(bpath)
    if n < 0:
        raise RuntimeError(f"{path}: the native reader cannot read it")
    m = max(n, 1)
    ids = np.empty(m, np.int64)
    xyz = np.empty(3 * m, np.float64)
    rgb = np.empty(3 * m, np.uint8)
    err = np.empty(m, np.float64)
    code = lib.cn_points3d_read(bpath, n, _ptr(ids), _ptr(xyz), _ptr(rgb), _ptr(err))
    if code:
        raise RuntimeError(f"{path}: the native reader failed with code {code}")
    return (
        xyz[: 3 * n].reshape(-1, 3).astype(np.float32),
        rgb[: 3 * n].reshape(-1, 3).copy(),
        err[:n].astype(np.float32),
        ids[:n].copy(),
    )


def read_model_bin(sparse_dir: str):
    """(cameras, images, points) of a binary model directory."""
    return (
        read_cameras_bin(os.path.join(sparse_dir, "cameras.bin")),
        read_images_bin(os.path.join(sparse_dir, "images.bin")),
        read_points3d_bin(os.path.join(sparse_dir, "points3D.bin")),
    )
