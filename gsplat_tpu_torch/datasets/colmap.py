"""COLMAP dataset: Parser + Dataset (port of gsplat_tpu/datasets/colmap.py).

The same fields, split and items as the JAX package's, from the port's
reader (colmap_io.py; binary models through the native reader,
colmap_native.py) and images (image_io.py: PNG and JPEG without PIL).
Where the JAX package calls cv2 and PIL, the port has its own numpy
counterparts:
  - undistortion (undistort.py): a camera with non-zero distortion
    parameters gets cv2's new camera matrix, roi and maps (OPENCV, RADIAL,
    SIMPLE_RADIAL), or the JAX package's theta-polynomial maps and their
    validity mask (the ``*FISHEYE`` models), which ``Dataset`` items carry
    as ``"mask"``; each view is remapped (`image_io.remap_bilinear`) and
    cropped to the roi;
  - resizing: an image whose size is not the camera's over ``factor``
    (``images_{factor}/`` missing) is resized as PIL's bilinear filter
    does (`image_io.resize_bilinear`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from .colmap_io import qvec_to_rotmat, read_model
from .image_io import load_image, remap_bilinear, resize_bilinear
from .normalize import (
    align_principal_axes,
    similarity_from_cameras,
    transform_cameras,
    transform_points,
)
from .undistort import camera_maps


class Parser:
    """COLMAP scene parser. Attributes as the JAX package's: image_names,
    image_paths, camtoworlds [N,4,4], camera_ids, Ks_dict, params_dict,
    imsize_dict, mask_dict, points [M,3], points_rgb, points_err,
    point_indices (per image, the rows of its observed points), transform,
    scene_scale; for each camera with distortion ``_mapx``, ``_mapy`` and
    ``_roi``."""

    def __init__(
        self,
        data_dir: str,
        factor: int = 1,
        normalize: bool = False,
        test_every: int = 8,
    ):
        self.data_dir = data_dir
        self.factor = factor
        self.normalize = normalize
        self.test_every = test_every

        sparse = os.path.join(data_dir, "sparse", "0")
        if not os.path.exists(sparse):
            sparse = os.path.join(data_dir, "sparse")
        cameras, images, (points, points_rgb, points_err, point_ids) = read_model(sparse)

        ordered = sorted(images.values(), key=lambda im: im.name)
        self.image_names: List[str] = [im.name for im in ordered]

        image_dir = os.path.join(data_dir, f"images_{factor}" if factor > 1 else "images")
        if not os.path.exists(image_dir):
            image_dir = os.path.join(data_dir, "images")
        self.image_dir = image_dir
        self.image_paths = [os.path.join(image_dir, n) for n in self.image_names]

        # the rows of each image's observed points, in observation order
        by_id = np.argsort(point_ids, kind="stable")
        sorted_ids = point_ids[by_id]
        w2c, camera_ids = [], []
        point_indices: Dict[str, np.ndarray] = {}
        for im in ordered:
            T = np.eye(4)
            T[:3, :3] = qvec_to_rotmat(im.qvec)
            T[:3, 3] = im.tvec
            w2c.append(T)
            camera_ids.append(im.camera_id)
            ids = im.point3D_ids[im.point3D_ids >= 0]
            pos = np.clip(np.searchsorted(sorted_ids, ids), 0, max(len(sorted_ids) - 1, 0))
            found = sorted_ids[pos] == ids if len(sorted_ids) else np.zeros(len(ids), bool)
            point_indices[im.name] = by_id[pos[found]].astype(np.int64)
        camtoworlds = np.linalg.inv(np.stack(w2c))

        # per-camera intrinsics (downscaled by `factor`)
        self.Ks_dict: Dict[int, np.ndarray] = {}
        self.params_dict: Dict[int, np.ndarray] = {}
        self.imsize_dict: Dict[int, tuple] = {}
        self.mask_dict: Dict[int, Optional[np.ndarray]] = {}
        self._mapx: Dict[int, np.ndarray] = {}
        self._mapy: Dict[int, np.ndarray] = {}
        self._roi: Dict[int, tuple] = {}
        for cam_id, cam in cameras.items():
            K = cam.K.copy()
            K[:2, :] /= factor
            self.Ks_dict[cam_id] = K.astype(np.float32)
            self.params_dict[cam_id] = cam.dist_params.astype(np.float32)
            self.imsize_dict[cam_id] = (cam.width // factor, cam.height // factor)
            self.mask_dict[cam_id] = None

        # undistortion maps: the new intrinsics less the roi offset, the
        # roi's size
        for cam_id, cam in cameras.items():
            dist = self.params_dict[cam_id]
            if not np.any(dist != 0.0):
                continue
            w, h = self.imsize_dict[cam_id]
            K_new, mapx, mapy, roi, mask = camera_maps(
                self.Ks_dict[cam_id].astype(np.float64), dist, w, h, cam.is_fisheye
            )
            x0, y0, ww, hh = roi
            self.Ks_dict[cam_id] = np.asarray(K_new, np.float32)
            self.Ks_dict[cam_id][0, 2] -= x0
            self.Ks_dict[cam_id][1, 2] -= y0
            self._mapx[cam_id], self._mapy[cam_id] = mapx, mapy
            self.imsize_dict[cam_id] = (ww, hh)
            self._roi[cam_id] = roi
            self.mask_dict[cam_id] = mask

        if normalize:
            T1 = similarity_from_cameras(camtoworlds)
            camtoworlds = transform_cameras(T1, camtoworlds)
            points = transform_points(T1, points)
            T2 = align_principal_axes(points)
            camtoworlds = transform_cameras(T2, camtoworlds)
            points = transform_points(T2, points)
            self.transform = T2 @ T1
        else:
            self.transform = np.eye(4)

        self.camtoworlds = camtoworlds.astype(np.float32)
        self.camera_ids = camera_ids
        self.points = points.astype(np.float32)
        self.points_err = points_err
        self.points_rgb = points_rgb
        self.point_indices = point_indices

        camera_locs = camtoworlds[:, :3, 3]
        scene_center = np.mean(camera_locs, axis=0)
        dists = np.linalg.norm(camera_locs - scene_center, axis=1)
        self.scene_scale = float(np.max(dists))

    def load_image(self, index: int) -> np.ndarray:
        """Image `index` as uint8 [H, W, 3] at its camera's size, as the JAX
        Parser loads it: a camera with maps resizes the file to the maps'
        size where it differs, remaps it and crops the roi; a camera
        without maps is only resized to its size."""
        img = load_image(self.image_paths[index])
        cam_id = self.camera_ids[index]
        w, h = self.imsize_dict[cam_id]
        if cam_id in self._mapx:
            mapx = self._mapx[cam_id]
            if img.shape[:2] != mapx.shape:
                img = resize_bilinear(img, mapx.shape[::-1])
            img = remap_bilinear(img, mapx, self._mapy[cam_id])
            x0, y0, ww, hh = self._roi[cam_id]
            return img[y0 : y0 + hh, x0 : x0 + ww]
        if img.shape[1] != w or img.shape[0] != h:
            img = resize_bilinear(img, (w, h))
        return img


class Dataset:
    """Train/val split over a Parser: image i is a validation image when
    i % test_every == 0. Items hold ``K``, ``camtoworld``, ``image`` (f32 in
    [0, 1]) and ``image_id`` (the image's position among all images, as in
    the JAX package), ``mask`` ([H, W] bool, False outside the fisheye
    projection) where the camera has one, and with ``load_depths`` ``points`` (pixel
    coordinates of the image's observed points in front of it and inside
    the frame) and their ``depths``."""

    def __init__(
        self,
        parser: Parser,
        split: str = "train",
        load_depths: bool = False,
    ):
        self.parser = parser
        self.split = split
        self.load_depths = load_depths
        idx = np.arange(len(parser.image_names))
        if split == "train":
            self.indices = idx[idx % parser.test_every != 0]
        else:
            self.indices = idx[idx % parser.test_every == 0]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, item: int) -> Dict:
        index = int(self.indices[item])
        cam_id = self.parser.camera_ids[index]
        image = self.parser.load_image(index).astype(np.float32) / 255.0
        data = {
            "K": self.parser.Ks_dict[cam_id],
            "camtoworld": self.parser.camtoworlds[index],
            "image": image,
            "image_id": index,
        }
        mask = self.parser.mask_dict.get(cam_id)
        if mask is not None:
            data["mask"] = mask
        if self.load_depths:
            name = self.parser.image_names[index]
            rows = self.parser.point_indices.get(name, np.zeros((0,), np.int64))
            pts = self.parser.points[rows]
            w2c = np.linalg.inv(self.parser.camtoworlds[index])
            pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
            K = self.parser.Ks_dict[cam_id]
            uv = pc @ K.T
            uv = uv[:, :2] / np.clip(uv[:, 2:3], 1e-6, None)
            h, w = image.shape[:2]
            sel = (
                (pc[:, 2] > 0)
                & (uv[:, 0] >= 0) & (uv[:, 0] < w)
                & (uv[:, 1] >= 0) & (uv[:, 1] < h)
            )
            data["points"] = uv[sel].astype(np.float32)
            data["depths"] = pc[sel, 2].astype(np.float32)
        return data
