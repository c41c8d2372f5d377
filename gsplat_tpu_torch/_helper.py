"""Test-fixture loader for the garden scene (copy of gsplat_tpu/_helper.py).

Loads the garden fixture (a real garden point cloud + 3 cameras) that ships
with the JAX package, crops it to an AABB, optionally replicates the scene
into a grid to mimic large-scale settings, and synthesizes random
scales/quats/opacities. Same crop, grid and seed as the JAX package, so
both packages see identical arrays; the output is numpy.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

# a data file of the JAX package, read by path (no import of that package)
_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    os.pardir, "gsplat_tpu", "assets", "test_garden.npz",
)


def load_test_data(
    data_path: Optional[str] = None,
    scene_crop: Tuple[float, float, float, float, float, float] = (-2, -2, -2, 2, 2, 2),
    scene_grid: int = 1,
    seed: int = 42,
):
    """Returns (means, quats, scales, opacities, colors, viewmats, Ks, width, height)
    as numpy float32 arrays."""
    if scene_grid % 2 != 1:
        raise ValueError(f"scene_grid must be odd, got {scene_grid}")
    if data_path is None:
        data_path = _DEFAULT_PATH
    data = np.load(data_path)
    height, width = int(data["height"]), int(data["width"])
    viewmats = data["viewmats"].astype(np.float32)
    Ks = data["Ks"].astype(np.float32)
    means = data["means3d"].astype(np.float32)
    colors = (data["colors"] / 255.0).astype(np.float32)

    aabb = np.array(scene_crop, np.float32)
    edges = aabb[3:] - aabb[:3]
    sel = ((means >= aabb[:3]) & (means <= aabb[3:])).all(axis=-1)
    means, colors = means[sel], colors[sel]

    repeats = scene_grid
    gridx, gridy = np.meshgrid(
        np.arange(-(repeats // 2), repeats // 2 + 1),
        np.arange(-(repeats // 2), repeats // 2 + 1),
        indexing="ij",
    )
    grid = np.stack([gridx, gridy, np.zeros_like(gridx)], axis=-1).reshape(-1, 3)
    means = (means[None, :, :] + grid[:, None, :] * edges[None, None, :]).reshape(-1, 3)
    colors = np.tile(colors, (repeats**2, 1))

    rng = np.random.default_rng(seed)
    N = len(means)
    scales = (rng.random((N, 3)) * 0.02).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacities = rng.random((N,)).astype(np.float32)

    return (
        means.astype(np.float32),
        quats,
        scales,
        opacities,
        colors,
        viewmats,
        Ks,
        width,
        height,
    )
