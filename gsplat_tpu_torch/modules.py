"""Initialisation helpers of the trainer (port of the numpy part of
gsplat_tpu/modules.py).

``knn_distances`` uses ``scipy.spatial.cKDTree``: the JAX package's
scikit-learn neighbour search gives the same distances, and scipy is what
the card's machine has. The pose and appearance modules come with a later
slice.
"""

from __future__ import annotations

import numpy as np

SH_C0 = 0.28209479177387814


def knn_distances(x: np.ndarray, k: int = 4) -> np.ndarray:
    """Euclidean distances [N, k] to each point's k nearest points, itself
    (distance 0) first."""
    from scipy.spatial import cKDTree

    distances, _ = cKDTree(x).query(x, k=k, workers=-1)
    return distances


def rgb_to_sh(rgb):
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh):
    return sh * SH_C0 + 0.5
