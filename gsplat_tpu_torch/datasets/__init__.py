"""COLMAP datasets in numpy (port of gsplat_tpu/datasets/), with a PNG
reader and writer of their own and a synthetic-scene writer."""

from .colmap import Dataset, Parser
from . import colmap_io, image_io, normalize, traj

__all__ = ["Dataset", "Parser", "colmap_io", "image_io", "normalize", "traj"]
