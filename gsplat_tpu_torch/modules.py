"""The trainer's initialisation helpers and its pose and appearance modules
(port of gsplat_tpu/modules.py).

``knn_distances`` uses ``scipy.spatial.cKDTree``: the JAX package's
scikit-learn neighbour search gives the same distances, and the port
depends on scipy, not scikit-learn.

``CameraOptModule`` (per-image SE(3) deltas through the 6D rotation
representation) and ``AppearanceOptModule`` (a per-image embedding and an
MLP over it, per-Gaussian features and the SH bases of the view
direction) are ``nn.Module``s holding the JAX package's parameter dicts as
parameters of the same names and layouts (``embeds``; ``w{i}`` [din, dout]
and ``b{i}``); ``from_numpy`` takes those dicts. The MLP's products are
plain float32 ``matmul`` (the JAX package leaves them to XLA), as is the
pose module's product with its camera, each run with TF32 off whatever the
caller allows, their gradients too (``_backend.f32_matmul``).

Rows are looked up by image id as the JAX package does it: an id past the
table's last row reads the last row (JAX's gather clamps) and sends it no
gradient (JAX's transposed scatter drops the update); see `take_rows`.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ._backend import f32_matmul, resolve_device
from .ops.sh import eval_sh_bases

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


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with the JAX package's out-of-range semantics: an id of
    ``len(table)`` or more reads the last row and carries no gradient back
    to it."""
    n = table.shape[0]
    rows = table[ids.clamp_max(n - 1)]
    in_range = (ids < n).reshape(ids.shape + (1,) * (rows.dim() - ids.dim()))
    return torch.where(in_range, rows, rows.detach())


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation representation (Zhou et al.) -> rotation matrix [..., 3, 3]."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-12)
    b2 = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


class CameraOptModule(nn.Module):
    """Per-image 9D pose deltas (3 translation + 6D rotation), zero at the
    start: ``forward(camtoworlds [..., 4, 4], embed_ids [...])`` returns
    ``camtoworlds @ delta``."""

    def __init__(self, n: int, device="cuda"):
        super().__init__()
        self.embeds = nn.Parameter(torch.zeros((n, 9), device=resolve_device(device)))

    @classmethod
    def from_numpy(cls, params: Mapping[str, np.ndarray], device="cuda") -> "CameraOptModule":
        m = cls(params["embeds"].shape[0], device=device)
        with torch.no_grad():
            m.embeds.copy_(torch.tensor(np.asarray(params["embeds"], np.float32)))
        return m

    def forward(self, camtoworlds: torch.Tensor, embed_ids: torch.Tensor) -> torch.Tensor:
        deltas = take_rows(self.embeds, embed_ids)  # [..., 9]
        dx, drot = deltas[..., :3], deltas[..., 3:]
        identity = torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=deltas.device)
        rot = rotation_6d_to_matrix(drot + identity)
        top = torch.cat([rot, dx[..., None]], dim=-1)  # [..., 3, 4]
        bottom = torch.tensor([0.0, 0, 0, 1.0], device=deltas.device).expand(top.shape[:-2] + (1, 4))
        return f32_matmul(camtoworlds, torch.cat([top, bottom], dim=-2))


class AppearanceOptModule(nn.Module):
    """Per-image embedding + MLP colour head: ``forward(features [N, F],
    embed_ids [C] or None, dirs [C, N, 3], sh_degree)`` returns colour
    offsets [C, N, 3]. ``embed_ids=None`` (evaluation) uses zero
    embeddings. The weights start uniform in +-sqrt(1/din), the biases and
    embeddings at zero; the weights are drawn on the CPU from
    ``generator``, so they do not depend on the device."""

    def __init__(
        self,
        n: int,
        feature_dim: int,
        embed_dim: int = 16,
        sh_degree: int = 3,
        mlp_width: int = 64,
        mlp_depth: int = 2,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.num_bases = (sh_degree + 1) ** 2
        self.n_layers = mlp_depth + 1
        self.embeds = nn.Parameter(torch.zeros((n, embed_dim), device=device))
        dims = [embed_dim + feature_dim + self.num_bases] + [mlp_width] * mlp_depth + [3]
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            lim = math.sqrt(1.0 / din)
            w = torch.rand((din, dout), generator=generator) * (2 * lim) - lim
            self.register_parameter(f"w{i}", nn.Parameter(w.to(device)))
            self.register_parameter(f"b{i}", nn.Parameter(torch.zeros((dout,), device=device)))

    @classmethod
    def from_numpy(cls, params: Mapping[str, np.ndarray], feature_dim: int, device="cuda") -> "AppearanceOptModule":
        """The module holding a JAX ``init_appearance_opt`` dict."""
        n_layers = sum(1 for k in params if k.startswith("w"))
        n, embed_dim = params["embeds"].shape
        num_bases = params["w0"].shape[0] - embed_dim - feature_dim
        sh_degree = math.isqrt(num_bases) - 1
        if (sh_degree + 1) ** 2 != num_bases:
            raise ValueError(f"w0 has {params['w0'].shape[0]} rows: {num_bases} SH bases is not a square")
        m = cls(n, feature_dim, embed_dim, sh_degree, params["w0"].shape[1], n_layers - 1, device=device)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if p.shape != params[name].shape:
                    raise ValueError(f"{name}: {tuple(params[name].shape)}, the module's {tuple(p.shape)}")
                p.copy_(torch.tensor(np.asarray(params[name], np.float32)))
        return m

    def forward(
        self,
        features: torch.Tensor,
        embed_ids: Optional[torch.Tensor],
        dirs: torch.Tensor,
        sh_degree: int,
    ) -> torch.Tensor:
        C, N = dirs.shape[:2]
        embed_dim = self.embeds.shape[1]
        if embed_ids is None:
            embeds = torch.zeros((C, embed_dim), device=dirs.device)
        else:
            embeds = take_rows(self.embeds, embed_ids)
        embeds = embeds[:, None, :].expand(C, N, embed_dim)
        feats = features[None].expand(C, N, features.shape[-1])
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
        use = min((sh_degree + 1) ** 2, self.num_bases)
        bases = torch.nn.functional.pad(eval_sh_bases(use, dirs), (0, self.num_bases - use))
        h = torch.cat([embeds, feats, bases] if embed_dim > 0 else [feats, bases], dim=-1)
        for i in range(self.n_layers):
            h = f32_matmul(h, getattr(self, f"w{i}")) + getattr(self, f"b{i}")
            if i < self.n_layers - 1:
                h = torch.relu(h)
        return h
