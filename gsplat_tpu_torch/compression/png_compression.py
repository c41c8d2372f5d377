"""PNG / K-means compression of trained splats (port of
gsplat_tpu/compression/png_compression.py).

The same files as the JAX package, so that each package reads the
other's directory: ``meta.json`` (each field's shape and dtype, and for a
PNG field its per-channel ``mins`` and ``maxs``), the means as two 8-bit
PNGs (``means_l.png`` / ``means_u.png``, the low and high bytes of a
16-bit quantization after `utils.log_transform`), scales, quats
(normalised), opacities and sh0 as 8-bit min-max-quantized PNGs (grey, RGB
or RGBA by their channels), shN as a K-means codebook (``shN.npz``:
float16 ``centroids``, uint16 or uint32 ``labels``) and every other field
as ``{name}.npz``. Before that the lowest opacities are cropped so that
the count is a square, and `sort.sort_splats` lays the splats out on the
square grid.

The PNGs go through the port's own `datasets.image_io` (the card's machine
has no PIL), every row Sub-filtered: the serpentine sort makes a row's
neighbours alike, and Sub rows decode as one running sum. The pixels are
the JAX package's; the files' bytes differ from PIL's encoding. The
quantization, the crop and the sort are numpy on the host, as in the JAX
package. The K-means of shN (`kmeans`) runs in torch on the splats'
device: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .._backend import full_f32_matmul, resolve_device
from ..datasets.image_io import read_png, write_png
from ..utils import inverse_log_transform, log_transform
from .sort import sort_splats

PNG_FILTER = 1  # Sub


def _imwrite(path: str, arr: np.ndarray):
    write_png(path, arr, filter_type=PNG_FILTER)


def _imread(path: str) -> np.ndarray:
    return read_png(path, as_stored=True)


def _compress_png(compress_dir, name, params, n_sidelen, **kw):
    if params.size == 0:
        return {"shape": list(params.shape), "dtype": str(params.dtype)}
    grid = params.reshape(n_sidelen, n_sidelen, -1)
    mins = grid.min(axis=(0, 1))
    maxs = grid.max(axis=(0, 1))
    norm = (grid - mins) / np.maximum(maxs - mins, 1e-12)
    img = (norm * 255).round().astype(np.uint8).squeeze()
    _imwrite(os.path.join(compress_dir, f"{name}.png"), img)
    return {"shape": list(params.shape), "dtype": str(params.dtype), "mins": mins.tolist(), "maxs": maxs.tolist()}


def _decompress_png(compress_dir, name, meta):
    if not np.all(meta["shape"]):
        return np.zeros(meta["shape"], meta["dtype"])
    img = _imread(os.path.join(compress_dir, f"{name}.png")).astype(np.float32)
    norm = img / 255.0
    mins = np.asarray(meta["mins"], np.float32)
    maxs = np.asarray(meta["maxs"], np.float32)
    grid = norm.reshape(norm.shape[0], norm.shape[1], -1) * (maxs - mins) + mins
    return grid.reshape(meta["shape"]).astype(meta["dtype"])


def _compress_png_16bit(compress_dir, name, params, n_sidelen, **kw):
    if params.size == 0:
        return {"shape": list(params.shape), "dtype": str(params.dtype)}
    grid = params.reshape(n_sidelen, n_sidelen, -1)
    mins = grid.min(axis=(0, 1))
    maxs = grid.max(axis=(0, 1))
    norm = (grid - mins) / np.maximum(maxs - mins, 1e-12)
    img = (norm * (2**16 - 1)).round().astype(np.uint16)
    _imwrite(os.path.join(compress_dir, f"{name}_l.png"), (img & 0xFF).astype(np.uint8))
    _imwrite(os.path.join(compress_dir, f"{name}_u.png"), ((img >> 8) & 0xFF).astype(np.uint8))
    return {"shape": list(params.shape), "dtype": str(params.dtype), "mins": mins.tolist(), "maxs": maxs.tolist()}


def _decompress_png_16bit(compress_dir, name, meta):
    if not np.all(meta["shape"]):
        return np.zeros(meta["shape"], meta["dtype"])
    img_l = _imread(os.path.join(compress_dir, f"{name}_l.png"))
    img_u = _imread(os.path.join(compress_dir, f"{name}_u.png")).astype(np.uint16)
    img = ((img_u << 8) + img_l).astype(np.float32) / (2**16 - 1)
    mins = np.asarray(meta["mins"], np.float32)
    maxs = np.asarray(meta["maxs"], np.float32)
    grid = img.reshape(img.shape[0], img.shape[1], -1) * (maxs - mins) + mins
    return grid.reshape(meta["shape"]).astype(meta["dtype"])


def _assign(x1: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Each row's nearest centroid: argmin of ||c||^2 - 2 x.c, as one
    product of the rows with a column of ones appended (``x1`` [N, D + 1])
    and [-2 c, ||c||^2]; the rows in batches of KMEANS_BATCH (one
    [KMEANS_BATCH, k] block at a time)."""
    c1 = torch.cat([-2.0 * c, (c * c).sum(1, keepdim=True)], 1)
    labels = torch.empty(x1.shape[0], dtype=torch.int64, device=x1.device)
    with full_f32_matmul():
        for i in range(0, x1.shape[0], KMEANS_BATCH):
            labels[i : i + KMEANS_BATCH] = (x1[i : i + KMEANS_BATCH] @ c1.T).argmin(1)
    return labels


def _centroids(x: torch.Tensor, labels: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Each cluster's mean row (a cluster with no row keeps ``prev``). The
    sums are of the rows in 64-bit fixed point, which integer adds give
    exactly in any order: the same centroids on every run."""
    k = prev.shape[0]
    xd = x.double()
    amax = float(xd.abs().max()) if x.numel() else 0.0
    # as many fraction bits as keep the largest possible sum under 2^62
    frac = 62 - int(np.ceil(np.log2(max(amax, 2.0**-40) * max(x.shape[0], 1)))) - 1
    scale = 2.0**frac
    q = torch.round(xd * scale).long()
    sums = torch.zeros((k, x.shape[1]), dtype=torch.int64, device=x.device).index_add_(0, labels, q)
    counts = torch.bincount(labels, minlength=k)
    means = (sums.double() / scale / counts.clamp_min(1)[:, None].double()).float()
    return torch.where((counts > 0)[:, None], means, prev)


SEED_ROUNDS = 256  # the seeding's rounds: ceil(k / 256) centres a round
SEED_CHUNK = 512  # candidates a [rows, candidates] distance block


def _dist2(x: torch.Tensor, xn: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances [rows, centres] as ||x||^2 + ||c||^2 - 2 x.c."""
    with full_f32_matmul():
        return torch.addmm(xn[:, None] + (c * c).sum(1)[None, :], x, c.T, alpha=-2.0).clamp_min(0.0)


def _seed(x: torch.Tensor, k: int, gen: torch.Generator) -> torch.Tensor:
    """Greedy k-means++ seeding of ``k`` centres among the rows of ``x``
    (scikit-learn's: 2 + ln k candidates a centre, drawn with weight the
    squared distance to the nearest centre so far, the one that lowers the
    summed distance most kept), in at most SEED_ROUNDS rounds: a round
    draws its b centres' candidates at once, without replacement, and
    keeps the b whose own gain is largest (k <= 256: one a round, the
    sequential seeding)."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    first = torch.randint(n, (1,), generator=gen, device=x.device)
    xn = (x * x).sum(1)
    centres = [x[first]]
    d2 = _dist2(x, xn, x[first])[:, 0]
    left = k - 1
    rounds = min(left, SEED_ROUNDS)
    for r in range(rounds):
        b = -(-left // (rounds - r))
        # a row already chosen weighs ~0; 1e-30 keeps the draw defined on
        # rows that all repeat a centre
        cand = torch.multinomial(d2 + 1e-30, min(b * trials, n), replacement=False, generator=gen)
        gains = torch.cat([(d2[:, None] - _dist2(x, xn, x[part])).clamp_min(0.0).sum(0)
                           for part in cand.split(SEED_CHUNK)])
        new = x[cand[torch.sort(gains, descending=True, stable=True).indices[:b]]]
        centres.append(new)
        d2 = torch.minimum(d2, _dist2(x, xn, new).min(1).values)
        left -= b
    return torch.cat(centres)


# the JAX package's MiniBatchKMeans knobs: batches of 4,096 rows, at most
# 20 passes, seed 0
KMEANS_BATCH, KMEANS_PASSES, KMEANS_SEED = 4096, 20, 0


def kmeans(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-means of the rows of ``x`` [N, D] into ``k`` <= N clusters, on
    ``x``'s device, where the JAX package runs scikit-learn's
    ``MiniBatchKMeans`` with the same knobs (KMEANS_*). Returns
    ``(centroids [k, D] float32, labels [N] int64)``.

    - Draws: one ``torch.Generator`` on ``x``'s device seeded with
      KMEANS_SEED; the same centroids on every run.
    - Init: greedy k-means++ (`_seed`) on ``max(3 k, 3 KMEANS_BATCH)`` rows
      drawn without replacement (all rows where N is smaller:
      scikit-learn's ``init_size``); k = N takes every row, each its own
      centroid.
    - A pass (Lloyd's) assigns every row to its nearest centroid (squared
      distance as ||c||^2 - 2 x.c, one float32 product with TF32 off, the
      rows in batches of KMEANS_BATCH: `_assign`), then moves each
      centroid to the mean of its rows (`_centroids`); a centroid that
      lost every row stays.
    - Stop: after a pass that changes no label, or after KMEANS_PASSES
      passes. The labels returned are the last assignment, to the
      centroids returned.
    """
    x = x.float()
    n = x.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    gen = torch.Generator(device=x.device).manual_seed(KMEANS_SEED)
    if k == n:
        c = x.clone()
    else:
        m = min(n, max(3 * k, 3 * KMEANS_BATCH))
        rows = torch.randperm(n, generator=gen, device=x.device)[:m] if m < n else slice(None)
        c = _seed(x[rows], k, gen)
    x1 = torch.cat([x, torch.ones_like(x[:, :1])], 1)
    labels = _assign(x1, c)
    for _ in range(KMEANS_PASSES):
        c = _centroids(x, labels, c)
        new = _assign(x1, c)
        done = torch.equal(new, labels)
        labels = new
        if done:
            break
    return c, labels


def _compress_kmeans(compress_dir, name, params, n_sidelen, n_clusters=65536, verbose=False, device="cuda", **kw):
    if params.size == 0:
        return {"shape": list(params.shape), "dtype": str(params.dtype)}
    flat = torch.as_tensor(params.reshape(params.shape[0], -1).astype(np.float32), device=device)
    k = int(min(n_clusters, flat.shape[0]))
    centroids, labels = kmeans(flat, k)
    np.savez_compressed(
        os.path.join(compress_dir, f"{name}.npz"),
        centroids=centroids.cpu().numpy().astype(np.float16),
        labels=labels.cpu().numpy().astype(np.uint32 if k > 65535 else np.uint16),
    )
    return {"shape": list(params.shape), "dtype": str(params.dtype), "n_clusters": k}


def _decompress_kmeans(compress_dir, name, meta):
    if not np.all(meta["shape"]):
        return np.zeros(meta["shape"], meta["dtype"])
    data = np.load(os.path.join(compress_dir, f"{name}.npz"))
    out = data["centroids"][data["labels"]].astype(meta["dtype"])
    return out.reshape(meta["shape"])


def _compress_npz(compress_dir, name, params, **kw):
    np.savez_compressed(os.path.join(compress_dir, f"{name}.npz"), arr=params)
    return {"shape": list(params.shape), "dtype": str(params.dtype)}


def _decompress_npz(compress_dir, name, meta):
    return np.load(os.path.join(compress_dir, f"{name}.npz"))["arr"].astype(meta["dtype"])


def _host(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@dataclass
class PngCompression:
    """Quantize, sort and PNG-compress splats; K-means for the SH rest
    bands. ``device`` is where the K-means runs: by default the device of
    the splats' tensors, or the card for numpy arrays."""

    use_sort: bool = True
    # opt-in blur-guided pair-swap refinement after the serpentine sort
    # (compression/sort.py::plas_refine)
    plas: bool = False
    verbose: bool = False
    device: Optional[str] = None

    _compress_map = {
        "means": _compress_png_16bit,
        "scales": _compress_png,
        "quats": _compress_png,
        "opacities": _compress_png,
        "sh0": _compress_png,
        "shN": _compress_kmeans,
    }
    _decompress_map = {
        "means": _decompress_png_16bit,
        "scales": _decompress_png,
        "quats": _decompress_png,
        "opacities": _decompress_png,
        "sh0": _decompress_png,
        "shN": _decompress_kmeans,
    }

    def _kmeans_device(self, splats: Dict[str, Any]) -> torch.device:
        if self.device is not None:
            return resolve_device(self.device)
        for v in splats.values():
            if isinstance(v, torch.Tensor):
                return v.device
        return resolve_device("cuda")

    def prepare(self, splats: Dict[str, Any]) -> Tuple[Dict[str, np.ndarray], int]:
        """The arrays as they are quantized, and the grid's side: the means
        log-transformed, the quats normalised, the lowest opacities
        cropped to a square count, then sorted onto the grid."""
        splats = {k: _host(v) for k, v in splats.items()}
        splats["means"] = log_transform(torch.from_numpy(np.ascontiguousarray(splats["means"]))).numpy()
        q = splats["quats"]
        splats["quats"] = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)

        n_gs = splats["means"].shape[0]
        n_sidelen = int(n_gs**0.5)
        n_crop = n_gs - n_sidelen**2
        if n_crop != 0:
            keep = np.argsort(splats["opacities"].reshape(-1))[n_crop:]
            splats = {k: v[keep] for k, v in splats.items()}
        if self.use_sort:
            splats = sort_splats(splats, n_sidelen=n_sidelen, plas=self.plas)
        return splats, n_sidelen

    def compress(self, compress_dir: str, splats: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Write ``splats`` (numpy arrays or tensors keyed by field) into
        ``compress_dir``. Returns the arrays as they were quantized
        (`prepare`'s)."""
        device = self._kmeans_device(splats)
        os.makedirs(compress_dir, exist_ok=True)
        splats, n_sidelen = self.prepare(splats)
        meta = {}
        for name, value in splats.items():
            fn: Callable = self._compress_map.get(name, _compress_npz)
            meta[name] = fn(compress_dir, name, value, n_sidelen=n_sidelen, verbose=self.verbose, device=device)
        with open(os.path.join(compress_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        return splats

    def decompress(self, compress_dir: str) -> Dict[str, np.ndarray]:
        """The splats of ``compress_dir`` as numpy arrays, in the grid's
        order."""
        with open(os.path.join(compress_dir, "meta.json")) as f:
            meta = json.load(f)
        splats = {}
        for name, m in meta.items():
            fn = self._decompress_map.get(name, _decompress_npz)
            splats[name] = fn(compress_dir, name, m)
        splats["means"] = inverse_log_transform(torch.from_numpy(splats["means"].astype(np.float32))).numpy()
        return splats
