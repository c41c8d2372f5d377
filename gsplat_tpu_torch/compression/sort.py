"""Spatial-coherence sort before grid compression (a copy of
gsplat_tpu/compression/sort.py: numpy only, the same permutation).

The reference uses the PLAS 2-D self-organizing sort
(gsplat/compression/sort.py:7-46, external `plas` package) to lay splats out
on a smooth 2-D grid so the PNG codec compresses better. PLAS is an
iterative GPU solver minimizing the summed feature distance between grid
neighbors; here we approximate the same objective in three numpy-only
stages:

  1. Morton-order (Z-curve) pre-sort of the normalized positions,
  2. serpentine (boustrophedon) placement onto the PNG grid, so list
     neighbors stay 2-D adjacent across row boundaries,
  3. vectorized even-odd transposition refinement along rows: swaps
     adjacent grid cells when that lowers the L1 distance of the
     *quantized stored bytes* to the along-row neighbors — the quantity
     PNG's left-predicting filters actually encode (an L2/4-neighbor
     objective was tried first and measurably HURT the PNG size).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _morton3(x: np.ndarray, bits: int = 16) -> np.ndarray:
    """Interleave 3 x `bits`-bit integer coordinates into Morton codes."""
    codes = np.zeros(x.shape[0], np.uint64)
    for b in range(bits):
        for d in range(3):
            codes |= ((x[:, d].astype(np.uint64) >> b) & 1) << np.uint64(
                3 * b + d
            )
    return codes


def _feature_grid(splats: Dict[str, np.ndarray], s: int):
    """The attributes as the codec will store them: per-channel min-max
    quantized bytes (shN is K-means-coded, not filter-predicted — skip)."""
    feats = []
    for k, v in splats.items():
        if k == "shN":
            continue
        f = v.reshape(s * s, -1).astype(np.float32)
        mins, maxs = f.min(axis=0), f.max(axis=0)
        f = (f - mins) / np.maximum(maxs - mins, 1e-12) * 255.0
        feats.append(np.round(f))
    return np.concatenate(feats, axis=1).reshape(s, s, -1)


def _pair_swap_pass(F: np.ndarray, P: np.ndarray, offset: int):
    """One even-odd transposition sweep along rows (the PNG scan axis).

    Considers disjoint adjacent column pairs (`ja`/`ja+1`, every row
    independently) and swaps a pair when that lowers the summed L1 byte
    distance to its *external* row neighbors (the internal pair bond is
    swap-invariant). F (quantized features) and P (permutation) are
    updated in place.
    """
    s = F.shape[1]
    n_pairs = (s - offset) // 2
    if n_pairs <= 0:
        return
    ja = offset + 2 * np.arange(n_pairs)
    a, b = F[:, ja], F[:, ja + 1]  # [s, n_pairs, C]

    cost_now = np.zeros((F.shape[0], n_pairs), np.float32)
    cost_sw = np.zeros_like(cost_now)
    m = ja > 0  # has an external neighbor before the pair
    cost_now[:, m] += np.abs(a[:, m] - F[:, ja[m] - 1]).sum(-1)
    cost_sw[:, m] += np.abs(b[:, m] - F[:, ja[m] - 1]).sum(-1)
    m = (ja + 2) < s  # has an external neighbor after the pair
    cost_now[:, m] += np.abs(b[:, m] - F[:, ja[m] + 2]).sum(-1)
    cost_sw[:, m] += np.abs(a[:, m] - F[:, ja[m] + 2]).sum(-1)

    upd = cost_sw < cost_now  # [s, n_pairs] per-cell swap decision
    F[:, ja] = np.where(upd[..., None], b, a)
    F[:, ja + 1] = np.where(upd[..., None], a, b)
    pa, pb = P[:, ja].copy(), P[:, ja + 1].copy()
    P[:, ja] = np.where(upd, pb, pa)
    P[:, ja + 1] = np.where(upd, pa, pb)


def _box_blur(F: np.ndarray, r: int) -> np.ndarray:
    """Exact [2r+1]-box blur (edge-padded, separable) of an [s, s, C] grid."""
    k = 2 * r + 1
    out = F
    for axis in (0, 1):
        pad = [(0, 0)] * 3
        pad[axis] = (r, r)
        p = np.pad(out, pad, mode="edge")
        c = np.cumsum(p, axis=axis, dtype=np.float64)
        zshape = list(c.shape)
        zshape[axis] = 1
        c = np.concatenate([np.zeros(zshape), c], axis=axis)
        sl_hi = [slice(None)] * 3
        sl_lo = [slice(None)] * 3
        sl_hi[axis] = slice(k, None)
        sl_lo[axis] = slice(0, -k)
        out = ((c[tuple(sl_hi)] - c[tuple(sl_lo)]) / k).astype(np.float32)
    return out


def _plas_pass(F: np.ndarray, P: np.ndarray, T: np.ndarray, d: int,
               axis: int, jitter: int):
    """One disjoint-pair swap sweep at offset ``d`` along ``axis`` against
    the blurred target ``T``: cells j in even d-blocks pair with j + d;
    a pair swaps when that lowers the summed squared distance of the cell
    CONTENTS to the cell TARGETS (the PLAS assignment objective,
    arXiv 2312.13299 §3). F [s,s,C], P [s,s] updated in place."""
    if axis == 0:
        F = F.transpose(1, 0, 2)
        P = P.T
        T = T.transpose(1, 0, 2)
    s = F.shape[1]
    j = np.arange(s - d)
    sel = ((j + jitter) // d) % 2 == 0
    ja = j[sel]
    jb = ja + d
    a, b = F[:, ja], F[:, jb]
    Ta, Tb = T[:, ja], T[:, jb]
    cost_now = ((a - Ta) ** 2).sum(-1) + ((b - Tb) ** 2).sum(-1)
    cost_sw = ((b - Ta) ** 2).sum(-1) + ((a - Tb) ** 2).sum(-1)
    upd = cost_sw < cost_now  # [s, n_pairs]
    F[:, ja] = np.where(upd[..., None], b, a)
    F[:, jb] = np.where(upd[..., None], a, b)
    pa, pb = P[:, ja].copy(), P[:, jb].copy()
    P[:, ja] = np.where(upd, pb, pa)
    P[:, jb] = np.where(upd, pa, pb)


def plas_refine(
    splats: Dict[str, np.ndarray],
    P: np.ndarray,
    sweeps_per_radius: int = 6,
    radius_decay: float = 0.7,
    seed: int = 0,
) -> np.ndarray:
    """Blur-guided self-organizing refinement of a grid layout — the
    pairwise-swap variant of PLAS (arXiv 2312.13299; reference
    gsplat/compression/sort.py:7-46 calls the external CUDA `plas` package).

    PLAS alternates (a) blurring the grid into a smooth target and (b)
    locally reassigning cells toward that target at exponentially
    decreasing radii. Here step (b) is disjoint-pair swaps at random
    offsets <= radius along alternating axes — numpy-only, a few seconds
    for a 1k x 1k grid — which minimizes the same neighborhood-smoothness
    objective. Returns the refined [s, s] permutation (indices into the
    splat arrays).

    Measured (scripts/exp_plas_gap.py, garden fixture, 334^2 grid): this
    cuts the L2 neighborhood roughness 2.7x below the serpentine layout —
    the refinement works — but the PNG artifact comes out 8% LARGER, not
    smaller: PNG's per-row Sub/Paeth predictors reward the morton scan's
    many near-duplicate consecutive entries (small-residual frequency),
    not evenly-spread L2 smoothness. ``sort_splats`` therefore keeps
    serpentine+even-odd as the default and ``plas=True`` is opt-in for
    data where 2D smoothness wins (e.g. attribute grids consumed by
    2D-predicting codecs).
    """
    s = P.shape[0]
    feats = []
    for k, v in splats.items():
        if k == "shN":
            continue
        f = v.reshape(s * s, -1).astype(np.float32)
        mins, maxs = f.min(axis=0), f.max(axis=0)
        feats.append((f - mins) / np.maximum(maxs - mins, 1e-12))
    feat = np.concatenate(feats, axis=1)
    F = feat[P.reshape(-1)].reshape(s, s, -1).copy()
    P = P.copy()
    rng = np.random.default_rng(seed)
    radius = max(2, s // 2)
    while radius >= 1:
        T = _box_blur(F, max(1, radius // 2))
        for _ in range(sweeps_per_radius):
            d = int(rng.integers(1, radius + 1))
            axis = int(rng.integers(0, 2))
            jitter = int(rng.integers(0, 2 * d))
            _plas_pass(F, P, T, d, axis, jitter)
        if radius == 1:
            break
        radius = max(1, int(radius * radius_decay))
    return P


def sort_splats(
    splats: Dict[str, np.ndarray],
    n_sidelen: Optional[int] = None,
    refine_iters: int = 8,
    plas: bool = False,
) -> Dict[str, np.ndarray]:
    """Reorder splats for 2-D grid compression (PLAS approximation)."""
    means = splats["means"]
    n = means.shape[0]
    lo = means.min(axis=0)
    hi = means.max(axis=0)
    q = ((means - lo) / np.maximum(hi - lo, 1e-12) * (2**16 - 1)).astype(
        np.uint32
    )
    order = np.argsort(_morton3(q))

    if n_sidelen is None or n_sidelen * n_sidelen != n:
        return {k: v[order] for k, v in splats.items()}
    s = n_sidelen

    # serpentine placement: reverse every other row so consecutive Morton
    # neighbors stay adjacent across row boundaries
    grid_pos = np.arange(n).reshape(s, s)
    grid_pos[1::2] = grid_pos[1::2, ::-1].copy()
    P = np.empty((s, s), np.int64)
    P.reshape(-1)[:] = order[grid_pos.reshape(-1)]

    if plas:
        # blur-guided self-organization (the PLAS objective), then the
        # byte-level even-odd polish against PNG's row predictor
        P = plas_refine(splats, P)

    if refine_iters > 0:
        base = {k: v[P.reshape(-1)] for k, v in splats.items()}
        F = _feature_grid(base, s)
        P2 = np.arange(n).reshape(s, s)
        for it in range(refine_iters):
            _pair_swap_pass(F, P2, offset=it % 2)
        return {k: v[P2.reshape(-1)] for k, v in base.items()}

    final = P.reshape(-1)
    return {k: v[final] for k, v in splats.items()}
