"""Alpha compositing of an explicit intersection list, `accumulate` and
`accumulate_2dgs` (port of gsplat_tpu/ops/accumulate.py).

They pair with `rasterize_to_indices_in_range`: list the contributing
(gaussian, pixel, camera) pairs, then composite them again under plain
autograd to try new blending math without touching the fused kernels. A
test and prototyping utility, not a training path.

As in the JAX package the id lists have a static length: a padded slot is
disabled through the optional ``valid`` mask, or by an out-of-range camera
id, whose ray lies outside the image and is dropped from the sums. The
gathers read such a slot's row at a clamped id (JAX's gather clamps,
after wrapping negative ids once), since torch's indexing would raise.

The per-ray transmittance is a segmented multiplicative scan over each
run of equal ray ids (`_segmented_weights`), with no global product: a
global cumprod divided by each run's start value, or a log-space cumsum,
loses digits on long rays with alpha near 0.999. Rays must be contiguous
runs, depth-ordered within each run, the order that
`rasterize_to_indices_in_range` gives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._backend import common_device
from .rasterize_ref import ALPHA_MAX


def _segmented_weights(
    alphas: torch.Tensor,  # [M] in [0, ALPHA_MAX], 0 at disabled slots
    rays: torch.Tensor,  # [M] ray index; contiguous runs
) -> torch.Tensor:
    """Per-sample weight a_i * prod_{j<i, same run} (1 - a_j).

    A Hillis-Steele scan restricted to the runs: after the step of offset
    d, v[i] is the product of 1 - a over the last min(2d, pos + 1) samples
    of its run ending at i (pos = i's place in its run)."""
    M = alphas.shape[0]
    if M == 0:
        return alphas
    first = torch.ones(M, dtype=torch.bool, device=alphas.device)
    first[1:] = rays[1:] != rays[:-1]
    idx = torch.arange(M, device=alphas.device)
    pos = idx - torch.cummax(torch.where(first, idx, 0), dim=0).values
    v = 1.0 - alphas
    ones = torch.ones_like(v)
    d, longest = 1, int(pos.max()) + 1
    while d < longest:
        v = torch.where(pos >= d, torch.cat([ones[:d], v[:-d]]) * v, v)
        d *= 2
    excl = torch.where(first, 1.0, torch.cat([ones[:1], v[:-1]]))
    return alphas * excl


def _gather_index(ids: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's gather index: a negative id wraps once, then clamps to [0, n)."""
    ids = ids.long()
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)


def _segment_sum(values: torch.Tensor, rays: torch.Tensor, total: int) -> torch.Tensor:
    """Sum of `values` [M, ...] by ray into [total, ...]; rays outside
    [0, total) are dropped."""
    keep = (rays >= 0) & (rays < total)
    out = torch.zeros((total,) + values.shape[1:], dtype=values.dtype, device=values.device)
    kv = keep.reshape(keep.shape + (1,) * (values.dim() - 1))
    return out.index_add(0, torch.where(keep, rays, 0), torch.where(kv, values, 0.0))


def _composite(w, rays, C, H, W, *channels):
    total = C * H * W
    outs = [_segment_sum(w[:, None] * ch, rays, total).reshape(C, H, W, -1) for ch in channels]
    return outs + [_segment_sum(w, rays, total).reshape(C, H, W, 1)]


def _pixels(pixel_ids, image_width):
    px = (pixel_ids % image_width).to(torch.float32) + 0.5
    py = (pixel_ids // image_width).to(torch.float32) + 0.5
    return px, py


def accumulate(
    means2d: torch.Tensor,  # [C, N, 2]
    conics: torch.Tensor,  # [C, N, 3]
    opacities: torch.Tensor,  # [C, N]
    colors: torch.Tensor,  # [C, N, D]
    gaussian_ids: torch.Tensor,  # [M] int
    pixel_ids: torch.Tensor,  # [M] int (row-major within an image)
    camera_ids: torch.Tensor,  # [M] int
    image_width: int,
    image_height: int,
    valid: Optional[torch.Tensor] = None,  # [M] bool; False = padded slot
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite an explicit intersection list (3DGS sigma).

    Returns (renders [C, H, W, D], alphas [C, H, W, 1]). Entries must be
    grouped by (camera, pixel) ray and depth-ordered within each group."""
    common_device(means2d, conics, opacities, colors, gaussian_ids, pixel_ids, camera_ids, valid)
    C, N = opacities.shape
    cam, gau = _gather_index(camera_ids, C), _gather_index(gaussian_ids, N)
    px, py = _pixels(pixel_ids, image_width)
    mu = means2d[cam, gau]  # [M, 2]
    con = conics[cam, gau]  # [M, 3]
    dx = px - mu[:, 0]
    dy = py - mu[:, 1]
    sigma = 0.5 * (con[:, 0] * dx * dx + con[:, 2] * dy * dy) + con[:, 1] * dx * dy
    alphas = torch.clamp_max(opacities[cam, gau] * torch.exp(-sigma), ALPHA_MAX)
    if valid is not None:
        alphas = torch.where(valid, alphas, 0.0)

    rays = camera_ids.long() * (image_height * image_width) + pixel_ids.long()
    w = _segmented_weights(alphas, rays)
    renders, accum_alpha = _composite(w, rays, C, image_height, image_width, colors[cam, gau])
    return renders, accum_alpha


def accumulate_2dgs(
    means2d: torch.Tensor,  # [C, N, 2]
    ray_transforms: torch.Tensor,  # [C, N, 3, 3]
    opacities: torch.Tensor,  # [C, N]
    colors: torch.Tensor,  # [C, N, D]
    normals: torch.Tensor,  # [C, N, 3]
    gaussian_ids: torch.Tensor,  # [M] int
    pixel_ids: torch.Tensor,  # [M] int
    camera_ids: torch.Tensor,  # [M] int
    image_width: int,
    image_height: int,
    valid: Optional[torch.Tensor] = None,  # [M] bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite an explicit intersection list (2DGS ray-splat sigma, min'd
    with the 2D low-pass filter).

    Returns (renders [C, H, W, D], alphas [C, H, W, 1], normals [C, H, W, 3])."""
    common_device(
        means2d, ray_transforms, opacities, colors, normals, gaussian_ids, pixel_ids, camera_ids, valid
    )
    C, N = opacities.shape
    cam, gau = _gather_index(camera_ids, C), _gather_index(gaussian_ids, N)
    px, py = _pixels(pixel_ids, image_width)
    mu = means2d[cam, gau]  # [M, 2]
    M3 = ray_transforms[cam, gau]  # [M, 3, 3]

    h_u = -M3[:, 0, :] + M3[:, 2, :] * px[:, None]  # [M, 3]
    h_v = -M3[:, 1, :] + M3[:, 2, :] * py[:, None]
    cross = torch.linalg.cross(h_u, h_v, dim=-1)
    zsafe = torch.where(cross[:, 2] == 0.0, 1.0, cross[:, 2])
    us = cross[:, 0] / zsafe
    vs = cross[:, 1] / zsafe
    sigma_3d = us * us + vs * vs
    dx = mu[:, 0] - px
    dy = mu[:, 1] - py
    sigma_2d = 2.0 * (dx * dx + dy * dy)
    sigma = 0.5 * torch.minimum(sigma_3d, sigma_2d)
    alphas = torch.clamp_max(opacities[cam, gau] * torch.exp(-sigma), ALPHA_MAX)
    alphas = torch.where(cross[:, 2] == 0.0, 0.0, alphas)
    if valid is not None:
        alphas = torch.where(valid, alphas, 0.0)

    rays = camera_ids.long() * (image_height * image_width) + pixel_ids.long()
    w = _segmented_weights(alphas, rays)
    renders, renders_normal, accum_alpha = _composite(
        w, rays, C, image_height, image_width, colors[cam, gau], normals[cam, gau]
    )
    return renders, accum_alpha, renders_normal
