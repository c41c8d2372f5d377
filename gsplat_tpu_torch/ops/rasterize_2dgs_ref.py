"""2DGS (surfel) oracle rasterizer: plain torch, differentiable by autograd,
O(N * pixels) memory (port of gsplat_tpu/ops/rasterize_2dgs_ref.py).

Same acceptance and termination as the 3DGS oracle (alpha in [1/255,
0.999], inclusive transmittance > 1e-4). Beyond 3DGS it returns the
alpha-composited normals, the per-pixel depth distortion
2 * sum_i w_i (m_i W_<i - WM_<i) and the median depth (the depth of the
last Gaussian whose transmittance before it is > 0.5), with the depth m
read from the last colour channel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._backend import common_device
from .rasterize_ref import (
    ALPHA_MAX,
    TRANSMITTANCE_EPS,
    depth_rank_window,
    pixel_grid,
    valid_pairs,
    window_contrib,
)


def surfel_sigma(means2d, M, px, py):
    """The surfel exponent of every (pixel, Gaussian) pair [C, P, N]: the
    ray-plane intersection, h_u = -M[0] + px M[2] and h_v = -M[1] + py M[2],
    min'd with the 2D low-pass filter."""
    Mx = M[:, None, :, 0, :]  # [C, 1, N, 3]
    My = M[:, None, :, 1, :]
    Mz = M[:, None, :, 2, :]
    h_u = -Mx + Mz * px[None, :, None, None]  # [C, P, N, 3]
    h_v = -My + Mz * py[None, :, None, None]
    cr = torch.linalg.cross(h_u, h_v, dim=-1)
    crz = torch.where(torch.abs(cr[..., 2]) < 1e-12, 1e-12, cr[..., 2])
    us = cr[..., 0] / crz
    vs = cr[..., 1] / crz
    sigma_3d = us * us + vs * vs
    dx = px[None, :, None] - means2d[:, None, :, 0]
    dy = py[None, :, None] - means2d[:, None, :, 1]
    return 0.5 * torch.minimum(sigma_3d, 2.0 * (dx * dx + dy * dy))


def rasterize_to_pixels_2dgs_ref(
    means2d: torch.Tensor,  # [C, N, 2]
    ray_transforms: torch.Tensor,  # [C, N, 3, 3]
    colors: torch.Tensor,  # [C, N, D] (last channel = depth for distort/median)
    normals: torch.Tensor,  # [C, N, 3]
    opacities: torch.Tensor,  # [C, N]
    radii: torch.Tensor,  # [C, N] int32
    depths: torch.Tensor,  # [C, N]
    image_width: int,
    image_height: int,
    tile_size: int = 16,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (render_colors [C,H,W,D], alphas [C,H,W,1], render_normals
    [C,H,W,3], render_distort [C,H,W,1], render_median [C,H,W,1])."""
    dev = common_device(
        means2d, ray_transforms, colors, normals, opacities, radii, depths, backgrounds
    )
    C, N, _ = means2d.shape
    D = colors.shape[-1]
    _, (means2d, M, colors, normals, opacities, radii) = depth_rank_window(
        depths, 0, N, means2d, ray_transforms.reshape(C, N, 9), colors, normals, opacities, radii
    )
    M = M.reshape(C, N, 3, 3)
    px, py, ptx, pty = pixel_grid(image_width, image_height, tile_size, dev)
    sigma = surfel_sigma(means2d, M, px, py)  # [C, P, N]
    alpha = torch.clamp_max(opacities[:, None, :] * torch.exp(-sigma), ALPHA_MAX)
    valid = valid_pairs(alpha, sigma, radii, means2d, ptx, pty, tile_size)

    one_m = torch.where(valid, 1.0 - alpha, 1.0)
    T_incl = torch.cumprod(one_m, dim=-1)
    accept = valid & (T_incl > TRANSMITTANCE_EPS)
    T_excl = torch.cat([torch.ones_like(T_incl[..., :1]), T_incl[..., :-1]], dim=-1)
    vis = torch.where(accept, T_excl * alpha, 0.0)  # [C, P, N]

    render = torch.einsum("cpn,cnd->cpd", vis, colors)
    render_normals = torch.einsum("cpn,cnd->cpd", vis, normals)
    final_T = torch.prod(torch.where(accept, one_m, 1.0), dim=-1)
    render_alphas = 1.0 - final_T

    # distortion (streaming pairwise form, depth = last colour channel)
    m = colors[..., -1]  # [C, N]
    wm = vis * m[:, None, :]
    W_excl = torch.cumsum(vis, dim=-1) - vis
    WM_excl = torch.cumsum(wm, dim=-1) - wm
    distort = torch.sum(2.0 * (wm * W_excl - vis * WM_excl), dim=-1, keepdim=True)

    # median: depth of the last accepted Gaussian with T before it > 0.5
    med_mask = accept & (T_excl > 0.5)
    idx = torch.arange(N, device=dev)[None, None, :]
    last_med = torch.where(med_mask, idx, -1).amax(dim=-1)  # [C, P]
    m_at = torch.gather(m[:, None, :].expand(med_mask.shape), -1, last_med.clamp_min(0)[..., None])[..., 0]
    median = torch.where(last_med >= 0, m_at, 0.0)[..., None]

    if backgrounds is not None:
        render = render + (1.0 - render_alphas)[..., None] * backgrounds[:, None, :]

    H, W = image_height, image_width
    return (
        render.reshape(C, H, W, D),
        render_alphas.reshape(C, H, W, 1),
        render_normals.reshape(C, H, W, 3),
        distort.reshape(C, H, W, 1),
        median.reshape(C, H, W, 1),
    )


def rasterize_to_indices_in_range_2dgs(
    range_start: int,
    range_end: int,
    transmittances: torch.Tensor,  # [C, H, W]
    means2d: torch.Tensor,  # [C, N, 2]
    ray_transforms: torch.Tensor,  # [C, N, 3, 3]
    opacities: torch.Tensor,  # [C, N]
    radii: torch.Tensor,  # [C, N]
    depths: torch.Tensor,  # [C, N]
    image_width: int,
    image_height: int,
    tile_size: int = 16,
):
    """2DGS variant of rasterize_to_indices_in_range, with the oracle's
    surfel sigma. Returns (contrib [C, H*W, R] bool, alpha [C, H*W, R],
    sel [C, R], new_transmittances [C, H*W]), the last the termination
    stream to pass to the next window."""
    dev = common_device(transmittances, means2d, ray_transforms, opacities, radii, depths)
    C, N, _ = means2d.shape
    sel, (means2d, M, opacities, radii) = depth_rank_window(
        depths, range_start, range_end, means2d, ray_transforms.reshape(C, N, 9), opacities, radii
    )
    M = M.reshape(C, sel.shape[1], 3, 3)
    px, py, ptx, pty = pixel_grid(image_width, image_height, tile_size, dev)
    sigma = surfel_sigma(means2d, M, px, py)
    alpha = torch.clamp_max(opacities[:, None, :] * torch.exp(-sigma), ALPHA_MAX)
    valid = valid_pairs(alpha, sigma, radii, means2d, ptx, pty, tile_size)
    contrib, new_T = window_contrib(valid, alpha, transmittances)
    return contrib, alpha, sel, new_T
