"""Oracle rasterizer in plain PyTorch, O(N * pixels) (port of
gsplat_tpu/ops/rasterize_ref.py).

Ground truth for the binned pipeline, differentiable by autograd, for tests
and toy scenes only: it materialises every (pixel, Gaussian) pair.

Exact per-pixel semantics:
  - process Gaussians in (depth, index) order (stable sort of the depth bits)
  - alpha   = min(opacity * exp(-sigma), 0.999)
  - invalid if alpha < 1/255, sigma < 0, radii <= 0, or the pixel's tile is
    outside the Gaussian's tile rectangle
  - a Gaussian is accepted iff valid and the *inclusive* transmittance
    prod_{valid j<=i}(1-alpha_j) stays > 1e-4; the first violation
    terminates the pixel (no acceptance after termination)
  - render = sum accepted T_excl * alpha * color + T_final * background
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._backend import common_device

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
TRANSMITTANCE_EPS = 1e-4


def rasterize_to_pixels_ref(
    means2d: torch.Tensor,  # [C, N, 2]
    conics: torch.Tensor,  # [C, N, 3]
    colors: torch.Tensor,  # [C, N, D]
    opacities: torch.Tensor,  # [C, N]
    radii: torch.Tensor,  # [C, N] int32
    depths: torch.Tensor,  # [C, N]
    image_width: int,
    image_height: int,
    tile_size: int = 16,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alpha-composite Gaussians to pixels (oracle path).

    Returns (render_colors [C, H, W, D], render_alphas [C, H, W, 1]).
    """
    device = common_device(means2d, conics, colors, opacities, radii, depths, backgrounds)
    C, N, _ = means2d.shape
    D = colors.shape[-1]

    # depth order by f32 bit pattern, stable => ties resolved by index
    order = torch.argsort(depths.detach().contiguous().view(torch.int32), dim=-1, stable=True)

    def take(x):
        idx = order.reshape(order.shape + (1,) * (x.ndim - 2))
        return torch.gather(x, 1, idx.expand((C, N) + x.shape[2:]))

    means2d = take(means2d)
    conics = take(conics)
    colors = take(colors)
    opacities = take(opacities[..., None])[..., 0]
    radii = take(radii[..., None])[..., 0]

    # tile rectangle per (cam, gaussian), identical to the binning's cull=False rect
    tile_means = means2d.detach() / tile_size
    tile_r = (radii / tile_size)[..., None]
    tmin = torch.floor(tile_means - tile_r).to(torch.int32)
    tmax = torch.ceil(tile_means + tile_r).to(torch.int32)

    # pixel coordinates (+0.5 centre convention)
    py, px = torch.meshgrid(
        torch.arange(image_height, device=device),
        torch.arange(image_width, device=device),
        indexing="ij",
    )
    px = px.reshape(-1).to(torch.float32) + 0.5
    py = py.reshape(-1).to(torch.float32) + 0.5
    ptx = (px - 0.5).to(torch.int32) // tile_size  # [P]
    pty = (py - 0.5).to(torch.int32) // tile_size

    dx = px[None, :, None] - means2d[:, None, :, 0]  # [C, P, N]
    dy = py[None, :, None] - means2d[:, None, :, 1]
    a = conics[:, None, :, 0]
    bq = conics[:, None, :, 1]
    c = conics[:, None, :, 2]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + bq * dx * dy
    alpha = torch.clamp_max(opacities[:, None, :] * torch.exp(-sigma), ALPHA_MAX)

    in_rect = (
        (ptx[None, :, None] >= tmin[:, None, :, 0])
        & (ptx[None, :, None] < tmax[:, None, :, 0])
        & (pty[None, :, None] >= tmin[:, None, :, 1])
        & (pty[None, :, None] < tmax[:, None, :, 1])
    )
    valid = (
        (alpha >= ALPHA_MIN)
        & (sigma >= 0.0)
        & (radii[:, None, :] > 0)
        & in_rect
    )

    # multiplicative transmittance chain (progressive T *= (1 - alpha))
    one_m = torch.where(valid, 1.0 - alpha, 1.0)
    T_incl = torch.cumprod(one_m, dim=-1)  # [C, P, N]
    accept = valid & (T_incl > TRANSMITTANCE_EPS)
    T_excl = torch.cat([torch.ones_like(T_incl[..., :1]), T_incl[..., :-1]], dim=-1)

    vis = torch.where(accept, T_excl * alpha, 0.0)
    render = torch.bmm(vis, colors)  # [C, P, D]
    final_T = torch.prod(torch.where(accept, one_m, 1.0), dim=-1)  # [C, P]
    render_alphas = 1.0 - final_T

    if backgrounds is not None:
        render = render + (1.0 - render_alphas)[..., None] * backgrounds[:, None, :]

    return (
        render.reshape(C, image_height, image_width, D),
        render_alphas.reshape(C, image_height, image_width, 1),
    )
