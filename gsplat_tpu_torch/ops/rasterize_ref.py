"""Oracle rasterizer in plain PyTorch, O(N * pixels) (port of
gsplat_tpu/ops/rasterize_ref.py).

Ground truth for the binned pipeline, differentiable by autograd, for tests
and toy scenes only: it materialises every (pixel, Gaussian) pair.
`rasterize_to_pixels_ref_absgrad` adds the per-tile absgrad statistic as
the gradient of a carrier input.

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


def pixel_grid(image_width: int, image_height: int, tile_size: int, device):
    """Pixel centres (px, py) [P] (+0.5) and their tiles (ptx, pty) [P]."""
    py, px = torch.meshgrid(
        torch.arange(image_height, device=device),
        torch.arange(image_width, device=device),
        indexing="ij",
    )
    px = px.reshape(-1).to(torch.float32) + 0.5
    py = py.reshape(-1).to(torch.float32) + 0.5
    return px, py, (px - 0.5).to(torch.int32) // tile_size, (py - 0.5).to(torch.int32) // tile_size


def depth_rank_window(depths: torch.Tensor, range_start: int, range_end: int, *xs):
    """The Gaussians of depth ranks [range_start, range_end) of each camera
    (a stable sort of the depths' int32 bit patterns, as the JAX package
    sorts them: ties keep index order, negative depths come before the
    positive ones, in reverse) and each [C, N, ...] input of `xs` gathered
    at them. Returns (sel [C, R], the gathered inputs)."""
    order = torch.argsort(depths.detach().contiguous().view(torch.int32), dim=-1, stable=True)
    sel = order[:, range_start:range_end]

    def take(x):
        idx = sel.reshape(sel.shape + (1,) * (x.dim() - 2)).expand(sel.shape + x.shape[2:])
        return torch.gather(x, 1, idx)

    return sel, [take(x) for x in xs]


def gauss_sigma(means2d, conics, px, py):
    """The Gaussian exponent of every (pixel, Gaussian) pair [C, P, N]."""
    dx = px[None, :, None] - means2d[:, None, :, 0]
    dy = py[None, :, None] - means2d[:, None, :, 1]
    a, b, c = (conics[:, None, :, i] for i in range(3))
    return 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy


def valid_pairs(alpha, sigma, radii, means2d, ptx, pty, tile_size):
    """The pairs [C, P, N] that may composite: alpha >= 1/255, sigma >= 0,
    radius > 0 and the pixel's tile inside the Gaussian's tile rectangle
    (the binning's cull=False rectangle)."""
    tile_means = means2d.detach() / tile_size
    tile_r = (radii / tile_size)[..., None]
    tmin = torch.floor(tile_means - tile_r).to(torch.int32)
    tmax = torch.ceil(tile_means + tile_r).to(torch.int32)
    in_rect = (
        (ptx[None, :, None] >= tmin[:, None, :, 0])
        & (ptx[None, :, None] < tmax[:, None, :, 0])
        & (pty[None, :, None] >= tmin[:, None, :, 1])
        & (pty[None, :, None] < tmax[:, None, :, 1])
    )
    return (alpha >= ALPHA_MIN) & (sigma >= 0.0) & (radii[:, None, :] > 0) & in_rect


def window_contrib(valid, alpha, transmittances):
    """The accepted pairs of a depth-rank window [C, P, R] after a start
    transmittance [C, H, W], and the window's termination stream (the
    product over all valid pairs). Returns (contrib, new_T [C, P])."""
    C = alpha.shape[0]
    T0 = transmittances.reshape(C, -1)[..., None]
    one_m = torch.where(valid, 1.0 - alpha, 1.0)
    T_incl = T0 * torch.cumprod(one_m, dim=-1)
    contrib = valid & (T_incl > TRANSMITTANCE_EPS)
    new_T = T0[..., 0] * torch.prod(one_m, dim=-1)
    return contrib, new_T


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
    _, (means2d, conics, colors, opacities, radii) = depth_rank_window(
        depths, 0, N, means2d, conics, colors, opacities, radii
    )
    px, py, ptx, pty = pixel_grid(image_width, image_height, tile_size, device)
    sigma = gauss_sigma(means2d, conics, px, py)  # [C, P, N]
    alpha = torch.clamp_max(opacities[:, None, :] * torch.exp(-sigma), ALPHA_MAX)
    valid = valid_pairs(alpha, sigma, radii, means2d, ptx, pty, tile_size)

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


class _RefAbsgrad(torch.autograd.Function):
    """The oracle, with the absgrad statistic as the gradient of an extra
    carrier input: one masked-cotangent replay of the oracle's gradient per
    tile, |d means2d| of each, summed over tiles."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, backgrounds, abs_carrier,
                radii, depths, image_width, image_height, tile_size):
        ctx.save_for_backward(means2d, conics, colors, opacities, backgrounds, radii, depths)
        ctx.geom = (image_width, image_height, tile_size)
        return rasterize_to_pixels_ref(
            means2d, conics, colors, opacities, radii, depths,
            image_width, image_height, tile_size, backgrounds,
        )

    @staticmethod
    def backward(ctx, v_render, v_alpha):
        means2d, conics, colors, opacities, backgrounds, radii, depths = ctx.saved_tensors
        W, H, ts = ctx.geom
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (means2d, conics, colors, opacities, backgrounds)]
            out = rasterize_to_pixels_ref(*ins[:4], radii, depths, W, H, ts, ins[4])
            cts = [
                torch.zeros_like(o) if v is None else v
                for o, v in zip(out, (v_render, v_alpha))
            ]
            grads = torch.autograd.grad(out, ins, cts, retain_graph=True)
            py, px = torch.meshgrid(
                torch.arange(H, device=means2d.device),
                torch.arange(W, device=means2d.device),
                indexing="ij",
            )
            tid = (py // ts) * (-(-W // ts)) + px // ts  # [H, W]
            v_abs = torch.zeros_like(means2d)
            for t in range(int(tid.max()) + 1):
                m = (tid == t)[None, :, :, None].to(cts[0].dtype)
                (g,) = torch.autograd.grad(out, ins[0], [c * m for c in cts], retain_graph=True)
                v_abs = v_abs + g.abs()
        return (*grads, v_abs, None, None, None, None, None)


def rasterize_to_pixels_ref_absgrad(
    means2d: torch.Tensor,  # [C, N, 2]
    conics: torch.Tensor,  # [C, N, 3]
    colors: torch.Tensor,  # [C, N, D]
    opacities: torch.Tensor,  # [C, N]
    radii: torch.Tensor,  # [C, N] int32
    depths: torch.Tensor,  # [C, N]
    image_width: int,
    image_height: int,
    tile_size: int,
    backgrounds: torch.Tensor,  # [C, D] (zeros rather than None)
    abs_carrier: torch.Tensor,  # [C, N, 2] zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The oracle, whose ``abs_carrier`` input has the reference's absgrad
    statistic as its gradient: the sum over tiles of |per-tile d means2d|
    (a Gaussian spanning several tiles gets the sum of the absolute per-tile
    gradients, not the absolute value of their sum). The output does not
    depend on ``abs_carrier``. The backward replays the oracle's gradient
    once per tile: for tests and toy scenes only."""
    common_device(means2d, conics, colors, opacities, radii, depths, backgrounds, abs_carrier)
    return _RefAbsgrad.apply(
        means2d, conics, colors, opacities, backgrounds, abs_carrier,
        radii, depths, image_width, image_height, tile_size,
    )


def rasterize_to_indices_in_range(
    range_start: int,
    range_end: int,
    transmittances: torch.Tensor,  # [C, H, W] current per-pixel transmittance
    means2d: torch.Tensor,  # [C, N, 2]
    conics: torch.Tensor,  # [C, N, 3]
    opacities: torch.Tensor,  # [C, N]
    radii: torch.Tensor,  # [C, N]
    depths: torch.Tensor,  # [C, N]
    image_width: int,
    image_height: int,
    tile_size: int = 16,
):
    """Which (pixel, Gaussian) pairs contribute within a depth-rank window.

    Returns (contrib [C, H*W, R] bool, alpha [C, H*W, R], sel [C, R] the
    Gaussians of the window, new_transmittances [C, H*W]), dense like the
    JAX package's. Chain windows by passing ``new_transmittances`` as the
    next window's ``transmittances``: it is the fused kernel's termination
    stream (the product over all valid pairs, accepted or not), so chaining
    every window reproduces rasterize_to_pixels_ref.
    """
    device = common_device(transmittances, means2d, conics, opacities, radii, depths)
    sel, (means2d, conics, opacities, radii) = depth_rank_window(
        depths, range_start, range_end, means2d, conics, opacities, radii
    )
    px, py, ptx, pty = pixel_grid(image_width, image_height, tile_size, device)
    sigma = gauss_sigma(means2d, conics, px, py)
    alpha = torch.clamp_max(opacities[:, None, :] * torch.exp(-sigma), ALPHA_MAX)
    valid = valid_pairs(alpha, sigma, radii, means2d, ptx, pty, tile_size)
    contrib, new_T = window_contrib(valid, alpha, transmittances)
    return contrib, alpha, sel, new_T
