"""Spherical-harmonics colour evaluation, degrees 0-4, in plain PyTorch
(port of gsplat_tpu/ops/sh.py).

Elementwise basis polynomials and a small per-Gaussian contraction; the JAX
package left them to XLA's fusion, so there is no kernel here. Basis
constants follow "Efficient Spherical Harmonic Evaluation", Sloan, JCGT
2013.
"""

from __future__ import annotations

from typing import Optional

import torch


def eval_sh_bases(basis_dim: int, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate the first `basis_dim` real SH bases at unit directions.

    Args:
        basis_dim: number of bases; one of {1, 4, 9, 16, 25}.
        dirs: [..., 3] unit directions.

    Returns:
        [..., basis_dim] basis values.
    """
    out = [torch.full(dirs.shape[:-1], 0.2820947917738781, dtype=dirs.dtype, device=dirs.device)]
    if basis_dim <= 1:
        return torch.stack(out, dim=-1)

    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]

    fTmpA = -0.48860251190292
    out += [fTmpA * y, -fTmpA * z, fTmpA * x]
    if basis_dim <= 4:
        return torch.stack(out, dim=-1)

    z2 = z * z
    fTmpB = -1.092548430592079 * z
    fTmpA = 0.5462742152960395
    fC1 = x * x - y * y
    fS1 = 2 * x * y
    out += [
        fTmpA * fS1,
        fTmpB * y,
        0.9461746957575601 * z2 - 0.3153915652525201,
        fTmpB * x,
        fTmpA * fC1,
    ]
    if basis_dim <= 9:
        return torch.stack(out, dim=-1)

    fTmpC = -2.285228997322329 * z2 + 0.4570457994644658
    fTmpB = 1.445305721320277 * z
    fTmpA = -0.5900435899266435
    fC2 = x * fC1 - y * fS1
    fS2 = x * fS1 + y * fC1
    out += [
        fTmpA * fS2,
        fTmpB * fS1,
        fTmpC * y,
        z * (1.865881662950577 * z2 - 1.119528997770346),
        fTmpC * x,
        fTmpB * fC1,
        fTmpA * fC2,
    ]
    if basis_dim <= 16:
        return torch.stack(out, dim=-1)

    fTmpD = z * (-4.683325804901025 * z2 + 2.007139630671868)
    fTmpC = 3.31161143515146 * z2 - 0.47308734787878
    fTmpB = -1.770130769779931 * z
    fTmpA = 0.6258357354491763
    fC3 = x * fC2 - y * fS2
    fS3 = x * fS2 + y * fC2
    out += [
        fTmpA * fS3,
        fTmpB * fS2,
        fTmpC * fS1,
        fTmpD * y,
        1.984313483298443 * z2 * (1.865881662950577 * z2 - 1.119528997770346)
        + -1.006230589874905 * (0.9461746957575601 * z2 - 0.3153915652525201),
        fTmpD * x,
        fTmpC * fC1,
        fTmpB * fC2,
        fTmpA * fC3,
    ]
    return torch.stack(out, dim=-1)


def spherical_harmonics(
    degree: int,
    dirs: torch.Tensor,  # [..., 3]
    coeffs: torch.Tensor,  # [..., K, 3]
    masks: Optional[torch.Tensor] = None,  # [...]
) -> torch.Tensor:
    """SH coefficients -> RGB colour for view directions.

    `degree` uses the first (degree+1)^2 of the K available bases; the rest
    are ignored.
    """
    num_bases = (degree + 1) ** 2
    if coeffs.shape[-1] != 3 or coeffs.shape[-2] < num_bases:
        raise ValueError(
            f"coeffs {tuple(coeffs.shape)} must be [..., K >= {num_bases}, 3]"
        )
    norm = torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
    dirs = dirs / norm
    bases = eval_sh_bases(num_bases, dirs)  # [..., num_bases]
    colors = (bases[..., None] * coeffs[..., :num_bases, :]).sum(dim=-2)
    if masks is not None:
        colors = torch.where(masks[..., None], colors, 0.0)
    return colors
