"""MCMC relocation math, Eq. 9 of "3D Gaussian Splatting as Markov Chain
Monte Carlo" (port of gsplat_tpu/relocation.py).

As in the JAX package, the double loop over (i, k) is one term table, a
product with the binomial table and a cumulative sum; plain torch, no
kernel. The product sums alternating-sign terms whose coefficients reach
C(50, 25) ~ 1.3e14, so it runs in float32 with TF32 off on the card.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ._backend import common_device, f32_matmul, resolve_device

N_MAX = 51


def make_binoms(n_max: int = N_MAX, device="cuda") -> torch.Tensor:
    """Binomial coefficient table [n_max, n_max] float32, C(n, k) at [n, k]
    (0 for k > n), on the card unless the caller asks for the CPU."""
    table = [[math.comb(n, k) if k <= n else 0 for k in range(n_max)] for n in range(n_max)]
    return torch.tensor(table, dtype=torch.float32, device=resolve_device(device))


def compute_relocation(
    opacities: torch.Tensor,  # [M] post-sigmoid
    scales: torch.Tensor,  # [M, 3] post-exp
    ratios: torch.Tensor,  # [M] int, number of samples landing on each Gaussian
    binoms: torch.Tensor,  # [n_max, n_max]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """New (opacity, scale) for a Gaussian replaced by `ratios` copies:

    new_opacity = 1 - (1 - o)^(1/n);
    new_scale = o / (sum_{i=1..n} sum_{k=0..i-1} C(i-1,k) (-1)^k
                     new_o^(k+1) / sqrt(k+1)) * scale,

    n clipped to [1, n_max]."""
    common_device(opacities, scales, ratios, binoms)
    n_max = binoms.shape[0]
    ratios = ratios.clamp(1, n_max).to(torch.int32)
    new_op = 1.0 - torch.pow(1.0 - opacities, 1.0 / ratios)

    k = torch.arange(n_max, dtype=torch.float32, device=opacities.device)
    sign = torch.where(torch.arange(n_max, device=opacities.device) % 2 == 0, 1.0, -1.0)
    term = sign / torch.sqrt(k + 1.0) * torch.pow(new_op[:, None], k[None, :] + 1.0)  # [M, n_max]
    inner = f32_matmul(term, binoms.T)  # inner[:, i-1] = sum_k C(i-1,k) term_k
    denom = torch.cumsum(inner, dim=1)  # denom[:, n-1] = sum_{i<=n} inner_{i-1}
    denom_n = torch.gather(denom, 1, (ratios - 1).long()[:, None])[:, 0]
    coeff = opacities / denom_n
    return new_op, coeff[:, None] * scales
