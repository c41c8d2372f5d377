"""Visibility-masked Adam (port of gsplat_tpu/optimizers/selective_adam.py).

Adam whose update, moments included, is skipped for the rows of a
Gaussian that no camera of the step sees. The JAX package writes it as one
``jnp.where`` around an Adam update and has no kernel for it; here it is
plain torch in the same form, as a ``torch.optim.Optimizer`` with the
reference gsplat's ``step(visibility)``.
"""

from __future__ import annotations

from typing import Optional

import torch


class SelectiveAdam(torch.optim.Optimizer):
    """Adam gated per Gaussian by a visibility mask.

    ``lr`` is a float or a callable of the step count; the count is
    incremented before the update, so the first step reads ``lr(1)`` and
    bias-corrects with count 1. ``step(visibility)`` takes a [cap] bool
    mask broadcast over each parameter's trailing dimensions: invisible rows
    keep their values and their moments. With ``visibility=None`` it is
    plain Adam. ``state[p]`` holds ``step`` (an int) and the moments
    ``exp_avg``/``exp_avg_sq`` (the tensors that pool surgery zeroes per
    row).
    """

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, visibility: Optional[torch.Tensor] = None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps = group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                count = state["step"]
                lr = group["lr"](count) if callable(group["lr"]) else group["lr"]
                c = torch.tensor(float(count), dtype=torch.float32, device=p.device)
                bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=p.device) ** c
                bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=p.device) ** c
                mu, nu = state["exp_avg"], state["exp_avg_sq"]
                new_mu = b1 * mu + (1 - b1) * g
                new_nu = b2 * nu + (1 - b2) * g * g
                upd = -lr * (new_mu / bc1) / (torch.sqrt(new_nu / bc2) + eps)
                if visibility is not None:
                    v = visibility.reshape(visibility.shape + (1,) * (p.dim() - 1))
                    new_mu = torch.where(v, new_mu, mu)
                    new_nu = torch.where(v, new_nu, nu)
                    upd = torch.where(v, upd, 0.0)
                mu.copy_(new_mu)
                nu.copy_(new_nu)
                p.add_(upd)
