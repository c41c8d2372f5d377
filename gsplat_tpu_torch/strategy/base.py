"""Strategy interface (port of gsplat_tpu/strategy/base.py).

A strategy controls densification of the Gaussian pool during training.
As in the JAX package the pool has a fixed capacity and a ``live`` mask;
the port's hooks update the parameters, the mask, the optimizers' state
and the strategy's own state in place (under ``torch.no_grad()``), the
PyTorch idiom of the reference gsplat.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch


@dataclass
class Strategy:
    """Base densification strategy."""

    def check_sanity(self, params: Dict[str, torch.Tensor], live: torch.Tensor):
        for key in ["means", "scales", "quats", "opacities"]:
            if key not in params:
                raise KeyError(f"{key} is required in params but missing.")
        cap = live.shape[0]
        for k, v in params.items():
            if v.shape[0] != cap:
                raise ValueError(f"param {k} has {v.shape[0]} rows, the pool {cap}")

    def initialize_state(self, cap: int, scene_scale: float = 1.0, device="cuda") -> Dict[str, Any]:
        """The strategy's running state for a `cap`-slot pool, on the card
        unless the caller asks for the CPU (``device="cpu"``)."""
        raise NotImplementedError

    def step_pre_backward(self, *args, **kwargs):
        """No-op: the screen-space gradients come from the
        ``means2d_carrier`` argument of ``rasterization``."""

    def step_post_backward(self, *args, **kwargs):
        raise NotImplementedError
