"""3DGS-paper densification strategy (port of gsplat_tpu/strategy/default.py).

Thresholds, grow (duplicate + split), prune and opacity reset follow the
JAX package on the same fixed-capacity pool (see strategy/ops.py), so both
packages fill the same slots. The screen-space gradients arrive as the
gradient of ``rasterization``'s ``means2d_carrier``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from .._backend import resolve_device
from . import ops
from .base import Strategy


@dataclass
class DefaultStrategy(Strategy):
    prune_opa: float = 0.005
    grow_grad2d: float = 0.0002
    grow_scale3d: float = 0.01
    grow_scale2d: float = 0.05
    prune_scale3d: float = 0.1
    prune_scale2d: float = 0.15
    refine_scale2d_stop_iter: int = 0
    refine_start_iter: int = 500
    refine_stop_iter: int = 15_000
    reset_every: int = 3000
    refine_every: int = 100
    pause_refine_after_reset: int = 0
    absgrad: bool = False
    revised_opacity: bool = False

    def initialize_state(self, cap: int, scene_scale: float = 1.0, device="cuda") -> Dict[str, Any]:
        device = resolve_device(device)
        state = {
            "grad2d": torch.zeros(cap, dtype=torch.float32, device=device),
            "count": torch.zeros(cap, dtype=torch.float32, device=device),
            "scene_scale": scene_scale,
        }
        if self.refine_scale2d_stop_iter > 0:
            state["radii"] = torch.zeros(cap, dtype=torch.float32, device=device)
        return state

    @torch.no_grad()
    def update_state(
        self,
        state: Dict[str, Any],
        meta: Dict[str, Any],
        v_means2d: torch.Tensor,  # [C, N, 2] gradient w.r.t. the projected means
    ) -> None:
        """Accumulate screen-space gradient statistics, in place.
        ``v_means2d`` is the loss gradient w.r.t. ``means2d_carrier`` (its
        per-tile |gradient| sum in absgrad mode)."""
        scale = torch.tensor(
            [meta["width"] / 2.0, meta["height"] / 2.0], dtype=torch.float32, device=v_means2d.device
        )
        grads = v_means2d * scale * meta["n_cameras"]
        sel = meta["radii"] > 0  # [C, N]
        norm = torch.linalg.norm(grads, dim=-1)  # [C, N]
        state["grad2d"] += torch.where(sel, norm, 0.0).sum(dim=0)
        state["count"] += sel.sum(dim=0).to(torch.float32)
        if "radii" in state:
            r = torch.where(sel, meta["radii"], 0).amax(dim=0) / float(max(meta["width"], meta["height"]))
            torch.maximum(state["radii"], r, out=state["radii"])

    @torch.no_grad()
    def refine(
        self,
        params: Dict[str, torch.Tensor],
        live: torch.Tensor,
        optimizers,
        state: Dict[str, Any],
        step: int,
        generator: Optional[torch.Generator] = None,
        split_noise: Optional[torch.Tensor] = None,
    ) -> None:
        """Grow (duplicate + split) then prune, in place. ``split_noise``
        [2, cap, 3] is the split's standard normal draw (by default from
        ``generator``)."""
        use_scale2d = step < self.refine_scale2d_stop_iter
        prune_too_big = step > self.reset_every
        grads = state["grad2d"] / torch.clamp_min(state["count"], 1.0)
        is_grad_high = (grads > self.grow_grad2d) & live
        is_small = (
            torch.exp(params["scales"]).amax(dim=-1)
            <= self.grow_scale3d * state["scene_scale"]
        )
        is_dupli = is_grad_high & is_small
        is_split = is_grad_high & ~is_small
        if use_scale2d and "radii" in state:
            is_split = is_split | (live & (state["radii"] > self.grow_scale2d))

        ops.duplicate(params, live, is_dupli, optimizers, state, priority=grads)
        ops.split(
            params, live, is_split, optimizers, state,
            revised_opacity=self.revised_opacity, priority=grads,
            noise=split_noise, generator=generator,
        )

        is_prune = live & (torch.sigmoid(params["opacities"]) < self.prune_opa)
        if prune_too_big:
            is_too_big = (
                torch.exp(params["scales"]).amax(dim=-1)
                > self.prune_scale3d * state["scene_scale"]
            )
            if use_scale2d and "radii" in state:
                is_too_big = is_too_big | (state["radii"] > self.prune_scale2d)
            is_prune = is_prune | (live & is_too_big)
        ops.remove(live, is_prune)

        state["grad2d"].zero_()
        state["count"].zero_()
        if "radii" in state:
            state["radii"].zero_()

    def step_post_backward(
        self,
        params: Dict[str, torch.Tensor],
        live: torch.Tensor,
        optimizers,
        state: Dict[str, Any],
        step: int,
        meta: Dict[str, Any],
        v_means2d: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        split_noise: Optional[torch.Tensor] = None,
        refine: Optional[Callable[..., None]] = None,
    ) -> bool:
        """Accumulate statistics every step; refine and reset the opacities
        on the schedule; nothing at or past ``refine_stop_iter``. Updates in
        place and returns whether this step refined. ``refine`` takes
        `refine`'s arguments in its place (a distributed trainer runs it on
        the whole pool)."""
        if step >= self.refine_stop_iter:
            return False
        self.update_state(state, meta, v_means2d)
        refined = (
            self.refine_start_iter < step
            and step % self.refine_every == 0
            and step % self.reset_every >= self.pause_refine_after_reset
        )
        if refined:
            (refine or self.refine)(params, live, optimizers, state, step, generator, split_noise)
        if step % self.reset_every == 0:
            ops.reset_opa(params, live, 2.0 * self.prune_opa, optimizers)
        return refined
