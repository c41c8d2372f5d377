"""MCMC densification strategy (port of gsplat_tpu/strategy/mcmc.py).

"3D Gaussian Splatting as Markov Chain Monte Carlo": every `refine_every`
steps the dead (low-opacity) Gaussians teleport onto samples of live ones
and the live count grows by 5% toward `cap_max`; every step the live
positions take opacity-gated anisotropic noise. The pool is the JAX
package's fixed-capacity pool with a ``live`` mask, updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch

from ..relocation import make_binoms
from . import ops
from .base import Strategy


def check_pool(cap: int) -> None:
    """Raise ValueError for a pool the MCMC sampler cannot draw from."""
    if cap > ops.MAX_SAMPLED_POOL:
        raise ValueError(
            f"an MCMC pool holds at most 2^24 = {ops.MAX_SAMPLED_POOL} slots (torch.multinomial's "
            f"limit on categories), got {cap}"
        )


@dataclass
class MCMCStrategy(Strategy):
    cap_max: int = 1_000_000
    noise_lr: float = 5e5
    refine_start_iter: int = 500
    refine_stop_iter: int = 25_000
    refine_every: int = 100
    min_opacity: float = 0.005

    def initialize_state(self, cap: int, scene_scale: float = 1.0, device="cuda") -> Dict[str, Any]:
        """The binomial table, on the card unless the caller asks for the
        CPU (``device="cpu"``). Refuses a pool of more than
        ``ops.MAX_SAMPLED_POOL`` slots, which the sampler cannot draw from."""
        check_pool(cap)
        return {"binoms": make_binoms(device=device)}

    @torch.no_grad()
    def refine(
        self,
        params: Dict[str, torch.Tensor],
        live: torch.Tensor,
        optimizers,
        state: Dict[str, Any],
        generator: Optional[torch.Generator] = None,
        targets: Optional[Sequence[torch.Tensor]] = None,
    ) -> None:
        """Relocate the dead Gaussians, then grow the live count to
        min(cap_max, cap, int(1.05 n_live)) (the product in float32, as the
        JAX package rounds it), in place. ``targets`` is (relocate's draws,
        sample_add's draws), [cap] each; by default from ``generator``."""
        binoms = state["binoms"]
        t_rel, t_add = (None, None) if targets is None else targets
        dead = live & (torch.sigmoid(params["opacities"]) <= self.min_opacity)
        ops.relocate(params, live, dead, binoms, optimizers, self.min_opacity, generator, t_rel)
        n_live = live.sum()
        cap_max = min(self.cap_max, live.shape[0])
        grown = (torch.tensor(1.05, dtype=torch.float32) * n_live.to(torch.float32)).to(n_live.dtype)
        n_add = torch.clamp_min(torch.clamp_max(grown, cap_max) - n_live, 0)
        ops.sample_add(params, live, n_add, binoms, optimizers, self.min_opacity, generator, t_add)

    def step_post_backward(
        self,
        params: Dict[str, torch.Tensor],
        live: torch.Tensor,
        optimizers,
        state: Dict[str, Any],
        step: int,
        lr: float,
        generator: Optional[torch.Generator] = None,
        targets: Optional[Sequence[torch.Tensor]] = None,
        noise: Union[torch.Tensor, Callable[[], torch.Tensor], None] = None,
        refine: Optional[Callable[..., None]] = None,
    ) -> bool:
        """Relocate and grow on the schedule (refine_start_iter < step <
        refine_stop_iter, step a multiple of refine_every), then inject
        position noise scaled by ``lr * noise_lr`` (``lr`` is the means'
        current learning rate; ``noise`` [cap, 3] its standard normal draw,
        or a function that draws it after the refine). ``refine`` takes
        `refine`'s arguments in its place (a distributed trainer runs it on
        the whole pool). Updates in place and returns whether this step
        refined."""
        refined = (
            self.refine_start_iter < step < self.refine_stop_iter
            and step % self.refine_every == 0
        )
        if refined:
            (refine or self.refine)(params, live, optimizers, state, generator, targets)
        if callable(noise):
            noise = noise()
        ops.inject_noise_to_position(params, live, lr * self.noise_lr, generator, noise)
        return refined
