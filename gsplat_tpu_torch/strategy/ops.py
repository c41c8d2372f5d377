"""Gaussian-pool surgery on a fixed-capacity pool (port of the
duplicate/split/remove/reset parts of gsplat_tpu/strategy/ops.py).

The pool has a static capacity ``cap`` and a bool ``live`` mask, as in the
JAX package, so the port fills the same slots as the JAX package does:

  - duplicate: the k-th candidate is copied into the k-th free slot; the
    new slot's optimizer state is zeroed.
  - split: the candidate's slot is overwritten by child 1 and child 2 goes
    to a free slot, both sampled from the parent; optimizer state zeroed at
    both slots.
  - remove: live &= ~mask.
  - reset_opa: clamp live opacities, zero the opacities' optimizer state.

When the pool is short of free slots, the candidates with the highest
``priority`` win. ``params`` is a dict of tensors with leading dimension
``cap`` ("opacities" holds logits, "scales" logs), updated in place.
``optimizers`` maps a parameter's name to its optimizer; every tensor in
``optimizer.state[param]`` with leading dimension ``cap`` is per-Gaussian
state. ``state`` (the strategy's running statistics) is copied along with
the Gaussian. The MCMC operations come with the port's MCMC slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.projection import quat_to_rotmat


def _expand(ok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return ok.reshape(ok.shape + (1,) * (x.dim() - 1))


def _cap_tensors(tree, cap: int):
    """Every tensor of a dict (or of each optimizer's state) with leading
    dimension ``cap``."""
    if tree is None:
        return []
    out = []
    for v in tree.values():
        if isinstance(v, torch.optim.Optimizer):
            for st in v.state.values():
                out += _cap_tensors(st, cap)
        elif isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == cap:
            out.append(v)
    return out


def pair_free_slots(
    live: torch.Tensor, cand: torch.Tensor, priority: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pair the k-th candidate with the k-th free slot.

    Returns (src [cap] candidate indices first, dst [cap] free slots first,
    ok [cap] bool marking the pairs that are in range). When the pool is
    short of free slots, the candidates with the highest `priority` win.
    """
    cap = live.shape[0]
    if priority is None:
        key = torch.where(cand, 0, 1)
    else:
        key = torch.where(cand, -priority, torch.inf)
    src = torch.sort(key, stable=True).indices
    dst = torch.sort(live.to(torch.uint8), stable=True).indices  # free slots first
    k = torch.arange(cap, device=live.device)
    ok = (k < cand.sum()) & (k < (~live).sum())
    return src, dst, ok


@torch.no_grad()
def _copy_rows(x: torch.Tensor, src, dst, ok, values=None) -> None:
    """x[dst] <- values[src] (or x[src]) where ok, in place."""
    v = x if values is None else values
    x[dst] = torch.where(_expand(ok, x), v[src], x[dst])


@torch.no_grad()
def _zero_rows(x: torch.Tensor, dst, ok) -> None:
    x[dst] = torch.where(_expand(ok, x), 0.0, x[dst])


@torch.no_grad()
def duplicate(
    params: Dict[str, torch.Tensor],
    live: torch.Tensor,
    mask: torch.Tensor,
    optimizers=None,
    state=None,
    priority: Optional[torch.Tensor] = None,
) -> None:
    """Copy masked Gaussians into free slots, in place."""
    cap = live.shape[0]
    src, dst, ok = pair_free_slots(live, mask, priority)
    for p in params.values():
        _copy_rows(p, src, dst, ok)
    live[dst] = live[dst] | ok
    for x in _cap_tensors(optimizers, cap):
        _zero_rows(x, dst, ok)
    for x in _cap_tensors(state, cap):
        _copy_rows(x, src, dst, ok)


@torch.no_grad()
def split(
    params: Dict[str, torch.Tensor],
    live: torch.Tensor,
    mask: torch.Tensor,
    optimizers=None,
    state=None,
    revised_opacity: bool = False,
    priority: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> None:
    """Split masked Gaussians into two children sampled from the parent, in
    place: child 1 overwrites the parent's slot, child 2 takes a free slot;
    scales shrink by 1.6; optimizer state is zeroed at both slots.
    ``noise`` [2, cap, 3] is the standard normal draw of the two children's
    offsets; by default it is drawn from ``generator``."""
    cap = live.shape[0]
    means = params["means"]
    scales = torch.exp(params["scales"])  # [cap, 3]
    rot = quat_to_rotmat(params["quats"])  # [cap, 3, 3]
    if noise is None:
        noise = torch.randn((2, cap, 3), generator=generator, device=means.device, dtype=means.dtype)
    samples = torch.einsum("nij,nj,bnj->bni", rot, scales, noise)  # [2, cap, 3]

    child = dict(params)
    child["scales"] = torch.log(scales / 1.6)
    if revised_opacity and "opacities" in params:
        new_op = 1.0 - torch.sqrt(torch.clamp_min(1.0 - torch.sigmoid(params["opacities"]), 1e-12))
        child["opacities"] = torch.logit(torch.clamp(new_op, 1e-7, 1 - 1e-7))
    child2 = dict(child)
    child2["means"] = means + samples[1]
    child1 = {name: v.clone() for name, v in child.items()}

    src, dst, ok = pair_free_slots(live, mask, priority)
    # child 2 -> free slots; only the pairs that fit (`ok`) split
    for name, p in params.items():
        _copy_rows(p, src, dst, ok, values=child2[name])
    live[dst] = live[dst] | ok
    child1["means"] = means + samples[0]
    # child 1 overwrites the parent's slot, for parents that got a child 2
    did = torch.zeros(cap, dtype=torch.bool, device=live.device)
    did[src] = ok
    for name, p in params.items():
        p.copy_(torch.where(_expand(did, p), child1[name], p))

    for x in _cap_tensors(optimizers, cap):
        _zero_rows(x, dst, ok)
        x.copy_(torch.where(_expand(did, x), 0.0, x))
    for x in _cap_tensors(state, cap):
        _copy_rows(x, src, dst, ok)


@torch.no_grad()
def remove(live: torch.Tensor, mask: torch.Tensor) -> None:
    """Free masked slots, in place; their stale values are overwritten (and
    their optimizer state zeroed) when a slot is reused."""
    live &= ~mask


@torch.no_grad()
def reset_opa(
    params: Dict[str, torch.Tensor],
    live: torch.Tensor,
    value: float,
    optimizers=None,
) -> None:
    """Clamp live opacities to logit(value) and zero the opacities'
    optimizer state, in place."""
    cap = live.shape[0]
    op = params["opacities"]
    limit = torch.logit(torch.tensor(value, dtype=op.dtype, device=op.device))
    op.copy_(torch.where(live, torch.minimum(op, limit), op))
    if optimizers is not None and "opacities" in optimizers:
        for x in _cap_tensors({"opacities": optimizers["opacities"]}, cap):
            x.zero_()
