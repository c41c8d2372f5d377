"""Gaussian-pool surgery on a fixed-capacity pool (port of
gsplat_tpu/strategy/ops.py).

The pool has a static capacity ``cap`` and a bool ``live`` mask, as in the
JAX package, so the port fills the same slots as the JAX package does:

  - duplicate: the k-th candidate is copied into the k-th free slot; the
    new slot's optimizer state is zeroed.
  - split: the candidate's slot is overwritten by child 1 and child 2 goes
    to a free slot, both sampled from the parent; optimizer state zeroed at
    both slots.
  - remove: live &= ~mask.
  - reset_opa: clamp live opacities, zero the opacities' optimizer state.
  - relocate / sample_add (MCMC): dead slots, or free ones, take the
    parameters of live Gaussians sampled in proportion to their opacity,
    after Eq. 9's new opacity and scale are written at the sampled
    targets; optimizer state zeroed at the targets and the destinations.
  - inject_noise_to_position (MCMC): opacity-gated anisotropic noise.

When the pool is short of free slots, the candidates with the highest
``priority`` win. ``params`` is a dict of tensors with leading dimension
``cap`` ("opacities" holds logits, "scales" logs), updated in place.
``optimizers`` maps a parameter's name to its optimizer; every tensor in
``optimizer.state[param]`` with leading dimension ``cap`` is per-Gaussian
state. ``state`` (the strategy's running statistics) is copied along with
the Gaussian. The random draws (the split's offsets, the MCMC targets and
noise) come from a ``generator`` unless the caller passes them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.projection import _covar_components, _sym_get, quat_to_rotmat
from ..relocation import compute_relocation


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


# torch.multinomial draws from at most 2^24 categories: the largest pool
# the MCMC ops sample (MCMCStrategy and the Runner refuse a larger one)
MAX_SAMPLED_POOL = 1 << 24


def _sample_targets(live, opacities_sig, cap, generator=None):
    """One draw per slot over the live slots, in proportion to their
    opacity (clipped at 1e-12): JAX's categorical over log-opacity logits,
    by torch.multinomial (so a pool of at most MAX_SAMPLED_POOL). With no live
    slot every draw is slot 0, as JAX's categorical gives over all -inf
    logits (torch.multinomial would raise on zero weights)."""
    w = torch.where(live, torch.clamp_min(opacities_sig, 1e-12), 0.0)
    none = torch.zeros_like(w)
    none[0] = 1.0
    w = torch.where(live.any(), w, none)
    return torch.multinomial(w, cap, replacement=True, generator=generator)


@torch.no_grad()
def _relocation_update(params, targets, used, binoms, min_opacity):
    """Write Eq. 9's new opacity and scale at the sampled targets, in place.
    `targets` [cap] are the draws, `used` [cap] marks the ones that are real.
    Returns (per-slot counts of the used draws, hit = counts > 0)."""
    cap = used.shape[0]
    counts = torch.zeros(cap, dtype=torch.int32, device=used.device)
    counts.scatter_add_(0, targets, used.to(torch.int32))
    op = params["opacities"]
    new_op, new_scales = compute_relocation(
        torch.sigmoid(op), torch.exp(params["scales"]), counts + 1, binoms
    )
    new_op = torch.clamp(new_op, min_opacity, 1.0 - 1e-7)
    hit = counts > 0
    op.copy_(torch.where(hit, torch.logit(new_op), op))
    params["scales"].copy_(torch.where(hit[:, None], torch.log(new_scales), params["scales"]))
    return counts, hit


@torch.no_grad()
def _move_sampled(params, live, optimizers, targets, dst, ok, binoms, min_opacity):
    """The relocation update at the targets, then slot dst[k] takes its
    target's (already updated) parameters where ok[k]; optimizer state
    zeroed at the hit targets and at the destinations. Returns the counts."""
    cap = live.shape[0]
    targets = targets.long()
    counts, hit = _relocation_update(params, targets, ok, binoms, min_opacity)
    for p in params.values():
        _copy_rows(p, targets, dst, ok)
    for x in _cap_tensors(optimizers, cap):
        x.copy_(torch.where(_expand(hit, x), 0.0, x))
        _zero_rows(x, dst, ok)
    return counts


@torch.no_grad()
def relocate(
    params: Dict[str, torch.Tensor],
    live: torch.Tensor,
    dead_mask: torch.Tensor,
    binoms: torch.Tensor,
    optimizers=None,
    min_opacity: float = 0.005,
    generator: Optional[torch.Generator] = None,
    targets: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Teleport dead Gaussians onto samples of the live ones, in place: the
    k-th dead slot takes the k-th draw. ``targets`` [cap] are the draws (by
    default from ``generator``, over the live slots that are not dead).
    Returns the number of draws that landed on each slot [cap]."""
    cap = live.shape[0]
    dead = dead_mask & live
    if targets is None:
        targets = _sample_targets(live & ~dead, torch.sigmoid(params["opacities"]), cap, generator)
    dst = torch.sort(torch.where(dead, 0, 1).to(torch.uint8), stable=True).indices
    ok = torch.arange(cap, device=live.device) < dead.sum()
    return _move_sampled(params, live, optimizers, targets, dst, ok, binoms, min_opacity)


@torch.no_grad()
def sample_add(
    params: Dict[str, torch.Tensor],
    live: torch.Tensor,
    n_add,
    binoms: torch.Tensor,
    optimizers=None,
    min_opacity: float = 0.005,
    generator: Optional[torch.Generator] = None,
    targets: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Activate ``n_add`` free slots (an int or a 0-d tensor) as samples of
    the live Gaussians, in place; ``targets`` [cap] are the draws (by
    default from ``generator``). Returns the per-slot counts of the draws."""
    cap = live.shape[0]
    if targets is None:
        targets = _sample_targets(live, torch.sigmoid(params["opacities"]), cap, generator)
    dst = torch.sort(live.to(torch.uint8), stable=True).indices  # free slots first
    k = torch.arange(cap, device=live.device)
    ok = (k < n_add) & (k < (~live).sum())
    counts = _move_sampled(params, live, optimizers, targets, dst, ok, binoms, min_opacity)
    live[dst] = live[dst] | ok
    return counts


@torch.no_grad()
def inject_noise_to_position(
    params: Dict[str, torch.Tensor],
    live: torch.Tensor,
    scaler: float,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> None:
    """Perturb the live means with opacity-gated anisotropic noise, in
    place: covar @ z, gated by 1 / (1 + exp(-100 (1 - opacity - 0.995))) and
    scaled by ``scaler`` (the means' learning rate times noise_lr). ``noise``
    [cap, 3] is the standard normal draw z (by default from ``generator``)."""
    means = params["means"]
    op_sig = torch.sigmoid(params["opacities"])
    scales = torch.exp(params["scales"])

    def op_gate(x, k=100.0, x0=0.995):
        return 1.0 / (1.0 + torch.exp(-k * (x - x0)))

    cov = _covar_components(params["quats"], scales)  # 6 symmetric [cap] components
    if noise is None:
        noise = torch.randn(means.shape, generator=generator, device=means.device, dtype=means.dtype)
    gate = op_gate(1.0 - op_sig) * scaler  # [cap]
    zc = [noise[:, j] * gate for j in range(3)]
    step = torch.stack([sum(_sym_get(cov, i, j) * zc[j] for j in range(3)) for i in range(3)], dim=-1)
    means.add_(torch.where(live[:, None], step, 0.0))
