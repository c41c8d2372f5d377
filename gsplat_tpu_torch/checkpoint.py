"""Trained splats from the JAX trainer's checkpoint layout into torch tensors.

The JAX trainer (examples/simple_trainer.py, ``Runner.save``) writes
``splat/means|quats|scales|opacities|sh0|shN`` plus the ``live`` pool mask
to an ``.npz``; the viewer (examples/simple_viewer.py) also takes the same
arrays without the ``splat/`` prefix. Values are carried across unchanged:
scales stay log-scales and opacities stay logits, so a render applies
``exp``, ``sigmoid`` and ``cat(sh0, shN)`` exactly as the JAX trainer's
``Runner.render`` does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ._backend import resolve_device

SPLAT_KEYS = ("means", "quats", "scales", "opacities", "sh0", "shN")


def splats_from_numpy(
    arrays: Mapping[str, np.ndarray], device="cuda"
) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """Returns ``(splats, live)``: a dict of float32 tensors keyed by
    ``SPLAT_KEYS`` on ``device``, and the bool ``live`` mask [N] (None if
    the mapping has none). ``shN`` may be absent (degree-0 splats): it is
    then an empty [N, 0, 3] tensor. Raises without a CUDA device unless
    ``device`` says otherwise."""
    device = resolve_device(device)
    splats = {}
    for key in SPLAT_KEYS:
        if f"splat/{key}" in arrays:
            value = arrays[f"splat/{key}"]
        elif key in arrays:
            value = arrays[key]
        elif key == "shN":
            value = np.zeros((len(splats["means"]), 0, 3), np.float32)
        else:
            raise KeyError(f"checkpoint has neither 'splat/{key}' nor '{key}'")
        splats[key] = torch.as_tensor(
            np.asarray(value, dtype=np.float32), device=device
        )
    live = None
    if "live" in arrays:
        live = torch.as_tensor(np.asarray(arrays["live"], dtype=bool), device=device)
    return splats, live
