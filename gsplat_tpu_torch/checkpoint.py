"""Trained splats from the JAX trainer's checkpoint layout into torch tensors.

The JAX trainer (examples/simple_trainer.py, ``Runner.save``) writes
``splat/means|quats|scales|opacities|sh0|shN`` plus the ``live`` pool mask
to an ``.npz``; the viewer (examples/simple_viewer.py) also takes the same
arrays without the ``splat/`` prefix. Values are carried across unchanged:
scales stay log-scales and opacities stay logits, so a render applies
``exp``, ``sigmoid`` and ``cat(sh0, shN)`` exactly as the JAX trainer's
``Runner.render`` does. A trainer run with appearance optimisation holds
``colors`` (logits) and ``features`` in place of ``sh0`` / ``shN``.

``aux_modules_from_numpy`` builds the port's pose, appearance and
bilateral-grid modules from the JAX trainer's ``aux_params`` dicts.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ._backend import resolve_device

SPLAT_KEYS = ("means", "quats", "scales", "opacities", "sh0", "shN")
APPEARANCE_KEYS = ("means", "quats", "scales", "opacities", "colors", "features")


def splats_from_numpy(
    arrays: Mapping[str, np.ndarray], device="cuda"
) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """Returns ``(splats, live)``: a dict of float32 tensors keyed by
    ``SPLAT_KEYS`` (by ``APPEARANCE_KEYS`` where the mapping holds
    ``colors``) on ``device``, and the bool ``live`` mask [N] (None if the
    mapping has none). ``shN`` may be absent (degree-0 splats): it is then
    an empty [N, 0, 3] tensor. Raises without a CUDA device unless
    ``device`` says otherwise."""
    device = resolve_device(device)
    appearance = "splat/colors" in arrays or "colors" in arrays
    splats = {}
    for key in APPEARANCE_KEYS if appearance else SPLAT_KEYS:
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


def aux_modules_from_numpy(
    aux_params: Mapping[str, Mapping[str, np.ndarray]], feature_dim: Optional[int] = None, device="cuda"
) -> Dict[str, torch.nn.Module]:
    """The port's modules holding the JAX trainer's ``aux_params``:
    ``"pose"`` -> ``CameraOptModule``, ``"app"`` -> ``AppearanceOptModule``
    (``feature_dim``, the splats' feature width, is then required),
    ``"bilagrid"`` -> ``BilateralGrid``; other keys raise."""
    from .bilagrid import BilateralGrid
    from .modules import AppearanceOptModule, CameraOptModule

    out = {}
    for name, params in aux_params.items():
        if name == "pose":
            out[name] = CameraOptModule.from_numpy(params, device=device)
        elif name == "app":
            if feature_dim is None:
                raise ValueError("the appearance module needs feature_dim")
            out[name] = AppearanceOptModule.from_numpy(params, feature_dim, device=device)
        elif name == "bilagrid":
            out[name] = BilateralGrid.from_numpy(params, device=device)
        else:
            raise KeyError(f"no port module for aux_params[{name!r}]")
    return out
