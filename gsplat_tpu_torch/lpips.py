"""LPIPS metric (Zhang et al. 2018) in PyTorch (port of gsplat_tpu/lpips.py).

The same architecture, weights layout, input scaling and taps as the JAX
package, whose metric follows torchmetrics'
``LearnedPerceptualImagePatchSimilarity``: AlexNet or VGG16 features at 5
taps (after a ReLU each), per-channel unit normalisation, learned 1x1
"lin" weights, a spatial mean, the sum over the taps and the mean over the
batch. No pretrained weights ship with the repository; they come from a
user's file:

  - ``.npz`` with the keys ``conv{i}_w``, ``conv{i}_b``, ``lin{i}_w``
    (`convert_torch_state_dict` makes the arrays from a state dict), or
  - a torch checkpoint (``.pt`` / ``.pth``) holding a
    richzhang/PerceptualSimilarity- or torchmetrics-style state dict.

`init_random_params` draws the JAX package's random weights (numpy, the
same seed gives the same arrays in both packages) for tests.

Parameters are ``{"convs": [(w, b), ...], "lins": [w, ...]}`` of float32
tensors (w [out, in, k, k], lins [1, C, 1, 1]). The convolutions
(``F.conv2d``, ``F.max_pool2d``: ``lax.conv_general_dilated`` and
``reduce_window`` in the JAX package) run on the device of the images,
with cuDNN's TF32 off, as the SSIM filter of losses.py runs.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ._backend import resolve_device

# published LPIPS input scaling constants (richzhang/PerceptualSimilarity)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# (out_ch, kernel, stride, pad) per conv; taps = indices after whose ReLU a
# feature is taken; pools = conv indices preceded by 3x3/2 max-pool (alex)
# or 2x2/2 max-pool (vgg)
_ALEX = dict(
    convs=[(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)],
    pools_before=[1, 2],
    pool_size=3,
    taps=[0, 1, 2, 3, 4],
)
_VGG = dict(
    convs=[(64, 3, 1, 1), (64, 3, 1, 1),
           (128, 3, 1, 1), (128, 3, 1, 1),
           (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1),
           (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1),
           (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1)],
    pools_before=[2, 4, 7, 10],
    pool_size=2,
    taps=[1, 3, 6, 9, 12],
)


def _net_cfg(net_type: str):
    if net_type == "alex":
        return _ALEX
    if net_type == "vgg":
        return _VGG
    raise ValueError(f"Unknown LPIPS net_type: {net_type}")


def _params(convs, lins, device) -> Dict:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {"convs": [(t(w), t(b)) for w, b in convs], "lins": [t(w) for w in lins]}


def init_random_params(net_type: str = "alex", seed: int = 0, device="cuda") -> Dict:
    """Random weights (for tests and architecture checks): the JAX
    package's draws from ``np.random.default_rng(seed)``, on ``device``."""
    cfg = _net_cfg(net_type)
    rng = np.random.default_rng(seed)
    convs, lins = [], []
    cin = 3
    for cout, k, _, _ in cfg["convs"]:
        w = rng.standard_normal((cout, cin, k, k)).astype(np.float32) * 0.05
        convs.append((w, np.zeros((cout,), np.float32)))
        cin = cout
    for t in cfg["taps"]:
        cout = cfg["convs"][t][0]
        lins.append(np.abs(rng.standard_normal((1, cout, 1, 1))).astype(np.float32))
    return _params(convs, lins, resolve_device(device))


@contextlib.contextmanager
def _no_tf32_conv():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _features(params, x, cfg):
    """x: [B, 3, H, W] already shifted and scaled. Returns the taps."""
    pool = cfg["pool_size"]
    feats = []
    h = x
    for i, (w, b) in enumerate(params["convs"]):
        if i in cfg["pools_before"]:
            h = F.max_pool2d(h, pool, 2)
        _, _, s, p = cfg["convs"][i]
        h = torch.relu(F.conv2d(h, w, b, stride=s, padding=p))
        if i in cfg["taps"]:
            feats.append(h)
    return feats


def lpips(
    params: Dict,
    img0: torch.Tensor,  # [B, H, W, 3]
    img1: torch.Tensor,  # [B, H, W, 3]
    net_type: str = "alex",
    normalize: bool = True,
) -> torch.Tensor:
    """LPIPS distance, the mean over the batch (torchmetrics semantics);
    ``normalize`` maps [0, 1] inputs to [-1, 1] first."""
    cfg = _net_cfg(net_type)
    if normalize:
        img0 = img0 * 2.0 - 1.0
        img1 = img1 * 2.0 - 1.0
    shift = torch.as_tensor(_SHIFT, device=img0.device).reshape(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=img0.device).reshape(1, 3, 1, 1)

    def prep(x):
        return (x.permute(0, 3, 1, 2) - shift) / scale

    with _no_tf32_conv():
        f0 = _features(params, prep(img0), cfg)
        f1 = _features(params, prep(img1), cfg)
    total = 0.0
    for a, b, lin in zip(f0, f1, params["lins"]):
        na = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
        nb = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
        d = (na - nb) ** 2  # [B, C, H, W]
        # the learned 1x1 conv is a channel-weighted sum; then the spatial mean
        wd = torch.sum(d * lin[0, :, 0, 0][None, :, None, None], dim=1)
        total = total + torch.mean(wd, dim=(1, 2))
    return torch.mean(total)


def convert_torch_state_dict(sd, net_type: str = "alex", device="cuda") -> Dict:
    """A richzhang / torchmetrics LPIPS state dict (arrays or tensors) as
    parameters on ``device``.

    Accepts the key styles ``net.slice{k}.{i}.weight`` (torchmetrics /
    richzhang) or ``net.features.{i}.weight``, and ``lin{k}.model.1.weight``
    / ``lins.{k}.model.1.weight``.
    """
    cfg = _net_cfg(net_type)
    keys = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v) for k, v in sd.items()}

    def order_key(kv):
        return [int(s) for s in kv[0].replace(".", " ").split() if s.isdigit()]

    # conv weights appear in layer order in both torchvision (.features.N)
    # and slice-style dicts; collect (weight, bias) pairs in order
    conv_ws = [(k, v) for k, v in keys.items()
               if k.endswith(".weight") and getattr(v, "ndim", 0) == 4 and "lin" not in k]
    conv_ws.sort(key=order_key)
    conv_bs = {k[: -len(".bias")]: v for k, v in keys.items() if k.endswith(".bias")}
    if len(conv_ws) != len(cfg["convs"]):
        raise ValueError(f"state dict has {len(conv_ws)} convs, expected {len(cfg['convs'])}")
    convs = []
    for k, w in conv_ws:
        b = conv_bs.get(k[: -len(".weight")])
        convs.append((w, np.zeros((w.shape[0],), np.float32) if b is None else b))
    lin_ws = [(k, v) for k, v in keys.items() if "lin" in k and k.endswith("weight") and getattr(v, "ndim", 0) == 4]
    lin_ws.sort(key=order_key)
    if len(lin_ws) != len(cfg["taps"]):
        raise ValueError(f"state dict has {len(lin_ws)} lin layers, expected {len(cfg['taps'])}")
    return _params(convs, [w for _, w in lin_ws], resolve_device(device))


def load_lpips_params(path: str, net_type: str = "alex", device="cuda") -> Optional[Dict]:
    """LPIPS weights from an ``.npz`` (the keys above) or a torch
    checkpoint, on ``device``. Returns None if the file does not exist."""
    if not path or not os.path.exists(path):
        return None
    device = resolve_device(device)
    if path.endswith(".npz"):
        data = np.load(path)
        cfg = _net_cfg(net_type)
        convs = [(data[f"conv{i}_w"], data[f"conv{i}_b"]) for i in range(len(cfg["convs"]))]
        lins = [data[f"lin{i}_w"] for i in range(len(cfg["taps"]))]
        return _params(convs, lins, device)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_torch_state_dict(sd, net_type, device)
