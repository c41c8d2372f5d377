"""Training losses and image metrics in plain PyTorch (port of
gsplat_tpu/losses.py).

SSIM is the standard 11x11 Gaussian-window formulation; the window is
the outer product of a 1D Gaussian, so each filter is a column pass and a
row pass of 11-tap depthwise convolutions (`F.conv2d` with ``groups=C``,
VALID). The JAX package left its convolution to XLA, so there is no kernel
here. Images are NHWC ([B, H, W, C]) as in the JAX package. SSIM's
variance terms (E[x^2] - mu^2) cancel, so the filter's rounding shows in
the gradient: with one 11x11 convolution (oneDNN's on the CPU) a training
step's gradients lay several times farther from a float64 evaluation than
the JAX package's, with the two passes as close
(tests/test_torch_trainer_colmap.py::test_step0_moments_float64_witness).
On the card a float32 convolution goes through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return g.astype(np.float32)


def _filter2d(img: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D filter by the window outer(g, g), VALID: a column pass
    then a row pass. img [B, H, W, C], g [k]."""
    C = img.shape[-1]
    k = g.shape[0]
    out = F.conv2d(img.permute(0, 3, 1, 2), g.reshape(1, 1, k, 1).expand(C, 1, k, 1), groups=C)
    out = F.conv2d(out, g.reshape(1, 1, 1, k).expand(C, 1, 1, k), groups=C)
    return out.permute(0, 2, 3, 1)


def ssim(
    img0: torch.Tensor,  # [B, H, W, C] in [0, 1]
    img1: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    data_range: float = 1.0,
) -> torch.Tensor:
    """Mean SSIM over the batch (standard Gaussian-window formulation)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    window = torch.as_tensor(_gaussian_1d(window_size, sigma), device=img0.device, dtype=img0.dtype)

    mu0 = _filter2d(img0, window)
    mu1 = _filter2d(img1, window)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = _filter2d(img0 * img0, window) - mu00
    s11 = _filter2d(img1 * img1, window) - mu11
    s01 = _filter2d(img0 * img1, window) - mu01

    ssim_map = ((2 * mu01 + c1) * (2 * s01 + c2)) / (
        (mu00 + mu11 + c1) * (s00 + s11 + c2)
    )
    return ssim_map.mean()


def psnr(img0: torch.Tensor, img1: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = ((img0 - img1) ** 2).mean()
    return 10.0 * torch.log10(data_range**2 / torch.clamp_min(mse, 1e-12))


def l1(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    return (img0 - img1).abs().mean()


def train_loss(
    render: torch.Tensor,
    target: torch.Tensor,
    ssim_lambda: float = 0.2,
) -> torch.Tensor:
    """(1 - l) * L1 + l * (1 - SSIM), the reference trainer's photometric
    loss."""
    return l1(render, target) * (1.0 - ssim_lambda) + ssim_lambda * (
        1.0 - ssim(render, target)
    )
