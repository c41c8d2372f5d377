"""Port losses (gsplat_tpu_torch.losses) vs the JAX package's.

Seeded numpy images [B, H, W, 3] in [0, 1] go through both packages; the
values and the gradients w.r.t. the first image must agree within rtol
1e-5 (atol 1e-7 for gradients near zero): both convolve in float32, summing
the window in another order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu import losses as jl
from gsplat_tpu_torch import losses as tl
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

FNS = ["l1", "ssim", "psnr", "train_loss"]


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    a = rng.random((2, 24, 32, 3)).astype(np.float32)
    # a blurred, noisy copy: SSIM well inside (0, 1)
    b = np.clip(0.7 * a + 0.3 * np.roll(a, 2, axis=2) + 0.05 * rng.standard_normal(a.shape), 0, 1)
    return a, b.astype(np.float32)


@pytest.mark.parametrize("name", FNS)
def test_loss_value_and_grad_match_jax(images, name):
    a, b = images
    want, want_g = jax.value_and_grad(lambda x: getattr(jl, name)(x, jnp.asarray(b)))(jnp.asarray(a))
    x = torch.tensor(a, requires_grad=True)
    got = getattr(tl, name)(x, torch.from_numpy(b))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)


def test_ssim_of_identical_images_is_one(images):
    a, _ = images
    t = torch.from_numpy(a)
    np.testing.assert_allclose(float(tl.ssim(t, t)), 1.0, rtol=1e-6)
    assert float(tl.psnr(t, t)) == pytest.approx(120.0)  # mse clamped at 1e-12


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_train_loss_lambda_matches_jax(images, lam):
    a, b = images
    want = jl.train_loss(jnp.asarray(a), jnp.asarray(b), ssim_lambda=lam)
    got = tl.train_loss(torch.from_numpy(a), torch.from_numpy(b), ssim_lambda=lam)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
