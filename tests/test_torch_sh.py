"""Port spherical harmonics (gsplat_tpu_torch.ops.sh) vs the JAX package.

Same seeded numpy directions, coefficients and masks through both; values
within rtol/atol 1e-5 (the contraction sums 1-25 terms in another order).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gsplat_tpu.ops import sh as jsh
from gsplat_tpu_torch.ops import sh as tsh
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, shape=(2, 300)):
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal(shape + (3,)).astype(np.float32)
    coeffs = rng.standard_normal(shape + (25, 3)).astype(np.float32)
    masks = rng.random(shape) > 0.3
    return dirs, coeffs, masks


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("use_masks", [False, True])
def test_spherical_harmonics_matches_jax(degree, use_masks):
    dirs, coeffs, masks = _inputs(degree)
    # K larger than the degree needs: only the first (degree+1)^2 count
    k = (degree + 1) ** 2 + (3 if degree < 4 else 0)
    coeffs = coeffs[..., :k, :]
    m = masks if use_masks else None
    want = jsh.spherical_harmonics(
        degree, jnp.asarray(dirs), jnp.asarray(coeffs),
        masks=None if m is None else jnp.asarray(m),
    )
    got = tsh.spherical_harmonics(
        degree, torch.from_numpy(dirs), torch.from_numpy(coeffs),
        masks=None if m is None else torch.from_numpy(m),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if use_masks:
        assert (got.numpy()[~masks] == 0).all()


@pytest.mark.parametrize("basis_dim", [1, 4, 9, 16, 25])
def test_eval_sh_bases_matches_jax(basis_dim):
    dirs, _, _ = _inputs(7)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = jsh.eval_sh_bases(basis_dim, jnp.asarray(dirs))
    got = tsh.eval_sh_bases(basis_dim, torch.from_numpy(dirs))
    assert tuple(got.shape) == dirs.shape[:-1] + (basis_dim,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_spherical_harmonics_rejects_too_few_coeffs():
    dirs, coeffs, _ = _inputs(0)
    with pytest.raises(ValueError):
        tsh.spherical_harmonics(3, torch.from_numpy(dirs), torch.from_numpy(coeffs[..., :9, :]))
