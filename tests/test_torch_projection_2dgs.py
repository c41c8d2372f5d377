"""Port 2DGS projection (gsplat_tpu_torch.ops.projection_2dgs) vs the JAX package.

Same seeded numpy inputs through gsplat_tpu's fully_fused_projection_2dgs
and the port's. Tolerances:
- radii equal; values of live entries (radii > 0) within rtol 1e-5 and
  atol 1e-5 x the output's largest |value| (the same f32 operations in
  the same order; culled entries are ill-conditioned near the camera and
  nothing reads them, so they are not compared);
- gradients of a seeded weighting of the live outputs w.r.t. means,
  quats, scales and viewmats within rtol 1e-4 and atol 1e-5 x the largest
  |gradient| (autograd and JAX's VJP sum the chain in other orders).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu.ops.projection_2dgs import fully_fused_projection_2dgs as jax_proj
from gsplat_tpu.ops.projection_2dgs import fully_fused_projection_2dgs_soa as jax_soa
from gsplat_tpu_torch.ops.projection_2dgs import (
    fully_fused_projection_2dgs,
    fully_fused_projection_2dgs_soa,
)
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

W, H = 64, 48


def _inputs(seed, N=300, C=2, spread=1.0, depth=4.0):
    rng = np.random.default_rng(seed)
    means = (rng.standard_normal((N, 3)) * spread).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.3 + 0.02).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[:, 2, 3] = depth
    viewmats[1, 0, 3] = 0.3
    viewmats[1, :3, :3] = np.array([[0.96, 0, 0.28], [0, 1, 0], [-0.28, 0, 0.96]], np.float32)
    Ks = np.tile(np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32), (C, 1, 1))
    return means, quats, scales, viewmats, Ks


# "near": points straddle the camera, so the near plane and the frustum cull
# many of them
SCENES = {"centred": dict(seed=0), "near": dict(seed=1, spread=3.0, depth=1.0)}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_projection_2dgs_matches_jax(scene):
    args = _inputs(**SCENES[scene])
    want = jax_soa(*map(jnp.asarray, args), W, H)
    got = fully_fused_projection_2dgs_soa(*map(torch.from_numpy, args), W, H)
    assert sorted(got) == sorted(want)
    radii = np.asarray(want["radii"])
    np.testing.assert_array_equal(got["radii"].numpy(), radii)
    assert got["radii"].dtype == torch.int32
    live = radii > 0
    assert 0 < live.sum() < live.size or scene == "centred"
    for k in want:
        if k == "radii":
            continue
        w = np.asarray(want[k])[live]
        g = got[k].detach().numpy()[live]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * max(float(np.abs(w).max()), 1e-6), err_msg=k)


def test_projection_2dgs_wrapper_shapes():
    args = _inputs(2, N=50)
    want = jax_proj(*map(jnp.asarray, args), W, H)
    got = fully_fused_projection_2dgs(*map(torch.from_numpy, args), W, H)
    C, N = 2, 50
    shapes = [(C, N), (C, N, 2), (C, N), (C, N, 3, 3), (C, N, 3)]
    live = np.asarray(want[0]) > 0
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live], rtol=1e-5, atol=1e-4)


def test_projection_2dgs_options():
    """near/far planes and radius_clip cull as the JAX package does."""
    args = _inputs(3)
    for kw in (dict(near_plane=3.5), dict(far_plane=4.2), dict(radius_clip=3.0)):
        want = np.asarray(jax_soa(*map(jnp.asarray, args), W, H, **kw)["radii"])
        got = fully_fused_projection_2dgs_soa(*map(torch.from_numpy, args), W, H, **kw)["radii"]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))
        assert (want == 0).any()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_projection_2dgs_gradients_match_jax(scene):
    args = _inputs(**SCENES[scene])
    radii = np.asarray(jax_soa(*map(jnp.asarray, args), W, H)["radii"])
    live = (radii > 0).astype(np.float32)
    keys = ["mean_x", "mean_y", "depth", "normal_x", "normal_y", "normal_z"] + [
        f"m{k}{i}" for k in range(3) for i in range(3)
    ]
    rng = np.random.default_rng(7)
    weights = {k: rng.standard_normal(radii.shape).astype(np.float32) * live for k in keys}

    def jloss(*a):
        out = jax_soa(*a, W, H)
        return sum(jnp.sum(out[k] * weights[k]) for k in keys)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args[:4]]
    out = fully_fused_projection_2dgs_soa(*leaves, torch.from_numpy(args[4]), W, H)
    sum((out[k] * torch.from_numpy(weights[k])).sum() for k in keys).backward()
    for t, w, name in zip(leaves, want, ("means", "quats", "scales", "viewmats")):
        w = np.asarray(w)
        assert np.isfinite(t.grad.numpy()).all(), name
        np.testing.assert_allclose(
            t.grad.numpy(), w, rtol=1e-4, atol=1e-5 * max(float(np.abs(w).max()), 1e-6), err_msg=name
        )
