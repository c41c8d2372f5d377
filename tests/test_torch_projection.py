"""Port projection (gsplat_tpu_torch.ops.projection) vs the JAX package.

The same seeded numpy inputs go through both packages on the CPU. Radii are
integers and must match exactly; every float output must agree within
rtol/atol 1e-5 on the live entries (radii > 0; both packages round the same
component formulas in the same order, so only transcendental and contraction
differences remain). Culled entries are not compared: nothing downstream
reads them, and near or behind the camera their ill-conditioned Jacobian
turns those last-bit differences into ~2e-5.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gsplat_tpu.ops import projection as jproj
from gsplat_tpu_torch import load_test_data
from gsplat_tpu_torch.ops import projection as tproj
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-5)


def _scene(seed=0, N=250, C=2, W=64, H=48):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.3 + 0.05).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[:, 2, 3] = 4.0
    viewmats[1, 0, 3] = 0.3
    Ks = np.tile(
        np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32),
        (C, 1, 1),
    )
    return means, quats, scales, viewmats, Ks, W, H


def _garden():
    """Garden fixture subsample, as tests/test_golden_garden.py cuts it."""
    means, quats, scales, _, _, viewmats, Ks, width, height = load_test_data()
    stride = max(1, means.shape[0] // 9000)
    factor = 4
    Ks = Ks.copy()
    Ks[:, :2, :] /= factor
    return (
        means[::stride], quats[::stride], scales[::stride], viewmats[:2],
        Ks[:2], width // factor, height // factor,
    )


SCENES = {"scene": _scene, "garden": _garden}

CASES = {
    "pinhole": dict(),
    "ortho": dict(camera_model="ortho"),
    "fisheye": dict(camera_model="fisheye"),
    "compensation": dict(calc_compensations=True),
    "near_far": dict(near_plane=3.5, far_plane=5.0),
    "radius_clip": dict(radius_clip=3.0),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    return SCENES[request.param]()


@pytest.fixture(scope="module")
def jax_soa(scene):
    """The JAX package's fused projection of the scene, for every case."""
    means, quats, scales, viewmats, Ks, W, H = scene
    args = tuple(map(jnp.asarray, (means, quats, scales, viewmats, Ks)))
    out = {}
    for case, kw in CASES.items():
        res = jproj.fully_fused_projection_soa(*args, W, H, **kw)
        out[case] = {k: np.asarray(v) for k, v in res.items()}
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_projection_matches_jax(scene, jax_soa, case):
    means, quats, scales, viewmats, Ks, W, H = scene
    want = jax_soa[case]
    got = tproj.fully_fused_projection_soa(
        *map(torch.from_numpy, (means, quats, scales, viewmats, Ks)), W, H, **CASES[case]
    )
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["radii"].numpy(), want["radii"])
    assert got["radii"].dtype == torch.int32
    live = got["radii"].numpy() > 0
    assert live.any()
    for key in sorted(got):
        if key == "radii":
            continue
        try:
            np.testing.assert_allclose(
                got[key].numpy()[live], want[key][live], err_msg=key, **TOL
            )
        except AssertionError as err:
            # say which package moved: each against a float64 evaluation
            ref = tproj.fully_fused_projection_soa(
                *(torch.from_numpy(a).double() for a in (means, quats, scales, viewmats, Ks)),
                W, H, **CASES[case],
            )[key].numpy()[live]
            raise AssertionError(
                f"{err}\nmax abs vs float64: port "
                f"{np.abs(got[key].numpy()[live] - ref).max():.3e}, JAX "
                f"{np.abs(want[key][live] - ref).max():.3e}"
            ) from None


def test_fused_projection_reference_shapes(scene):
    means, quats, scales, viewmats, Ks, W, H = scene
    want = jproj.fully_fused_projection(
        *map(jnp.asarray, (means, quats, scales, viewmats, Ks)), W, H,
        calc_compensations=True,
    )
    got = tproj.fully_fused_projection(
        *map(torch.from_numpy, (means, quats, scales, viewmats, Ks)), W, H,
        calc_compensations=True,
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    live = got[0].numpy() > 0
    for g, w in zip(got[1:], want[1:]):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live], **TOL)


def test_fused_projection_with_covars():
    means, quats, scales, viewmats, Ks, W, H = _scene(seed=1)
    covars, _ = jproj.quat_scale_to_covar_preci(
        jnp.asarray(quats), jnp.asarray(scales), compute_preci=False
    )
    covars = np.array(covars)
    want = jproj.fully_fused_projection_soa(
        jnp.asarray(means), None, None, jnp.asarray(viewmats), jnp.asarray(Ks),
        W, H, covars=jnp.asarray(covars),
    )
    got = tproj.fully_fused_projection_soa(
        torch.from_numpy(means), None, None, torch.from_numpy(viewmats),
        torch.from_numpy(Ks), W, H, covars=torch.from_numpy(covars),
    )
    np.testing.assert_array_equal(got["radii"].numpy(), np.asarray(want["radii"]))
    live = got["radii"].numpy() > 0
    for key in ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "depth"):
        np.testing.assert_allclose(got[key].numpy()[live], np.asarray(want[key])[live], **TOL)


@pytest.mark.parametrize("triu", [False, True])
def test_matrix_helpers_match_jax(triu):
    means, quats, scales, viewmats, Ks, W, H = _scene(seed=2, N=64)
    jq, js = jnp.asarray(quats), jnp.asarray(scales)
    tq, tsc = torch.from_numpy(quats), torch.from_numpy(scales)
    np.testing.assert_allclose(
        tproj.quat_to_rotmat(tq).numpy(), np.asarray(jproj.quat_to_rotmat(jq)), **TOL
    )
    for g, w in zip(
        tproj.quat_scale_to_covar_preci(tq, tsc, triu=triu),
        jproj.quat_scale_to_covar_preci(jq, js, triu=triu),
    ):
        # precision entries are sums of terms up to 1/s^2 ~ 400 that cancel:
        # the absolute tolerance scales with the largest entry
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    covars = tproj.quat_scale_to_covar_preci(tq, tsc, compute_preci=False)[0]
    got = tproj.world_to_cam(torch.from_numpy(means), covars, torch.from_numpy(viewmats))
    want = jproj.world_to_cam(
        jnp.asarray(means), jnp.asarray(covars.numpy()), jnp.asarray(viewmats)
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    means_c, covars_c = (g.numpy() for g in got)
    for name in ("persp_proj", "ortho_proj", "fisheye_proj"):
        g = getattr(tproj, name)(
            torch.from_numpy(means_c), torch.from_numpy(covars_c),
            torch.from_numpy(Ks), W, H,
        )
        w = getattr(jproj, name)(
            jnp.asarray(means_c), jnp.asarray(covars_c), jnp.asarray(Ks), W, H
        )
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
