"""Port rasterization() (gsplat_tpu_torch.rendering) vs the JAX package.

Garden fixture subsample, cut as tests/test_golden_garden.py cuts it (every
~15th Gaussian, cameras / 4, 2 cameras); the oracle cases use a coarser cut
(every ~60th Gaussian, cameras / 8) because both oracles hold every
(pixel, Gaussian) pair in memory. The same numpy parameters go through both
packages on the CPU (the JAX Pallas kernels in interpret mode, the port's
kernels through their plain versions). Images (expected depth included) and
alphas must agree within rtol/atol 1e-5, and every meta value must be equal
(float meta within 1e-5 on the live entries).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import gsplat_tpu
from gsplat_tpu_torch import load_test_data, rasterization
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

CAP = 1 << 16


def _garden(n_target, factor):
    means, quats, scales, opac, colors, viewmats, Ks, width, height = load_test_data()
    stride = max(1, means.shape[0] // n_target)
    Ks = Ks.copy()
    Ks[:, :2, :] /= factor
    rng = np.random.default_rng(0)
    N = means[::stride].shape[0]
    return dict(
        means=means[::stride], quats=quats[::stride], scales=scales[::stride],
        opacities=opac[::stride], rgb=colors[::stride],
        sh=rng.standard_normal((N, 16, 3)).astype(np.float32) * 0.3,
        masks=rng.random(N) > 0.2,
        viewmats=viewmats[:2], Ks=Ks[:2], W=width // factor, H=height // factor,
        bg=rng.random((2, 40)).astype(np.float32),
        percam=rng.random((2, N, 3)).astype(np.float32),
        wide=rng.random((N, 40)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def garden():
    return _garden(9000, 4)


@pytest.fixture(scope="module")
def garden_small():
    return _garden(2250, 8)


# name -> (backend, colors key, rasterization kwargs)
CASES = {
    "binned-RGB-bg": ("binned", "rgb", dict(backgrounds=3)),
    "binned-D": ("binned", "rgb", dict(render_mode="D")),
    "binned-ED-bg": ("binned", "rgb", dict(render_mode="ED", backgrounds=3)),
    "binned-RGB+D-sh3-masks": ("binned", "sh", dict(render_mode="RGB+D", sh_degree=3, masks=True)),
    "binned-RGB+ED-antialiased-percam": ("binned", "percam", dict(render_mode="RGB+ED", rasterize_mode="antialiased", backgrounds=3)),
    "binned-chunked-D40": ("binned", "wide", dict(backgrounds=40, channel_chunk=32)),
    "binned-ts32-sh1": ("binned", "sh", dict(sh_degree=1, tile_size=32)),
    "oracle-RGB-sh3-masks-bg": ("oracle", "sh", dict(sh_degree=3, masks=True, backgrounds=3)),
    "oracle-RGB+ED-antialiased": ("oracle", "rgb", dict(render_mode="RGB+ED", rasterize_mode="antialiased")),
    "oracle-D": ("oracle", "rgb", dict(render_mode="D")),
}


def _run(g, backend, color_key, kw):
    kw = dict(kw)
    if "backgrounds" in kw:
        kw["backgrounds"] = g["bg"][:, : kw["backgrounds"]]
    if kw.pop("masks", False):
        kw["masks"] = g["masks"]
    if backend == "binned":
        kw["isect_capacity"] = CAP
    args = [g[k] for k in ("means", "quats", "scales", "opacities")]
    args += [g[color_key], g["viewmats"], g["Ks"]]
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want = gsplat_tpu.rasterization(
        *map(jnp.asarray, args), g["W"], g["H"], backend=backend, **jkw
    )
    got = rasterization(
        *map(torch.from_numpy, args), g["W"], g["H"], backend=backend, **tkw
    )
    return want, got


def _compare(want, got):
    (r_j, a_j, m_j), (r_t, a_t, m_t) = want, got
    assert tuple(r_t.shape) == tuple(r_j.shape)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5, atol=1e-5)
    assert float(a_t.mean()) > 0.05
    assert sorted(m_t) == sorted(m_j)
    for key in m_j:
        w, g = m_j[key], m_t[key]
        if key == "radii":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        elif key in ("depths", "means2d"):
            live = m_t["radii"].numpy() > 0
            np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live], rtol=1e-5, atol=1e-5)
        else:
            assert int(g) == int(w), key


@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterization_matches_jax(case, garden, garden_small):
    backend, color_key, kw = CASES[case]
    g = garden if backend == "binned" else garden_small
    want, got = _run(g, backend, color_key, kw)
    _compare(want, got)


def test_rasterization_packed_sparse_grad_are_inert(garden):
    """`packed` and `sparse_grad`, which the JAX API takes and leaves inert
    on one device, are taken too: with both set (False, as a call written
    for the JAX API passes them) the render equals JAX's with the same
    flags, and the port's renders with them unset and with both True are
    the same bits."""
    flags = dict(packed=False, sparse_grad=False)
    want, got = _run(garden, "binned", "rgb", dict(backgrounds=3, **flags))
    _compare(want, got)
    args = [torch.from_numpy(garden[k]) for k in ("means", "quats", "scales", "opacities", "rgb", "viewmats", "Ks")]
    kw = dict(backgrounds=torch.from_numpy(garden["bg"][:, :3]), backend="binned", isect_capacity=CAP)
    unset = rasterization(*args, garden["W"], garden["H"], **kw)
    on = rasterization(*args, garden["W"], garden["H"], packed=True, sparse_grad=True, **kw)
    for a, b, c in zip(got[:2], unset[:2], on[:2]):
        assert torch.equal(a, b) and torch.equal(a, c)
