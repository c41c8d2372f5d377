"""Port `accumulate` / `accumulate_2dgs` (gsplat_tpu_torch.ops.accumulate) vs
the JAX package, on the same COO lists.

The scene is tests/test_accumulate.py's (the garden fixture's first 300
Gaussians, scales x2, 96x64, 3 cameras); the lists are every contributing
pair of the JAX package's rasterize_to_indices_in_range(_2dgs) over all
depth ranks, grouped by (camera, pixel) and depth-ordered.
- renders, alphas and normals within rtol 1e-5 and atol 1e-6; gradients
  w.r.t. means2d (3DGS) and the ray transforms (2DGS) within rtol 1e-4 and
  atol 1e-5 x the largest |gradient| (autograd and JAX's VJP sum in other
  orders);
- padding both ways: slots disabled by `valid`, and slots with an
  out-of-range camera id (and wrapped or out-of-range Gaussian ids), give
  the unpadded result in both packages;
- rays of 1 to 4096 samples with alphas up to 0.99 (the segmented scan)
  within the same tolerance of JAX and of a float64 sequential product.
"""

import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu import load_test_data
from gsplat_tpu.ops.accumulate import accumulate as jax_acc
from gsplat_tpu.ops.accumulate import accumulate_2dgs as jax_acc2
from gsplat_tpu.ops.projection import fully_fused_projection
from gsplat_tpu.ops.projection_2dgs import fully_fused_projection_2dgs
from gsplat_tpu.ops.rasterize_2dgs_ref import rasterize_to_indices_in_range_2dgs
from gsplat_tpu.ops.rasterize_ref import rasterize_to_indices_in_range
from gsplat_tpu_torch.ops.accumulate import accumulate, accumulate_2dgs

from torch_exp_warmup import one_torch_thread, warm_exp  # noqa: F401 (one_torch_thread: an autouse fixture)

# the module (gsplat_tpu.ops exports the function under the same name)
jax_accumulate_module = importlib.import_module("gsplat_tpu.ops.accumulate")

W, H = 96, 64
N = 300
TOL = dict(rtol=1e-5, atol=1e-6)


def _coo(contrib, sel):
    """Dense [C, P, R] mask + [C, R] selection -> (gaussian, pixel, camera)
    id lists grouped by (camera, pixel), depth-ordered within a group."""
    gs, pix, cam = [], [], []
    for c in range(contrib.shape[0]):
        p_idx, r_idx = np.nonzero(contrib[c])
        gs.append(sel[c][r_idx])
        pix.append(p_idx)
        cam.append(np.full_like(p_idx, c))
    return [np.concatenate(x).astype(np.int32) for x in (gs, pix, cam)]


@functools.lru_cache(maxsize=None)
def _lists():
    """The scene's inputs and COO lists, built once per process (under
    `--dist load` a worker runs this module's tests between other modules',
    and a module-scoped fixture would rebuild them each time)."""
    warm_exp()
    means, quats, scales, opacities, colors, viewmats, Ks, w0, h0 = load_test_data()
    Ks = Ks.copy()
    Ks[:, 0] *= W / w0
    Ks[:, 1] *= H / h0
    args = tuple(map(jnp.asarray, (means[:N], quats[:N], scales[:N] * 2.0, viewmats, Ks)))
    C = viewmats.shape[0]
    out = {}
    # the lists are both packages' inputs, so the JAX calls that build them
    # are jitted (eagerly each op compiles on its own, ~10 s a build)
    radii, means2d, depths, conics, _ = jax.jit(fully_fused_projection, static_argnums=(5, 6))(*args, W, H)
    opac = jnp.broadcast_to(jnp.asarray(opacities[:N])[None], radii.shape)
    colors = jnp.broadcast_to(jnp.asarray(colors[:N])[None], (C, N, 3))
    contrib, _, sel, _ = jax.jit(rasterize_to_indices_in_range, static_argnums=(0, 1, 8, 9))(
        0, N, jnp.ones((C, H, W)), means2d, conics, opac, radii, depths, W, H
    )
    out["3dgs"] = dict(
        ins=[np.array(x) for x in (means2d, conics, opac, colors)],
        ids=_coo(np.array(contrib), np.array(sel)),
    )
    radii, means2d, depths, M, normals = jax.jit(fully_fused_projection_2dgs, static_argnums=(5, 6))(*args, W, H)
    contrib, _, sel, _ = jax.jit(rasterize_to_indices_in_range_2dgs, static_argnums=(0, 1, 8, 9))(
        0, N, jnp.ones((C, H, W)), means2d, M, opac, radii, depths, W, H
    )
    out["2dgs"] = dict(
        ins=[np.array(x) for x in (means2d, M, opac, colors, normals)],
        ids=_coo(np.array(contrib), np.array(sel)),
    )
    return out


@pytest.fixture
def scene():
    return _lists()


FNS = {"3dgs": (jax_acc, accumulate), "2dgs": (jax_acc2, accumulate_2dgs)}


@functools.lru_cache(maxsize=None)
def _jitted_scan():
    return jax.jit(jax_accumulate_module._segmented_weights)


@pytest.fixture(autouse=True)
def jitted_jax_scan(monkeypatch):
    """The JAX functions run eagerly, as a caller runs them, except their
    segmented scan, which is jitted (once per process): eagerly each level
    of the associative scan compiles its own ops (~12 s a call). The scan
    only multiplies, so jit changes none of its roundings; jitting the
    whole function would let XLA contract the 2DGS cross products into
    multiply-adds."""
    monkeypatch.setattr(jax_accumulate_module, "_segmented_weights", _jitted_scan())


def _both(kind, ins, ids, valid=None):
    jfn, tfn = FNS[kind]
    want = jfn(*map(jnp.asarray, ins), *map(jnp.asarray, ids), W, H,
               valid=None if valid is None else jnp.asarray(valid))
    got = tfn(*map(torch.from_numpy, ins), *map(torch.from_numpy, ids), W, H,
              valid=None if valid is None else torch.from_numpy(valid))
    return [np.array(w) for w in want], [g.detach().numpy() for g in got]


@functools.lru_cache(maxsize=None)
def _unpadded(kind):
    """Both packages on the scene's lists, once per process: the padding
    tests compare against it too."""
    s = _lists()[kind]
    return _both(kind, s["ins"], s["ids"])


@pytest.mark.parametrize("kind", ["3dgs", "2dgs"])
def test_accumulate_matches_jax(scene, kind):
    s = scene[kind]
    assert s["ids"][0].size > 1000  # the scene hits pixels
    want, got = _unpadded(kind)
    assert len(got) == (2 if kind == "3dgs" else 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    assert got[1].max() > 0.5


@pytest.mark.parametrize("kind", ["3dgs", "2dgs"])
def test_accumulate_gradients_match_jax(scene, kind):
    s = scene[kind]
    jfn, tfn = FNS[kind]
    arg = 0 if kind == "3dgs" else 1  # means2d, or the ray transforms
    ids = [jnp.asarray(x) for x in s["ids"]]

    def jloss(x):
        ins = [jnp.asarray(v) for v in s["ins"]]
        ins[arg] = x
        out = jfn(*ins, *ids, W, H)
        return sum(c * jnp.sum(o) for c, o in zip((1.0, 0.5, 0.25), out))

    want = np.array(jax.grad(jloss)(jnp.asarray(s["ins"][arg])))
    ins = [torch.from_numpy(v) for v in s["ins"]]
    ins[arg] = ins[arg].clone().requires_grad_(True)
    out = tfn(*ins, *map(torch.from_numpy, s["ids"]), W, H)
    sum(c * o.sum() for c, o in zip((1.0, 0.5, 0.25), out)).backward()
    np.testing.assert_allclose(
        ins[arg].grad.numpy(), want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max())
    )


@pytest.mark.parametrize("kind", ["3dgs", "2dgs"])
@pytest.mark.parametrize("how", ["valid", "camera_id"])
def test_accumulate_padding(scene, kind, how):
    """257 padded slots after the list: disabled by `valid` (pointing at
    real ids), or by camera id C (an out-of-range ray; their Gaussian ids
    -1 and N + 5, which JAX's gather wraps or clamps)."""
    s = scene[kind]
    C = s["ins"][0].shape[0]
    g, p, c = s["ids"]
    pad = 257
    if how == "valid":
        extra = [np.zeros(pad, np.int32)] * 3
        valid = np.concatenate([np.ones(g.size, bool), np.zeros(pad, bool)])
    else:
        gpad = np.where(np.arange(pad) % 2 == 0, -1, N + 5).astype(np.int32)
        extra = [gpad, np.arange(pad, dtype=np.int32) % (H * W), np.full(pad, C, np.int32)]
        valid = None
    ids = [np.concatenate([a, b]) for a, b in zip((g, p, c), extra)]
    want0, got0 = _unpadded(kind)
    want, got = _both(kind, s["ins"], ids, valid)
    for a, b, w in zip(got, got0, want):
        np.testing.assert_allclose(a, b, **TOL)
        np.testing.assert_allclose(a, w, **TOL)
    for a, b in zip(want, want0):
        np.testing.assert_allclose(a, b, **TOL)


def test_accumulate_long_rays():
    """Six rays of 1 to 4096 samples at the pixels' centres (sigma 0, so
    alpha is the opacity): alphas of 1e-3 to 0.05 with 0.99 every 97th
    sample, against JAX and a float64 sequential product."""
    rng = np.random.default_rng(5)
    lengths = [1, 2, 7, 300, 1000, 4096]
    n = sum(lengths)
    op = rng.uniform(1e-3, 0.05, n).astype(np.float32)
    op[::97] = 0.99
    pix = np.repeat(np.arange(len(lengths)) * 131 % (H * W), lengths).astype(np.int32)
    means2d = np.stack([pix % W + 0.5, pix // W + 0.5], -1).astype(np.float32)[None]
    conics = np.tile(np.array([1.0, 0.0, 1.0], np.float32), (1, n, 1))
    colors = rng.random((1, n, 3)).astype(np.float32)
    ids = [np.arange(n, dtype=np.int32), pix, np.zeros(n, np.int32)]
    ins = [means2d, conics, op[None], colors]
    want, got = _both("3dgs", ins, ids)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    # float64 sequential product, ray by ray
    start = 0
    for L in lengths:
        a = op[start:start + L].astype(np.float64)
        T = np.concatenate([[1.0], np.cumprod(1.0 - a)[:-1]])
        w = a * T
        p = pix[start]
        np.testing.assert_allclose(got[1][0, p // W, p % W, 0], w.sum(), **TOL)
        np.testing.assert_allclose(got[0][0, p // W, p % W], (w[:, None] * colors[0, start:start + L]).sum(0), **TOL)
        start += L
