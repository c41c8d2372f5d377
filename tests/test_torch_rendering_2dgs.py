"""Port rasterization_2dgs (gsplat_tpu_torch.rendering) vs the JAX package.

Same seeded numpy inputs through gsplat_tpu.rasterization_2dgs (oracle) and
the port's, on both of the port's backends (binned: the kernels' plain
versions). Tolerances:
- port oracle against JAX's oracle: rtol 1e-5, atol 1e-4 (ED divides the
  depth by alpha and the normals from depth difference and normalise it,
  which amplifies rounding);
- port binned against JAX's oracle: count-based flip gates, as the JAX
  package holds its own 2DGS backends to the oracle: a share < 1e-3 of
  values off by > 5e-4 and none by > 5e-2 (a flipped borderline
  acceptance moves a pixel's depth, and the normals from depth of its
  neighbours with it);
- gradients of a seeded weighting of the outputs (distortion on) w.r.t.
  the splat parameters and the densify carrier: 99.5% of values within
  rtol 1e-3 and atol 1e-3 x max(1, the largest |gradient|), none off by
  more than 0.05 x that (tests/test_rasterize_2dgs_tiled.py's gates);
- depth_to_points / depth_to_normal: rtol 1e-5, atol 1e-5.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu.rendering import rasterization_2dgs as jax_r2
from gsplat_tpu.utils import depth_to_normal as jax_d2n
from gsplat_tpu.utils import depth_to_points as jax_d2p
from gsplat_tpu_torch import depth_to_normal, depth_to_points, rasterization_2dgs
import torch_prefetch as prefetch
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

N, C, W, H, CAP = 200, 2, 48, 32, 8192
OUTS = ("colors", "alphas", "normals", "normals_from_depth", "distort", "median")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.2 + 0.02).astype(np.float32)
    opac = rng.random((N,)).astype(np.float32)
    vm = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    vm[:, 2, 3] = 4.0
    vm[1, 0, 3] = 0.3
    vm[1, :3, :3] = np.array([[0.98, 0, 0.2], [0, 1, 0], [-0.2, 0, 0.98]], np.float32)
    Ks = np.tile(np.array([[25.0, 0, W / 2], [0, 25.0, H / 2], [0, 0, 1]], np.float32), (C, 1, 1))
    return dict(
        means=means, quats=quats, scales=scales, opacities=opac, viewmats=vm, Ks=Ks,
        rgb=rng.random((N, 3)).astype(np.float32),
        sh=(rng.standard_normal((N, 16, 3)) * 0.3).astype(np.float32),
        percam=rng.random((C, N, 3)).astype(np.float32),
        masks=rng.random(N) > 0.2,
        bg=rng.random((C, 3)).astype(np.float32),
    )


# name -> (colors key, kwargs); "bg" and "masks" name the scene's arrays
CASES = {
    "RGB-bg": ("rgb", dict(backgrounds="bg")),
    "D": ("rgb", dict(render_mode="D")),
    "ED-distloss": ("rgb", dict(render_mode="ED", distloss=True)),
    "RGB+D-median-sh3-masks": ("sh", dict(render_mode="RGB+D", depth_mode="median", sh_degree=3, masks="masks")),
    "RGB+ED-sh3-bg-distloss": ("sh", dict(render_mode="RGB+ED", sh_degree=3, backgrounds="bg", distloss=True)),
    "RGB+ED-percam-ts32": ("percam", dict(render_mode="RGB+ED", tile_size=32)),
}


@pytest.fixture(scope="module")
def scene():
    return _inputs(0)


def _args(s, colors, conv):
    return [conv(s[k]) for k in ("means", "quats", "scales", "opacities")] + [conv(s[colors])] + [
        conv(s["viewmats"]), conv(s["Ks"]), W, H
    ]


def _kw(s, kw, conv):
    return {k: conv(s[v]) if isinstance(v, str) and v in s else v for k, v in kw.items()}


def _jax_outputs():
    """JAX's oracle outputs (and meta, as numpy) of every case on
    _inputs(0)."""
    scene = _inputs(0)
    out = {}
    for name, (colors, kw) in CASES.items():
        o = jax_r2(*_args(scene, colors, jnp.asarray), backend="oracle", **_kw(scene, kw, jnp.asarray))
        meta = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in o[6].items()}
        out[name] = [None if x is None else np.asarray(x) for x in o[:6]] + [meta]
    return out


# computed once per session in the background from collection on
# (tests/torch_prefetch.py)
prefetch.start("rendering_2dgs_outputs", [os.path.abspath(__file__), "--outputs"])


@pytest.fixture(scope="module")
def jax_outputs():
    return prefetch.result("rendering_2dgs_outputs")


def _flip_gate(got, want, name):
    d = np.abs(got - want)
    assert d.max() < 5e-2, f"{name} max {d.max():.2e}"
    assert (d > 5e-4).mean() < 1e-3, f"{name} flips {(d > 5e-4).mean():.2%}"


@pytest.mark.parametrize("backend", ["oracle", "binned"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterization_2dgs_matches_jax(scene, jax_outputs, case, backend):
    colors, kw = CASES[case]
    with torch.no_grad():
        got = rasterization_2dgs(
            *_args(scene, colors, torch.from_numpy), backend=backend, isect_capacity=CAP,
            **_kw(scene, kw, torch.from_numpy),
        )
    want = jax_outputs[case]
    for g, w, name in zip(got[:6], want[:6], OUTS):
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == w.shape, name
        if backend == "oracle":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-4, err_msg=name)
        else:
            _flip_gate(g.numpy(), w, name)
    meta, jmeta = got[6], want[6]
    np.testing.assert_array_equal(meta["radii"].numpy(), np.asarray(jmeta["radii"]))
    for key in ("depths", "normals"):
        live = np.asarray(jmeta["radii"]) > 0
        np.testing.assert_allclose(meta[key].numpy()[live], np.asarray(jmeta[key])[live], rtol=1e-5, atol=1e-5)
    assert meta["n_cameras"] == C and (meta["width"], meta["height"]) == (W, H)
    if backend == "binned":
        assert int(meta["n_isects"]) > 0 and meta["isect_capacity"] == CAP
        assert meta["slab_required"] >= int(meta["n_isects"])
    if not kw.get("distloss"):
        assert not got[4].any()


def _grad_close(got, want, name):
    s = max(float(np.abs(want).max()), 1.0)
    assert np.isfinite(got).all(), name
    d = np.abs(got - want)
    off = d > 1e-3 * np.abs(want) + 1e-3 * s
    assert off.mean() <= 5e-3, f"{name}: {off.sum()} of {off.size} values off, max abs {d.max():.3e}"
    assert d.max() <= 0.05 * s, f"{name}: max abs {d.max():.3e} against scale {s:.3e}"


GRAD_DIFF = ("means", "quats", "scales", "opacities", "sh")
GRAD_KW = dict(sh_degree=3, render_mode="RGB+ED", distloss=True)


def _jax_gradients():
    """The seeded output weights and JAX's oracle gradients (eager) of the
    weighted outputs w.r.t. GRAD_DIFF and the densify carrier, on
    _inputs(0)."""
    scene = _inputs(0)
    rng = np.random.default_rng(5)
    ws = [rng.standard_normal(shape).astype(np.float32)
          for shape in ((C, H, W, 4), (C, H, W, 1), (C, H, W, 3), (C, H, W, 3), (C, H, W, 1))]

    def jloss(means, quats, scales, opac, sh, carrier):
        o = jax_r2(means, quats, scales, opac, sh, jnp.asarray(scene["viewmats"]), jnp.asarray(scene["Ks"]),
                   W, H, backend="oracle", densify_carrier=carrier, **GRAD_KW)
        return sum(jnp.sum(x * w) for x, w in zip((o[0], o[1], o[2], o[3], o[4]), ws))

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *[jnp.asarray(scene[k]) for k in GRAD_DIFF], jnp.zeros((C, N, 2), jnp.float32)
    )
    return ws, [np.asarray(w) for w in want]


# computed once per session in the background from collection on
# (tests/torch_prefetch.py): JAX's eager gradients take ~1 min
prefetch.start("rendering_2dgs_gradients", [os.path.abspath(__file__), "--gradients"])


def test_rasterization_2dgs_gradients_match_jax(scene):
    """Gradients through projection, SH, the rasterizer (distortion on) and
    the world rotation of the normals, w.r.t. the splats and the densify
    carrier, on both port backends against JAX's oracle."""
    ws, want = prefetch.result("rendering_2dgs_gradients")
    diff, kw = GRAD_DIFF, GRAD_KW
    for backend in ("oracle", "binned"):
        leaves = [torch.tensor(scene[k], requires_grad=True) for k in diff]
        carrier = torch.zeros((C, N, 2), requires_grad=True)
        o = rasterization_2dgs(
            *leaves, torch.from_numpy(scene["viewmats"]), torch.from_numpy(scene["Ks"]), W, H,
            backend=backend, isect_capacity=CAP, densify_carrier=carrier, **kw,
        )
        sum((x * torch.from_numpy(w)).sum() for x, w in zip((o[0], o[1], o[2], o[3], o[4]), ws)).backward()
        for t, w, name in zip(leaves + [carrier], want, diff + ("densify_carrier",)):
            _grad_close(t.grad.numpy(), np.asarray(w), f"{backend} {name}")


def test_depth_to_normal_matches_jax():
    rng = np.random.default_rng(3)
    depths = (2.0 + rng.random((2, 12, 16, 1))).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c2w[1, :3, :3] = np.array([[0.8, 0, 0.6], [0, 1, 0], [-0.6, 0, 0.8]], np.float32)
    c2w[:, :3, 3] = rng.standard_normal((2, 3)).astype(np.float32)
    Ks = np.tile(np.array([[20.0, 0, 8.0], [0, 22.0, 6.0], [0, 0, 1]], np.float32), (2, 1, 1))
    for z_depth in (True, False):
        args = (depths, c2w, Ks)
        np.testing.assert_allclose(
            depth_to_points(*map(torch.from_numpy, args), z_depth=z_depth).numpy(),
            np.asarray(jax_d2p(*map(jnp.asarray, args), z_depth=z_depth)), rtol=1e-5, atol=1e-5,
        )
        got = depth_to_normal(*map(torch.from_numpy, args), z_depth=z_depth).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_d2n(*map(jnp.asarray, args), z_depth=z_depth)),
                                   rtol=1e-5, atol=1e-5)
        assert not got[:, 0].any() and not got[:, :, -1].any()
    with pytest.raises(ValueError, match="channel"):
        depth_to_points(torch.ones(2, 4, 4, 3), torch.eye(4).expand(2, 4, 4), torch.eye(3).expand(2, 3, 3))


def test_rasterization_2dgs_options_and_refusals(scene):
    args = _args(scene, "rgb", torch.from_numpy)
    with torch.no_grad():
        base = rasterization_2dgs(*args, backend="binned", isect_capacity=CAP)
        inert = rasterization_2dgs(*args, backend="binned", isect_capacity=CAP, packed=True, sparse_grad=True)
    for a, b in zip(base[:6], inert[:6]):
        assert (a is None and b is None) or torch.equal(a, b)
    # multi-GPU needs a torch.distributed process group, and raises without
    # one rather than render on one device
    with pytest.raises(RuntimeError, match="init_process_group"):
        rasterization_2dgs(*args, distributed=True)
    # the tiled backend, which raised until its slice, renders as the binned
    # one does (the same stream, no cull in either)
    with torch.no_grad():
        tiled = rasterization_2dgs(*args, backend="tiled", isect_capacity=CAP)
    for a, b in zip(base[:6], tiled[:6]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert int(tiled[6]["n_isects"]) == int(base[6]["n_isects"])
    with pytest.raises(ValueError, match="isect_capacity"):
        rasterization_2dgs(*args, backend="binned")
    with pytest.raises(ValueError, match="depth_mode"):
        rasterization_2dgs(*args, render_mode="RGB+D", depth_mode="mean")
    with pytest.raises(ValueError, match="render_mode"):
        rasterization_2dgs(*args, render_mode="N")


if __name__ == "__main__" and sys.argv[1:2] in (["--gradients"], ["--outputs"]):
    prefetch.as_test_process()
    make = _jax_gradients if sys.argv[1] == "--gradients" else _jax_outputs
    prefetch.write(sys.argv[sys.argv.index("--out") + 1], make())
