"""Port 2DGS trainer (gsplat_tpu_torch.simple_trainer_2dgs) vs the JAX trainer.

- Three steps from one initial state on a 2-view in-memory scene (300
  points in front of a backdrop of 192, 48x36): the port's Runner2DGS
  against a JAX step built from rasterization_2dgs (oracle, RGB+ED),
  train_loss, examples/simple_trainer_2dgs.py's own `_geom_losses`
  (normal consistency from step 1, distortion from step 2, so both
  warm-ups switch on), value_and_grad, SelectiveAdam and DefaultStrategy
  (its opacity reset at step 0). Every pixel of the views is covered: JAX's
  normal normalisation has a NaN gradient at a pixel whose rendered
  normal is exactly 0, where torch's is 0. After every step, each
  parameter within rtol 1e-4 and atol 1e-4 x its learning rate and each
  Adam moment within rtol 1e-4 and atol 1e-6 x the array's largest
  |value| (tests/test_torch_trainer.py's tolerances: one Adam step is at
  most ~lr, and a second step whose moments nearly cancel amplifies the
  gradients' rounding), for all but a share of the values, and none of a
  parameter off by more than 2 x its learning rate nor of a moment by
  more than 1% of the array's largest |value|. The share:
  - 0.5% on the port's oracle backend (0.14% measured): the gradient of
    an edge-on surfel's ray transform sums pixel-scaled terms that
    cancel, so a few means gradients differ by ~1e-3 relative between
    any two summation orders, the oracles of both packages included;
  - 2% on the binned backend (the kernels' plain versions; 0.87%
    measured): its depth differs from the oracle's by ~1e-5, which
    expected depth (divided by alpha) and the normals from depth (a
    normalised finite difference) amplify into the normal-consistency
    gradient.
- A Runner2DGS smoke on the binned backend: the probe sizes the budget
  from a surfel render, the tile is capped at 16, finite parameters, the
  loss of a view falls, eval and eval_geometry finite.
- Runner2DGS runs on CUDA unless told device="cpu".
"""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu.losses import train_loss as jax_train_loss
from gsplat_tpu.optimizers import SelectiveAdam as JaxAdam
from gsplat_tpu.rendering import rasterization_2dgs as jax_r2
from gsplat_tpu.strategy import DefaultStrategy as JaxDefault
from gsplat_tpu_torch import rasterization, rasterization_2dgs
from gsplat_tpu_torch import simple_trainer as st
from gsplat_tpu_torch.simple_trainer_2dgs import Runner2DGS

import torch_prefetch as prefetch
from test_torch_trainer import _ROOT, _c2w, _jax_trainer
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

W, H = 48, 36
NORMAL_START, DIST_START = 1, 2


def _jax_trainer_2dgs():
    """examples/simple_trainer_2dgs.py, loaded under its own module name
    (it imports `simple_trainer`: the JAX trainer, for the load only)."""
    name = "jax_simple_trainer_2dgs_for_port_tests"
    if name not in sys.modules:
        prev = sys.modules.get("simple_trainer")
        sys.modules["simple_trainer"] = _jax_trainer()
        try:
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(_ROOT, "examples", "simple_trainer_2dgs.py")
            )
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
        finally:
            if prev is None:
                del sys.modules["simple_trainer"]
            else:
                sys.modules["simple_trainer"] = prev
    return sys.modules[name]


def _scene(seed=0, n=300, n_views=2):
    """Points in front of a backdrop grid that covers the views, and targets
    rendered from them as opaque splats by the port's 3DGS oracle."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(-3.6, 3.6, 16), np.linspace(-2.7, 2.7, 12))
    backdrop = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 1.5)], axis=-1)
    pts = np.concatenate([rng.standard_normal((n, 3)) * 0.5, backdrop]).astype(np.float32)
    rgb = (rng.random((pts.shape[0], 3)) * 255).astype(np.uint8)
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32)
    views = []
    for i in range(n_views):
        c2w = _c2w(0.3 * i, -0.1 * i)
        with torch.no_grad():
            img, _, _ = rasterization(
                torch.from_numpy(pts), torch.tensor([[1.0, 0, 0, 0]]).expand(len(pts), 4),
                torch.full((len(pts), 3), 0.08), torch.full((len(pts),), 0.9),
                torch.from_numpy(rgb.astype(np.float32) / 255.0),
                torch.linalg.inv(torch.from_numpy(c2w))[None], torch.from_numpy(K)[None], W, H,
                backend="oracle",
            )
        views.append({"image": img[0].numpy(), "camtoworld": c2w, "K": K, "image_id": i})
    return pts, rgb, views


def _jax_steps(runner0, n_steps):
    """The JAX 2DGS trainer's step (examples/simple_trainer.py's step_fn
    with examples/simple_trainer_2dgs.py's render and geometry-loss hooks,
    without the aux modules) from the Runner's initial state, on its views
    in its order. Returns per step (params, moments)."""
    cfg = runner0.cfg
    geom_losses = _jax_trainer_2dgs().Runner2DGS._geom_losses
    params = {k: jnp.asarray(v.detach().numpy()) for k, v in runner0.params.items()}
    live = jnp.asarray(runner0.live.numpy())
    means_lr0 = cfg.means_lr * runner0.scene_scale
    lrs = {
        "means": lambda c: means_lr0 * 0.01 ** (c.astype(jnp.float32) / cfg.max_steps),
        "scales": cfg.scales_lr, "quats": cfg.quats_lr, "opacities": cfg.opacities_lr,
        "sh0": cfg.sh0_lr, "shN": cfg.shN_lr,
    }
    opts = {k: JaxAdam(lrs[k], eps=1e-15) for k in params}
    states = {k: opts[k].init(v) for k, v in params.items()}
    strat = JaxDefault(refine_start_iter=cfg.refine_start_iter, refine_every=cfg.refine_every,
                       reset_every=cfg.reset_every, refine_stop_iter=cfg.refine_stop_iter)
    sstate = strat.initialize_state(live.shape[0], scene_scale=runner0.scene_scale)
    out = []
    for step in range(n_steps):
        view = runner0.trainset[runner0.data_index(step, 0)]
        sh_degree = min(step // cfg.sh_degree_interval, cfg.sh_degree)
        pixels = jnp.asarray(view["image"])[None]
        hooks = types.SimpleNamespace(
            _cur_step=step, normal_start=NORMAL_START, dist_start=DIST_START,
            normal_lambda=runner0.normal_lambda, dist_lambda=runner0.dist_lambda,
        )

        def loss_fn(p, carrier):
            render, alphas, normals, normals_depth, distort, _, meta = jax_r2(
                p["means"], p["quats"], jnp.exp(p["scales"]), jax.nn.sigmoid(p["opacities"]),
                jnp.concatenate([p["sh0"], p["shN"]], axis=1),
                jnp.linalg.inv(jnp.asarray(view["camtoworld"]))[None], jnp.asarray(view["K"])[None],
                W, H, sh_degree=sh_degree, backend="oracle", densify_carrier=carrier, masks=live,
                tile_size=cfg.tile_size, render_mode="RGB+ED", distloss=step >= DIST_START,
            )
            loss = jax_train_loss(render[..., :3], pixels, cfg.ssim_lambda)
            geom = {"normals": normals, "normals_depth": normals_depth, "distort": distort}
            return geom_losses(hooks, loss, geom, alphas), meta["radii"]

        carrier = jnp.zeros((1, live.shape[0], 2), jnp.float32)
        (_, radii), (g, gc) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(params, carrier)
        for k, v in g.items():
            assert np.isfinite(np.asarray(v)).all(), (step, k)
        vis = jnp.any(radii > 0, axis=0)
        for k in params:
            upd, states[k] = opts[k].update(g[k], states[k], params[k], vis)
            params = {**params, k: params[k] + upd}
        meta = {"radii": radii, "width": W, "height": H, "n_cameras": 1}
        params, live, states, sstate = strat.step_post_backward(
            params, live, states, sstate, step, meta, gc, jax.random.PRNGKey(step),
        )
        out.append(({k: np.asarray(v) for k, v in params.items()},
                    {k: (np.asarray(s.mu), np.asarray(s.nu)) for k, s in states.items()}))
    return out


def _mostly_close(got, want, name, atol, max_abs, share):
    d = np.abs(got - want)
    off = d > 1e-4 * np.abs(want) + atol
    assert off.mean() <= share, f"{name}: {off.sum()} of {off.size} values off, max abs {d.max():.3e}"
    assert d.max() <= max_abs, f"{name}: max abs {d.max():.3e} (limit {max_abs:.3e})"


def _runner(backend, views, pts, rgb):
    cfg = st.Config(max_steps=30, sh_degree=2, sh_degree_interval=1, refine_start_iter=100,
                    backend=backend, tile_size=16, pool_headroom=1.0, seed=3)
    runner = Runner2DGS(cfg, views, pts, rgb, scene_scale=1.0, device="cpu",
                        normal_start=NORMAL_START, dist_start=DIST_START)
    runner.probe_isect_capacity()
    # kNN scales are isotropic, so the rotation's true gradient is 0 and
    # Adam would step on rounding noise: make the initial state anisotropic
    with torch.no_grad():
        runner.params["scales"] += torch.from_numpy(
            np.random.default_rng(0).normal(0.0, 0.3, runner.params["scales"].shape).astype(np.float32)
        )
    return runner


def _three_steps():
    """The scene and JAX's three steps from the runners' common initial
    state (create_splats does not depend on the backend)."""
    pts, rgb, views = _scene(2)
    runner = _runner("oracle", views, pts, rgb)
    with torch.no_grad():
        _, alphas, _ = runner.render(torch.from_numpy(views[0]["camtoworld"])[None],
                                     torch.from_numpy(views[0]["K"])[None], W, H)
    assert float(alphas.min()) > 0  # every pixel covered (see the docstring)
    return (pts, rgb, views), _jax_steps(runner, 3)


# computed once per session in the background from collection on
# (tests/torch_prefetch.py): JAX's steps run op by op, ~1 min alone
prefetch.start("three_steps_2dgs", [os.path.abspath(__file__), "--three-steps"])


@pytest.fixture(scope="module")
def three_steps():
    return prefetch.result("three_steps_2dgs")


@pytest.mark.parametrize("backend", ["oracle", "binned"])
def test_three_steps_match_jax(three_steps, backend):
    (pts, rgb, views), want = three_steps
    runner = _runner(backend, views, pts, rgb)
    cfg = runner.cfg
    for step in range(3):
        out = runner.train_step(step)
        assert np.isfinite(float(out["loss"]))
        params, moments = want[step]
        for k, p in runner.params.items():
            lr = runner.optimizers[k].param_groups[0]["lr"]
            lr = cfg.means_lr * runner.scene_scale if callable(lr) else lr
            state = runner.optimizers[k].state[p]
            assert state["step"] == step + 1
            got = [p.detach().numpy(), state["exp_avg"].numpy(), state["exp_avg_sq"].numpy()]
            wants = [params[k], *moments[k]]
            names = [f"step {step} {k}", f"step {step} {k} exp_avg", f"step {step} {k} exp_avg_sq"]
            share = 5e-3 if backend == "oracle" else 2e-2
            for i, (g, w, name) in enumerate(zip(got, wants, names)):
                scale = max(float(np.abs(w).max()), 1e-12)
                if i == 0:
                    _mostly_close(g, w, name, 1e-4 * lr, 2 * lr, share)
                else:
                    _mostly_close(g, w, name, 1e-6 * scale, 1e-2 * scale, share)


def test_runner2dgs_smoke_binned():
    pts, rgb, views = _scene(4)
    cfg = st.Config(max_steps=12, sh_degree=1, sh_degree_interval=5, refine_start_iter=4,
                    refine_every=8, backend="binned", tile_size=32, seed=0, eval_steps=[12])
    runner = Runner2DGS(cfg, views, pts, rgb, scene_scale=1.0, val_views=views, device="cpu",
                        normal_start=3, dist_start=2)
    assert runner.cfg.tile_size == 16 and cfg.tile_size == 32
    runner.probe_isect_capacity()
    # the probe renders surfels: its budget comes from rasterization_2dgs
    p = runner.params
    with torch.no_grad():
        meta = rasterization_2dgs(
            p["means"], p["quats"], torch.exp(p["scales"]), torch.sigmoid(p["opacities"]),
            torch.cat([p["sh0"], p["shN"]], dim=1), torch.linalg.inv(torch.from_numpy(views[0]["camtoworld"]))[None],
            torch.from_numpy(views[0]["K"])[None], W, H, sh_degree=1, masks=runner.live, tile_size=16,
            backend="binned", isect_capacity=4096,
        )[6]
    need = int(meta["slab_required"])
    assert runner.isect_capacity == st._round_up(max(int(need * cfg.isect_headroom * 1.5), 65536), 4096)
    outs = runner.train(log_every=100)
    assert [s for s, o in enumerate(outs) if o["refined"]] == [8]
    for k, v in runner.params.items():
        assert torch.isfinite(v).all(), k
    losses = {}
    for o in outs:
        losses.setdefault(o["image_ids"][0], []).append(float(o["loss"]))
    for view, ls in losses.items():
        assert ls[-1] < ls[1], (view, ls)  # after the step-0 opacity reset
    stats = runner.eval(cfg.max_steps)
    assert np.isfinite(stats["psnr"]) and 0 < stats["ssim"] <= 1
    geom = runner.eval_geometry(cfg.max_steps)
    assert np.isfinite(geom["normal_consistency"]) and geom["distortion"] == 0.0  # render() has no distloss


def test_runner2dgs_needs_cuda_unless_cpu(monkeypatch):
    pts, rgb, views = _scene(5, n=50, n_views=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Runner2DGS(st.Config(), views, pts, rgb, scene_scale=1.0)
    runner = Runner2DGS(st.Config(), views, pts, rgb, scene_scale=1.0, device="cpu")
    assert runner.params["means"].device.type == "cpu"
    assert (runner.normal_start, runner.dist_start) == (7000, 3000)


if __name__ == "__main__" and sys.argv[1:2] == ["--three-steps"]:
    prefetch.as_test_process()
    prefetch.write(sys.argv[sys.argv.index("--out") + 1], _three_steps())
