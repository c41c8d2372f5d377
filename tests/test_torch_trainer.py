"""Port trainer (gsplat_tpu_torch.simple_trainer) vs the JAX trainer.

- create_splats against examples/simple_trainer.py's on the same points
  (scipy's cKDTree against scikit-learn's neighbour distances): values
  within rtol 1e-5, the pool mask equal.
- Three steps from one initial state on a 2-view in-memory scene (300
  points, 48x36): the port's Runner (binned backend, the kernels' plain
  versions) against a JAX step built from rasterization (oracle),
  train_loss, value_and_grad, SelectiveAdam and DefaultStrategy (its
  opacity reset at step 0). Parameters within rtol 1e-4 and atol 1e-4 x
  their learning rate (one Adam step is at most ~lr, and a second step
  whose moments nearly cancel amplifies the gradients' rounding), Adam
  moments within rtol 1e-4 and atol 1e-6 x the array's largest |value|,
  after every step.
- A Runner smoke on the binned backend with refines: finite, the pool
  grows, the loss of a view falls.
- The Runner runs on CUDA unless told device="cpu".
- Two steps on the tiled backend against the binned backend: parameters
  within rtol 1e-5 and atol 1e-5 x their learning rate.
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

from gsplat_tpu import rasterization as jax_rasterization
from gsplat_tpu.losses import train_loss as jax_train_loss
from gsplat_tpu.optimizers import SelectiveAdam as JaxAdam
from gsplat_tpu.strategy import DefaultStrategy as JaxDefault
from gsplat_tpu_torch import rasterization
from gsplat_tpu_torch import simple_trainer as st
from gsplat_tpu_torch.modules import knn_distances, rgb_to_sh, sh_to_rgb
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 36


def _jax_trainer():
    """examples/simple_trainer.py, loaded under its own module name."""
    name = "jax_simple_trainer_for_port_tests"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(_ROOT, "examples", "simple_trainer.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _c2w(x, y):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [x, y, -3.0]
    return m


def _scene(seed=0, n=300, n_views=2):
    """Points, colours and views whose targets are the points rendered as
    opaque splats by the port's oracle."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n, 3)) * 0.5).astype(np.float32)
    rgb = (rng.random((n, 3)) * 255).astype(np.uint8)
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32)
    views = []
    for i in range(n_views):
        c2w = _c2w(0.3 * i, -0.1 * i)
        with torch.no_grad():
            img, _, _ = rasterization(
                torch.from_numpy(pts), torch.tensor([[1.0, 0, 0, 0]]).expand(n, 4),
                torch.full((n, 3), 0.06), torch.full((n,), 0.9),
                torch.from_numpy(rgb.astype(np.float32) / 255.0),
                torch.linalg.inv(torch.from_numpy(c2w))[None], torch.from_numpy(K)[None], W, H,
                backend="oracle",
            )
        views.append({"image": img[0].numpy(), "camtoworld": c2w, "K": K, "image_id": i})
    return pts, rgb, views


def test_knn_and_sh_helpers():
    from sklearn.neighbors import NearestNeighbors

    x = np.random.default_rng(0).standard_normal((500, 3)).astype(np.float32)
    want, _ = NearestNeighbors(n_neighbors=4).fit(x).kneighbors(x)
    np.testing.assert_allclose(knn_distances(x, 4), want, rtol=1e-5, atol=1e-6)
    rgb = np.random.default_rng(1).random((10, 3))
    np.testing.assert_allclose(sh_to_rgb(rgb_to_sh(rgb)), rgb, rtol=1e-12)


@pytest.mark.parametrize("init_type", ["sfm", "random"])
def test_create_splats_matches_jax(init_type):
    pts, rgb, _ = _scene(1)
    jt = _jax_trainer()
    jcfg = jt.Config(init_type=init_type, init_num_pts=200, sh_degree=3)
    tcfg = st.Config(init_type=init_type, init_num_pts=200, sh_degree=3)
    parser = types.SimpleNamespace(points=pts, points_rgb=rgb, scene_scale=1.3)
    cap = 4096
    jp, jl = jt.create_splats(jcfg, parser, cap, jax.random.PRNGKey(0))
    tp, tl = st.create_splats(tcfg, pts, rgb, 1.3, cap, device="cpu")
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tp[k].requires_grad and tp[k].dtype == torch.float32
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def _jax_steps(runner0, n_steps):
    """The JAX trainer's step (examples/simple_trainer.py's step_fn without
    the aux modules) from the Runner's initial state, on the Runner's views
    in the Runner's order. Returns per step (params, moments)."""
    cfg = runner0.cfg
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

        def loss_fn(p, carrier):
            render, alphas, meta = jax_rasterization(
                p["means"], p["quats"], jnp.exp(p["scales"]), jax.nn.sigmoid(p["opacities"]),
                jnp.concatenate([p["sh0"], p["shN"]], axis=1),
                jnp.linalg.inv(jnp.asarray(view["camtoworld"]))[None], jnp.asarray(view["K"])[None],
                W, H, sh_degree=sh_degree, backend="oracle", means2d_carrier=carrier, masks=live,
                tile_size=cfg.tile_size,
            )
            return jax_train_loss(render, pixels, cfg.ssim_lambda), meta["radii"]

        carrier = jnp.zeros((1, live.shape[0], 2), jnp.float32)
        (_, radii), (g, gc) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(params, carrier)
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


def _close(got, want, name, atol=None):
    if atol is None:
        atol = 1e-6 * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=name)


def test_three_steps_match_jax():
    pts, rgb, views = _scene(2)
    cfg = st.Config(max_steps=30, sh_degree=2, sh_degree_interval=1, refine_start_iter=100,
                    backend="binned", tile_size=16, pool_headroom=1.0, seed=3)
    runner = st.Runner(cfg, views, pts, rgb, scene_scale=1.0, device="cpu")
    runner.probe_isect_capacity()
    # kNN scales are isotropic, so the rotation's true gradient is 0 and
    # Adam would step on rounding noise: make the initial state anisotropic
    with torch.no_grad():
        runner.params["scales"] += torch.from_numpy(
            np.random.default_rng(0).normal(0.0, 0.3, runner.params["scales"].shape).astype(np.float32)
        )
    want = _jax_steps(runner, 3)
    for step in range(3):
        out = runner.train_step(step)
        assert np.isfinite(float(out["loss"]))
        params, moments = want[step]
        for k, p in runner.params.items():
            lr = runner.optimizers[k].param_groups[0]["lr"]
            lr = cfg.means_lr * runner.scene_scale if callable(lr) else lr
            _close(p.detach().numpy(), params[k], f"step {step} {k}", atol=1e-4 * lr)
            state = runner.optimizers[k].state[p]
            assert state["step"] == step + 1
            _close(state["exp_avg"].numpy(), moments[k][0], f"step {step} {k} exp_avg")
            _close(state["exp_avg_sq"].numpy(), moments[k][1], f"step {step} {k} exp_avg_sq")


def test_runner_smoke_binned_refines_and_learns():
    pts, rgb, views = _scene(4, n_views=2)
    cfg = st.Config(max_steps=20, sh_degree=1, sh_degree_interval=5, refine_start_iter=4,
                    refine_every=8, grow_grad2d=1e-5, backend="binned", tile_size=16, seed=0,
                    eval_steps=[20])
    runner = st.Runner(cfg, views, pts, rgb, scene_scale=1.0, val_views=views, device="cpu")
    n0 = int(runner.live.sum())
    outs = runner.train(log_every=100)
    assert runner.isect_capacity >= 65536
    assert [s for s, o in enumerate(outs) if o["refined"]] == [8, 16]
    assert int(runner.live.sum()) > n0
    for k, p in runner.params.items():
        assert torch.isfinite(p).all(), k
    losses = {}
    for o in outs:
        losses.setdefault(o["image_ids"][0], []).append(float(o["loss"]))
    for view, ls in losses.items():
        assert ls[-1] < ls[1], (view, ls)  # after the step-0 opacity reset
    stats = runner.eval(cfg.max_steps)
    assert np.isfinite(stats["psnr"]) and 0 < stats["ssim"] <= 1 and stats["num_GS"] == int(runner.live.sum())


def test_runner_step_options():
    """The step's other settings (white background, opacity and scale
    regularisers, absgrad statistics, antialiased projection, a batch of
    two views) run and stay finite."""
    pts, rgb, views = _scene(6, n_views=2)
    cfg = st.Config(max_steps=4, batch_size=2, sh_degree=1, refine_start_iter=1, refine_every=3,
                    grow_grad2d=1e-6, white_bkgd=True, opacity_reg=0.01, scale_reg=0.01,
                    absgrad=True, antialiased=True, backend="binned", seed=1)
    runner = st.Runner(cfg, views, pts, rgb, scene_scale=1.0, device="cpu")
    outs = runner.train(log_every=100)
    assert outs[3]["refined"] and sorted(outs[0]["image_ids"]) == [0, 1]
    assert runner.strategy.absgrad
    for k, p in runner.params.items():
        assert torch.isfinite(p).all(), k


def test_runner_needs_cuda_unless_cpu(monkeypatch):
    pts, rgb, views = _scene(5, n=50, n_views=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.Runner(st.Config(), views, pts, rgb, scene_scale=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.create_splats(st.Config(), pts, rgb, 1.0, 4096)
    runner = st.Runner(st.Config(), views, pts, rgb, scene_scale=1.0, device="cpu")
    assert runner.params["means"].device.type == "cpu"
    # since the tiled slice the Runner takes backend="tiled", with the JAX
    # trainer's initial budget of 4e6 rounded to 4096; other names raise
    tiled = st.Runner(st.Config(backend="tiled"), views, pts, rgb, scene_scale=1.0, device="cpu")
    assert tiled.isect_capacity == 4_001_792
    with pytest.raises(ValueError, match="backend"):
        st.Runner(st.Config(backend="bogus"), views, pts, rgb, scene_scale=1.0, device="cpu")


def test_runner_tiled_matches_binned():
    """Two steps of the Runner on the tiled backend (isect_tiles, the tiled
    kernels' plain versions, the gid reduce) from the same initial state as
    on the binned backend, which test_three_steps_match_jax holds to JAX:
    the tiled stream holds the binned one's entries plus entries that no
    pixel accepts, in the same order, so parameters agree within rtol 1e-5
    and atol 1e-5 x the learning rate. The capacity comes from the probe's
    n_isects and grows from a step's."""
    pts, rgb, views = _scene(2)
    params = {}
    for backend in ("binned", "tiled"):
        cfg = st.Config(max_steps=30, sh_degree=2, sh_degree_interval=1, refine_start_iter=100,
                        backend=backend, tile_size=16, pool_headroom=1.0, seed=3)
        runner = st.Runner(cfg, views, pts, rgb, scene_scale=1.0, device="cpu")
        runner.probe_isect_capacity()
        if backend == "tiled":
            view = views[0]
            meta = runner.render(torch.from_numpy(view["camtoworld"])[None], torch.from_numpy(view["K"])[None], W, H)[2]
            probed = st._round_up(max(int(int(meta["n_isects"]) * 1.5 * 1.5), 65536), 4096)
            assert "slab_required" not in meta and runner.isect_capacity == probed
        with torch.no_grad():
            runner.params["scales"] += torch.from_numpy(
                np.random.default_rng(0).normal(0.0, 0.3, runner.params["scales"].shape).astype(np.float32)
            )
        outs = [runner.train_step(step) for step in range(2)]
        params[backend] = {k: p.detach().clone() for k, p in runner.params.items()}
        if backend == "tiled":
            assert all(o["slab_required"] > 0 for o in outs)  # the steps' n_isects
            runner._grow_isect(runner.isect_capacity)  # a step that needs it all doubles it
            assert runner.isect_capacity == 2 * probed
    for k, want in params["binned"].items():
        lr = cfg.means_lr if k == "means" else getattr(cfg, f"{k}_lr")
        np.testing.assert_allclose(params["tiled"][k].numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * lr, err_msg=k)
