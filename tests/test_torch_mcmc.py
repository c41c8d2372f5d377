"""Port MCMC training (gsplat_tpu_torch.relocation, the MCMC pool operations
of strategy/ops.py, strategy/mcmc.py, Runner(strategy_name="mcmc")) vs the
JAX package.

The draws cannot match JAX's (torch.multinomial is not JAX's categorical),
so the port takes JAX's own draws: the categorical targets of
gsplat_tpu.strategy.ops._sample_targets and the normal draw of the noise,
from the key chain the JAX functions use (k_ref, k_noise = split(key);
k_rel, k_add = split(k_ref)), recorded while JAX's strategy runs.
- make_binoms equal;
- compute_relocation within rtol 1e-5 (atol 1e-7) of JAX for ratios 1-10;
  for ratios 1-51 each package's largest relative error against a float64
  evaluation of Eq. 9 is printed, and the port's is at most JAX's + 2.5e-4
  in each band of ratios (both sum the cancelling terms in float32 in other
  orders: up to ~1e-3 each at ratios 26-51 and opacity 1 - 1e-7); its
  product runs with TF32 off and leaves the caller's switch as it was,
  the same bits whatever the caller set;
- relocate, sample_add, inject_noise_to_position and
  MCMCStrategy.step_post_backward over a schedule, on tests/
  test_strategy.py's pool: parameters within rtol 1e-5 and atol 1e-6,
  `live` equal, the Adam moments within the same tolerance and zeroed at
  the same slots;
- the port's own sampler draws only live slots, in proportion to their
  opacity (chi-square with a 1e-6 false-alarm bound), and with no live
  slot draws slot 0 as JAX's categorical does;
- three Runner(strategy_name="mcmc") steps against a JAX step built as
  tests/test_torch_trainer.py builds it, with JAX's draws: parameters within
  rtol 1e-4 and atol 1e-4 x their learning rate, moments within rtol 1e-4
  and atol 1e-6 x their largest |value|, `live` equal;
- the new entry points run on CUDA unless told device="cpu".
"""

import math

import numpy as np
import pytest
import scipy.stats

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu import rasterization as jax_rasterization
from gsplat_tpu.losses import train_loss as jax_train_loss
from gsplat_tpu.optimizers import SelectiveAdam as JaxAdam
from gsplat_tpu.relocation import compute_relocation as jax_reloc
from gsplat_tpu.relocation import make_binoms as jax_binoms
from gsplat_tpu.strategy import MCMCStrategy as JaxMCMC
from gsplat_tpu.strategy import ops as jops
from gsplat_tpu_torch import simple_trainer as st
from gsplat_tpu_torch.relocation import compute_relocation, make_binoms
from gsplat_tpu_torch.simple_trainer_2dgs import Runner2DGS
from gsplat_tpu_torch.strategy import MCMCStrategy
from gsplat_tpu_torch.strategy import ops as tops

from test_strategy import CAP
from test_strategy import _pool as _jax_pool
from test_torch_strategy import _jax, _torch
from test_torch_trainer import W, H, _scene
from torch_exp_warmup import one_torch_thread, warm_exp  # noqa: F401 (one_torch_thread: an autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-6)
# the JAX step's photometric loss, jitted: eagerly each of its ops compiles
# on its own (~10 of test_runner_mcmc_three_steps_match_jax's ~45 s). The
# rasterization stays eager: jitted, XLA's fusions move its gradients by an
# ulp, and Adam's first step turns a near-zero gradient's sign into +-lr
_JIT_LOSS = jax.jit(jax_train_loss, static_argnums=2)


def _pool(seed, n_live=64, n_dead=10):
    """test_strategy.py's pool (CAP slots, the first n_live live) as numpy,
    `n_dead` of its live slots at opacity 0.001, seeded Adam moments."""
    warm_exp()
    rng = np.random.default_rng(seed)
    params, live = _jax_pool(rng, n_live=n_live)
    params = {k: np.array(v) for k, v in params.items()}
    params["opacities"][rng.choice(n_live, n_dead, replace=False)] = math.log(0.001 / 0.999)
    moments = {k: (rng.standard_normal(p.shape).astype(np.float32),
                   rng.random(p.shape).astype(np.float32)) for k, p in params.items()}
    return params, np.array(live), moments


def _check(jax_side, torch_side):
    (jp, jl, jo), (tp, tl, to) = jax_side, torch_side
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for k in jp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
        state = to[k].state[tp[k]]
        for got, want in ((state["exp_avg"], jo[k].mu), (state["exp_avg_sq"], jo[k].nu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=k, **TOL)
            np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0, err_msg=k)


def _record_draws(monkeypatch):
    """Record every categorical draw of JAX's pool operations, jitted or
    not (through a host callback)."""
    draws = []
    orig = jops._sample_targets

    def recording(*args, **kwargs):
        out = orig(*args, **kwargs)
        jax.debug.callback(lambda x: draws.append(np.array(x)), out, ordered=True)
        return out

    monkeypatch.setattr(jops, "_sample_targets", recording)
    return draws


def test_make_binoms_exact():
    for n in (51, 10):
        got = make_binoms(n, device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_binoms(n)))
    assert float(make_binoms(device="cpu")[50, 25]) == float(np.float32(math.comb(50, 25)))


def _eq9_f64(op, n):
    """Eq. 9 in float64: (new opacity, the scale's factor)."""
    op = op.astype(np.float64)
    new = 1.0 - (1.0 - op) ** (1.0 / n)
    denom = np.zeros_like(op)
    for r in range(op.size):
        for i in range(1, n[r] + 1):
            k = np.arange(i)
            c = np.array([math.comb(i - 1, kk) for kk in k], np.float64)
            denom[r] += np.sum(c * (-1.0) ** k * new[r] ** (k + 1) / np.sqrt(k + 1))
    return new, op / denom


def _reloc_inputs():
    rng = np.random.default_rng(0)
    ops = np.concatenate([[0.005, 0.05, 0.5, 0.9, 0.99, 0.999, 0.99999, 0.9999999],
                          rng.uniform(0.005, 0.999, 8)]).astype(np.float32)
    op = np.repeat(ops, 51)
    ratios = np.tile(np.arange(1, 52), ops.size).astype(np.int32)
    scales = np.exp(rng.standard_normal((op.size, 3))).astype(np.float32)
    return op, scales, ratios


def test_compute_relocation_matches_jax_for_small_ratios():
    op, scales, ratios = _reloc_inputs()
    keep = ratios <= 10
    op, scales, ratios = op[keep], scales[keep], ratios[keep]
    want = jax_reloc(*map(jnp.asarray, (op, scales, ratios)), jax_binoms())
    got = compute_relocation(*map(torch.from_numpy, (op, scales, ratios)), make_binoms(device="cpu"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


def _spy_tf32(monkeypatch):
    """The TF32 switch as each float32 product (Tensor.__matmul__) sees it."""
    seen = []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    return seen


def test_compute_relocation_keeps_the_callers_tf32_switch(monkeypatch):
    """compute_relocation's product runs with TF32 off through allow_tf32
    alone and restores the caller's setting: a caller that has set the
    precision and then sets allow_tf32 between calls (a mix after which
    torch.get_float32_matmul_precision may raise) reads back its own
    setting each time, and the results do not move."""
    op, scales, ratios = (torch.from_numpy(x) for x in _reloc_inputs())
    binoms = make_binoms(device="cpu")
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    seen = _spy_tf32(monkeypatch)
    outs = []
    try:
        torch.set_float32_matmul_precision("high")
        for allow in (True, False, True):
            torch.backends.cuda.matmul.allow_tf32 = allow
            outs.append(compute_relocation(op, scales, ratios, binoms))
            assert torch.backends.cuda.matmul.allow_tf32 is allow
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cuda.matmul.allow_tf32 = before[1]
    assert seen == [False] * 3
    for o in outs[1:]:
        for g, w in zip(o, outs[0]):
            assert torch.equal(g, w)


def test_compute_relocation_error_against_float64():
    """For ratios 1-51 the alternating sums cancel: each package's largest
    relative error against float64, by ratio band; the port's at most JAX's
    + 2.5e-4."""
    op, scales, ratios = _reloc_inputs()
    want_op, want_f = _eq9_f64(op, ratios)
    got = compute_relocation(*map(torch.from_numpy, (op, scales, ratios)), make_binoms(device="cpu"))
    ref = jax_reloc(*map(jnp.asarray, (op, scales, ratios)), jax_binoms())
    errs = {}
    for name, (new_op, new_scales) in (("port", [g.numpy() for g in got]), ("jax", [np.asarray(r) for r in ref])):
        e_op = np.abs(new_op - want_op) / want_op
        e_sc = np.abs(new_scales[:, 0] / scales[:, 0] - want_f) / want_f
        errs[name] = np.maximum(e_op, e_sc)
    for lo, hi in ((1, 10), (11, 25), (26, 51)):
        band = (ratios >= lo) & (ratios <= hi)
        port, jx = float(errs["port"][band].max()), float(errs["jax"][band].max())
        print(f"ratios {lo}-{hi}: max rel error vs float64 port {port:.3e}, JAX {jx:.3e}")
        assert port <= jx + 2.5e-4


def _targets(key, alive, params):
    return np.array(jops._sample_targets(key, jnp.asarray(alive), jax.nn.sigmoid(jnp.asarray(params["opacities"])), CAP))


def test_relocate_matches_jax():
    params, live, moments = _pool(1)
    key = jax.random.PRNGKey(3)
    binoms = jax_binoms()
    dead = live & (1.0 / (1.0 + np.exp(-params["opacities"])) <= 0.005)
    assert dead.sum() >= 10
    jp, jl, jo, _ = _jax(params, live, moments, {})
    jp, jl, jo = jops.relocate(jp, jl, jnp.asarray(dead), key, binoms, jo, min_opacity=0.005)
    tp, tl, to, _ = _torch(params, live, moments, {})
    counts = tops.relocate(tp, tl, torch.from_numpy(dead), make_binoms(device="cpu"), to, 0.005,
                           targets=torch.from_numpy(_targets(key, live & ~dead, params)))
    _check((jp, jl, jo), (tp, tl, to))
    assert int(counts.sum()) == int(dead.sum())
    assert (torch.sigmoid(tp["opacities"])[tl] > 0.005).all()


def test_sample_add_matches_jax():
    params, live, moments = _pool(2)
    key = jax.random.PRNGKey(4)
    jp, jl, jo, _ = _jax(params, live, moments, {})
    jp, jl, jo = jops.sample_add(jp, jl, jnp.asarray(20), key, jax_binoms(), jo, min_opacity=0.005)
    tp, tl, to, _ = _torch(params, live, moments, {})
    counts = tops.sample_add(tp, tl, 20, make_binoms(device="cpu"), to, 0.005,
                             targets=torch.from_numpy(_targets(key, live, params)))
    _check((jp, jl, jo), (tp, tl, to))
    assert int(tl.sum()) == int(live.sum()) + 20 and int(counts.sum()) == 20


def test_inject_noise_matches_jax():
    params, live, moments = _pool(5)
    key = jax.random.PRNGKey(6)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jp = jops.inject_noise_to_position(jp, jnp.asarray(live), key, scaler=88.0)
    z = np.array(jax.random.normal(key, params["means"].shape, jnp.float32))
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tops.inject_noise_to_position(tp, torch.from_numpy(live), 88.0, noise=torch.from_numpy(z))
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
    moved = (tp["means"].numpy() != params["means"]).any(axis=1)
    assert moved.any() and not (moved & ~live).any()  # live means only


def test_step_post_backward_schedule_matches_jax(monkeypatch):
    """Steps 0..7 (refine_start_iter 1, refine_every 3: relocate and grow at
    3 and 6; noise every step) with cap_max 100 in the 128-slot pool."""
    params, live, moments = _pool(7, n_live=80)
    kw = dict(cap_max=100, refine_start_iter=1, refine_every=3)
    jstrat, tstrat = JaxMCMC(**kw), MCMCStrategy(**kw)
    jp, jl, jo, _ = _jax(params, live, moments, {})
    tp, tl, to, _ = _torch(params, live, moments, {})
    js = jstrat.initialize_state(CAP)
    ts = tstrat.initialize_state(CAP, device="cpu")
    draws = _record_draws(monkeypatch)
    refined_at, n_live = [], []
    for step in range(8):
        key = jax.random.PRNGKey(50 + step)
        z = np.array(jax.random.normal(jax.random.split(key)[1], params["means"].shape, jnp.float32))
        lr = 1e-3 * 0.9 ** step
        draws.clear()
        jp, jl, jo, js = jstrat.step_post_backward(jp, jl, jo, js, step, lr, key)
        jax.effects_barrier()
        targets = [torch.from_numpy(d) for d in draws] if draws else None
        if tstrat.step_post_backward(tp, tl, to, ts, step, lr, targets=targets, noise=torch.from_numpy(z)):
            refined_at.append(step)
        _check((jp, jl, jo), (tp, tl, to))
        n_live.append(int(tl.sum()))
    assert refined_at == [3, 6]
    n80 = int(np.float32(1.05) * np.float32(80))
    assert n_live == [80] * 3 + [n80] * 3 + [min(100, int(np.float32(1.05) * np.float32(n80)))] * 2


def test_sampler_draws_live_slots_by_opacity():
    """200,000 draws over 32 slots, 12 of them live with opacities 0.01-0.9:
    only live slots, and counts whose chi-square against opacity / sum is
    below its 1 - 1e-6 quantile."""
    rng = np.random.default_rng(9)
    live = np.zeros(32, bool)
    live[rng.choice(32, 12, replace=False)] = True
    op = rng.uniform(0.01, 0.9, 32).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    n = 200_000
    draws = tops._sample_targets(torch.from_numpy(live), torch.from_numpy(op), n, gen).numpy()
    counts = np.bincount(draws, minlength=32)
    assert counts[~live].sum() == 0
    expected = n * op[live] / op[live].sum()
    chi2 = float(((counts[live] - expected) ** 2 / expected).sum())
    assert chi2 < scipy.stats.chi2.ppf(1 - 1e-6, live.sum() - 1), chi2


def test_no_alive_slot_matches_jax():
    """Every live slot dead: JAX's categorical over all -inf logits draws
    slot 0 every time, and so does the port's sampler (torch.multinomial
    would raise on zero weights); relocate then agrees with JAX."""
    params, live, moments = _pool(8, n_live=16, n_dead=0)
    params["opacities"][:] = math.log(0.001 / 0.999)
    dead = live.copy()
    key = jax.random.PRNGKey(1)
    want = _targets(key, np.zeros(CAP, bool), params)
    assert (want == 0).all()
    got = tops._sample_targets(torch.zeros(CAP, dtype=torch.bool), torch.sigmoid(torch.from_numpy(params["opacities"])), CAP)
    assert (got == 0).all()
    jp, jl, jo, _ = _jax(params, live, moments, {})
    jp, jl, jo = jops.relocate(jp, jl, jnp.asarray(dead), key, jax_binoms(), jo, min_opacity=0.005)
    tp, tl, to, _ = _torch(params, live, moments, {})
    tops.relocate(tp, tl, torch.from_numpy(dead), make_binoms(device="cpu"), to, 0.005,
                  generator=torch.Generator().manual_seed(0))
    _check((jp, jl, jo), (tp, tl, to))


def _jax_mcmc_steps(runner0, n_steps, monkeypatch):
    """The JAX trainer's MCMC step (examples/simple_trainer.py's step_fn,
    then MCMCStrategy.step_post_backward with the decayed means lr) from the
    Runner's initial state. Returns per step (params, moments, live, draws:
    (targets or None, noise))."""
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
    updates = {k: jax.jit(opt.update) for k, opt in opts.items()}  # elementwise: eagerly ~1 s a step
    strat = JaxMCMC(cap_max=cfg.cap_max, noise_lr=cfg.noise_lr, refine_start_iter=cfg.refine_start_iter,
                    refine_stop_iter=25_000, refine_every=cfg.refine_every)
    sstate = strat.initialize_state(live.shape[0])
    draws = _record_draws(monkeypatch)
    out = []
    for step in range(n_steps):
        view = runner0.trainset[runner0.data_index(step, 0)]
        sh_degree = min(step // cfg.sh_degree_interval, cfg.sh_degree)
        pixels = jnp.asarray(view["image"])[None]

        def loss_fn(p):
            render, alphas, meta = jax_rasterization(
                p["means"], p["quats"], jnp.exp(p["scales"]), jax.nn.sigmoid(p["opacities"]),
                jnp.concatenate([p["sh0"], p["shN"]], axis=1),
                jnp.linalg.inv(jnp.asarray(view["camtoworld"]))[None], jnp.asarray(view["K"])[None],
                W, H, sh_degree=sh_degree, backend="oracle", masks=live, tile_size=cfg.tile_size,
            )
            return _JIT_LOSS(render, pixels, cfg.ssim_lambda), meta["radii"]

        (_, radii), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        vis = jnp.any(radii > 0, axis=0)
        for k in params:
            upd, states[k] = updates[k](g[k], states[k], params[k], vis)
            params = {**params, k: params[k] + upd}
        key = jax.random.PRNGKey(100 + step)
        noise = np.array(jax.random.normal(jax.random.split(key)[1], params["means"].shape, jnp.float32))
        lr = cfg.means_lr * runner0.scene_scale * 0.01 ** (step / cfg.max_steps)
        draws.clear()
        params, live, states, sstate = strat.step_post_backward(params, live, states, sstate, step, lr, key)
        jax.effects_barrier()
        out.append(({k: np.asarray(v) for k, v in params.items()},
                    {k: (np.asarray(s.mu), np.asarray(s.nu)) for k, s in states.items()},
                    np.asarray(live), (list(draws) or None, noise)))
    return out


def test_runner_mcmc_three_steps_match_jax(monkeypatch):
    warm_exp()
    pts, rgb, views = _scene(2)
    cfg = st.Config(strategy_name="mcmc", cap_max=1000, max_steps=30, sh_degree=2, sh_degree_interval=1,
                    refine_start_iter=0, refine_every=1, backend="binned", tile_size=16, seed=3)
    runner = st.Runner(cfg, views, pts, rgb, scene_scale=1.0, device="cpu")
    assert runner.live.shape[0] == 4096 and isinstance(runner.strategy, MCMCStrategy)
    assert runner.strategy.refine_stop_iter == 25_000
    runner.probe_isect_capacity()
    with torch.no_grad():
        rng = np.random.default_rng(0)
        runner.params["scales"] += torch.from_numpy(
            rng.normal(0.0, 0.3, runner.params["scales"].shape).astype(np.float32))
        runner.params["opacities"][torch.from_numpy(rng.choice(300, 20, replace=False))] = math.log(0.001 / 0.999)
    want = _jax_mcmc_steps(runner, 3, monkeypatch)
    orig = runner.strategy.step_post_backward
    refined = []

    def with_jax_draws(*args, **kwargs):
        targets, noise = want[args[4]][3]
        kwargs.update(targets=None if targets is None else [torch.from_numpy(t) for t in targets],
                      noise=torch.from_numpy(noise))
        return orig(*args, **kwargs)

    runner.strategy.step_post_backward = with_jax_draws
    n_live = []
    for step in range(3):
        out = runner.train_step(step)
        refined.append(out["refined"])
        assert np.isfinite(float(out["loss"]))
        params, moments, live, _ = want[step]
        np.testing.assert_array_equal(runner.live.numpy(), live)
        n_live.append(int(runner.live.sum()))
        for k, p in runner.params.items():
            lr = runner.optimizers[k].param_groups[0]["lr"]
            lr = cfg.means_lr * runner.scene_scale if callable(lr) else lr
            np.testing.assert_allclose(p.detach().numpy(), params[k], rtol=1e-4, atol=1e-4 * lr,
                                       err_msg=f"step {step} {k}")
            state = runner.optimizers[k].state[p]
            for got, w in zip((state["exp_avg"], state["exp_avg_sq"]), moments[k]):
                np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-6 * max(float(np.abs(w).max()), 1e-12),
                                           err_msg=f"step {step} {k}")
    assert refined == [False, True, True]
    assert n_live == [300, 315, int(np.float32(1.05) * np.float32(315))]


def test_mcmc_entry_points_need_cuda_unless_cpu(monkeypatch):
    pts, rgb, views = _scene(5, n=50, n_views=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MCMCStrategy().initialize_state(CAP)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_binoms()
    with pytest.raises(RuntimeError, match="CUDA"):
        st.Runner(st.Config(strategy_name="mcmc", cap_max=100), views, pts, rgb, scene_scale=1.0)
    state = MCMCStrategy().initialize_state(CAP, device="cpu")
    assert state["binoms"].device.type == "cpu"
    runner = st.Runner(st.Config(strategy_name="mcmc", cap_max=100), views, pts, rgb, scene_scale=1.0, device="cpu")
    assert runner.live.shape[0] == 4096 and runner.params["means"].device.type == "cpu"
    with pytest.raises(ValueError, match="do not fit"):
        st.Runner(st.Config(strategy_name="mcmc", cap_max=10, pool_headroom=1.0), views,
                  np.repeat(pts, 100, axis=0), np.repeat(rgb, 100, axis=0), scene_scale=1.0, device="cpu")
    with pytest.raises(ValueError, match="strategy_name"):
        st.Runner(st.Config(strategy_name="bogus"), views, pts, rgb, scene_scale=1.0, device="cpu")
    with pytest.raises(ValueError, match="default strategy"):
        Runner2DGS(st.Config(strategy_name="mcmc"), views, pts, rgb, scene_scale=1.0, device="cpu")


def test_mcmc_refuses_pools_past_the_sampler_limit():
    """torch.multinomial draws from at most 2^24 categories: the Runner
    refuses a larger MCMC pool before it allocates one, and so does
    MCMCStrategy.initialize_state; a pool of exactly 2^24 slots passes."""
    pts, rgb, views = _scene(5, n=50, n_views=1)
    with pytest.raises(ValueError, match="2\\^24"):
        st.Runner(st.Config(strategy_name="mcmc", cap_max=(1 << 24) + 1), views, pts, rgb, scene_scale=1.0,
                  device="cpu")
    with pytest.raises(ValueError, match="2\\^24"):
        MCMCStrategy().initialize_state((1 << 24) + 4096, device="cpu")
    assert MCMCStrategy().initialize_state(1 << 24, device="cpu")["binoms"].shape == (51, 51)


def test_scale_steps_matches_jax():
    from test_torch_trainer import _jax_trainer

    jcfg = _jax_trainer().Config(steps_scaler=0.25)
    tcfg = st.Config(steps_scaler=0.25)
    jcfg.scale_steps()
    tcfg.scale_steps()
    for name in ("max_steps", "eval_steps", "save_steps", "refine_start_iter", "refine_stop_iter", "reset_every",
                 "refine_every", "sh_degree_interval"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
