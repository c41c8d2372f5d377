"""Port pool surgery and DefaultStrategy (gsplat_tpu_torch.strategy) vs the
JAX package's.

A 64-slot pool with holes, seeded numpy parameters, Adam moments and
running statistics go through both packages: the JAX functions return new
arrays, the port updates its tensors (and its SelectiveAdam states) in
place. Masks and slot indices must be equal exactly, values within 1e-6.
The split's noise is JAX's own draw (jax.random.normal of the key the JAX
function splits), handed to the port.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu.optimizers.selective_adam import SelectiveAdamState
from gsplat_tpu.strategy import DefaultStrategy as JaxDefault
from gsplat_tpu.strategy import ops as jops
from gsplat_tpu_torch.optimizers import SelectiveAdam
from gsplat_tpu_torch.strategy import DefaultStrategy
from gsplat_tpu_torch.strategy import ops as tops
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

CAP = 64
SHAPES = {"means": (3,), "scales": (3,), "quats": (4,), "opacities": (), "sh0": (1, 3), "shN": (3, 3)}
TOL = dict(rtol=1e-6, atol=1e-6)


def _pool(seed, n_live=40):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal((CAP,) + s).astype(np.float32) for k, s in SHAPES.items()}
    params["scales"] = (np.log(0.05) + rng.standard_normal((CAP, 3))).astype(np.float32)
    live = np.zeros(CAP, bool)
    live[:n_live] = True
    live[rng.choice(n_live, 6, replace=False)] = False  # holes inside the live range
    moments = {k: (rng.standard_normal(p.shape).astype(np.float32),
                   rng.random(p.shape).astype(np.float32)) for k, p in params.items()}
    state = {
        "grad2d": (rng.random(CAP) * 4e-4).astype(np.float32),
        "count": rng.integers(0, 4, CAP).astype(np.float32),
        "scene_scale": 1.5,
    }
    return params, live, moments, state


def _jax(params, live, moments, state):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    opt = {k: SelectiveAdamState(jnp.asarray(3, jnp.int32), jnp.asarray(m), jnp.asarray(n))
           for k, (m, n) in moments.items()}
    st = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in state.items()}
    return p, jnp.asarray(live), opt, st


def _torch(params, live, moments, state):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opts = {}
    for k, t in p.items():
        opts[k] = SelectiveAdam([t], lr=1e-3)
        m, n = moments[k]
        opts[k].state[t] = {"step": 3, "exp_avg": torch.tensor(m), "exp_avg_sq": torch.tensor(n)}
    st = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in state.items()}
    return p, torch.from_numpy(live.copy()), opts, st


def _check(jax_side, torch_side):
    (jp, jl, jo, js), (tp, tl, to, ts) = jax_side, torch_side
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for k in jp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
        st = to[k].state[tp[k]]
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(jo[k].mu), err_msg=k, **TOL)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(jo[k].nu), err_msg=k, **TOL)
        assert st["step"] == int(jo[k].count)
    for k in js:
        if k != "scene_scale":
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("n_cand", [5, 30])
@pytest.mark.parametrize("use_priority", [False, True])
def test_pair_free_slots_matches_jax(n_cand, use_priority):
    """Fewer candidates than free slots, and more (priority decides)."""
    rng = np.random.default_rng(n_cand)
    live = rng.random(CAP) < 0.7
    cand = np.zeros(CAP, bool)
    cand[rng.choice(np.flatnonzero(live), n_cand, replace=False)] = True
    prio = rng.random(CAP).astype(np.float32) if use_priority else None
    want = jops.pair_free_slots(jnp.asarray(live), jnp.asarray(cand), None if prio is None else jnp.asarray(prio))
    got = tops.pair_free_slots(torch.from_numpy(live), torch.from_numpy(cand),
                               None if prio is None else torch.from_numpy(prio))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) == min(n_cand, int((~live).sum()))


@pytest.mark.parametrize("n_cand", [4, 30])
def test_duplicate_matches_jax(n_cand):
    params, live, moments, state = _pool(1)
    rng = np.random.default_rng(2)
    mask = np.zeros(CAP, bool)
    mask[rng.choice(np.flatnonzero(live), n_cand, replace=False)] = True
    prio = state["grad2d"]
    jp, jl, jo, js = _jax(params, live, moments, state)
    jp, jl, jo, js = jops.duplicate(jp, jl, jnp.asarray(mask), jo, js, priority=jnp.asarray(prio))
    tp, tl, to, ts = _torch(params, live, moments, state)
    tops.duplicate(tp, tl, torch.from_numpy(mask), to, ts, priority=torch.from_numpy(prio))
    _check((jp, jl, jo, js), (tp, tl, to, ts))


@pytest.mark.parametrize("revised_opacity", [False, True])
def test_split_matches_jax(revised_opacity):
    params, live, moments, state = _pool(3)
    rng = np.random.default_rng(4)
    mask = np.zeros(CAP, bool)
    mask[rng.choice(np.flatnonzero(live), 9, replace=False)] = True
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (2, CAP, 3), jnp.float32))
    jp, jl, jo, js = _jax(params, live, moments, state)
    jp, jl, jo, js = jops.split(jp, jl, jnp.asarray(mask), key, jo, js, revised_opacity=revised_opacity,
                                priority=jnp.asarray(state["grad2d"]))
    tp, tl, to, ts = _torch(params, live, moments, state)
    tops.split(tp, tl, torch.from_numpy(mask), to, ts, revised_opacity=revised_opacity,
               priority=torch.from_numpy(state["grad2d"]), noise=torch.from_numpy(noise))
    _check((jp, jl, jo, js), (tp, tl, to, ts))


def test_split_draws_its_own_noise():
    params, live, moments, state = _pool(3)
    mask = torch.zeros(CAP, dtype=torch.bool)
    mask[:3] = True
    tp, tl, to, ts = _torch(params, live, moments, state)
    tops.split(tp, tl, mask, to, ts, generator=torch.Generator().manual_seed(0))
    assert int(tl.sum()) == int(live.sum()) + int((mask.numpy() & live).sum())
    assert torch.isfinite(tp["means"]).all()


def test_remove_and_reset_opa_match_jax():
    params, live, moments, state = _pool(5)
    mask = np.random.default_rng(6).random(CAP) < 0.3
    jp, jl, jo, js = _jax(params, live, moments, state)
    jl = jops.remove(jl, jnp.asarray(mask))
    jp, jo = jops.reset_opa(jp, jl, 0.01, jo)
    tp, tl, to, ts = _torch(params, live, moments, state)
    tops.remove(tl, torch.from_numpy(mask))
    tops.reset_opa(tp, tl, 0.01, to)
    _check((jp, jl, jo, js), (tp, tl, to, ts))
    assert not to["opacities"].state[tp["opacities"]]["exp_avg"].any()


def test_update_state_matches_jax():
    rng = np.random.default_rng(8)
    C = 2
    v = rng.standard_normal((C, CAP, 2)).astype(np.float32) * 1e-4
    radii = (rng.integers(0, 5, (C, CAP)) * (rng.random((C, CAP)) > 0.3)).astype(np.int32)
    meta = {"width": 64, "height": 48, "n_cameras": C}
    for stop in (0, 100):  # without and with the radii statistic
        js_ = JaxDefault(refine_scale2d_stop_iter=stop)
        ts_ = DefaultStrategy(refine_scale2d_stop_iter=stop)
        jst = js_.initialize_state(CAP)
        tst = ts_.initialize_state(CAP, device="cpu")
        for _ in range(2):
            jst = js_.update_state(jst, dict(meta, radii=jnp.asarray(radii)), jnp.asarray(v))
            ts_.update_state(tst, dict(meta, radii=torch.from_numpy(radii)), torch.from_numpy(v))
        assert sorted(jst) == sorted(tst)
        for k in jst:
            if k != "scene_scale":
                np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("step,stop2d", [(5, 0), (700, 0), (50, 100)])
def test_refine_matches_jax(step, stop2d):
    """Grow + prune, with and without the too-big prune (step > reset_every)
    and the 2D-radius split (step < refine_scale2d_stop_iter)."""
    params, live, moments, state = _pool(9)
    strat_kw = dict(reset_every=600, refine_scale2d_stop_iter=stop2d, grow_grad2d=2e-4)
    if stop2d:
        state["radii"] = (np.random.default_rng(10).random(CAP) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(step)
    noise = np.asarray(jax.random.normal(jax.random.split(key)[1], (2, CAP, 3), jnp.float32))
    jp, jl, jo, js = _jax(params, live, moments, state)
    jp, jl, jo, js = JaxDefault(**strat_kw).refine(jp, jl, jo, js, step, key)
    tp, tl, to, ts = _torch(params, live, moments, state)
    DefaultStrategy(**strat_kw).refine(tp, tl, to, ts, step, split_noise=torch.from_numpy(noise))
    _check((jp, jl, jo, js), (tp, tl, to, ts))
    assert not np.array_equal(np.asarray(jl), live)


def test_step_post_backward_schedule_matches_jax():
    """Steps 0..12: statistics every step, refine at 3, 6 and 9 (start 2,
    every 3), opacity reset at 0 and 6, nothing from refine_stop_iter 11."""
    params, live, moments, state = _pool(11)
    kw = dict(refine_start_iter=2, refine_every=3, reset_every=6, refine_stop_iter=11)
    jstrat, tstrat = JaxDefault(**kw), DefaultStrategy(**kw)
    jp, jl, jo, _ = _jax(params, live, moments, state)
    tp, tl, to, _ = _torch(params, live, moments, state)
    js = jstrat.initialize_state(CAP, scene_scale=1.5)
    ts = tstrat.initialize_state(CAP, scene_scale=1.5, device="cpu")
    rng = np.random.default_rng(12)
    refined_at = []
    for step in range(13):
        v = (rng.standard_normal((1, CAP, 2)) * 3e-4).astype(np.float32)
        radii = (rng.integers(1, 5, (1, CAP)) * (rng.random((1, CAP)) > 0.2)).astype(np.int32)
        meta = {"width": 64, "height": 48, "n_cameras": 1}
        key = jax.random.PRNGKey(100 + step)
        noise = np.asarray(jax.random.normal(jax.random.split(key)[1], (2, CAP, 3), jnp.float32))
        jp, jl, jo, js = jstrat.step_post_backward(
            jp, jl, jo, js, step, dict(meta, radii=jnp.asarray(radii)), jnp.asarray(v), key,
        )
        if tstrat.step_post_backward(
            tp, tl, to, ts, step, dict(meta, radii=torch.from_numpy(radii)), torch.from_numpy(v),
            split_noise=torch.from_numpy(noise),
        ):
            refined_at.append(step)
        _check((jp, jl, jo, js), (tp, tl, to, ts))
    assert refined_at == [3, 6, 9]


def test_check_sanity():
    params, live, _, _ = _pool(13)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tl = torch.from_numpy(live)
    DefaultStrategy().check_sanity(tp, tl)
    with pytest.raises(KeyError, match="quats"):
        DefaultStrategy().check_sanity({k: v for k, v in tp.items() if k != "quats"}, tl)
    with pytest.raises(ValueError, match="rows"):
        DefaultStrategy().check_sanity(dict(tp, sh0=tp["sh0"][:-1]), tl)


def test_initialize_state_needs_cuda_unless_cpu(monkeypatch):
    """The strategy's state goes on the card by default, as the trainer's
    parameters do; without one the default raises and device="cpu" works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DefaultStrategy().initialize_state(CAP)
    with pytest.raises(RuntimeError, match="CUDA"):
        DefaultStrategy(refine_scale2d_stop_iter=100).initialize_state(CAP, scene_scale=2.0)
    state = DefaultStrategy(refine_scale2d_stop_iter=100).initialize_state(CAP, scene_scale=2.0, device="cpu")
    assert sorted(state) == ["count", "grad2d", "radii", "scene_scale"]
    assert all(state[k].device.type == "cpu" and state[k].shape == (CAP,) for k in ("count", "grad2d", "radii"))
    assert state["scene_scale"] == 2.0
