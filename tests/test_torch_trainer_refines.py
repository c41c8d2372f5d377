"""The port's trainer against the JAX trainer (examples/simple_trainer.py)
through refines that prune slots and then fill them again, on the CPU.

The scene is tests/torch_synth_scene.py's (5 train views of 64x48, 300
points in a 4,096-slot pool). The schedule is the quality matrix's cut
short: refines at steps 4, 6 and 8 (``refine_start_iter`` 2,
``refine_every`` 2) and an initial opacity of 0.006, so the refine at step 4 prunes splats whose opacity fell
under 0.005 and those at 6 and 8 place new splats in some of the freed
slots. The JAX trainer (binned backend, interpret mode) runs from step 0.
The port starts from its state after step 5 (splats, live mask, Adam
moments and counts, statistics, intersection budget) and runs steps 6-9
on the binned backend's plain versions, splitting with the JAX trainer's
draws (tests/torch_jax_quality_refs.py). After step 9:
- the live masks are equal: both refines chose, pruned and placed alike;
- the validation view's renders agree within 1e-4;
- each parameter lies within 1e-3 x its learning rate of JAX's on at least
  90% of the live rows, and within 2 x its learning rate on every row. A
  splat whose gradient is rounding noise (the rotation of an isotropic
  splat) takes a step of about its learning rate whose sign is the noise's:
  on this scene 22 of 511 rotations lie up to 0.96 x lr apart, 2 means
  0.38 x lr. The colours of splats with a channel exactly at the clamp's
  edge are not held (ROADMAP Queue 3 item 10's known tie: the port passes
  half the gradient there, JAX's jitted step none; 36 rows here, up to 1.70
  x lr).

The second test runs the same schedule with the SH degree rising from 0 to
1 at step 8 (``sh_degree_interval`` 8 of the matrix's ``sh_degree`` 3), as
the quality runs' degree first rises at step 1000, on a refine step: the
port follows JAX through steps 6-9 by the same measures, and the rise
moves shN.
"""

import os
import sys

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import simple_trainer as st
from gsplat_tpu_torch.modules import SH_C0

from test_torch_trainer import _jax_trainer
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_jax_quality_refs import split_draw
from torch_synth_scene import scene_dir

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

from torch_quality_diag import use_split_draws  # noqa: E402

START, STOP = 5, 9  # the port runs steps START+1 .. STOP
SEED = 42
INIT_OPA = 0.006
LR = {"means": 1.6e-4, "scales": 5e-3, "quats": 1e-3, "opacities": 5e-2, "sh0": 2.5e-3, "shN": 2.5e-3 / 20}
SHARE, CAP = 0.9, 2.0


def _config(interval=1000, **kw):
    return dict(data_dir=scene_dir(), data_factor=1, white_bkgd=True, test_every=8, max_steps=100,
                eval_steps=[], save_steps=[], sh_degree_interval=interval, refine_start_iter=2, refine_every=2,
                reset_every=1000, backend="binned", seed=SEED, tile_size=16, tb_every=0, init_opa=INIT_OPA, **kw)


class _Stop(Exception):
    pass


def _at_edge(sh0):
    """Rows with a degree-0 colour channel exactly at the clamp's edge."""
    colour = np.asarray(sh0)[:, 0] * SH_C0 + 0.5
    return ((colour == 0.0) | (colour == 1.0)).any(axis=-1)


def _jax_run(result_dir, interval=1000):
    """The JAX Runner trained to STOP; returns (runner, its state after
    START, the live masks before and after each step, the rows at the
    clamp's edge after any of steps START..STOP)."""
    mod = _jax_trainer()
    runner = mod.Runner(mod.Config(result_dir=result_dir, **_config(interval)))
    step_post_backward = runner.strategy.step_post_backward
    caught, masks = {}, {}
    edge = np.zeros(runner.live.shape, bool)

    def spb(params, live, opt_states, state, step, meta, v_means2d, key):
        out = step_post_backward(params, live, opt_states, state, step, meta, v_means2d, key)
        masks[step] = (np.asarray(live), np.asarray(out[1]))
        if START <= step <= STOP:
            edge[:] |= _at_edge(out[0]["sh0"])
        if step == START:
            p, lv, opts, s = out
            caught.update(
                params={k: np.asarray(v) for k, v in p.items()}, live=np.asarray(lv),
                moments={k: (int(o.count), np.asarray(o.mu), np.asarray(o.nu)) for k, o in opts.items()},
                grad2d=np.asarray(s["grad2d"]), count=np.asarray(s["count"]), isect=runner.isect_capacity)
        if step == STOP:
            runner.params, runner.live = out[0], out[1]
            raise _Stop()
        return out

    runner.strategy.step_post_backward = spb
    with pytest.raises(_Stop):
        runner.train()
    return runner, caught, masks, edge


def _port_from(state, interval=1000):
    runner = st.Runner.from_colmap(st.Config(result_dir=None, **_config(interval)), device="cpu")
    runner.set_state({k: v.copy() for k, v in state["params"].items()}, state["live"].copy())
    for k, p in runner.params.items():
        count, mu, nu = state["moments"][k]
        runner.optimizers[k].state[p] = {"step": count, "exp_avg": torch.from_numpy(mu.copy()),
                                         "exp_avg_sq": torch.from_numpy(nu.copy())}
    runner.strategy_state["grad2d"].copy_(torch.from_numpy(state["grad2d"]))
    runner.strategy_state["count"].copy_(torch.from_numpy(state["count"]))
    runner.isect_capacity = state["isect"]
    use_split_draws(runner, lambda step, cap: split_draw(SEED, step, cap))
    return runner


def test_refines_that_reuse_pruned_slots_follow_jax(tmp_path):
    jax_runner, state, masks, _ = _jax_run(str(tmp_path / "jax"))
    # the schedule does what the test is for: a prune, then freed slots filled
    before, after = masks[4]
    freed = before & ~after
    assert freed.sum() > 0
    filled = [(~masks[s][0] & masks[s][1] & freed).sum() for s in (6, 8)]
    assert sum(filled) > 0, filled

    port = _port_from(state)
    for step in range(START + 1, STOP + 1):
        port.train_step(step)
    _assert_follows(port, jax_runner, _at_edge(jax_runner.params["sh0"]))


def test_sh_degree_rise_follows_jax(tmp_path):
    interval = 8
    jax_runner, state, _, edge = _jax_run(str(tmp_path / "jax"), interval)
    assert [min(s // interval, 3) for s in range(START + 1, STOP + 1)] == [0, 0, 1, 1]
    port = _port_from(state, interval)
    for step in range(START + 1, STOP + 1):
        port.train_step(step)
    live = np.asarray(jax_runner.live)
    # the rise moved shN: degree-1 coefficients of live splats left their values at START
    rows = live & state["live"]
    moved = np.abs(np.asarray(jax_runner.params["shN"])[rows, :3] - state["params"]["shN"][rows, :3]).max(axis=(1, 2))
    assert (moved > 1e-2 * LR["shN"]).mean() > 0.5, (moved > 1e-2 * LR["shN"]).mean()
    # the rise moves tied colours off the edge, so the rows tied at any step are not held
    _assert_follows(port, jax_runner, edge)


def _assert_follows(port, jax_runner, at_edge):
    live = np.asarray(jax_runner.live)
    assert np.array_equal(port.live.numpy(), live)

    for k, p in port.params.items():
        lr = LR[k] * (port.scene_scale if k == "means" else 1.0)
        rows = live & ~at_edge if k == "sh0" else live
        d = np.abs(p.detach().numpy() - np.asarray(jax_runner.params[k]))[rows].reshape(int(rows.sum()), -1)
        d = d.max(axis=1) / lr
        assert (d <= 1e-3).mean() >= SHARE and d.max() <= CAP, (k, (d <= 1e-3).mean(), d.max())

    view = port.valset[0]
    H, W = view["image"].shape[:2]
    c2w, K = view["camtoworld"][None], view["K"][None]
    rgb, _, _ = port.render(torch.as_tensor(c2w), torch.as_tensor(K), W, H)
    want, _, _ = jax_runner.render(c2w, K, W, H)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want), rtol=0, atol=1e-4)
