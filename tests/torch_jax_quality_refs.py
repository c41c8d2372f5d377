"""JAX-side references for the port's quality runs, on the CPU.

``draws``: examples/simple_trainer.py keys step ``s`` with
``fold_in(PRNGKey(seed), s)`` and hands the second half of its split to
the strategy, whose ``refine`` hands the second half of another split to
``ops.split``: a standard normal ``[2, cap, 3]`` of the pool's size
``cap``. `split_draw` makes that array. The command writes the draws of a
range of refine steps at each of the given pool sizes into one ``.npz``,
as ``s{step}_c{cap}`` cut to their first ``--rows`` rows (the slots a
run's parents hold), for ``scripts/torch_quality_diag.py --split-draws``.

``gt``: the quality scene's ground truth (scripts/make_synth_dataset.py's
splats and cameras, as ``gsplat_tpu_torch.datasets.synth --jax-scene``
builds them) rendered for the given views by JAX's tiled kernel, as the
JAX script renders on a TPU (here in interpret mode), and by the port's
binned backend (its plain versions); prints each view's largest
difference in 8-bit levels, the share of pixels more than a level apart
and the mean absolute difference. ~15 s a view.

``train``: the JAX trainer (examples/simple_trainer.py) on that scene
(``--data``, written by ``python -m gsplat_tpu_torch.datasets.synth
--jax-scene --n-views 64 --width 648 --height 420 --n-points 60000
--device cpu``, ~10 min) with the quality matrix's ``default`` flags and
the JAX run's tile size 32, on the binned backend in interpret mode (~6 s
a step here), to ``--steps`` with evaluations at 1000 and 2000 below it;
``stats.jsonl`` every 100 steps and the evaluations go to ``--out``.

    python tests/torch_jax_quality_refs.py draws --out build/jax_draws.npz \
        --steps 600 2000 100 --caps 122880 983040 --rows 262144
    python tests/torch_jax_quality_refs.py gt --views 0 8
    python tests/torch_jax_quality_refs.py train --data DATA --out OUT --steps 1000
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def split_draw(seed: int, step: int, cap: int) -> np.ndarray:
    """The standard normal [2, cap, 3] that the JAX trainer's refine at
    `step` splits with."""
    _, k_strat = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step))
    _, k_split = jax.random.split(k_strat)
    return np.asarray(jax.random.normal(k_split, (2, cap, 3), jnp.float32))


def write_draws(args) -> None:
    draws = {f"s{s}_c{c}": split_draw(args.seed, s, c)[:, : args.rows]
             for s in range(*args.steps) for c in args.caps}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **draws)
    print(f"wrote {len(draws)} draws to {args.out}")


def compare_gt(args) -> None:
    import torch

    sys.path.insert(0, ROOT)
    import gsplat_tpu
    from gsplat_tpu_torch import load_test_data
    from gsplat_tpu_torch.datasets import synth
    from gsplat_tpu_torch.rendering import rasterization

    means, _, _, _, colors, *_ = load_test_data()
    splats, _ = synth.jax_scene(means, colors, 120_000, args.n_points, 3)
    K, w2cs = synth.circle_cameras(np.asarray(splats["means"], np.float64), args.n_views, args.width, args.height)
    names = ("means", "quats", "scales", "opacities", "colors")
    for v in args.views:
        vm = np.asarray(w2cs[v:v + 1], np.float32)
        want = gsplat_tpu.rasterization(
            *(jnp.asarray(splats[k]) for k in names), jnp.asarray(vm), jnp.asarray(K, jnp.float32)[None],
            args.width, args.height, backgrounds=jnp.ones((1, 3), jnp.float32), backend="tiled",
            isect_capacity=2**21)[0]
        t = {k: torch.as_tensor(np.asarray(splats[k], np.float32)) for k in names}
        got = rasterization(*(t[k] for k in names), torch.as_tensor(vm), torch.as_tensor(K, dtype=torch.float32)[None],
                            args.width, args.height, backgrounds=torch.ones((1, 3)), backend="binned",
                            isect_capacity=2**22)[0]
        a, b = np.asarray(want[0]), got[0].numpy()
        levels = np.abs((np.clip(a, 0, 1) * 255).astype(np.int32) - (np.clip(b, 0, 1) * 255).astype(np.int32))
        print(f"view {v}: largest difference {levels.max()} levels, {(levels > 1).mean():.6f} of the values more "
              f"than one level apart, mean |difference| {np.abs(a - b).mean():.3e}", flush=True)


def train(args) -> None:
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_simple_trainer", os.path.join(ROOT, "examples",
                                                                                       "simple_trainer.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    cfg = mod.Config(data_dir=args.data, data_factor=1, result_dir=args.out, white_bkgd=True, test_every=8,
                     max_steps=7000, eval_steps=[s for s in (1000, 2000) if s <= args.steps], save_steps=[],
                     backend="binned", tile_size=32, tb_every=0)
    runner = mod.Runner(cfg)
    post = runner.strategy.step_post_backward

    class Done(Exception):
        pass

    def stop_at(*a):
        if a[4] >= args.steps:  # the step, after the evaluation at `steps`
            raise Done()
        return post(*a)

    runner.strategy.step_post_backward = stop_at
    try:
        runner.train()
    except Done:
        pass


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("draws", help="the JAX trainer's split draws into an .npz")
    d.add_argument("--out", required=True)
    d.add_argument("--seed", type=int, default=42, help="the trainer's --seed")
    d.add_argument("--steps", type=int, nargs=3, default=[600, 2000, 100], metavar=("FIRST", "STOP", "EVERY"))
    d.add_argument("--caps", type=int, nargs="+", default=[122880, 983040], help="pool sizes")
    d.add_argument("--rows", type=int, default=262144, help="rows kept of each draw")
    g = sub.add_parser("gt", help="the quality scene's ground truth, JAX's tiled kernel against the port")
    g.add_argument("--views", type=int, nargs="+", default=[0])
    g.add_argument("--n-views", type=int, default=64)
    g.add_argument("--width", type=int, default=648)
    g.add_argument("--height", type=int, default=420)
    g.add_argument("--n-points", type=int, default=60000)
    t = sub.add_parser("train", help="the JAX trainer's default run on that scene, on the CPU")
    t.add_argument("--data", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--steps", type=int, default=1000)
    args = ap.parse_args(argv)
    {"draws": write_draws, "gt": compare_gt, "train": train}[args.cmd](args)


if __name__ == "__main__":
    main()
