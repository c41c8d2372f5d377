"""Where a quality run of the port loses PSNR (the `default` run of
scripts/torch_quality.py's matrix, on its scene).

Trains `default` with the matrix's flags (plus any trainer flags after
``--``) for ``--steps`` steps of a ``--max-steps`` schedule, evaluating at
``--eval-steps`` and printing the loss every 100 steps. Then, for each of
``--views`` (validation views), it writes the render, the ground truth and
the error as PNGs into ``--out`` and prints the view's PSNR and the share
of its squared error that its worst 0.1%, 1% and 5% of pixels hold.
``--split-draws`` hands each refine step's split the JAX trainer's draw
where the file holds one for the pool's size (``python
tests/torch_jax_quality_refs.py draws`` writes it).

    python scripts/torch_quality_diag.py --out build/quality_diag --steps 2000 --eval-steps 1000 2000 \\
        --split-draws build/jax_draws.npz
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_quality  # noqa: E402
from gsplat_tpu_torch import simple_trainer  # noqa: E402
from gsplat_tpu_torch.datasets.image_io import write_png  # noqa: E402

SHARES = (0.001, 0.01, 0.05)


def error_shares(render: np.ndarray, gt: np.ndarray):
    """(PSNR, the share of the squared error held by the worst SHARES of the
    pixels) of two [H, W, 3] images in [0, 1]."""
    err = ((render - gt) ** 2).mean(-1).ravel()
    top = np.sort(err)[::-1]
    total = float(top.sum())
    return -10.0 * np.log10(err.mean()), [float(top[: max(int(len(top) * q), 1)].sum()) / total for q in SHARES]


def use_split_draws(runner, draw) -> None:
    """Make the runner's refines split with ``draw(step, cap)``: the first
    rows of the JAX trainer's [2, cap, 3] draw at that step and pool size,
    or None where there is none (then the port's own draw, said once a
    step); rows past those given come from the runner's generator."""
    refine = runner.strategy.refine

    def with_draws(params, live, optimizers, state, step, generator=None, split_noise=None):
        rows = draw(step, live.shape[0])
        if rows is None:
            print(f"split draws: none for step {step} at {live.shape[0]} slots: the port's own", flush=True)
        else:
            split_noise = torch.from_numpy(rows).to(live.device)
            if rows.shape[1] < live.shape[0]:
                rest = torch.randn((2, live.shape[0], 3), generator=generator, device=live.device)
                split_noise = torch.cat([split_noise, rest[:, rows.shape[1]:]], dim=1)
        return refine(params, live, optimizers, state, step, generator, split_noise)

    runner.strategy.refine = with_draws


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[: argv.index("--")] if "--" in argv else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=os.path.join(torch_quality.ROOT, "build", "torch_quality", "data"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-steps", type=int, default=7000)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--eval-steps", type=int, nargs="*", default=[1000, 2000, 4000])
    ap.add_argument("--views", type=int, nargs="*", default=[0, 3])
    ap.add_argument("--split-draws", default="", help="an .npz of the JAX trainer's split draws")
    args = ap.parse_args(argv)

    torch_quality.write_scene(args.data, args.device)
    os.makedirs(args.out, exist_ok=True)
    cfg = simple_trainer.parse_config(
        torch_quality.run_args("default7k", args.data, os.path.join(args.out, "run"), args.max_steps, [], [])
        + ["--tb-every", "0"] + extra)
    runner = simple_trainer.Runner.from_colmap(cfg, device=args.device)
    runner.probe_isect_capacity()
    if args.split_draws:
        draws = np.load(args.split_draws)
        use_split_draws(runner, lambda step, cap: draws[f"s{step}_c{cap}"] if f"s{step}_c{cap}" in draws.files
                        else None)

    t0 = time.time()
    for step in range(args.steps):
        out = runner.train_step(step)
        if step % 100 == 0:
            print(f"step {step}: loss {float(out['loss']):.6f} live {runner.n_live()} ({time.time() - t0:.1f} s)",
                  flush=True)
        if step + 1 in args.eval_steps:
            print("EVAL", json.dumps(runner.eval(step + 1)), flush=True)

    with torch.no_grad():
        for i in args.views:
            view = runner.valset[i]
            c2w = torch.as_tensor(view["camtoworld"], device=runner.device)[None]
            K = torch.as_tensor(view["K"], device=runner.device)[None]
            H, W = view["image"].shape[:2]
            rgb, alphas, _ = runner.render(c2w, K, W, H)
            img = (rgb + (1.0 - alphas))[0].clamp(0, 1).cpu().numpy()
            psnr, shares = error_shares(img, view["image"])
            print(f"val view {i}: PSNR {psnr:.3f}; the worst "
                  + ", ".join(f"{q:.1%} of the pixels hold {s:.3f}" for q, s in zip(SHARES, shares))
                  + " of the squared error", flush=True)
            err = np.abs(img - view["image"]).mean(-1)
            for name, a in (("render", img), ("gt", view["image"]), ("err8x", np.repeat(err[..., None] * 8, 3, -1))):
                write_png(os.path.join(args.out, f"val{i}_{name}.png"), (np.clip(a, 0, 1) * 255 + 0.5).astype(np.uint8))


if __name__ == "__main__":
    main()
