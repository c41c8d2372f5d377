"""The quality matrix on the port (the counterpart of scripts/run_quality_r5.sh):
the synthetic garden scene, ``default`` to 7k and ``mcmc`` to 30k with
``--compression png``, then the compression round trip of the newest
checkpoint, with the reference's flags letter for letter.

    python scripts/torch_quality.py                      # on the card
    python scripts/torch_quality.py --runs default7k     # one run
    python scripts/torch_quality.py --runs mcmc30k --resume-mcmc OUT/mcmc30k/ckpt_15000.npz

Steps, as in the shell script:

1. ``python -m gsplat_tpu_torch.datasets.synth --jax-scene --n-views 64
   --width 648 --height 420 --n-points 60000`` into ``--data``, unless
   ``sparse/0/cameras.bin`` is there already;
2. ``default``: ``--data-factor 1 --white-bkgd --test-every 8 --max-steps
   7000 --eval-steps 1000 2000 4000 7000 --save-steps 4000 7000``;
3. ``mcmc``: the same scene flags with ``--cap-max 300000 --max-steps 30000
   --eval-steps 7000 15000 30000 --save-steps 15000 30000 --compression png``;
4. ``scripts/torch_compress_eval.py`` on the newest checkpoint, its CSV in
   ``--results``/compression.csv.

Each run trains in this process through ``simple_trainer.run_main`` (which
also evaluates at ``max_steps``, as the JAX trainer's ``main`` does) into
``--out``/RUN, its standard output teed into ``train.log``. Every 60 s and
after each step, ``cfg.json``, ``stats.jsonl``, ``val_step*.json``,
``train.log``, the trainer's ``compression_*/report.json`` and
compress_eval's ``val_step*_*.json`` are copied into ``--results``/RUN;
checkpoints, PLYs and compressed PNGs stay in ``--out``. A run cut short
keeps what was copied. ``--resume-default`` / ``--resume-mcmc`` continue a
run from its checkpoint (the trainer's ``--resume``; its draws are seeded
by step, so a resumed run draws what an uninterrupted one would). The
scene-size and step-list options shrink the matrix for a test on the CPU
(``--device cpu``).
"""

import argparse
import contextlib
import glob
import importlib.util
import os
import re
import shutil
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gsplat_tpu_torch import simple_trainer  # noqa: E402
from gsplat_tpu_torch.datasets import synth  # noqa: E402

RUNS = ("default7k", "mcmc30k")
PERSIST_EVERY_S = 60.0


def run_args(run: str, data: str, result_dir: str, steps=None, eval_steps=None, save_steps=None,
             cap_max=None, resume: str = "", backend: str = ""):
    """The trainer's argument list of ``run`` (the reference's flags, with
    the step lists, MCMC's cap and the backend replaced where given; an
    empty list is a list)."""

    def steps_of(given, ref):
        return [str(v) for v in (ref if given is None else given)]
    base = ["--data-dir", data, "--data-factor", "1", "--white-bkgd", "--test-every", "8"]
    if run == "default7k":
        args = ["default"] + base + ["--max-steps", str(steps or 7000),
                                     "--eval-steps", *steps_of(eval_steps, (1000, 2000, 4000, 7000)),
                                     "--save-steps", *steps_of(save_steps, (4000, 7000))]
    elif run == "mcmc30k":
        args = ["mcmc"] + base + ["--cap-max", str(cap_max or 300000), "--max-steps", str(steps or 30000),
                                  "--eval-steps", *steps_of(eval_steps, (7000, 15000, 30000)),
                                  "--save-steps", *steps_of(save_steps, (15000, 30000)),
                                  "--compression", "png"]
    else:
        raise ValueError(f"unknown run {run!r}; the runs are {RUNS}")
    args += ["--result-dir", result_dir] + (["--backend", backend] if backend else [])
    return args + (["--resume", resume] if resume else [])


def write_scene(data: str, device: str, n_views=64, width=648, height=420, n_points=60000, gt_splats=None) -> None:
    """Step 1: the scene into ``data``, unless ``sparse/0/cameras.bin`` is
    there already."""
    if not os.path.exists(os.path.join(data, "sparse", "0", "cameras.bin")):
        synth.main(["--jax-scene", "--out", data, "--n-views", str(n_views), "--width", str(width),
                    "--height", str(height), "--n-points", str(n_points), "--device", device]
                   + ([] if gt_splats is None else ["--gt-splats", str(gt_splats)]))


def persist(out: str, results: str) -> None:
    """Copy each run's evidence from ``out`` into ``results`` (never a
    checkpoint, a PLY or a compressed PNG)."""
    for run in RUNS:
        src = os.path.join(out, run)
        names = ["cfg.json", "stats.jsonl", "train.log"]
        files = [os.path.join(src, n) for n in names] + sorted(glob.glob(os.path.join(src, "val_step*.json")))
        files += sorted(glob.glob(os.path.join(src, "compression_*", "report.json")))
        # only compress_eval's suffixed evaluations: a bare val_step file is
        # one that compress_eval had not renamed yet
        files += sorted(glob.glob(os.path.join(src, "compress_eval", "val_step*_*.json")))
        for f in files:
            if not os.path.isfile(f):
                continue
            dst = os.path.join(results, run, os.path.relpath(f, src))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(f, dst)


class _Tee:
    """A text stream that writes to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def newest_checkpoint(out: str) -> str:
    """The checkpoint compress_eval reads: MCMC's highest step, else the
    default run's ("" where neither saved one)."""
    for run in ("mcmc30k", "default7k"):
        ckpts = glob.glob(os.path.join(out, run, "ckpt_*.npz"))
        if ckpts:
            return max(ckpts, key=lambda p: int(re.search(r"ckpt_(\d+)\.npz$", p).group(1)))
    return ""


def _compress_eval():
    spec = importlib.util.spec_from_file_location("torch_compress_eval",
                                                  os.path.join(ROOT, "scripts", "torch_compress_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=os.path.join(ROOT, "build", "torch_quality", "data"),
                    help="the scene (written there unless sparse/0/cameras.bin exists)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "torch_quality", "out"),
                    help="the runs' result directories: checkpoints, PLYs, compressed splats")
    ap.add_argument("--results", default=os.path.join(ROOT, "results", "torch_quality_r1"),
                    help="where the evidence is copied")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the kernels' plain versions")
    ap.add_argument("--runs", nargs="+", default=list(RUNS), choices=RUNS)
    ap.add_argument("--no-compress-eval", action="store_true", help="skip step 4")
    ap.add_argument("--resume-default", default="", help="a default7k checkpoint to resume from")
    ap.add_argument("--resume-mcmc", default="", help="an mcmc30k checkpoint to resume from")
    scene = ap.add_argument_group("the scene's size (the reference's by default)")
    scene.add_argument("--n-views", type=int, default=64)
    scene.add_argument("--width", type=int, default=648)
    scene.add_argument("--height", type=int, default=420)
    scene.add_argument("--n-points", type=int, default=60000)
    scene.add_argument("--gt-splats", type=int, default=None, help="synth's --gt-splats (default: its own)")
    steps = ap.add_argument_group("the step lists (the reference's by default)")
    for run in ("default", "mcmc"):
        steps.add_argument(f"--{run}-steps", type=int, default=None, help="--max-steps")
        steps.add_argument(f"--{run}-eval-steps", type=int, nargs="*", default=None)
        steps.add_argument(f"--{run}-save-steps", type=int, nargs="*", default=None)
    steps.add_argument("--cap-max", type=int, default=None, help="MCMC's --cap-max")
    steps.add_argument("--backend", default="", help="the trainer's --backend (default its own: auto, binned on "
                       "the card; binned keeps a CPU run off the O(pool x pixels) oracle)")
    args = ap.parse_args(argv)

    write_scene(args.data, args.device, args.n_views, args.width, args.height, args.n_points, args.gt_splats)
    os.makedirs(args.results, exist_ok=True)

    stop = threading.Event()

    def watcher():
        while not stop.wait(PERSIST_EVERY_S):
            persist(args.out, args.results)

    threading.Thread(target=watcher, daemon=True).start()
    runners = {}
    try:
        for run in args.runs:
            key = run.rstrip("0123456789k")
            result_dir = os.path.join(args.out, run)
            os.makedirs(result_dir, exist_ok=True)
            argv_run = run_args(run, args.data, result_dir, getattr(args, f"{key}_steps"),
                                getattr(args, f"{key}_eval_steps"), getattr(args, f"{key}_save_steps"),
                                args.cap_max, getattr(args, f"resume_{key}"), args.backend)
            cfg = simple_trainer.parse_config(argv_run)
            with open(os.path.join(result_dir, "train.log"), "a") as log:
                tee = _Tee(sys.stdout, log)
                with contextlib.redirect_stdout(tee):
                    print(f"[torch_quality] {run}: simple_trainer {' '.join(argv_run)}", flush=True)
                    runners[run] = simple_trainer.run_main(simple_trainer.Runner, cfg, args.device,
                                                           lambda r: r.eval(cfg.max_steps))
            persist(args.out, args.results)
        ckpt = newest_checkpoint(args.out)
        if ckpt and not args.no_compress_eval:
            _compress_eval().main(["--ckpt", ckpt, "--data-dir", args.data,
                                   "--out-csv", os.path.join(args.results, "compression.csv")]
                                  + (["--cpu"] if args.device == "cpu" else []))
    finally:
        stop.set()
        persist(args.out, args.results)
    return runners


if __name__ == "__main__":
    main()
