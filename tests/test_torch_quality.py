"""The port's quality-matrix driver (scripts/torch_quality.py), on the CPU.

- (a) Each run's trainer arguments parse to the JAX run's committed
  ``results/quality_r5/{default7k,mcmc30k}/cfg.json``, field for field,
  but ``data_dir`` and ``result_dir`` (the machine's paths) and
  ``tile_size`` (the port's 16; the JAX run used 32).
- (b) A toy matrix (4 views of 64x48, 2,000 ground-truth splats, 1,000
  points; ``default`` and ``mcmc`` to step 30 with evaluations at 15 and
  30 and saves at 15 and 30, MCMC's with ``--compression png``; the
  binned backend's plain versions, not the O(pool x pixels) oracle)
  writes and persists every file the driver keeps, and nothing it must
  not keep; each run's validation PSNR rises from step 15 to 30.
- (c) The default run resumed from its step-15 checkpoint gives the
  uninterrupted run's ``val_step30.json``.

TensorBoard is off in the toy runs (importing it imports TensorFlow, ~7 s).
"""

import glob
import json
import os
import sys

import pytest
import torch

from gsplat_tpu_torch import simple_trainer

from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_quality  # noqa: E402

# the fields the port's run may differ in from the JAX run's cfg.json
NOT_COMPARED = {"data_dir", "result_dir", "tile_size"}

TOY = ["--device", "cpu", "--n-views", "4", "--width", "64", "--height", "48", "--n-points", "1000",
       "--gt-splats", "2000", "--backend", "binned", "--cap-max", "2000",
       "--default-steps", "30", "--default-eval-steps", "15", "30", "--default-save-steps", "15", "30",
       "--mcmc-steps", "30", "--mcmc-eval-steps", "15", "30", "--mcmc-save-steps", "15", "30"]
KEPT = {
    "default7k": ["cfg.json", "stats.jsonl", "train.log", "val_step15.json", "val_step30.json"],
    "mcmc30k": ["cfg.json", "stats.jsonl", "train.log", "val_step15.json", "val_step30.json",
                "compression_15/report.json", "compression_30/report.json"]
    + [f"compress_eval/val_step30_{v}.json" for v in ("uncompressed", "unsorted", "serpentine", "serpentine+plas")],
}


@pytest.mark.parametrize("run", torch_quality.RUNS)
def test_arguments_match_the_jax_run(run):
    with open(os.path.join(ROOT, "results", "quality_r5", run, "cfg.json")) as f:
        want = json.load(f)
    got = vars(simple_trainer.parse_config(torch_quality.run_args(run, "DATA", "OUT")))
    assert sorted(got) == sorted(want)
    diff = {k: (got[k], want[k]) for k in want if k not in NOT_COMPARED and got[k] != want[k]}
    assert not diff
    assert (got["tile_size"], want["tile_size"]) == (16, 32)


def _driver(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(simple_trainer.Runner, "_tb", property(lambda self: None))
        return torch_quality.main(argv)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    base = tmp_path_factory.mktemp("quality")
    paths = {k: str(base / k) for k in ("data", "out", "results")}
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as one_torch_thread does for a test
    try:
        _driver(TOY + [f"--{k}={v}" for k, v in paths.items()])
    finally:
        torch.set_num_threads(n)
    return paths


def _val(results, run, step):
    with open(os.path.join(results, run, f"val_step{step}.json")) as f:
        return json.load(f)


def test_toy_matrix_persists_its_evidence(toy):
    res = toy["results"]
    for run, names in KEPT.items():
        for name in names:
            assert os.path.isfile(os.path.join(res, run, name)), (run, name)
        kept = glob.glob(os.path.join(res, run, "**", "*"), recursive=True)
        assert not [p for p in kept if p.endswith((".npz", ".ply", ".png"))], run
        with open(os.path.join(res, run, "train.log")) as f:
            log = f.read()
        assert f"[torch_quality] {run}" in log and "EVAL" in log
        cfg = json.load(open(os.path.join(res, run, "cfg.json")))
        assert cfg["strategy_name"] == run.rstrip("0123456789k") and cfg["max_steps"] == 30
        assert _val(res, run, 30)["psnr"] > _val(res, run, 15)["psnr"], run
    assert json.load(open(os.path.join(res, "mcmc30k", "compression_30", "report.json")))["size_bytes"] > 0
    with open(os.path.join(res, "compression.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0] == "variant,n_gaussians,bytes,psnr,ssim" and len(rows) == 5
    # the checkpoints stay in --out
    assert os.path.isfile(os.path.join(toy["out"], "mcmc30k", "ckpt_30.npz"))
    assert torch_quality.newest_checkpoint(toy["out"]).endswith(os.path.join("mcmc30k", "ckpt_30.npz"))


def test_resumed_run_matches_the_uninterrupted_one(toy, tmp_path):
    ckpt = os.path.join(toy["out"], "default7k", "ckpt_15.npz")
    res = str(tmp_path / "results")
    _driver(TOY + ["--data", toy["data"], "--out", str(tmp_path / "out"), "--results", res, "--runs", "default7k",
                   "--resume-default", ckpt, "--no-compress-eval"])
    got, want = _val(res, "default7k", 30), _val(toy["results"], "default7k", 30)
    assert not os.path.exists(os.path.join(res, "default7k", "val_step15.json"))
    for k in ("step", "psnr", "ssim", "num_GS"):
        assert got[k] == want[k], k
