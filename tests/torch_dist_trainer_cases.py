"""Shared harness of tests/test_torch_trainer_distributed.py: the port's
multi-GPU training (gsplat_tpu_torch.simple_trainer{,_2dgs} with
``distributed=True``) in 4 gloo ranks on the CPU.

Every case trains on tests/torch_synth_scene.py's scene (5 train views of
64x48, 300 points; binned backend, the kernels' plain versions). The port's
side runs in one spawn of 4 rank processes (``python
tests/torch_dist_trainer_cases.py --rank r ...``, one intra-op thread
each), once per test session, through tests/torch_dist_cases.py's
`spawn_ranks` and `once_per_session` (its fcntl lock in the directory that
pytest-xdist's workers share). The spawn runs, in order:

1. each rank's share of the single-device references and of the world-size-1
   pairs (a one-rank gloo group and the single-device runner, step by step);
2. every 4-rank case (``CASES``), each rank's results with the whole pool
   gathered to rank 0 after every step;
3. the constructor's refusals (a 3-rank group, batch sizes, packed);
4. ``simple_trainer.main`` with ``--distributed`` under the environment
   ``torch.distributed.run`` sets, each rank with its own result directory.

Every case starts from the port's single-device initial state of its
configuration with an anisotropic noise on the scales (`port_initial_state`,
the same in every process); the JAX trainer takes it too (`jax_runner`).
"""

from __future__ import annotations

import argparse
import functools
import os
import pickle
import sys
import tempfile
import time
import traceback

import numpy as np

from torch_dist_cases import N_RANKS, free_port, once_per_session, spawn_ranks

AUX_ON = dict(depth_loss=True, pose_opt=True, app_opt=True, use_bilateral_grid=True, pose_opt_lr=1e-3)
BASE = dict(data_factor=1, tile_size=16, seed=3, eval_steps=[], save_steps=[], sh_degree=1, sh_degree_interval=1000,
            backend="binned", tb_every=0)
# refines from step 2, every 2 steps, growing every live Gaussian whose
# statistic is not zero: splits and duplicates (grow_scale3d, set per case,
# parts them)
REFINE = dict(refine_start_iter=1, refine_every=2, grow_grad2d=1e-9)


def _case(dim, steps, cfg, **kw):
    return dict(dim=dim, steps=steps, cfg=cfg, **kw)


# 4-rank cases. jax: held to JAX's Runner(distributed=True) on 8 CPU
# devices (batch 4: JAX cuts strips, the port takes whole cameras); else
# to the port's single-device runner. Keys past the config: normal_start /
# dist_start (2DGS), pack0 (the packed exchange's first capacity), dup
# (grow_scale3d at the initial scales' median, so that a refine both
# duplicates and splits)
CASES = {
    "jax-3dgs": _case("3dgs", 3, dict(batch_size=4, refine_start_iter=100, **AUX_ON), jax=True),
    "jax-2dgs": _case("2dgs", 3, dict(batch_size=4, refine_start_iter=100, **AUX_ON), jax=True,
                      normal_start=100, dist_start=1),
    "strips": _case("3dgs", 3, dict(batch_size=1, tile_size=8, refine_start_iter=100, depth_loss=True,
                                    pose_opt=True, pose_opt_lr=1e-3, use_bilateral_grid=True)),
    "packed": _case("3dgs", 4, dict(batch_size=4, packed=True, refine_start_iter=100, depth_loss=True,
                                    pose_opt=True, pose_opt_lr=1e-3, opacity_reg=0.01, scale_reg=0.01), pack0=8),
    "mcmc": _case("3dgs", 4, dict(batch_size=4, strategy_name="mcmc", cap_max=4000, refine_start_iter=1,
                                  refine_every=2)),
    "refine": _case("3dgs", 5, dict(batch_size=4, random_bkgd=True, **REFINE), dup=True),
    "growth": _case("3dgs", 4, dict(batch_size=2, pool_grow_at=0.05, app_opt=True, **REFINE), dup=True),
    "2dgs": _case("2dgs", 3, dict(batch_size=4, **REFINE), normal_start=0, dist_start=0, dup=True),
}
# one-rank groups against the single-device runner, one a rank, in parallel
WORLD1 = {
    "3dgs-aux-refine-growth": _case("3dgs", 5, dict(batch_size=2, pool_grow_at=0.05, random_bkgd=True,
                                                    opacity_reg=0.01, scale_reg=0.01, **AUX_ON, **REFINE), dup=True),
    "2dgs-geometry": _case("2dgs", 3, dict(batch_size=2, **REFINE), normal_start=0, dist_start=0, dup=True),
    "mcmc": CASES["mcmc"],
    "3dgs-tiled-strips-of-one": _case("3dgs", 3, dict(batch_size=1, backend="tiled", depth_loss=True, **REFINE),
                                      dup=True),
}
# resumed at step 4: refines at 3 and 6 with splits (the step generator),
# every aux module, random backgrounds
RESUME = _case("3dgs", 8, dict(batch_size=4, refine_start_iter=2, refine_every=3, grow_grad2d=1e-9,
                               sh_degree_interval=2, random_bkgd=True, save_steps=[4], **AUX_ON))
RESUME_AT = 4
# the constructor's refusals at 4 ranks: name -> (config, message)
REFUSALS = {
    "batch-3": (dict(batch_size=3), "divide one another"),
    "packed-batch-2": (dict(batch_size=2, packed=True), "whole cameras"),
    "packed-app-opt": (dict(batch_size=4, packed=True, app_opt=True), "SH colours"),
}


def config(spec, scene, result_dir, **kw):
    from gsplat_tpu_torch import simple_trainer as st

    return st.Config(data_dir=scene, result_dir=result_dir, max_steps=spec["steps"], **{**BASE, **spec["cfg"], **kw})


def runner_cls(spec):
    from gsplat_tpu_torch.simple_trainer import Runner
    from gsplat_tpu_torch.simple_trainer_2dgs import Runner2DGS

    return Runner if spec["dim"] == "3dgs" else Runner2DGS


def make_runner(spec, scene, result_dir, group=None, **kw):
    """The port's Runner (or Runner2DGS) of the case: on one device, or a
    rank of ``group`` (None: the default group) with ``distributed=True``."""
    cfg = config(spec, scene, result_dir, **kw)
    extra = {k: spec[k] for k in ("normal_start", "dist_start") if k in spec}
    if cfg.distributed:
        extra["group"] = group
    return runner_cls(spec).from_colmap(cfg, device="cpu", **extra)


def scale_noise(shape):
    """kNN scales are isotropic, so the rotations' true gradient is 0 and
    Adam would step on rounding noise: an anisotropic start, as in
    tests/test_torch_trainer_colmap.py."""
    return np.random.default_rng(0).normal(0.0, 0.3, shape).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy().copy()


@functools.lru_cache(maxsize=None)
def port_initial_state(name, scene):
    """A case's initial state (global numpy params, live, aux params): the
    single-device runner's, the scales' noise added."""
    spec = {**CASES, **WORLD1, "resume": RESUME}[name]
    r = make_runner(spec, scene, tempfile.mkdtemp(prefix="init_"))
    params = {k: _np(v) for k, v in r.params.items()}
    params["scales"] = params["scales"] + scale_noise(params["scales"].shape)
    aux = {m: {n: _np(p) for n, p in mod.named_parameters()} for m, mod in r.aux.items()}
    return params, _np(r.live), aux


def prepare(runner, spec, init):
    """Start ``runner`` from ``init`` (the whole pool: each rank keeps its
    rows), with the case's packed capacity and duplicate threshold, and
    probe its intersection budget."""
    import copy

    # set_state's tensors on one device share the arrays' memory, and the
    # initial states are cached
    params, live, aux = copy.deepcopy(init)
    runner.set_state(params, live, aux or None)
    if "pack0" in spec:
        runner.pack_capacity = spec["pack0"]
    if spec.get("dup"):
        s = np.exp(params["scales"][live]).max(axis=-1)
        runner.strategy.grow_scale3d = float(np.median(s)) / runner.strategy_state["scene_scale"]
    runner.probe_isect_capacity()
    return runner


def state(runner):
    """The whole pool (gathered to rank 0: every rank calls it), the aux
    modules and their optimizers, as numpy; None on the other ranks."""
    import torch

    whole = runner._gather_pool()
    if runner.rank != 0:
        return None
    out = {k: _np(v) for k, v in whole.items()}
    for m, mod in runner.aux.items():
        out.update({f"aux/{m}/{n}": _np(p) for n, p in mod.named_parameters()})
        for idx, s in runner.aux_optimizers[m].state_dict()["state"].items():
            out.update({f"aux_adam/{m}/{idx}/{k}": _np(v) for k, v in s.items() if isinstance(v, torch.Tensor)})
    out["pack_capacity"] = np.asarray(runner.pack_capacity)
    out["isect_capacity"] = np.asarray(runner.isect_capacity or 0)
    return out


def learning_rates(runner):
    """{state key prefix: learning rate} for the tolerances (the means' at
    count 0)."""
    cfg = runner.cfg
    lrs = {}
    for k, opt in runner.optimizers.items():
        lr = opt.param_groups[0]["lr"]
        lrs[f"splat/{k}"] = cfg.means_lr * runner.scene_scale if callable(lr) else lr
    for m, opt in runner.aux_optimizers.items():
        lrs[f"aux/{m}/"] = opt.param_groups[0]["lr"]
    return lrs


def run_steps(runner, steps, record_every_step=False, start=0):
    """Train steps ``start`` to ``steps - 1``: per step the loss, whether it
    refined and grew, the packed exchange's need and capacity after it, the
    host's ms; the state after every step (or after the last)."""
    import torch

    out = {"losses": [], "refined": [], "grew": [], "ms": [], "states": [], "pack": [], "pack_required": []}
    for step in range(start, steps):
        t0 = time.perf_counter()
        o = runner.train_step(step)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(o["loss"]))
        out["refined"].append(bool(o["refined"]))
        out["grew"].append(bool(o["pool_grew"]))
        out["pack"].append(runner.pack_capacity)
        out["pack_required"].append(o["pack_required"])
        if record_every_step or step == steps - 1:
            out["states"].append(state(runner))
    out["n_live"] = runner.n_live()
    out["pool_size"] = runner.pool_size
    out["lrs"] = learning_rates(runner)
    out["finite"] = all(bool(torch.isfinite(p).all()) for p in runner.params.values())
    return out


# --- the port's side: one rank ----------------------------------------------


def _single(name, spec, scene, work):
    """The single-device reference of a case (its initial state: the JAX
    trainer's for the JAX cases)."""
    init = port_initial_state(name, scene)
    r = prepare(make_runner(spec, scene, os.path.join(work, f"single-{name}")), spec, init)
    return run_steps(r, spec["steps"], record_every_step=True)


def _packed(spec, scene, work):
    """The packed case at 4 ranks from its first capacity (pack0: step 0 is
    truncated and the capacity grows), a checkpoint after step 0, then the
    rest of its steps; on rank 0 the single-device runner loaded from that
    checkpoint trains the same steps."""
    init = port_initial_state("packed", scene)
    r = prepare(make_runner(spec, scene, os.path.join(work, "packed"), distributed=True), spec, init)
    first = run_steps(r, 1, record_every_step=True)
    ckpt = r.save(1)
    rest = run_steps(r, spec["steps"], record_every_step=True, start=1)
    out = {k: first[k] + rest[k] if isinstance(first[k], list) else rest[k] for k in rest}
    if r.rank == 0:
        one = make_runner(spec, scene, os.path.join(work, "packed-single"))
        one.load(ckpt)
        out["single"] = run_steps(one, spec["steps"], record_every_step=True, start=1)
    return out


def _world1(name, spec, scene, work, group):
    """The case in a one-rank group and on one device: whether every loss
    and every array of the state after every step is the same bits."""
    init = port_initial_state(name, scene)
    one = run_steps(prepare(make_runner(spec, scene, os.path.join(work, f"w1-{name}"), group, distributed=True),
                            spec, init), spec["steps"], record_every_step=True)
    single = run_steps(prepare(make_runner(spec, scene, os.path.join(work, f"w1s-{name}")), spec, init),
                       spec["steps"], record_every_step=True)
    diffs = []
    for s, (a, b) in enumerate(zip(one["states"], single["states"])):
        if sorted(a) != sorted(b):
            diffs.append(f"step {s}: keys {sorted(set(a) ^ set(b))}")
            continue
        diffs += [f"step {s}: {k}" for k in a if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k])]
    return {"losses": (one["losses"], single["losses"]), "diffs": diffs, "refined": one["refined"],
            "grew": one["grew"], "pool_size": (one["pool_size"], single["pool_size"])}


def _resume(scene, work):
    """RESUME at 4 ranks: steps 0-3, the state and a checkpoint at step 4,
    steps 4-7; then a runner resumed from that checkpoint trains 4-7. On
    rank 0: the checkpoint's arrays and a single-device load of it."""
    import torch.distributed as dist

    spec = RESUME
    init = port_initial_state("resume", scene)
    a = prepare(make_runner(spec, scene, os.path.join(work, "resume-a"), distributed=True), spec, init)
    first = run_steps(a, RESUME_AT, record_every_step=False)
    at = state(a)
    ckpt = a.save(RESUME_AT)
    dist.barrier()
    losses_a, refined_a = [], []
    for step in range(RESUME_AT, spec["steps"]):
        o = a.train_step(step)
        losses_a.append(float(o["loss"]))
        refined_a.append(bool(o["refined"]))
    end_a = state(a)
    b = make_runner(spec, scene, os.path.join(work, "resume-b"), distributed=True, resume=ckpt, save_steps=[])
    outs = b.train(log_every=1000)
    end_b = state(b)
    res = {"first": first["losses"], "losses": (losses_a, [float(o["loss"]) for o in outs]),
           "refined": (first["refined"] + refined_a, [bool(o["refined"]) for o in outs]),
           "end": (end_a, end_b), "at": at}
    if a.rank == 0:
        f = np.load(ckpt)
        res["ckpt"] = {k: f[k] for k in f.files}
        one = make_runner(spec, scene, os.path.join(work, "resume-single"))
        assert one.load(ckpt) == RESUME_AT and not one.distributed
        res["single_load"] = state(one)
        res["single_load_cap"] = (one.pool_size, one.world_size)
        res["files"] = sorted(os.listdir(os.path.join(work, "resume-a")))
    return res


def _refusals(scene, work, rank):
    """The constructor's ValueErrors: a 3-rank group (capacity 4096 % 3),
    and at 4 ranks the batch and packed configurations of REFUSALS."""
    import torch.distributed as dist

    out = {}
    three = dist.new_group([0, 1, 2])
    if rank < 3:
        try:
            make_runner(_case("3dgs", 1, dict(batch_size=3)), scene, os.path.join(work, "refuse3"), three,
                        distributed=True)
            out["cap-3"] = None
        except ValueError as e:
            out["cap-3"] = str(e)
    for name, (kw, _) in REFUSALS.items():
        try:
            make_runner(_case("3dgs", 1, kw), scene, os.path.join(work, "refuse"), distributed=True)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    dist.barrier()
    return out


def _main(scene, work, rank, port):
    """simple_trainer.main with --distributed as torch.distributed.run
    starts it (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), each
    rank's own result directory: which files each rank wrote."""
    from gsplat_tpu_torch import simple_trainer as st

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(N_RANKS), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    out = os.path.join(work, "main", f"rank{rank}")
    argv = ["default", "--data-dir", scene, "--data-factor", "1", "--result-dir", out, "--max-steps", "2",
            "--eval-steps", "2", "--save-steps", "2", "--render-traj", "--pose-opt", "--seed", "3",
            "--backend", "binned", "--batch-size", "4", "--distributed", "--tb-every", "0"]
    runner = st.main(argv, device="cpu")
    import torch.distributed as dist

    return {"files": sorted(os.listdir(out)) if os.path.isdir(out) else None,
            "videos": sorted(os.listdir(os.path.join(out, "videos"))) if os.path.isdir(os.path.join(out, "videos"))
            else None,
            "group_destroyed": not dist.is_initialized(), "world_size": runner.world_size, "rank": runner.rank,
            "stats": open(os.path.join(out, "stats.jsonl")).read() if rank == 0 else None}


def rank_main(rank, port, main_port, scene, work, out_path):
    os.environ["OMP_NUM_THREADS"] = "1"
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.exp(torch.zeros(1 << 20))  # tests/torch_exp_warmup.py's warm-up
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=N_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    results, name = {}, None
    try:
        groups = [dist.new_group([r]) for r in range(N_RANKS)]
        jobs = [("single/" + n, s) for n, s in CASES.items() if not s.get("jax") and n != "packed"]
        jobs += [("world1/" + n, s) for n, s in WORLD1.items()]
        for name, spec in jobs[rank::N_RANKS]:
            t0 = time.perf_counter()
            kind, case = name.split("/")
            results[name] = (_single(case, spec, scene, work) if kind == "single"
                             else _world1(case, spec, scene, work, groups[rank]))
            results[name]["seconds"] = time.perf_counter() - t0
        for name, spec in CASES.items():
            t0 = time.perf_counter()
            if name == "packed":
                results[name] = _packed(spec, scene, work)
            else:
                r = prepare(make_runner(spec, scene, os.path.join(work, name), distributed=True), spec,
                            port_initial_state(name, scene))
                results[name] = run_steps(r, spec["steps"], record_every_step=True)
            results[name]["seconds"] = time.perf_counter() - t0
        name = "resume"
        results[name] = _resume(scene, work)
        name = "refusals"
        results[name] = _refusals(scene, work, rank)
        name = "main"
        dist.destroy_process_group()
        results[name] = _main(scene, work, rank, main_port)
    except Exception:
        results["__error__"] = f"rank {rank}, case {name}:\n{traceback.format_exc()}"
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


def _spawn(scene, out_dir):
    argv = ["--port", str(free_port()), "--main-port", str(free_port()), "--scene", scene, "--work", out_dir]
    per_rank = spawn_ranks("torch_dist_trainer_cases.py", argv, out_dir)
    if isinstance(per_rank, dict):
        return per_rank
    merged = {}
    for pr in per_rank:
        for k, v in pr.items():
            if k.startswith(("single/", "world1/")):
                merged[k] = v
    for k in list(CASES) + ["resume", "refusals", "main"]:
        merged[k] = [pr[k] for pr in per_rank]
    return merged


def port_results(tmp_path_factory):
    """{case: [rank 0's result, ...]} and {"single/...", "world1/...": the
    result}, from the one spawn of the session."""
    from torch_synth_scene import scene_dir

    return once_per_session(tmp_path_factory, "torch_dist_trainer", lambda work: _spawn(scene_dir(), work))


# --- the JAX side -------------------------------------------------------------


def _jax_modules():
    from test_torch_trainer import _jax_trainer
    from test_torch_trainer_2dgs import _jax_trainer_2dgs

    return _jax_trainer(), _jax_trainer_2dgs()


@functools.lru_cache(maxsize=None)
def jax_runner(name, scene, distributed=True):
    """JAX's Runner (Runner2DGS) with ``distributed=True`` on conftest's 8
    CPU devices (or on one device) for a JAX case, started from the port's
    initial state of the case (`port_initial_state`: its splats sharded as
    JAX shards them, its aux modules' parameters, the optimizers' states
    anew). Built once per process."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gsplat_tpu.datasets import colmap_native
    from gsplat_tpu_torch import simple_trainer as st

    spec = CASES[name]
    jt, jt2 = _jax_modules()
    real = colmap_native._build_and_load, jt.knn_distances
    # the Python COLMAP reader (the native one compiles with g++ first) and
    # the kNN through scipy, as tests/test_torch_trainer_colmap.py does
    colmap_native._build_and_load = lambda: None
    jt.knn_distances = st.knn_distances
    try:
        cfg = jt.Config(data_dir=scene, result_dir=tempfile.mkdtemp(prefix="jax_"), distributed=distributed,
                        max_steps=spec["steps"], **{k: v for k, v in {**BASE, **spec["cfg"]}.items()
                                                    if k not in ("backend",)})
        if spec["dim"] == "3dgs":
            runner = jt.Runner(cfg)
        else:
            runner = jt2.Runner2DGS(cfg, normal_start=spec["normal_start"], dist_start=spec["dist_start"])
    finally:
        colmap_native._build_and_load, jt.knn_distances = real
    assert (runner.mesh is not None) == distributed
    params, live, aux = port_initial_state(name, scene)
    assert sorted(params) == sorted(runner.params) and live.shape == runner.live.shape
    shard = NamedSharding(runner.mesh, P("gauss")) if distributed else None
    runner.params = {k: jax.device_put(jnp.asarray(v), shard) for k, v in params.items()}
    runner.live = jax.device_put(jnp.asarray(live), shard)
    runner._build_optimizers()
    if distributed:
        runner.opt_states = jax.tree.map(
            lambda x: jax.device_put(x, shard) if getattr(x, "ndim", 0) >= 1 and x.shape[0] == live.shape[0] else x,
            runner.opt_states)
    for m, p in runner.aux_params.items():
        trainable = {k for k, v in p.items() if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating)}
        assert trainable == set(aux[m]), (m, sorted(trainable), sorted(aux[m]))
        runner.aux_params[m] = {**p, **{k: jnp.asarray(v) for k, v in aux[m].items()}}
        runner.aux_states[m] = runner.aux_txs[m].init({k: runner.aux_params[m][k] for k in trainable})
    return runner, jax_state(runner)


def jax_state(r):
    return {
        "params": {k: np.asarray(v) for k, v in r.params.items()},
        "moments": {k: (np.asarray(s.mu), np.asarray(s.nu)) for k, s in r.opt_states.items()},
        "aux": {m: {k: np.asarray(v) for k, v in p.items()} for m, p in r.aux_params.items()},
        "live": np.asarray(r.live),
    }


@functools.lru_cache(maxsize=None)
def jax_steps(name, scene, distributed=True):
    """The JAX runner's states after each of its `train` steps."""
    runner, init = jax_runner(name, scene, distributed)
    snaps = []
    grow = runner._maybe_grow

    def snapshot(*args, **kwargs):
        snaps.append(jax_state(runner))
        return grow(*args, **kwargs)

    runner._maybe_grow = snapshot
    runner.train()
    return init, snaps


def spread(name):
    """Prints, after each step of a JAX case, how far two runs lie from
    JAX's mesh run, array by array: JAX's Runner on one device (JAX's own
    two layouts) and the port's single-device runner (which the 4 ranks
    equal at the strict tolerances). Per array: the share of values past
    tests/test_torch_trainer_distributed.py's tolerance against JAX (rtol
    1e-4, atol 1e-3 x the learning rate or 1e-5 x the largest |value|) and
    the largest error over the learning rate or the largest |value|. The
    readings behind that file's 2DGS gates:
    ``python tests/torch_dist_trainer_cases.py --spread jax-2dgs``."""
    from torch_synth_scene import scene_dir

    scene = scene_dir()
    spec = CASES[name]
    _, mesh = jax_steps(name, scene)
    _, one = jax_steps(name, scene, distributed=False)
    runner = prepare(make_runner(spec, scene, tempfile.mkdtemp(prefix="spread_")), spec,
                     port_initial_state(name, scene))
    lrs = learning_rates(runner)
    port = run_steps(runner, spec["steps"], record_every_step=True)["states"]

    def reading(got, want, lr):
        scale = max(float(np.abs(want).max()), 1e-12)
        d = np.abs(got - want)
        off = float((d > 1e-4 * np.abs(want) + (1e-3 * lr if lr else 1e-5 * scale)).mean())
        return f"{off:.4f} {float(d.max()) / (lr or scale):.3e}"

    print("step array: JAX one device (share past, max error) | the port's one device")
    for step, (m, j, p) in enumerate(zip(mesh, one, port)):
        rows = []
        for k, w in m["params"].items():
            lr = next(v for q, v in lrs.items() if f"splat/{k}".startswith(q))
            rows.append((k, lr, w, j["params"][k], p[f"splat/{k}"]))
            for i, moment in enumerate(("exp_avg", "exp_avg_sq")):
                rows.append((f"{k} {moment}", None, m["moments"][k][i], j["moments"][k][i], p[f"adam/{k}/{moment}"]))
        for mod, params in m["aux"].items():
            for n, w in params.items():
                key = f"aux/{mod}/{n}"
                if key in p:
                    lr = next(v for q, v in lrs.items() if key.startswith(q))
                    rows.append((key, lr, w, j["aux"][mod][n], p[key]))
        for what, lr, w, jv, pv in rows:
            print(f"{step} {what}: {reading(jv, w, lr)} | {reading(pv, w, lr)}")


if __name__ == "__main__" and sys.argv[1:2] == ["--spread"]:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    spread(sys.argv[2])
elif __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--main-port", type=int, required=True)
    ap.add_argument("--scene", required=True)
    ap.add_argument("--work", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    rank_main(a.rank, a.port, a.main_port, a.scene, a.work, a.out)
