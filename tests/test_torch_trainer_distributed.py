"""The port's multi-GPU training (simple_trainer{,_2dgs} with
``distributed=True``) in 4 gloo ranks on the CPU.

tests/torch_dist_trainer_cases.py holds the cases and spawns the ranks once
for the session (every case below comes from that one spawn); the scene is
tests/torch_synth_scene.py's, the port on its binned backend (the kernels'
plain versions). The rank's rows of the pool are gathered to rank 0 after
every step, so each comparison is of the whole pool:

- **Against JAX's trainer** (``Runner(distributed=True)`` and
  ``Runner2DGS``, examples/, on conftest's 8 CPU devices, its oracle, its
  step jitted): 3 steps of batch 4 with the depth loss and the pose,
  appearance and bilateral-grid modules (2DGS: the distortion loss from
  step 1), from the port's initial state. JAX cuts each camera into 2
  strips, the port gives each rank a whole camera: the same global step
  through two layouts. Splats and aux modules within rtol 1e-4 and atol
  1e-3 x their learning rate, moments within rtol 1e-4 and atol 1e-5 x the
  array's largest |value| (10 x tests/test_torch_trainer_colmap.py's
  PARAM_ATOL and MOMENT_ATOL, which hold one device to one device: a strip
  and a whole camera sum a gradient in another order, and Adam's first
  step, lr x g / (|g| + eps), turns the rounding of a gradient near eps
  into a share of the learning rate: 4 of the grid's 122,880 values lay
  1.4e-6 from JAX's at 1e-4 x lr, and the grid's cells that the batch
  barely reaches are held by a count gate: at most a share of 1e-3 of them
  past that tolerance, none past 2.5 x the learning rate; 1 of 122,880
  lay past it at step 0, 14 at step 1). 2DGS: JAX's Runner2DGS renders
  on the CPU through its oracle (backend "auto"), the port through the
  binned backend, and the port's surfel moments lie ~1% of a moment's
  largest value from JAX's at step 0 already on one device (the edge-on
  surfels of tests/test_torch_trainer_2dgs.py's docstring); Adam moves
  them apart over the steps. So 2DGS is held by that file's count gate
  for the binned backend with the factor 10 on its atols, step by step
  (SHARE_2DGS, MOMENT_CAP_2DGS): at most 2% of an array's values past
  the tolerance at step 0 and 4% at steps 1-2 (the port's one device on
  this case: up to 0.57%, 1.84%, 3.02%; JAX's own two layouts, 8 strips
  against one device: 0.24%, 0.70%, 1.81%), none past 2.5 x the
  learning rate, and no moment past 2%, 3% and 30% of its largest
  |value| (the port: 1.18%, 1.56%, 25.4%, the last from three surfels
  that part at step 2, where JAX's own layouts stay within 2.6%); the
  pose module's 45 values by that cap alone (22% and 36% of them past
  the tolerance at steps 1-2; JAX's own layouts 11% and 29%). The port's
  4 ranks hold its single-device runner at the strict tolerances below.
- **Against the port's single-device runner** from the same state and
  step generator, at PARAM_ATOL and MOMENT_ATOL themselves: strips (batch 1, tile 8, three
  strips and an empty one), the packed exchange from a truncated capacity
  of 8 (its growth to JAX's round_up(1.5 x pack_required, 512), then the
  single-device runner loaded from the 4-rank checkpoint after the
  truncated step), MCMC (a relocation and a sample_add on rank 0, the
  noise each rank's rows of one draw), refines that split and duplicate,
  pool growths that move rows between ranks (with the appearance module,
  in strips), and 2DGS with both geometry losses.
- **World size 1** (a one-rank gloo group in each rank) gives the
  single-device runner's bits: every loss and every array after every
  step, through refines, growths, the regularisers, MCMC, 2DGS and tiled.
- **Resume**: a 4-rank checkpoint at step 4 holds the gathered pool bit for
  bit and loads into a single-device runner; resumed at 4 ranks it
  continues as the uninterrupted run, bit for bit (refine at step 6).
- ``simple_trainer.main`` with ``--distributed`` under the environment
  ``torch.distributed.run`` sets: rank 0 writes every file, the others
  none; the group it made is destroyed.
- The refusals: no process group, a capacity the ranks cannot split,
  batch sizes that do not divide the world size, and packed without whole
  cameras or with the appearance module.
"""

import numpy as np
import pytest

import torch_dist_trainer_cases as T
from test_torch_trainer_colmap import MOMENT_ATOL, PARAM_ATOL
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_synth_scene import scene_dir


def _port(tmp_path_factory):
    res = T.port_results(tmp_path_factory)
    assert "__error__" not in res, res.get("__error__")
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return _port(tmp_path_factory)


def _lr(lrs, key):
    return next(v for p, v in lrs.items() if key.startswith(p))


# against JAX's trainer (see the docstring)
JAX_FACTOR = 10


def _close_param(got, want, lr, what, factor=1):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=factor * PARAM_ATOL * lr, err_msg=what)


def _close_moment(got, want, what, factor=1):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=factor * MOMENT_ATOL * max(float(np.abs(want).max()), 1e-12), err_msg=what)


def _count_gate(got, want, what, share, lr=None, moment_cap=2e-2):
    """At most ``share`` of the values past rtol 1e-4 and JAX_FACTOR x the
    atol (PARAM_ATOL x ``lr`` for a parameter, MOMENT_ATOL x the largest
    |value| for a moment), and none past 2.5 x the learning rate (Adam's
    first step from a gradient of the other sign moves a value 2 x lr) or
    ``moment_cap`` x the largest |value|. Prints the share."""
    scale = max(float(np.abs(want).max()), 1e-12)
    atol, limit = ((JAX_FACTOR * PARAM_ATOL * lr, 2.5 * lr) if lr is not None
                   else (JAX_FACTOR * MOMENT_ATOL * scale, moment_cap * scale))
    d = np.abs(got - want)
    off = float((d > 1e-4 * np.abs(want) + atol).mean())
    print(f"{what}: share past the tolerance {off:.4f}, max abs {float(d.max()):.3e} "
          f"({float(d.max()) / (lr or scale):.3e} of {'the learning rate' if lr is not None else 'the largest value'})")
    assert np.isfinite(got).all(), what
    assert off <= share and float(d.max()) <= limit, what


# 2DGS against JAX, by step (see the docstring): the share of values past
# the tolerance, and a moment's largest error over its largest |value|
SHARE_2DGS = (2e-2, 4e-2, 4e-2)
MOMENT_CAP_2DGS = (2e-2, 3e-2, 0.3)


def _gate_2dgs(got, want, step, what, lr=None, share=None):
    """2DGS against JAX (see the docstring): tests/test_torch_trainer_2dgs.py's
    count gate for the binned backend, with JAX_FACTOR on the atols, at
    SHARE_2DGS and MOMENT_CAP_2DGS of the step (``share``: in their place)."""
    _count_gate(got, want, what, SHARE_2DGS[step] if share is None else share, lr, MOMENT_CAP_2DGS[step])


def compare_states(got, want, lrs, what):
    """A rank-0 state of the 4-rank run against the single-device one:
    the same keys and shapes; live equal; splats and aux modules by
    PARAM_ATOL x their learning rate; moments and the strategy's
    statistics by MOMENT_ATOL x their largest |value|; step counts equal."""
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if w.dtype == bool or k.endswith("/step") or k in ("pack_capacity", "isect_capacity"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        elif k.startswith(("splat/", "aux/")):
            _close_param(g, w, _lr(lrs, k), f"{what} {k}")
        else:
            _close_moment(g, w, f"{what} {k}")


@pytest.mark.parametrize("case", ["jax-3dgs", "jax-2dgs"])
def test_matches_jax_distributed_trainer(tmp_path_factory, case):
    spec = T.CASES[case]
    init, snaps = T.jax_steps(case, scene_dir())  # before the ranks' results: JAX's steps overlap their spawn
    ranks = _port(tmp_path_factory)[case]
    res = ranks[0]
    assert all(r["losses"] == res["losses"] for r in ranks)  # every rank returns the whole step's loss
    assert all(np.isfinite(res["losses"])) and res["finite"] and not any(res["refined"])
    assert len(res["states"]) == len(snaps) == spec["steps"]
    for step, (got, want) in enumerate(zip(res["states"], snaps)):
        np.testing.assert_array_equal(got["live"], want["live"])
        for k, w in want["params"].items():
            lr = _lr(res["lrs"], f"splat/{k}")
            moments = ((got[f"adam/{k}/exp_avg"], want["moments"][k][0], "mu"),
                       (got[f"adam/{k}/exp_avg_sq"], want["moments"][k][1], "nu"))
            if spec["dim"] == "3dgs":
                _close_param(got[f"splat/{k}"], w, lr, f"step {step} {k}", JAX_FACTOR)
                for g, m, name in moments:
                    _close_moment(g, m, f"step {step} {k} {name}", JAX_FACTOR)
            else:
                _gate_2dgs(got[f"splat/{k}"], w, step, f"step {step} {k}", lr=lr)
                for g, m, name in moments:
                    _gate_2dgs(g, m, step, f"step {step} {k} {name}")
        for m, params in want["aux"].items():
            for name, w in params.items():
                key = f"aux/{m}/{name}"
                if key not in got:
                    continue
                if spec["dim"] == "3dgs" and key == "aux/bilagrid/grids":
                    # cells the batch barely reaches take Adam's steps
                    # lr x m / (sqrt(v) + eps) on gradients near eps
                    _count_gate(got[key], w, f"step {step} {key}", 1e-3, _lr(res["lrs"], key))
                elif spec["dim"] == "3dgs":
                    _close_param(got[key], w, _lr(res["lrs"], key), f"step {step} {key}", JAX_FACTOR)
                else:  # the pose module's 45 values: by the cap alone
                    _gate_2dgs(got[key], w, step, f"step {step} {key}", lr=_lr(res["lrs"], key),
                               share=1.0 if key == "aux/pose/embeds" else None)
        assert {f"aux/{m}/{n}" for m, p in want["aux"].items() for n in p} >= {k for k in got if k.startswith("aux/")}
    for m, name in (("pose", "embeds"), ("app", "w0"), ("bilagrid", "grids")):  # each module trained
        assert not np.array_equal(snaps[-1]["aux"][m][name], init["aux"][m][name]), m


@pytest.mark.parametrize("case", ["strips", "mcmc", "refine", "growth", "2dgs"])
def test_matches_single_device_runner(port, case):
    spec = T.CASES[case]
    ranks, single = port[case], port["single/" + case]
    res = ranks[0]
    assert all(r["losses"] == res["losses"] for r in ranks)
    assert res["finite"] and len(res["states"]) == len(single["states"]) == spec["steps"]
    assert res["refined"] == single["refined"] and res["grew"] == single["grew"]
    assert (res["pool_size"], res["n_live"]) == (single["pool_size"], single["n_live"])
    np.testing.assert_allclose(res["losses"], single["losses"], rtol=1e-5)
    for step, (got, want) in enumerate(zip(res["states"], single["states"])):
        compare_states(got, want, res["lrs"], f"{case} step {step}")
    if case in ("mcmc", "refine", "2dgs"):
        assert any(res["refined"]) and res["n_live"] > 300
    if case == "refine":  # refines at 2 and 4 that both split and duplicated: the live count grew
        assert res["refined"] == [False, False, True, False, True]
    if case == "growth":  # two growths; after them the live rows lie on more than one rank's rows
        assert res["grew"] == [True, False, True, False] and res["pool_size"] == 4 * 8192
        live = res["states"][-1]["live"]
        assert sum(bool(b.any()) for b in np.split(live, 4)) >= 1 and live.sum() == res["n_live"]


def test_packed_exchange_grows_and_matches_single_device(port):
    spec = T.CASES["packed"]
    res = port["packed"][0]
    assert all(r["losses"] == res["losses"] for r in port["packed"])
    need = res["pack_required"][0]
    assert need > spec["pack0"]  # step 0 was truncated
    assert res["pack"][0] == -(-int(need * 1.5) // 512) * 512 >= max(res["pack_required"])
    assert res["pack"] == [res["pack"][0]] * spec["steps"]  # no further growth: nothing truncated
    single = res["single"]
    np.testing.assert_allclose(res["losses"][1:], single["losses"], rtol=1e-5)
    for step, (got, want) in enumerate(zip(res["states"][1:], single["states"])):
        want = {k: v for k, v in want.items() if k != "pack_capacity"}
        compare_states({k: v for k, v in got.items() if k != "pack_capacity"}, want, res["lrs"],
                       f"packed step {step + 1}")
    assert single["states"][0]["pack_capacity"] == res["pack"][0]  # the checkpoint carries it


@pytest.mark.parametrize("case", sorted(T.WORLD1))
def test_world_size_one_gives_the_single_device_bits(port, case):
    res = port["world1/" + case]
    assert res["diffs"] == []
    assert res["losses"][0] == res["losses"][1]
    assert res["pool_size"][0] == res["pool_size"][1]
    if case.startswith("3dgs-aux"):
        assert any(res["grew"]) and any(res["refined"])
    if case == "mcmc":
        assert any(res["refined"])


def test_resume_gives_the_uninterrupted_bits(port):
    res = port["resume"][0]
    losses_a, losses_b = res["losses"]
    assert losses_a == losses_b and len(losses_b) == T.RESUME["steps"] - T.RESUME_AT
    refined_a, refined_b = res["refined"]
    assert refined_a[T.RESUME_AT:] == refined_b and refined_a == [s in (3, 6) for s in range(8)]
    end_a, end_b = res["end"]
    assert sorted(end_a) == sorted(end_b)
    for k in end_a:
        np.testing.assert_array_equal(end_b[k], end_a[k], err_msg=k)
    assert all(r["losses"] == res["losses"] for r in port["resume"])


def test_checkpoint_is_the_gathered_pool_and_loads_on_one_device(port):
    """The 4-rank checkpoint at step 4 holds the gathered pool, the aux
    modules and their optimizers bit for bit, in the single-device layout;
    a single-device runner loads it whole."""
    res = port["resume"][0]
    at, ckpt = res["at"], res["ckpt"]
    pool = {k: v for k, v in at.items() if k not in ("pack_capacity", "isect_capacity")}
    assert set(pool) <= set(ckpt)
    for k, v in pool.items():
        np.testing.assert_array_equal(ckpt[k], v, err_msg=k)
    assert int(ckpt["step"]) == T.RESUME_AT and int(ckpt["pool/pack_capacity"]) == 4096
    assert ckpt["live"].shape[0] == 4096 and ckpt["splat/means"].shape == (4096, 3)
    assert res["files"] == ["cfg.json", "ckpt_4.npz", "splats_4.ply"]
    assert res["single_load_cap"] == (4096, 1)
    for k, v in at.items():
        np.testing.assert_array_equal(res["single_load"][k], v, err_msg=k)


def test_main_with_distributed_writes_rank0_files_only(port):
    ranks = port["main"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3] and all(r["world_size"] == 4 for r in ranks)
    assert all(r["group_destroyed"] for r in ranks)
    assert ranks[0]["files"] == ["cfg.json", "ckpt_2.npz", "splats_2.ply", "stats.jsonl", "val_step2.json", "videos"]
    assert ranks[0]["videos"] in (["traj_interp_2.mp4"], ["traj_interp_2_frames.npz"])
    assert '"step": 0' in ranks[0]["stats"]
    assert all(r["files"] is None for r in ranks[1:])


@pytest.mark.parametrize("case", ["no-group", "capacity-3-ranks"] + sorted(T.REFUSALS))
def test_refusals(port, case, tmp_path):
    if case == "no-group":
        import torch.distributed as dist

        assert not (dist.is_available() and dist.is_initialized())
        with pytest.raises(RuntimeError, match="init_process_group"):
            T.make_runner(T.CASES["refine"], scene_dir(), str(tmp_path), distributed=True)
        return
    ranks = port["refusals"]
    if case == "capacity-3-ranks":
        assert [r.get("cap-3") is not None and "split into rows over 3 ranks" in r["cap-3"] for r in ranks] == \
            [True, True, True, False]
        return
    _, message = T.REFUSALS[case]
    assert all(r[case] is not None and message in r[case] for r in ranks), [r[case] for r in ranks]


def test_chip_smoke_holds_its_ranks_to_these_tolerances():
    """chip_smoke.py's phase 16b holds its two ranks on the card to world
    size 1 at the tolerances this file holds the 4 ranks to."""
    import chip_smoke

    assert (chip_smoke.PARAM_ATOL, chip_smoke.MOMENT_ATOL) == (PARAM_ATOL, MOMENT_ATOL)
