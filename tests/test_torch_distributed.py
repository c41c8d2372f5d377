"""The port's multi-GPU 3DGS rendering (gsplat_tpu_torch/distributed.py)
vs the JAX package's (gsplat_tpu/distributed.py).

The port runs in 4 gloo ranks on the CPU (the kernels' plain versions), JAX
on a mesh of the first 4 of the 8 virtual CPU devices, jitted, its binned
and tiled backends in interpret mode; tests/torch_dist_cases.py holds the
cases and spawns the ranks once for the session. For every case the ranks'
blocks, assembled in rank order, their radii (exactly) and every meta value
(n_isects, slab_required, isect_capacity, a2a_bytes_per_device, n_strips,
strip_rows, pack_required) hold to JAX's, at JAX's own tolerances
(tests/test_distributed.py: render and alphas atol 2e-5, rtol 1e-5;
gradients w.r.t. means, quats, scales, opacities, colours and the means2d
carrier atol 2e-4 x max(|g|, 1), rtol 2e-4). The cases cover the oracle,
binned and tiled backends; whole cameras (C=4, and C=8 with two a rank),
tile-row strips (C=1 in 4 strips, the last cropped; C=2 in 2) and the
packed exchange (a real compaction at capacity 8 of 32 rows, absgrad rows
riding the pack, a truncated capacity with pack_required past it); RGB, D,
ED, RGB+D and RGB+ED with and without backgrounds; absgrad and the
densification carrier; SH degree 3, antialiased, masks and per-camera
colours; and rasterization(distributed=True) against the direct call. At
world size 1 (a one-rank group in each rank) the binned and tiled paths
give the single-device call's bits, values and gradients.
"""

import pytest

import torch_dist_cases as T
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

T.start_references()


@pytest.fixture(scope="module")
def port():
    res = T.port_results()
    assert "__error__" not in res, res.get("__error__")
    return res


@pytest.mark.parametrize("case", sorted(T.CASES_3DGS))
def test_distributed_matches_jax(port, case):
    name = "3dgs/" + case
    spec = T.CASES[name]
    T.compare_values(name, port[name])
    if spec["grad"]:
        T.compare_grads(name, port[name])
    meta = port[name][0]["meta"]
    if spec.get("packed") == 4:  # the truncated capacity: the signal past it
        assert meta["pack_required"] > 4
    if spec["backend"] == "binned":
        assert meta["slab_required"] > 0 and (meta["n_isects"] > 0).all()


@pytest.mark.parametrize("case", sorted(k for k, v in T.CASES_3DGS.items() if v.get("dispatch")))
def test_rasterization_distributed_dispatch(port, case):
    """rasterization(distributed=True[, packed=True, pack_capacity=...])
    gives the direct call's outputs, bit for bit, on every rank."""
    assert all(r["dispatch_equal"] for r in port["3dgs/" + case])


@pytest.mark.parametrize("case", [n for n in T.WORLD1 if n.startswith("3dgs/")])
def test_world_size_one_gives_the_single_device_bits(port, case):
    res = port["world1/" + case]
    assert all(r["equal"] for r in res), [r["max_abs"] for r in res]


def test_shard_check_once_and_stats_on_device(monkeypatch):
    """In a one-rank gloo group in this process: the shard sizes are
    checked by one all-reduce on the first call with them and not again,
    the stats' all-reduce runs on every call, and slab_required comes back
    as a device tensor (the call does not wait for it)."""
    import torch
    import torch.distributed as dist
    from gsplat_tpu_torch import rasterization

    spec = T.CASES["3dgs/binned-C4-bg"]
    g = T.inputs(spec)
    args = [torch.from_numpy(g[k]) for k in ("means", "quats", "scales", "opacities", "colors", "viewmats", "Ks")]
    calls = []
    real = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: (calls.append(t.dtype), real(t, *a, **k))[1])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{T.free_port()}", world_size=1, rank=0)
    try:
        metas = [rasterization(*args, spec["W"], spec["H"], backend="binned", isect_capacity=1 << 15,
                               distributed=True)[2] for _ in range(2)]
        want = rasterization(*args, spec["W"], spec["H"], backend="binned", isect_capacity=1 << 15)[2]
    finally:
        dist.destroy_process_group()
    assert len(calls) == 3  # the check once, the stats twice
    for meta in metas:
        assert isinstance(meta["slab_required"], torch.Tensor) and meta["slab_required"].dim() == 0
        assert int(meta["slab_required"]) == want["slab_required"]
        assert meta["n_isects"].tolist() == [int(want["n_isects"])]
