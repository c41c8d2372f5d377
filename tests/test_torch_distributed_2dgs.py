"""The port's multi-GPU 2DGS rendering (gsplat_tpu_torch/distributed.py)
vs the JAX package's (gsplat_tpu/distributed.py), as
tests/test_torch_distributed.py does for 3DGS (4 gloo ranks against a
4-device CPU mesh; tests/torch_dist_cases.py).

The 7 outputs assembled in rank order, radii and meta against JAX's: on
the oracle with whole cameras at JAX's tolerances (colours, normals,
distortion, median atol 1e-4, normals from depth 5e-4), alphas at the
port's own port-vs-JAX 2DGS atol 1e-4. The binned and tiled backends, and
the strip layout on any backend, by tests/test_torch_rendering_2dgs.py's
count gates (`torch_dist_cases.flip_gated` says why). Gradients of a seeded
weighting of colours, alphas, normals, distortion and the normals from
depth w.r.t. the splats and the densify carrier by the port's 2DGS
gradient gate, each value past it explained by JAX's single-device
gradient or a single-device flip (`torch_dist_cases.grad_gate`). The
normals from depth of a strip read one depth row of each neighbouring
strip: they equal `depth_to_normal` of the assembled depth within 1e-6,
the strip boundary rows compared on their own and non-zero.
"""

import numpy as np
import pytest

import torch_dist_cases as T
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    res = T.port_results(tmp_path_factory)
    assert "__error__" not in res, res.get("__error__")
    return res


@pytest.mark.parametrize("case", sorted(T.CASES_2DGS))
def test_distributed_2dgs_matches_jax(port, case):
    name = "2dgs/" + case
    spec = T.CASES[name]
    T.compare_values(name, port[name])
    if spec["grad"]:
        T.compare_grads(name, port[name])
    meta = port[name][0]["meta"]
    if spec.get("packed") == 4:
        assert meta["pack_required"] > 4
    if not spec.get("distloss"):
        assert all(not r["images"][4].any() for r in port[name])


@pytest.mark.parametrize("case", sorted(k for k, v in T.CASES_2DGS.items()
                                        if v.get("render_mode") in ("RGB+D", "RGB+ED")))
def test_normals_from_depth_across_strips(port, case):
    """Normals from depth of every rank's block against depth_to_normal of
    the assembled depth; at a strip's first and last rows (which read the
    neighbouring strip's depth) compared on their own, and not zero."""
    name = "2dgs/" + case
    rows, got, want = T.compare_normals_from_depth(name, port[name])
    if T.CASES[name]["C"] % T.N_RANKS != 0:
        assert rows
        np.testing.assert_allclose(got[:, rows], want[:, rows], atol=1e-6, rtol=0)
        inner = got[:, rows, 1:-1]
        assert (np.linalg.norm(inner, axis=-1) > 0.5).mean() > 0.9, "boundary rows left zero"


@pytest.mark.parametrize("case", sorted(k for k, v in T.CASES_2DGS.items() if v.get("dispatch")))
def test_rasterization_2dgs_distributed_dispatch(port, case):
    assert all(r["dispatch_equal"] for r in port["2dgs/" + case])


@pytest.mark.parametrize("case", [n for n in T.WORLD1 if n.startswith("2dgs/")])
def test_world_size_one_gives_the_single_device_bits(port, case):
    res = port["world1/" + case]
    assert all(r["equal"] for r in res), [r["max_abs"] for r in res]
