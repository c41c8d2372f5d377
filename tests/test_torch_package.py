"""The port as a package: what it imports, where it runs, what it refuses.

- importing gsplat_tpu_torch loads neither jax nor gsplat_tpu (the apps,
  compression/, lpips and profile included), and no source of the package
  (datasets/ included), chip_smoke.py or the port's scripts/torch_*.py
  imports them; the package exports the JAX package's names;
- functions run on the device of their inputs and refuse mixed devices;
  splats_from_numpy defaults to CUDA and raises without it;
- multi-GPU rendering and training (both trainers' ``distributed``)
  raise without a torch.distributed process group instead of falling
  back; the tiled backend, once such a path, renders, and
  backend="auto" reaches it at scene scale without a capacity;
- the binned backend differentiates (the training slice), 3DGS and 2DGS;
- CPU runs take the kernels' plain versions and launch no kernel, forward
  and backward, through an MCMC training step, the bilateral grid's
  gradient and every micro-benchmark wrapper;
- the trainer runs on CUDA unless told device="cpu";
- checkpoint arrays (the JAX trainer's layout and the viewer's) render the
  same image in both packages through the trainer's render transform.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import gsplat_tpu
import gsplat_tpu_torch
from gsplat_tpu.ops.rasterize import resolve_auto_backend as jax_resolve
from gsplat_tpu_torch import _backend, rasterization, splats_from_numpy
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.ops import rasterize_binned as trb
from gsplat_tpu_torch.ops.rasterize import rasterize_to_pixels, resolve_auto_backend

from test_torch_rendering import CAP, _compare, _garden
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gsplat_tpu_torch")


def test_import_loads_no_jax():
    code = (
        "import sys, gsplat_tpu_torch, gsplat_tpu_torch.ops.rasterize_binned\n"
        "import gsplat_tpu_torch.simple_trainer, gsplat_tpu_torch.losses, gsplat_tpu_torch.modules\n"
        "import gsplat_tpu_torch.optimizers, gsplat_tpu_torch.strategy.ops\n"
        "import gsplat_tpu_torch.simple_trainer_2dgs, gsplat_tpu_torch.ops.rasterize_2dgs_binned\n"
        "import gsplat_tpu_torch.ops.isect, gsplat_tpu_torch.ops.rasterize_tiled\n"
        "import gsplat_tpu_torch.ops.rasterize_2dgs_tiled, gsplat_tpu_torch.ops.accumulate\n"
        "import gsplat_tpu_torch.relocation, gsplat_tpu_torch.strategy.mcmc, gsplat_tpu_torch.utils\n"
        "import gsplat_tpu_torch.distributed, gsplat_tpu_torch.checkpoint, gsplat_tpu_torch.strategy.default\n"
        "import gsplat_tpu_torch.datasets.synth, gsplat_tpu_torch.bilagrid, gsplat_tpu_torch.image_fitting\n"
        "import gsplat_tpu_torch.microbench.vpu_calib, gsplat_tpu_torch.microbench.primitives\n"
        "import gsplat_tpu_torch.microbench.kernel_shapes, gsplat_tpu_torch.microbench.fwd_breakdown\n"
        "import gsplat_tpu_torch.compression.sort, gsplat_tpu_torch.lpips, gsplat_tpu_torch.profile\n"
        "import gsplat_tpu_torch.simple_viewer, gsplat_tpu_torch.interactive_viewer\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'gsplat_tpu' or m.startswith('gsplat_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for root, _, files in os.walk(PKG):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))
    yield os.path.join(ROOT, "chip_smoke.py")
    scripts = os.path.join(ROOT, "scripts")
    yield from (os.path.join(scripts, f) for f in os.listdir(scripts) if f.startswith("torch_") and f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "gsplat_tpu"), f"{path} imports {name}"


def test_exports_match_jax_names():
    """Every name the JAX package exports, under the same name; the
    reference's misspelled `full_fused_projection_2dgs` is the same
    function."""
    missing = [n for n in gsplat_tpu.__all__ if not hasattr(gsplat_tpu_torch, n)]
    assert not missing, missing
    assert set(gsplat_tpu.__all__) <= set(gsplat_tpu_torch.__all__)
    assert gsplat_tpu_torch.full_fused_projection_2dgs is gsplat_tpu_torch.fully_fused_projection_2dgs


def test_kernel_sources_ship():
    for name in _backend.KERNELS:
        assert os.path.exists(os.path.join(_backend.CSRC, name + ".cu"))


def test_load_test_data_matches_jax():
    for a, b in zip(gsplat_tpu_torch.load_test_data(), gsplat_tpu.load_test_data()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("cap", [None, 4096])
@pytest.mark.parametrize("n", [10, 10_000_000])
def test_resolve_auto_backend_matches_jax(cap, n):
    for backend in ("auto", "oracle", "binned", "tiled"):
        assert resolve_auto_backend(backend, cap, 2, n, 64, 48) == jax_resolve(
            backend, cap, 2, n, 64, 48
        )


def test_splats_from_numpy_needs_cuda_unless_cpu(monkeypatch):
    arrays = {"means": np.zeros((4, 3), np.float32), "quats": np.ones((4, 4), np.float32),
              "scales": np.zeros((4, 3), np.float32), "opacities": np.zeros(4, np.float32),
              "sh0": np.zeros((4, 1, 3), np.float32)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        splats_from_numpy(arrays)
    splats, live = splats_from_numpy(arrays, device="cpu")
    assert live is None
    assert splats["shN"].shape == (4, 0, 3)
    assert all(t.device.type == "cpu" for t in splats.values())
    with pytest.raises(KeyError):
        splats_from_numpy({"means": arrays["means"]}, device="cpu")


def _tiny(requires_grad=False):
    rng = np.random.default_rng(0)
    N, C, W, H = 64, 1, 32, 32
    means = torch.from_numpy(rng.standard_normal((N, 3)).astype(np.float32))
    quats = torch.from_numpy(rng.standard_normal((N, 4)).astype(np.float32))
    scales = torch.full((N, 3), 0.2)
    opac = torch.full((N,), 0.8)
    colors = torch.from_numpy(rng.random((N, 3)).astype(np.float32))
    viewmats = torch.eye(4)[None].clone()
    viewmats[0, 2, 3] = 4.0
    Ks = torch.tensor([[[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]]])
    means.requires_grad_(requires_grad)
    return [means, quats, scales, opac, colors, viewmats, Ks, W, H]


def test_binned_backend_refuses_gradients():
    """Since the training slice the binned backend no longer refuses a
    gradient: it differentiates, and agrees with the oracle's autograd."""
    args = _tiny(requires_grad=True)
    with torch.no_grad():
        img, alpha, meta = rasterization(*args, backend="binned", isect_capacity=4096)
    assert int(meta["n_isects"]) > 0 and float(alpha.mean()) > 0
    grads = []
    for backend in ("binned", "oracle"):
        args[0].grad = None
        img, alpha, _ = rasterization(*args, backend=backend, isect_capacity=4096)
        (img.sum() + alpha.sum()).backward()
        assert torch.isfinite(args[0].grad).all()
        grads.append(args[0].grad.clone())
    s = float(grads[1].abs().max())
    assert s > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-3, atol=1e-4 * s)


@pytest.mark.parametrize("kw,match", [
    (dict(backend="tiled", isect_capacity=4096), "tiled"),
    (dict(distributed=True), "init_process_group"),
    (dict(backend="tiled", isect_capacity=4096, means2d_carrier=torch.zeros(1, 64, 2), absgrad=True), "tiled"),
    (dict(distributed=True, means2d_carrier=torch.zeros(1, 64, 2)), "init_process_group"),
])
def test_unported_paths_raise(kw, match):
    """Multi-GPU, which raised NotImplementedError until its slice, needs a
    torch.distributed process group: without one it raises and never
    renders on one device instead. The tiled backend, which raised until its
    slice, renders (with the absgrad carrier too) and matches the oracle."""
    if match != "tiled":
        assert not torch.distributed.is_initialized()
        with pytest.raises(RuntimeError, match=match):
            rasterization(*_tiny(), **kw)
        return
    with torch.no_grad():
        img, alpha, meta = rasterization(*_tiny(), **kw)
        want, want_alpha, _ = rasterization(*_tiny(), backend="oracle")
    assert int(meta["n_isects"]) > 0 and meta["isect_capacity"] == 4096
    torch.testing.assert_close(img, want, rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(alpha, want_alpha, rtol=1e-5, atol=2e-5)


def test_unported_entry_points_raise():
    """rasterization_2dgs's multi-GPU path, and both trainers' multi-GPU
    training, raise without a process group (never rendering or training
    on one device instead). Its tiled path and the
    tiled backend of both tile rasterizers, which raised until the tiled
    slice, render: rasterization_2dgs as its binned backend does (the same
    stream order), and on an all-culled scene the two rasterizers give the
    background and aux {"n_isects": 0}."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        gsplat_tpu_torch.rasterization_2dgs(*_tiny(), distributed=True)
    with pytest.raises(RuntimeError, match="init_process_group"):
        gsplat_tpu_torch.rasterization_2dgs(*_tiny(), distributed=True, packed=True, pack_capacity=64)
    from gsplat_tpu_torch.simple_trainer import Config

    for cls in (gsplat_tpu_torch.Runner, gsplat_tpu_torch.Runner2DGS):
        with pytest.raises(RuntimeError, match="init_process_group"):
            cls(Config(distributed=True, init_type="random", init_num_pts=64), [], None, None, 1.0, device="cpu")
    with torch.no_grad():
        tiled = gsplat_tpu_torch.rasterization_2dgs(*_tiny(), backend="tiled", isect_capacity=4096)
        binned = gsplat_tpu_torch.rasterization_2dgs(*_tiny(), backend="binned", isect_capacity=4096)
    assert int(tiled[6]["n_isects"]) > 0 and float(tiled[1].mean()) > 0
    for a, b in zip(tiled[:6], binned[:6]):
        assert (a is None and b is None) or torch.equal(a, b)
    args = _tiny()
    C, N = 1, args[0].shape[0]
    bg = torch.full((C, 3), 0.5)
    img, alpha, aux = rasterize_to_pixels(
        torch.zeros(C, N, 2), torch.zeros(C, N, 3), torch.zeros(C, N, 3),
        torch.zeros(C, N), torch.zeros(C, N, dtype=torch.int32),
        torch.ones(C, N), 32, 32, capacity=4096, backgrounds=bg, backend="tiled",
    )
    assert int(aux["n_isects"]) == 0 and bool((img == 0.5).all()) and not alpha.any()
    out = gsplat_tpu_torch.rasterize_to_pixels_2dgs(
        torch.zeros(C, N, 2), torch.zeros(C, N, 3, 3), torch.zeros(C, N, 3),
        torch.zeros(C, N, 3), torch.zeros(C, N), torch.zeros(C, N, dtype=torch.int32),
        torch.ones(C, N), 32, 32, capacity=4096, backgrounds=bg, backend="tiled",
    )
    assert int(out[5]["n_isects"]) == 0 and bool((out[0] == 0.5).all())
    assert not any(x.any() for x in out[1:5])


def test_auto_backend_on_a_large_scene_raises_not_falls_back(monkeypatch):
    """resolve_auto_backend sends large scenes without a capacity to the
    tiled backend, which raised until the tiled slice: the call now renders
    there, with the derived budget max(2^20, 16 C N) as its capacity, and
    matches the oracle, 3DGS and 2DGS."""
    import gsplat_tpu_torch.ops.rasterize as rz

    monkeypatch.setattr(rz, "_ORACLE_AUTO_ELEMS", 16)
    with torch.no_grad():
        img, alpha, meta = rasterization(*_tiny())
        out2 = gsplat_tpu_torch.rasterization_2dgs(*_tiny(), backend="auto")
    monkeypatch.setattr(rz, "_ORACLE_AUTO_ELEMS", 1 << 28)
    with torch.no_grad():
        want, want_alpha, want_meta = rasterization(*_tiny())
    C, N = 1, _tiny()[0].shape[0]
    assert "n_isects" not in want_meta  # the oracle, at the default limit
    assert meta["isect_capacity"] == out2[6]["isect_capacity"] == max(1 << 20, 16 * C * N)
    assert int(meta["n_isects"]) > 0 and "slab_required" not in meta and "slab_required" not in out2[6]
    torch.testing.assert_close(img, want, rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(alpha, want_alpha, rtol=1e-5, atol=2e-5)


def test_mixed_devices_raise():
    args = _tiny()
    args[4] = torch.zeros(args[4].shape, device="meta")
    with pytest.raises(ValueError, match="one device"):
        rasterization(*args, backend="binned", isect_capacity=4096)
    with pytest.raises(NotImplementedError):
        _backend.use_kernel(torch.device("meta"))
    assert _backend.use_kernel(torch.device("cuda")) is True
    assert _backend.use_kernel(torch.device("cpu")) is False


def test_kernel_wrappers_refuse_cpu_tensors():
    args = _tiny()
    with torch.no_grad():
        _, _, _, binned = trb._raster_binned_fwd(
            *gsplat_tpu_torch.fully_fused_projection(*args[:3], *args[5:])[1:2],
            torch.zeros(1, 64, 3), torch.rand(1, 64, 3), torch.full((1, 64), 0.5),
            torch.ones(1, 64, dtype=torch.int32), torch.full((1, 64), 4.0),
            32, 32, 16, 4096,
        )
    with pytest.raises(ValueError, match="CUDA"):
        trb._fwd_cuda(binned.entries, binned.offs, binned.cnts, 1, 32, 32, 16)
    plan, _ = binning.plan_emit(
        *[torch.zeros(1, 4)] * 6, torch.zeros(1, 4, 3),
        torch.ones(1, 4, dtype=torch.int32), torch.ones(1, 4), 16, 2, 2, 4096,
    )
    with pytest.raises(ValueError, match="CUDA"):
        binning._emit_cuda(plan)
    keys, gids = binning._emit_plain(plan)
    with pytest.raises(ValueError, match="CUDA"):
        binning._gather_cuda(plan.packed, plan.nf, torch.sort(keys, stable=True)[1], gids,
                             torch.tensor(plan.n_emit))


def test_cpu_runs_launch_no_kernel():
    _backend.reset_launch_counts()
    with torch.no_grad():
        rasterization(*_tiny(), backend="binned", isect_capacity=4096, sh_degree=None)
    img, _, _ = rasterization(*_tiny(requires_grad=True), backend="binned", isect_capacity=4096)
    img.sum().backward()
    out = gsplat_tpu_torch.rasterization_2dgs(
        *_tiny(requires_grad=True), backend="binned", isect_capacity=4096, render_mode="RGB+ED", distloss=True
    )
    (out[0].sum() + out[4].sum()).backward()
    img, _, _ = rasterization(*_tiny(requires_grad=True), backend="tiled", isect_capacity=4096)
    img.sum().backward()
    out = gsplat_tpu_torch.rasterization_2dgs(
        *_tiny(requires_grad=True), backend="tiled", isect_capacity=4096, render_mode="RGB+ED", distloss=True
    )
    (out[0].sum() + out[4].sum()).backward()
    from gsplat_tpu_torch import simple_trainer

    pts = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    view = {"image": np.zeros((16, 16, 3), np.float32), "K": np.array([[16.0, 0, 8], [0, 16, 8], [0, 0, 1]], np.float32),
            "camtoworld": np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -4], [0, 0, 0, 1]], np.float32), "image_id": 0}
    cfg = simple_trainer.Config(strategy_name="mcmc", cap_max=100, refine_start_iter=0, refine_every=1,
                                sh_degree=0, isect_capacity_init=4096, backend="binned")
    runner = simple_trainer.Runner(cfg, [view], pts, np.full((50, 3), 128, np.uint8), 1.0, device="cpu")
    assert runner.train_step(1)["refined"] and int(runner.live.sum()) == 52
    # the bilateral grid's gradient and each micro-benchmark's wrapper
    from gsplat_tpu_torch.bilagrid import BilateralGrid
    from gsplat_tpu_torch.microbench import fwd_breakdown, kernel_shapes, primitives, vpu_calib

    grid = BilateralGrid(2, 4, 4, 3, device="cpu")
    grid(torch.rand(1, 8, 8, 3), torch.tensor([1])).sum().backward()
    x = torch.rand(64, 64)
    vpu_calib.fma_chain(x, 2), vpu_calib.sgemm(x, x, 2), vpu_calib.tf32_mma(x, x, 2)
    tab, idx = torch.rand(2, 8, 8), torch.randint(0, 8, (2, 8, 8), dtype=torch.int32)
    primitives.gather_rows(tab, idx), primitives.gather_window(tab[0], idx), primitives.gather_cols(tab, idx[:, :1])
    primitives.inner_math(torch.rand(2, 8, 4), 8), primitives.inner_math(torch.rand(2, 8, 4), 8, torch.bfloat16)
    for v in kernel_shapes.VARIANTS:
        kernel_shapes.slice_shapes(v, torch.rand(16, 128), 256, 1, 1)
    for level in range(4):
        fwd_breakdown.fwd_breakdown(level, torch.rand(9, 600), torch.tensor([0, 500], dtype=torch.int32),
                                    torch.tensor([300, 100], dtype=torch.int32), 2, 1, 16)
    assert _backend.launch_counts() == {name: 0 for name in (
        "emit", "emit_gather", "rasterize_fwd", "rasterize_bwd", "gid_reduce", "rasterize_2dgs_fwd",
        "rasterize_2dgs_bwd",
        "rasterize_tiled_fwd", "rasterize_tiled_bwd", "rasterize_2dgs_tiled_fwd", "rasterize_2dgs_tiled_bwd",
        "bilagrid_bwd", "bilagrid_lum_bwd", "fma_chain", "sgemm", "tf32_mma", "gather_rows", "gather_window", "gather_cols",
        "inner_math_f32", "inner_math_bf16", "slice_vpu_sigma", "slice_mxu_sigma", "slice_moments",
        "slice_vpu_reduce5", "slice_scan", "slice_fwd_mix", "fwd_breakdown_L0", "fwd_breakdown_L1",
        "fwd_breakdown_L2", "fwd_breakdown_L3",
    )}
    assert not _backend.BUILD_LOG


def test_trainer_needs_cuda_unless_cpu(monkeypatch):
    from gsplat_tpu_torch import simple_trainer

    pts = np.random.default_rng(0).standard_normal((20, 3)).astype(np.float32)
    rgb = np.full((20, 3), 128, np.uint8)
    view = {"image": np.zeros((8, 8, 3), np.float32), "camtoworld": np.eye(4, dtype=np.float32),
            "K": np.eye(3, dtype=np.float32), "image_id": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        simple_trainer.Runner(simple_trainer.Config(), [view], pts, rgb, scene_scale=1.0)
    runner = simple_trainer.Runner(simple_trainer.Config(), [view], pts, rgb, scene_scale=1.0, device="cpu")
    assert all(p.device.type == "cpu" for p in runner.params.values())


@pytest.fixture(scope="module")
def garden():
    return _garden(4500, 8)


@pytest.mark.parametrize("prefix", ["splat/", ""])
def test_checkpoint_render_matches_jax(garden, prefix):
    """Weights carried across: both packages render the same checkpoint
    arrays through the JAX trainer's render transform (Runner.render)."""
    g = garden
    N = g["means"].shape[0]
    op = np.clip(g["opacities"], 1e-4, 1 - 1e-4)
    arrays = {
        prefix + "means": g["means"],
        prefix + "quats": g["quats"],
        prefix + "scales": np.log(g["scales"]),
        prefix + "opacities": np.log(op / (1.0 - op)),
        prefix + "sh0": g["rgb"][:, None, :],
        prefix + "shN": g["sh"][:, 1:, :] * 0.1,
        "live": g["masks"],
    }
    splats, live = splats_from_numpy(arrays, device="cpu")
    assert live.dtype == torch.bool and live.shape == (N,)
    for key in ("means", "quats", "scales", "opacities", "sh0", "shN"):
        np.testing.assert_array_equal(splats[key].numpy(), arrays[prefix + key])
    common = dict(sh_degree=3, backend="binned", isect_capacity=CAP)
    got = rasterization(
        splats["means"], splats["quats"], torch.exp(splats["scales"]),
        torch.sigmoid(splats["opacities"]),
        torch.cat([splats["sh0"], splats["shN"]], dim=1),
        torch.from_numpy(g["viewmats"]), torch.from_numpy(g["Ks"]),
        g["W"], g["H"], masks=live, **common,
    )
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    want = gsplat_tpu.rasterization(
        j[prefix + "means"], j[prefix + "quats"], jnp.exp(j[prefix + "scales"]),
        1.0 / (1.0 + jnp.exp(-j[prefix + "opacities"])),
        jnp.concatenate([j[prefix + "sh0"], j[prefix + "shN"]], axis=1),
        jnp.asarray(g["viewmats"]), jnp.asarray(g["Ks"]), g["W"], g["H"],
        masks=j["live"], **common,
    )
    _compare(want, got)
