"""The port's apps on the CPU: profile.py, both viewers,
scripts/torch_compress_eval.py, and the trainer's LPIPS and PNG
compression against the JAX package.

- profile.timeit as a context manager and a decorator, report and reset;
  a no-op without TIMEIT=1.
- simple_viewer.main runs on the card unless asked for the CPU, and
  writes two small frames of the garden fixture, the first equal to
  rasterization() of its camera.
- interactive_viewer: Viewer.frame equals rasterization() (rgb, depth,
  alpha), and one local GET returns the frame as a PNG.
- scripts/torch_compress_eval.py on a port checkpoint of the synthetic
  COLMAP scene (tests/torch_synth_scene.py) writes its three CSV rows and
  the uncompressed line.
- The trainer's eval with lpips_weights: "lpips" equals JAX's lpips on the
  port's own renders (rtol 1e-5); with compression="png" the save step
  writes compression_{step}/ and its report, and JAX's
  PngCompression.decompress reads that directory as the port does.
"""

import functools
import importlib.util
import json
import os
import tempfile
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import lpips as jl
from gsplat_tpu.compression import PngCompression as JaxPng
from gsplat_tpu_torch import load_test_data, lpips, profile, rasterization
from gsplat_tpu_torch import simple_trainer as st
from gsplat_tpu_torch.compression import PngCompression
from gsplat_tpu_torch.datasets.image_io import decode_png, read_png

from torch_exp_warmup import one_torch_thread, warm_exp  # noqa: F401 (one_torch_thread: an autouse fixture)
from torch_synth_scene import scene_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_profile_timeit_and_report(monkeypatch):
    profile.reset()
    monkeypatch.setattr(profile, "_ENABLED", False)

    def f(x):
        return x + 1

    assert profile.timeit("off")(f) is f
    with profile.timeit("off"):
        pass
    assert not profile.profiler
    monkeypatch.setattr(profile, "_ENABLED", True)
    g = profile.timeit("fn")(f)
    assert g(torch.ones(2)).tolist() == [2.0, 2.0] and g.__name__ == "f"
    g(torch.ones(2))
    with profile.timeit("block"):
        torch.ones(3).sum()
    assert dict(profile.profiler_counts) == {"fn": 2, "block": 1}
    lines = profile.report().splitlines()
    assert lines[0] == "name\ttotal_s\tcalls\tper_call_ms" and len(lines) == 3
    assert sorted(line.split("\t")[0] for line in lines[1:]) == ["block", "fn"]
    assert profile.block_until_ready({"a": [torch.ones(1)]})["a"][0].item() == 1.0
    profile.reset()
    assert not profile.profiler and not profile.profiler_counts


def test_simple_viewer_writes_frames(tmp_path, monkeypatch):
    from gsplat_tpu_torch import simple_viewer
    from gsplat_tpu_torch.datasets.traj import generate_ellipse_path_z

    out = str(tmp_path / "frames")
    argv = ["--traj", "ellipse", "--n-frames", "2", "--width", "48", "--height", "32", "--output-dir", out]
    with monkeypatch.context() as m:  # the card unless the caller asks for the CPU
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            simple_viewer.main(argv)
    assert simple_viewer.main(argv + ["--cpu"]) == out
    names = sorted(os.listdir(out))
    assert names == ["frame_0000.png", "frame_0001.png"]
    frame = read_png(os.path.join(out, names[0]))
    assert frame.shape == (32, 48, 3) and frame.std() > 0
    # the same camera through rasterization()
    means, quats, scales, opac, colors, viewmats, Ks, w, h = load_test_data()
    c2w = np.linalg.inv(viewmats).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :4] = generate_ellipse_path_z(c2w[:, :3, :], n_frames=2)[0]
    K = Ks[0].copy()
    K[0] *= 48 / w
    K[1] *= 32 / h
    logit = torch.from_numpy(np.log(opac / np.clip(1.0 - opac, 1e-6, None)).astype(np.float32))
    with torch.no_grad():
        rgb, _, _ = rasterization(torch.from_numpy(means), torch.from_numpy(quats),
                                  torch.exp(torch.from_numpy(np.log(scales))), torch.sigmoid(logit),
                                  torch.from_numpy(colors[:, None, :]), torch.linalg.inv(torch.from_numpy(pose))[None],
                                  torch.from_numpy(K)[None], 48, 32, sh_degree=0, backend="binned",
                                  isect_capacity=1 << 16)
    np.testing.assert_array_equal(frame, (torch.clamp(rgb[0], 0, 1) * 255).to(torch.uint8).numpy())


def test_interactive_viewer_frame_and_get():
    from gsplat_tpu_torch import interactive_viewer

    args = interactive_viewer.parse_args(["--demo", "--max-points", "3000", "--width", "40", "--height", "30",
                                          "--focal", "40"])
    viewer = interactive_viewer.build_viewer(args, torch.device("cpu"))
    pan = np.array([0.1, 0.0, 0.0])
    frames = {m: viewer.frame(0.8, 0.4, viewer.r0, pan, m) for m in interactive_viewer.MODES}
    w2c = torch.as_tensor(viewer.look_at(0.8, 0.4, viewer.r0, pan), dtype=torch.float32)[None]
    r = viewer.render
    with torch.no_grad():
        out, alphas, _ = rasterization(r.means, r.quats, r.scales, r.opacities, r.colors, w2c, viewer.K, 40, 30,
                                       render_mode="RGB+ED", backend="binned", isect_capacity=r.capacity)
    out, alphas = out[0].numpy(), alphas[0].numpy()
    np.testing.assert_array_equal(frames["rgb"], (np.clip(out[..., :3], 0, 1) * 255).astype(np.uint8))
    np.testing.assert_array_equal(frames["alpha"], (np.repeat(alphas, 3, axis=-1) * 255).astype(np.uint8))
    m = alphas[..., 0] > 0.2
    assert m.any() and frames["depth"].shape == (30, 40, 3)
    lo, hi = np.percentile(out[..., 3][m], [2, 98])
    d = np.clip((out[..., 3] - lo) / max(hi - lo, 1e-6), 0, 1)
    np.testing.assert_array_equal(frames["depth"], (np.stack([d, d, 1.0 - d * 0.5], -1) * 255).astype(np.uint8))
    with pytest.raises(ValueError, match="mode"):
        viewer.frame(0.8, 0.4, viewer.r0, pan, "normals")
    httpd = interactive_viewer.serve(viewer, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        url = f"http://127.0.0.1:{port}/render?az=0.8&el=0.4&r={viewer.r0}&tx=0.1&ty=0&tz=0&mode=rgb"
        with urllib.request.urlopen(url, timeout=60) as resp:
            assert resp.headers["Content-Type"] == "image/png"
            got = decode_png(resp.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/info", timeout=60) as resp:
            assert json.loads(resp.read()) == {"width": 40, "height": 30, "r0": viewer.r0}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    np.testing.assert_array_equal(got, frames["rgb"])


LPIPS_SEED = 6


def _lpips_npz(tmp):
    p = jl.init_random_params("alex", LPIPS_SEED)
    arrays = {f"conv{i}_{k}": np.asarray(t) for i, wb in enumerate(p["convs"]) for k, t in zip("wb", wb)}
    arrays.update({f"lin{i}_w": np.asarray(w) for i, w in enumerate(p["lins"])})
    path = os.path.join(tmp, "lpips_alex.npz")
    np.savez(path, **arrays)
    return path


@functools.lru_cache(maxsize=None)
def _trained():
    """A port run on the synthetic scene (CPU, binned), once per process: 2
    steps with lpips_weights and compression="png", an eval and a save at
    step 2; the LPIPS calls' inputs and values recorded. Returns (result
    dir, eval stats, [(render, pixels, value, net, normalize)])."""
    tmp = tempfile.mkdtemp(prefix="apps_")
    calls = []
    real = lpips.lpips

    def recording(params, img0, img1, net_type="alex", normalize=True):
        out = real(params, img0, img1, net_type, normalize)
        calls.append((img0.numpy().copy(), img1.numpy().copy(), float(out), net_type, normalize))
        return out

    res = os.path.join(tmp, "run")
    cfg = st.Config(data_dir=scene_dir(), data_factor=1, result_dir=res, max_steps=2, eval_steps=[2],
                    save_steps=[2], sh_degree=1, backend="binned", seed=3, tb_every=0, compression="png",
                    lpips_weights=_lpips_npz(tmp))
    lpips.lpips = recording
    try:
        runner = st.Runner.from_colmap(cfg, device="cpu")
        runner.train()
    finally:
        lpips.lpips = real
    return res, json.load(open(os.path.join(res, "val_step2.json"))), calls


@pytest.fixture
def trained():
    return _trained()


def test_trainer_lpips_equals_jax_on_the_port_renders(trained):
    warm_exp()
    _, val, calls = trained
    assert calls and all(net == "alex" and normalize for *_, net, normalize in calls)
    params = jl.init_random_params("alex", LPIPS_SEED)
    for render, pixels, got, *_ in calls:
        want = float(jl.lpips(params, jnp.asarray(render), jnp.asarray(pixels), net_type="alex", normalize=True))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    # the last eval of step 2 is the compressed round trip's (as in JAX)
    n = len(calls) // 2
    assert val["lpips"] == pytest.approx(float(np.mean([c[2] for c in calls[n:]])), rel=1e-12)


def test_trainer_compression_reads_in_jax(trained):
    res, val, _ = trained
    cdir = os.path.join(res, "compression_2")
    report = json.load(open(os.path.join(cdir, "report.json")))
    assert report["step"] == 2 and report["size_bytes"] > 0 and report["lpips"] == val["lpips"]
    assert report["num_GS"] == json.load(open(os.path.join(cdir, "meta.json")))["means"]["shape"][0]
    got, want = PngCompression(device="cpu").decompress(cdir), JaxPng().decompress(cdir)
    assert sorted(got) == sorted(want) == ["means", "opacities", "quats", "scales", "sh0", "shN"]
    for k in want:
        if k == "means":  # expm1: torch's and XLA's (test_torch_compression.py)
            np.testing.assert_array_max_ulp(got[k], want[k], maxulp=4)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_compress_eval_script_writes_three_rows(trained, tmp_path):
    res, _, _ = trained
    spec = importlib.util.spec_from_file_location("torch_compress_eval", os.path.join(ROOT, "scripts",
                                                                                        "torch_compress_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out_csv = str(tmp_path / "compression.csv")
    rows = mod.main(["--ckpt", os.path.join(res, "ckpt_2.npz"), "--data-dir", scene_dir(), "--out-csv", out_csv,
                     "--cpu"])
    lines = open(out_csv).read().splitlines()
    assert lines[0] == "variant,n_gaussians,bytes,psnr,ssim" and len(lines) == 5
    assert [r["variant"] for r in rows] == ["unsorted", "serpentine", "serpentine+plas"]
    assert [line.split(",")[0] for line in lines[1:4]] == ["unsorted", "serpentine", "serpentine+plas"]
    assert lines[4].startswith("# uncompressed: n_gaussians=")
    assert all(r["bytes"] > 0 and np.isfinite(r["psnr"]) for r in rows)
    assert len({r["n_gaussians"] for r in rows}) == 1
