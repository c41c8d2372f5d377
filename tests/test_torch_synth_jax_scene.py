"""The port's synthetic-scene writer in its JAX mode
(``python -m gsplat_tpu_torch.datasets.synth --jax-scene``) against
scripts/make_synth_dataset.py itself, both on the CPU at a tiny size (300
ground-truth splats, 3 views of 48x32, 100 points):

- the camera (model, size, intrinsics) and every image's pose equal, bit
  for bit (both compute them in float64 from the same float32 points);
- the ground-truth splats equal: the JAX script's are caught at its call
  of ``gsplat_tpu.rasterization``, the port's come back from ``main``;
- the initial points' positions, colours and errors equal, in the same
  order (the JAX script's points have no tracks; the port's list their
  observations, extra data the JAX script does not write);
- the images within 1 level of 255 on all but 0.5% of the pixels, none
  off by more than 8 levels: the JAX script renders with its oracle, the
  port with the binned backend's plain version, and a value on a level's
  edge truncates to either side (at this size every level is equal).
"""

import importlib.util
import os
import sys

import jax
import numpy as np

import gsplat_tpu
from gsplat_tpu_torch.datasets import colmap_io, image_io, synth

from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--width", "48", "--height", "32", "--gt-splats", "300", "--n-points", "100", "--seed", "3"]
N_VIEWS = 3


def _run_jax_script(out, monkeypatch):
    """scripts/make_synth_dataset.py --cpu in this process; returns the
    splats it handed to gsplat_tpu.rasterization."""
    spec = importlib.util.spec_from_file_location("make_synth_dataset", os.path.join(ROOT, "scripts",
                                                                                      "make_synth_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}
    render = gsplat_tpu.rasterization

    def record(*arrays):
        seen.update(zip(("means", "quats", "scales", "opacities", "colors"), map(np.asarray, arrays)))

    def hook(means, quats, scales, opacities, colors, *args, **kw):
        # the script renders under jit: the splats are read when it runs
        jax.debug.callback(record, means, quats, scales, opacities, colors)
        return render(means, quats, scales, opacities, colors, *args, **kw)

    monkeypatch.setattr(gsplat_tpu, "rasterization", hook)
    monkeypatch.setattr(sys, "argv", ["make_synth_dataset.py", "--cpu", "--out", out, "--n-cams", str(N_VIEWS)]
                        + ARGS)
    mod.main()
    return seen


def test_jax_scene_matches_the_jax_script(tmp_path, monkeypatch):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _run_jax_script(jdir, monkeypatch)
    info = synth.main(["--jax-scene", "--out", tdir, "--n-views", str(N_VIEWS), "--device", "cpu"] + ARGS)

    got = info["splats"]
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k

    jcams, tcams = (colmap_io.read_cameras_bin(os.path.join(d, "sparse", "0", "cameras.bin")) for d in (jdir, tdir))
    assert sorted(jcams) == sorted(tcams) == [1]
    a, b = jcams[1], tcams[1]
    assert (a.model, a.width, a.height) == (b.model, b.width, b.height) and np.array_equal(a.params, b.params)
    jimgs, timgs = (colmap_io.read_images_bin(os.path.join(d, "sparse", "0", "images.bin")) for d in (jdir, tdir))
    assert sorted(jimgs) == sorted(timgs) == list(range(1, N_VIEWS + 1))
    for i in jimgs:
        a, b = jimgs[i], timgs[i]
        assert a.name == b.name and a.camera_id == b.camera_id
        assert np.array_equal(a.qvec, b.qvec) and np.array_equal(a.tvec, b.tvec), i
        assert len(a.point3D_ids) == 0 and len(b.point3D_ids) > 0

    jpts, tpts = (colmap_io.read_points3d_bin(os.path.join(d, "sparse", "0", "points3D.bin")) for d in (jdir, tdir))
    for a, b in zip(jpts[:3], tpts[:3]):  # positions, colours, errors
        assert a.shape == b.shape and np.array_equal(a, b)
    np.testing.assert_array_equal(tpts[0], want["means"][info["keep"]].astype(np.float64))

    for i in range(N_VIEWS):
        name = f"view_{i:03d}.png"
        a, b = (image_io.read_png(os.path.join(d, "images", name)).astype(np.int32) for d in (jdir, tdir))
        assert a.shape == b.shape == (32, 48, 3)
        diff = np.abs(a - b)
        assert (diff > 1).mean() <= 5e-3 and diff.max() <= 8, (name, (diff > 1).mean(), diff.max())
