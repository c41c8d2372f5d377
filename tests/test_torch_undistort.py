"""The port's resize, remap and undistortion (gsplat_tpu_torch.datasets
image_io.py, undistort.py, colmap.py) against PIL, cv2 and the JAX
package's Parser, and its fisheye trainer and TensorBoard logging against
the JAX trainer.

- `resize_bilinear` equals PIL's ``resize(..., BILINEAR)`` bit for bit,
  down and up, grey and RGB.
- `remap_bilinear` within 1 level of ``cv2.remap(..., INTER_LINEAR)`` on
  at most 0.01% of the values (equal elsewhere), constant and replicate
  borders, on random maps that cross the border and on undistortion maps.
- The camera maps: K_new within 1e-12 relative of
  ``cv2.getOptimalNewCameraMatrix``, the roi equal, the maps within 1e-3
  px of ``cv2.initUndistortRectifyMap``.
- `Parser` against the JAX package's for SIMPLE_RADIAL, RADIAL, OPENCV and
  OPENCV_FISHEYE cameras at factor 1 and at factor 2 without images_2/:
  Ks_dict within 1e-5 relative, imsize_dict and roi equal, fisheye maps
  and masks bit for bit, OPENCV maps within 1e-3 px; `Dataset` items
  within 1 level (/255) on at most 0.1% of the values and otherwise
  equal, "mask" included.
- Two steps of the port's trainer with camera_model="fisheye" on
  tests/test_fisheye.py's 64x48 scene (the views' pixel masks applied)
  against the JAX Runner's, both on the oracle, each from JAX's state
  before it: parameters and moments within test_torch_trainer_colmap.py's
  tolerances (a black point's sh0 channels apart: the test's docstring).
  With tb_every=1 and tb_save_image, the event files the port writes into
  result_dir/tb hold the JAX trainer's tags and steps (its writes
  recorded), the scalars within rtol 1e-4 and the render image within 1
  level on at most 1% of its values.
"""

import functools
import io
import os
import shutil
import struct
import tempfile

import cv2
import numpy as np
import pytest
from PIL import Image

from gsplat_tpu.datasets import Dataset as JaxDataset
from gsplat_tpu.datasets import Parser as JaxParser
from gsplat_tpu_torch.datasets import Dataset, Parser, image_io, undistort

from torch_exp_warmup import one_torch_thread, warm_exp  # noqa: F401 (one_torch_thread: an autouse fixture)
from torch_synth_scene import H, W, scene_dir

PARAM_ATOL, MOMENT_ATOL = 1e-4, 1e-6  # test_torch_trainer_colmap.py's


@pytest.fixture(autouse=True)
def jax_python_colmap_reader(monkeypatch):
    """The JAX Parser reads through its Python reader: its native one
    compiles with g++ first."""
    from gsplat_tpu.datasets import colmap_native

    monkeypatch.setattr(colmap_native, "_build_and_load", lambda: None)


def _image(h, w, ch, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 7.0) * 60 + np.cos(yy / 5.0) * 50 + 120)[..., None] + np.arange(ch) * 30
    img = np.clip(base + rng.normal(0, 25, (h, w, ch)), 0, 255).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


@pytest.mark.parametrize("src,dst", [((64, 48), (32, 24)), ((647, 421), (161, 105)), ((131, 97), (200, 150)),
                                     ((97, 61), (48, 30)), ((7, 5), (3, 11)), ((1, 1), (4, 3))])
@pytest.mark.parametrize("ch", [1, 3])
def test_resize_matches_pil(src, dst, ch):
    img = _image(src[1], src[0], ch, seed=src[0])
    want = np.asarray(Image.fromarray(img).resize(dst, Image.Resampling.BILINEAR))
    got = image_io.resize_bilinear(img, dst)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _check_remap(got, want, share=1e-4):
    d = np.abs(got.astype(np.int32) - want)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert d.max() <= 1 and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("border", ["constant", "replicate"])
@pytest.mark.parametrize("ch", [1, 3])
def test_remap_matches_cv2(border, ch):
    bm = {"constant": cv2.BORDER_CONSTANT, "replicate": cv2.BORDER_REPLICATE}[border]
    rng = np.random.default_rng(ch)
    h, w = 421, 647
    img = _image(h, w, ch, seed=5)
    # random maps reaching 3 pixels past every edge, a few far off and NaN
    mx = (rng.random((h, w)) * (w + 6) - 3).astype(np.float32)
    my = (rng.random((h, w)) * (h + 6) - 3).astype(np.float32)
    mx[0, :5] = [-1e9, 1e9, np.nan, -2.5, w - 0.5]
    K = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]])
    dist = np.array([-0.05, 0.01, 0.001, -0.002])
    Kn, _ = cv2.getOptimalNewCameraMatrix(K, dist, (w, h), 0)
    ux, uy = cv2.initUndistortRectifyMap(K, dist, None, Kn, (w, h), cv2.CV_32FC1)
    for a, b in ((mx, my), (ux, uy)):
        want = cv2.remap(img, a, b, cv2.INTER_LINEAR, borderMode=bm)
        _check_remap(image_io.remap_bilinear(img, a, b, border), want)


@pytest.mark.parametrize("dist", [(-0.05, 0.01, 0.0, 0.0), (0.1, -0.03, 0.002, -0.001), (-0.3, 0.1, 0.01, 0.005)])
def test_camera_maps_match_cv2(dist):
    for w, h in ((64, 48), (1920, 1080), (97, 61)):
        K = np.array([[0.8 * w, 0, w / 2 + 1.3], [0, 0.8 * w + 0.7, h / 2 - 0.4], [0, 0, 1]], np.float32)
        K, d = K.astype(np.float64), np.array(dist, np.float32).astype(np.float64)
        Kn, roi = cv2.getOptimalNewCameraMatrix(K, d, (w, h), 0)
        mx, my = cv2.initUndistortRectifyMap(K, d, None, Kn, (w, h), cv2.CV_32FC1)
        got_K, got_roi = undistort.optimal_new_camera_matrix(K, d, w, h)
        np.testing.assert_allclose(got_K, Kn, rtol=1e-12)
        assert got_roi == tuple(roi)
        gx, gy = undistort.undistort_rectify_map(K, d, got_K, w, h)
        assert gx.dtype == np.float32 and gx.shape == (h, w)
        np.testing.assert_allclose(gx, mx, rtol=0, atol=1e-3)
        np.testing.assert_allclose(gy, my, rtol=0, atol=1e-3)


# camera model id, its parameters at the scene's 64x48 (f, cx, cy first)
CAMERAS = {
    "SIMPLE_RADIAL": (2, (52.0, 32.5, 23.6, -0.08)),
    "RADIAL": (3, (52.0, 31.7, 24.2, -0.06, 0.02)),
    "OPENCV": (4, (52.0, 53.0, 32.4, 23.8, -0.05, 0.01, 0.002, -0.001)),
    "OPENCV_FISHEYE": (5, (0.55 * W, 0.55 * W, W / 2, H / 2, 0.08, 0.015, 0.0, 0.0)),
}


@functools.lru_cache(maxsize=None)
def _distorted_scene(model):
    """The tiny synth scene with its camera replaced (no images_2/)."""
    mid, params = CAMERAS[model]
    out = os.path.join(tempfile.mkdtemp(prefix="distorted_"), "s")
    shutil.copytree(scene_dir(), out)
    with open(os.path.join(out, "sparse", "0", "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, mid, W, H) + struct.pack(f"<{len(params)}d", *params))
    return out


def _check_items(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        if k == "image":
            g, w = np.round(got[k] * 255).astype(np.int32), np.round(want[k] * 255).astype(np.int32)
            assert g.shape == w.shape and got[k].dtype == want[k].dtype, what
            d = np.abs(g - w)
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (what, d.max(), (d > 0).mean())
            np.testing.assert_array_equal(got[k][d == 0], want[k][d == 0])
        elif k == "mask":
            assert got[k].dtype == want[k].dtype == bool
            np.testing.assert_array_equal(got[k], want[k], err_msg=what)
        elif k == "image_id":
            assert got[k] == want[k]
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=f"{what} {k}")


@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("model", list(CAMERAS))
def test_parser_matches_jax(model, factor):
    d = _distorted_scene(model)
    got, want = Parser(d, factor=factor, normalize=True), JaxParser(d, factor=factor, normalize=True)
    cam = 1
    np.testing.assert_allclose(got.Ks_dict[cam], want.Ks_dict[cam], rtol=1e-5)
    assert got.Ks_dict[cam].dtype == np.float32
    assert got.imsize_dict == want.imsize_dict and got._roi == want._roi
    np.testing.assert_array_equal(got.params_dict[cam], want.params_dict[cam])
    if model == "OPENCV_FISHEYE":
        for a in ("_mapx", "_mapy"):
            np.testing.assert_array_equal(getattr(got, a)[cam], getattr(want, a)[cam])
        np.testing.assert_array_equal(got.mask_dict[cam], want.mask_dict[cam])
        assert not got.mask_dict[cam].all() and got.mask_dict[cam].shape == got.imsize_dict[cam][::-1]
    else:
        for a in ("_mapx", "_mapy"):
            g, w = getattr(got, a)[cam], getattr(want, a)[cam]
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
        assert got.mask_dict[cam] is None is want.mask_dict[cam]
    for split in ("train", "val"):
        gd, wd = Dataset(got, split, load_depths=True), JaxDataset(want, split, load_depths=True)
        assert len(gd) == len(wd)
        for i in range(len(wd)):
            g, w = gd[i], wd[i]
            assert g["image"].shape[:2] == got.imsize_dict[cam][::-1]
            _check_items(g, w, f"{model} factor {factor} {split} {i}")


def test_resize_without_images_dir_matches_jax():
    """A pinhole scene at factor 2 and 3 without images_{factor}/: the JAX
    Parser resizes with PIL, the port with resize_bilinear: the same
    bits."""
    for factor in (2, 3):
        got, want = Dataset(Parser(scene_dir(), factor=factor)), JaxDataset(JaxParser(scene_dir(), factor=factor))
        for i in range(len(want)):
            g, w = got[i], want[i]
            assert g["image"].shape == (H // factor, W // factor, 3)
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["K"], w["K"])


FISHEYE_CFG = dict(data_factor=1, max_steps=2, eval_steps=[], save_steps=[], sh_degree=1, sh_degree_interval=1000,
                   refine_start_iter=100, test_every=5, camera_model="fisheye", seed=3, tb_every=1,
                   tb_save_image=True)


class _Recorder:
    """Stands in for the JAX trainer's SummaryWriter: what it logs."""

    def __init__(self):
        self.scalars, self.images = {}, {}

    def add_scalar(self, tag, value, step):
        self.scalars[(tag, int(step))] = float(value)

    def add_image(self, tag, img, step, dataformats="HWC"):
        assert dataformats == "HWC"
        self.images[(tag, int(step))] = np.asarray(img)

    def flush(self):
        pass


@functools.lru_cache(maxsize=None)
def _jax_fisheye():
    """The JAX Runner with camera_model="fisheye" on test_fisheye.py's
    scene: 2 steps of its `train`, its state before each step and after
    the last, and its TensorBoard writes recorded. Built once per
    process."""
    from gsplat_tpu.datasets import colmap_native
    from gsplat_tpu_torch import simple_trainer as st
    from test_fisheye import _fisheye_colmap
    from test_torch_trainer import _jax_trainer
    from test_torch_trainer_colmap import _jax_state

    warm_exp()
    data = os.path.join(tempfile.mkdtemp(prefix="fisheye_"), "scene")
    _fisheye_colmap(data, np.random.default_rng(0))
    jt = _jax_trainer()
    real = colmap_native._build_and_load, jt.knn_distances
    colmap_native._build_and_load = lambda: None
    jt.knn_distances = st.knn_distances  # scipy's: the same distances, no scikit-learn import
    try:
        jr = jt.Runner(jt.Config(data_dir=data, result_dir=tempfile.mkdtemp(), **FISHEYE_CFG))
    finally:
        colmap_native._build_and_load, jt.knn_distances = real
    assert jr._has_pix_masks
    # an anisotropic start, as in test_torch_trainer_colmap.py: with
    # isotropic kNN scales the rotations' gradient is rounding noise
    import jax.numpy as jnp

    noise = np.random.default_rng(0).normal(0.0, 0.3, jr.params["scales"].shape).astype(np.float32)
    jr.params = {**jr.params, "scales": jr.params["scales"] + jnp.asarray(noise)}
    states = [_jax_state(jr)]
    grow = jr._maybe_grow

    def snapshot(*args, **kwargs):  # called after each step's update
        states.append(_jax_state(jr))
        return grow(*args, **kwargs)

    jr._maybe_grow = snapshot
    rec = jr._tb_writer = _Recorder()
    jr.train()
    return data, states, rec


def _port_runner(data, out=None):
    from gsplat_tpu_torch import simple_trainer as st

    cfg = st.Config(data_dir=data, result_dir=out or tempfile.mkdtemp(), tile_size=16, backend="auto", **FISHEYE_CFG)
    return st.Runner.from_colmap(cfg, device="cpu")


def test_fisheye_trainer_matches_jax():
    """Each step from the JAX trainer's state before it (splats, moments and
    Adam's count), on the oracle: the port's parameters and moments after
    it against JAX's, by test_torch_trainer_colmap.py's tolerances. The sh0
    channels of a black initial point are exempt: their colour sh0 C0 + 0.5
    is 0 to float32 rounding, at the clamp, where the port passes half the
    gradient (torch.maximum at a tie, as JAX's clip does eagerly) and the
    JAX trainer's jitted step none (its contracted multiply-add lands below
    0); the rendered colour is 0 either way, so no other gradient moves."""
    import copy

    import torch

    data, states, _ = _jax_fisheye()
    runner = _port_runner(data)
    item = runner.trainset[0]
    assert "mask" in item and not item["mask"].all() and item["mask"].shape == item["image"].shape[:2]
    tie = (np.float32(0.28209479177387814) * states[0]["params"]["sh0"] + np.float32(0.5)) == 0
    assert 0 < tie.sum() <= 0.02 * tie.size
    for step in range(2):
        start = copy.deepcopy(states[step])
        runner.set_state(start["params"], start["live"], start["aux"])
        for k, p in runner.params.items():
            if step:
                runner.optimizers[k].state[p] = {"step": step, "exp_avg": torch.from_numpy(start["moments"][k][0]),
                                                 "exp_avg_sq": torch.from_numpy(start["moments"][k][1])}
        out = runner.train_step(step)
        assert np.isfinite(float(out["loss"]))
        want = states[step + 1]
        np.testing.assert_array_equal(runner.live.numpy(), want["live"])
        for k, p in runner.params.items():
            lr = runner.cfg.means_lr * runner.scene_scale if k == "means" else runner.optimizers[k].param_groups[0]["lr"]
            keep = ~tie if k == "sh0" else np.ones(p.shape, bool)
            state = runner.optimizers[k].state[p]
            np.testing.assert_allclose(p.detach().numpy()[keep], want["params"][k][keep], rtol=1e-4,
                                       atol=PARAM_ATOL * lr, err_msg=f"step {step} {k}")
            for got, w, name in ((state["exp_avg"], want["moments"][k][0], "mu"),
                                 (state["exp_avg_sq"], want["moments"][k][1], "nu")):
                np.testing.assert_allclose(got.numpy()[keep], w[keep], rtol=1e-4,
                                           atol=MOMENT_ATOL * max(float(np.abs(w).max()), 1e-12),
                                           err_msg=f"step {step} {k} {name}")


def _events(tb_dir):
    """Every scalar and image in the event files under `tb_dir`:
    ({(tag, step): value}, {(tag, step): uint8 [H, W, C]})."""
    from tensorboard.compat.proto import event_pb2

    scalars, images = {}, {}
    for name in sorted(os.listdir(tb_dir)):
        with open(os.path.join(tb_dir, name), "rb") as f:
            buf = f.read()
        pos = 0
        while pos < len(buf):  # TFRecord: u64 length, u32 crc, data, u32 crc
            (n,) = struct.unpack_from("<Q", buf, pos)
            ev = event_pb2.Event.FromString(buf[pos + 12 : pos + 12 + n])
            pos += 16 + n
            for v in ev.summary.value:
                if v.HasField("image"):
                    images[(v.tag, ev.step)] = np.asarray(Image.open(io.BytesIO(v.image.encoded_image_string)))
                elif v.HasField("simple_value"):
                    scalars[(v.tag, ev.step)] = v.simple_value
                elif v.HasField("tensor"):
                    scalars[(v.tag, ev.step)] = float(np.frombuffer(v.tensor.tensor_content, np.float32)[0]
                                                      if v.tensor.tensor_content else v.tensor.float_val[0])
    return scalars, images


def test_tensorboard_matches_jax():
    """The port's `train` from the JAX trainer's initial state, 2 steps with
    tb_every=1 and tb_save_image: its event files hold the JAX trainer's
    tags and steps, the scalars within rtol 1e-4, the images within 1
    level on at most 1% of the values."""
    import copy

    data, states, rec = _jax_fisheye()
    out = tempfile.mkdtemp(prefix="fisheye_tb_")
    runner = _port_runner(data, out)
    start = copy.deepcopy(states[0])
    runner.set_state(start["params"], start["live"], start["aux"])
    runner.train()
    scalars, images = _events(os.path.join(out, "tb"))
    assert sorted(scalars) == sorted(rec.scalars) and len(scalars) == 8
    assert {t for t, _ in scalars} == {"train/loss", "train/num_GS", "train/n_isects", "train/mem_params_mb"}
    for key, w in rec.scalars.items():
        assert scalars[key] == pytest.approx(w, rel=1e-4, abs=1e-6), key
    assert sorted(images) == sorted(rec.images) == [("train/render", 0), ("train/render", 1)]
    for key, w in rec.images.items():
        w8 = (np.asarray(w, np.float32) * 255).clip(0, 255).astype(np.uint8)  # torch's add_image conversion
        g = images[key][..., :3]
        assert g.shape == w8.shape, key
        d = np.abs(g.astype(np.int32) - w8)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-2, (key, d.max(), (d > 0).mean())
