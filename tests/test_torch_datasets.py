"""Port datasets (gsplat_tpu_torch.datasets) vs the JAX package's.

- A tiny scene written by datasets/synth.py (tests/torch_synth_scene.py:
  6 views of 64x48, 300 points, each view's observations) read by both
  packages' Parser with normalize=True: every field equal (floats within
  rtol 1e-6), point_indices equal; Dataset items of both splits equal,
  with points/depths.
- The COLMAP text readers of both packages on the same model: equal.
- The PNG reader against PIL on PNGs PIL writes (grey, grey + alpha, RGB,
  RGBA, with and without `optimize`) and on a handmade file with rows of
  every filter type: equal bytes; the writer's files read back equal by
  PIL and the reader.
- The trajectories equal JAX's within rtol 1e-6.
- A distorted camera (OPENCV, OPENCV_FISHEYE, SIMPLE_RADIAL) and an image
  that needs a resize load as the JAX package's Parser loads them (with
  cv2 and PIL); a scene of JPEG views reads without PIL; synth --fisheye
  writes an OPENCV_FISHEYE scene whose items carry the mask.
"""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from gsplat_tpu.datasets import Dataset as JaxDataset
from gsplat_tpu.datasets import Parser as JaxParser
from gsplat_tpu.datasets import colmap_io as jax_io
from gsplat_tpu.datasets import traj as jax_traj
from gsplat_tpu_torch.datasets import Dataset, Parser, colmap_io, image_io, synth, traj

from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_synth_scene import N_POINTS, N_VIEWS, H, W, scene_dir

RTOL = 1e-6


@pytest.fixture(autouse=True)
def jax_python_colmap_reader(monkeypatch):
    """The JAX Parser reads through its Python reader: its native one
    compiles with g++ first (~20 s), and the port has none."""
    from gsplat_tpu.datasets import colmap_native

    monkeypatch.setattr(colmap_native, "_build_and_load", lambda: None)


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (name, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("normalize", [True, False])
def test_parser_matches_jax(normalize):
    d = scene_dir()
    got, want = Parser(d, normalize=normalize), JaxParser(d, normalize=normalize)
    assert got.image_names == want.image_names == [f"view_{i:03d}.png" for i in range(N_VIEWS)]
    assert got.image_paths == want.image_paths and got.camera_ids == want.camera_ids
    assert got.scene_scale == pytest.approx(want.scene_scale, rel=RTOL)
    for name in ("camtoworlds", "points", "points_rgb", "points_err", "transform"):
        _close(getattr(got, name), getattr(want, name), name)
    assert got.points.shape == (N_POINTS, 3)
    for attr in ("Ks_dict", "params_dict", "imsize_dict", "mask_dict"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert sorted(g) == sorted(w)
        for k in w:
            if w[k] is None or isinstance(w[k], tuple):
                assert g[k] == w[k], (attr, k)
            else:
                _close(g[k], w[k], f"{attr}[{k}]")
    assert sorted(got.point_indices) == sorted(want.point_indices)
    n_obs = 0
    for name, rows in want.point_indices.items():
        np.testing.assert_array_equal(got.point_indices[name], rows, err_msg=name)
        n_obs += len(rows)
    assert n_obs > N_VIEWS * 100  # the writer lists each view's observations


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_items_match_jax(split):
    d = scene_dir()
    got = Dataset(Parser(d, normalize=True), split, load_depths=True)
    want = JaxDataset(JaxParser(d, normalize=True), split, load_depths=True)
    assert len(got) == len(want) == (N_VIEWS - 1 if split == "train" else 1)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w) == ["K", "camtoworld", "depths", "image", "image_id", "points"]
        assert g["image_id"] == w["image_id"]
        np.testing.assert_array_equal(g["image"], w["image"])
        assert g["image"].shape == (H, W, 3) and g["image"].dtype == np.float32
        for k in ("K", "camtoworld", "points", "depths"):
            _close(g[k], w[k], f"{split} {i} {k}")
        assert len(g["points"]) > 0


def test_text_model_matches_jax(tmp_path):
    """The binary model written out as COLMAP text, read by both packages'
    text readers (an image with no observations included)."""
    cams, imgs, (xyz, rgb, err, ids) = colmap_io.read_model(os.path.join(scene_dir(), "sparse", "0"))
    with open(tmp_path / "cameras.txt", "w") as f:
        f.write("# camera list\n")
        for c in cams.values():
            f.write(f"{c.camera_id} {c.model} {c.width} {c.height} " + " ".join(repr(float(p)) for p in c.params) + "\n")
    def write_images(empty=None):
        with open(tmp_path / "images.txt", "w") as f:
            f.write("# image list\n# two lines each\n")
            for k, im in enumerate(imgs.values()):
                f.write(f"{im.image_id} " + " ".join(repr(float(v)) for v in (*im.qvec, *im.tvec))
                        + f" {im.camera_id} {im.name}\n")
                n = 0 if k == empty else len(im.xys)
                f.write(" ".join(f"{x!r} {y!r} {int(p)}" for (x, y), p in zip(im.xys[:n].tolist(), im.point3D_ids[:n]))
                        + "\n")

    write_images()
    with open(tmp_path / "points3D.txt", "w") as f:
        for i in range(len(xyz)):
            f.write(f"{ids[i]} " + " ".join(repr(float(v)) for v in xyz[i]) + " " + " ".join(str(int(v)) for v in rgb[i])
                    + f" {float(err[i])!r} 1 0\n")
    got = colmap_io.read_model(str(tmp_path))
    want = jax_io.read_model(str(tmp_path))
    for k, c in want[0].items():
        g = got[0][k]
        assert (g.model, g.width, g.height) == (c.model, c.width, c.height)
        np.testing.assert_array_equal(g.params, c.params)
    for k, im in imgs.items():
        g, w = got[1][k], want[1][k]
        assert (g.name, g.camera_id) == (w.name, w.camera_id)
        for a in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(g, a), getattr(w, a), err_msg=a)
    for a, b in zip(got[2][:3], want[2][:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2][3], sorted(want[2][3], key=want[2][3].get))
    # an image with no observations has an empty second line, which the
    # port's reader keeps in step (the JAX reader drops empty lines)
    write_images(empty=2)
    got = colmap_io.read_images_txt(str(tmp_path / "images.txt"))
    assert [len(im.xys) for im in got.values()] == [0 if k == 2 else len(im.xys) for k, im in enumerate(imgs.values())]
    assert [im.name for im in got.values()] == [im.name for im in imgs.values()]


def _image(h, w, ch, seed):
    """Smooth ramps plus noise: PIL's encoder picks several filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 7 + yy * 3)[..., None] + np.arange(ch) * 40
    return ((base + rng.integers(0, 24, (h, w, ch))) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("optimize", [False, True])
def test_png_reader_matches_pil(tmp_path, mode, optimize):
    arr = _image(37, 53, len(mode), seed=len(mode))
    path = str(tmp_path / "img.png")
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode=mode).save(path, optimize=optimize)
    want = np.asarray(Image.open(path).convert("RGB"))
    got = image_io.read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_io.load_image(path), want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def test_png_reader_every_filter_type(tmp_path):
    """A handmade 10x6 RGB PNG whose rows use filter types 0-4 twice over,
    filtered by the PNG specification's formulas, one byte at a time."""
    img = _image(10, 6, 3, seed=9)
    bpp, raw = 3, b""
    prior = [0] * 18
    for r in range(10):
        kind = r % 5
        cur = img[r].reshape(-1).tolist()
        out = []
        for i, x in enumerate(cur):
            a = cur[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
            out.append((x - pred) % 256)
        raw += bytes([kind] + out)
        prior = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    path = str(tmp_path / "filters.png")
    with open(path, "wb") as f:
        f.write(image_io.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 6, 10, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(image_io.read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), img)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ch", [1, 3, 4])
def test_png_writer_reads_back(tmp_path, ch, filter_type):
    """The writer's files, every row carrying one filter type, read back
    by PIL and by the reader (Average and Paeth through its anti-diagonal
    path, on a frame wider than it is tall and one taller than wide)."""
    for h, w in ((21, 34), (34, 7)):
        arr = _image(h, w, ch, seed=ch + filter_type)
        path = str(tmp_path / f"w{h}.png")
        size = image_io.write_png(path, arr[..., 0] if ch == 1 else arr, filter_type=filter_type)
        assert size == os.path.getsize(path)
        want = np.asarray(Image.open(path).convert("RGB"))
        rgb = np.repeat(arr, 3, axis=2) if ch == 1 else arr[..., :3]
        np.testing.assert_array_equal(want, rgb)
        np.testing.assert_array_equal(image_io.read_png(path), rgb)


def test_trajectories_match_jax():
    c2w = Parser(scene_dir(), normalize=True).camtoworlds[:, :3, :4].astype(np.float64)
    pairs = [
        (traj.generate_interpolated_path(c2w, 4), jax_traj.generate_interpolated_path(c2w, 4)),
        (traj.generate_ellipse_path_z(c2w, height=0.3), jax_traj.generate_ellipse_path_z(c2w, height=0.3)),
        (traj.generate_spiral_path(c2w, np.array([0.5, 4.0])), jax_traj.generate_spiral_path(c2w, np.array([0.5, 4.0]))),
    ]
    for got, want in pairs:
        assert got.shape == want.shape and len(got) > 10
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9)


def _copy_scene(src, dst, cameras_bin=None, factor_dir=None):
    import shutil

    shutil.copytree(src, dst)
    if cameras_bin is not None:
        with open(os.path.join(dst, "sparse", "0", "cameras.bin"), "wb") as f:
            f.write(cameras_bin)
    return str(dst)


@pytest.mark.parametrize("model,params", [(4, (50.0, 50.0, 32.0, 24.0, 0.01, 0.0, 0.0, 0.0)),
                                          (5, (50.0, 50.0, 32.0, 24.0, 0.06, 0.012, 0.0, 0.0)),
                                          (2, (50.0, 32.0, 24.0, -0.02))])
def test_distorted_camera_matches_jax(tmp_path, model, params):
    """OPENCV, OPENCV_FISHEYE and SIMPLE_RADIAL with non-zero distortion:
    the port's Parser undistorts as the JAX package's does with cv2 (the
    intrinsics within rtol 1e-5, the size, roi and fisheye mask equal; each
    item's image within 1 level on at most 0.1% of its values)."""
    body = struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, model, W, H) + struct.pack(f"<{len(params)}d", *params)
    d = _copy_scene(scene_dir(), tmp_path / "s", cameras_bin=body)
    got, want = Parser(d), JaxParser(d)
    np.testing.assert_allclose(got.Ks_dict[1], want.Ks_dict[1], rtol=1e-5)
    assert got.imsize_dict == want.imsize_dict and got._roi == want._roi
    if model == 5:
        np.testing.assert_array_equal(got.mask_dict[1], want.mask_dict[1])
    for g, w in zip(Dataset(got, "train"), JaxDataset(want, "train")):
        assert sorted(g) == sorted(w) and g["image"].shape == w["image"].shape
        diff = np.abs(np.round(g["image"] * 255) - np.round(w["image"] * 255))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_resize_matches_jax(tmp_path):
    """factor 2 without images_2/: the JAX Parser resizes with PIL, the port
    with its own bilinear resize: the same bits."""
    d = _copy_scene(scene_dir(), tmp_path / "s")
    p, jp = Parser(d, factor=2), JaxParser(d, factor=2)
    assert p.imsize_dict[1] == (W // 2, H // 2)
    for g, w in zip(Dataset(p, "train"), JaxDataset(jp, "train")):
        assert g["image"].shape == (H // 2, W // 2, 3)
        np.testing.assert_array_equal(g["image"], w["image"])


def test_jpeg_scene_without_pil(tmp_path, monkeypatch):
    """The scene with its views stored as JPEGs (named .jpg in images.bin):
    the port's Dataset reads them with PIL's import blocked, each item the
    JAX Dataset's (which decodes with PIL) bit for bit."""
    import builtins

    d = _copy_scene(scene_dir(), tmp_path / "s")
    img_dir = os.path.join(d, "images")
    for name in sorted(os.listdir(img_dir)):
        arr = image_io.read_png(os.path.join(img_dir, name))
        os.remove(os.path.join(img_dir, name))
        Image.fromarray(arr).save(os.path.join(img_dir, name[:-4] + ".jpg"), quality=90)
    images_bin = os.path.join(d, "sparse", "0", "images.bin")
    with open(images_bin, "rb") as f:
        body = f.read()
    with open(images_bin, "wb") as f:
        f.write(body.replace(b".png\x00", b".jpg\x00"))
    want = [item["image"] for item in JaxDataset(JaxParser(d), "train")]
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    got = Dataset(Parser(d), "train")
    assert len(got) == len(want) and got.parser.image_paths[1].endswith(".jpg")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w)


def test_synth_fisheye_command_line(tmp_path):
    """synth --fisheye: an OPENCV_FISHEYE camera with the JAX script's k,
    whose Parser carries the fisheye mask into every item."""
    synth.main(["--out", str(tmp_path / "f"), "--n-views", "2", "--width", "40", "--height", "30",
                "--n-points", "50", "--gt-splats", "500", "--device", "cpu", "--fisheye"])
    cams = colmap_io.read_cameras_bin(str(tmp_path / "f" / "sparse" / "0" / "cameras.bin"))
    assert cams[1].model == "OPENCV_FISHEYE" and list(cams[1].params[4:]) == list(synth.FISHEYE_K)
    p = Parser(str(tmp_path / "f"))
    item = Dataset(p, "val")[0]
    assert item["mask"].shape == item["image"].shape[:2] == p.imsize_dict[1][::-1]


def test_synth_command_line(tmp_path):
    info = synth.main(["--out", str(tmp_path / "cli"), "--n-views", "2", "--width", "24", "--height", "16",
                       "--n-points", "50", "--gt-splats", "500", "--device", "cpu"])
    p = Parser(str(tmp_path / "cli"))
    assert len(p.image_names) == 2 and p.points.shape == (50, 3) and info["observations"] > 0
    assert Dataset(p, "val")[0]["image"].shape == (16, 24, 3)
