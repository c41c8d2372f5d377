"""The port's native COLMAP reader (gsplat_tpu_torch/csrc/colmap_native.cpp
through datasets/colmap_native.py, built with g++ here) against the port's
numpy reader and the JAX package's reader.

- A synth scene (tests/torch_synth_scene.py: 6 views with their
  observations, 300 points with tracks) and a handmade binary model
  (every camera model, an image without observations, a point with an
  empty track, negative point ids in an image, a non-ASCII name): the
  native reader's cameras, images and points equal the numpy reader's
  and gsplat_tpu's Python reader's (ids against its id -> row map).
- A text model and the same model in binary: the native reader on the
  binary equals both packages' text readers.
- `read_model` reads a binary model natively and counts it in
  ``_backend.HOST_CALLS``; where the library cannot be built it warns
  once (with the reason) and the numpy reader reads the same model;
  a truncated points3D.bin raises in the native reader.
"""

import os
import shutil
import struct
import warnings

import numpy as np
import pytest

from gsplat_tpu.datasets import colmap_io as jax_io
from gsplat_tpu_torch import _backend
from gsplat_tpu_torch.datasets import colmap_io, colmap_native

from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_synth_scene import scene_dir


def _handmade(out):
    """A binary model of every camera model, odd images and points."""
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(4)
    with open(os.path.join(out, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(colmap_io.CAMERA_MODELS)))
        for mid, (_, n) in colmap_io.CAMERA_MODELS.items():
            f.write(struct.pack("<iiQQ", 10 + mid, mid, 640 + mid, 480 - mid))
            f.write(struct.pack(f"<{n}d", *rng.normal(size=n)))
    names = ["a.png", "sub/dir/b.jpg", "été.png", "empty.png"]
    with open(os.path.join(out, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for i, name in enumerate(names):
            f.write(struct.pack("<i7di", 3 * i + 1, *rng.normal(size=7), 10 + i))
            f.write(name.encode() + b"\x00")
            n2d = 0 if name == "empty.png" else 5 + i
            f.write(struct.pack("<Q", n2d))
            for k in range(n2d):
                f.write(struct.pack("<ddq", *rng.normal(size=2) * 100, -1 if k % 3 == 0 else 1000 + k))
    with open(os.path.join(out, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 5))
        for j in range(5):
            f.write(struct.pack("<Q3d3Bd", 1000 + 7 * j, *rng.normal(size=3), *rng.integers(0, 256, 3), 0.1 * j))
            track = 0 if j == 2 else j + 1
            f.write(struct.pack("<Q", track))
            f.write(struct.pack(f"<{2 * track}i", *rng.integers(0, 9, 2 * track)))
    return out


def _jax_bin(sp):
    """gsplat_tpu's Python readers (its read_model would build its own
    native reader first)."""
    return (
        jax_io.read_cameras_bin(os.path.join(sp, "cameras.bin")),
        jax_io.read_images_bin(os.path.join(sp, "images.bin")),
        jax_io.read_points3d_bin(os.path.join(sp, "points3D.bin")),
    )


def _check_same(native, numpy_model, jax_model):
    (nc, ni, npts), (pc, pi, ppts) = native, numpy_model
    jc, ji, jpts = jax_model
    assert sorted(nc) == sorted(pc) == sorted(jc)
    for k in pc:
        for other in (pc[k], jc[k]):
            assert (nc[k].camera_id, nc[k].model, nc[k].width, nc[k].height) == \
                (other.camera_id, other.model, other.width, other.height)
            np.testing.assert_array_equal(nc[k].params, other.params)
    assert sorted(ni) == sorted(pi) == sorted(ji)
    for k in pi:
        for other in (pi[k], ji[k]):
            assert (ni[k].name, ni[k].camera_id) == (other.name, other.camera_id)
            for a in ("qvec", "tvec", "xys", "point3D_ids"):
                np.testing.assert_array_equal(getattr(ni[k], a), getattr(other, a), err_msg=a)
    for a, b, c in zip(npts[:3], ppts[:3], jpts[:3]):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert npts[3].dtype == np.int64
    np.testing.assert_array_equal(npts[3], ppts[3])
    np.testing.assert_array_equal(npts[3], sorted(jpts[3], key=jpts[3].get))


@pytest.mark.parametrize("scene", ["synth", "handmade"])
def test_native_matches_both_readers(scene, tmp_path):
    sp = os.path.join(scene_dir(), "sparse", "0") if scene == "synth" else _handmade(str(tmp_path / "m"))
    native = colmap_native.read_model_bin(sp)
    _check_same(native, colmap_io.read_model_numpy_bin(sp), _jax_bin(sp))
    if scene == "synth":
        assert len(native[2][0]) == 300 and sum(len(im.xys) for im in native[1].values()) > 600


def test_native_on_binary_matches_text_readers(tmp_path):
    """The synth scene's model written as COLMAP text (full-precision
    reprs) and kept as binary: the native reader on the binary equals both
    packages' text readers."""
    src = os.path.join(scene_dir(), "sparse", "0")
    cams, imgs, (xyz, rgb, err, ids) = colmap_io.read_model_numpy_bin(src)
    txt = tmp_path / "txt"
    txt.mkdir()
    with open(txt / "cameras.txt", "w") as f:
        for c in cams.values():
            f.write(f"{c.camera_id} {c.model} {c.width} {c.height} " + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(txt / "images.txt", "w") as f:
        for im in imgs.values():
            f.write(f"{im.image_id} " + " ".join(repr(float(v)) for v in (*im.qvec, *im.tvec)) + f" {im.camera_id} "
                    f"{im.name}\n")
            f.write(" ".join(f"{x!r} {y!r} {int(p)}" for (x, y), p in zip(im.xys.tolist(), im.point3D_ids)) + "\n")
    with open(txt / "points3D.txt", "w") as f:
        for i in range(len(xyz)):
            f.write(f"{ids[i]} " + " ".join(repr(float(v)) for v in xyz[i]) + " "
                    + " ".join(str(int(v)) for v in rgb[i]) + f" {float(err[i])!r} 1 0\n")
    native = colmap_native.read_model_bin(src)
    port_txt = colmap_io.read_model(str(txt))
    jax_txt = jax_io.read_model(str(txt))
    _check_same(native, port_txt, jax_txt)


def test_read_model_native_and_fallback(tmp_path, monkeypatch):
    sp = os.path.join(scene_dir(), "sparse", "0")
    before = dict(_backend.HOST_CALLS)
    native = colmap_io.read_model(sp)
    assert _backend.HOST_CALLS["colmap_native"] == before["colmap_native"] + 1
    assert _backend.HOST_CALLS["colmap_numpy"] == before["colmap_numpy"]

    def no_compiler(name):
        raise RuntimeError(f"g++ failed on csrc/{name}.cpp:\nerror: no compiler here")

    monkeypatch.setattr(_backend, "host_library", no_compiler)
    monkeypatch.setattr(colmap_io, "_NATIVE_WARNED", [])
    with pytest.warns(RuntimeWarning, match="no compiler here"):
        fallback = colmap_io.read_model(sp)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once a process
        colmap_io.read_model(sp)
    assert _backend.HOST_CALLS["colmap_numpy"] == before["colmap_numpy"] + 2
    _check_same(native, fallback, _jax_bin(sp))


def test_truncated_points_raise(tmp_path):
    d = str(tmp_path / "t")
    shutil.copytree(os.path.join(scene_dir(), "sparse", "0"), d)
    path = os.path.join(d, "points3D.bin")
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(RuntimeError, match="native reader failed"):
        colmap_native.read_points3d_bin(path)
