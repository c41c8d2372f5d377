"""The port's JPEG decoder (gsplat_tpu_torch/csrc/jpeg_decode.cpp through
datasets/image_io.py::decode_jpeg, built with g++ here) against PIL, bit
for bit.

- Files PIL writes in the test at quality 50, 75 and 95, subsampling
  4:4:4, 4:2:2 and 4:2:0, and grey, with and without restart markers, at
  97x61, 1x1, 17x9, 2x2 and 33x17; 4:4:0 and 4:1:1 files written by cv2
  (PIL cannot write them) at the same sizes: the decoder's RGB equals
  ``np.asarray(PIL.Image.open(f).convert("RGB"))``.
- The committed fixtures (tests/assets/jpeg/, their README): each equals
  its PIL decoding stored beside it as a PNG.
- Progressive, CMYK, arithmetic-coded and 12-bit files raise
  RuntimeError naming the SOF marker, the component count or the
  precision.
- `load_image` reads a JPEG without PIL (its import blocked), and each
  decode adds one to ``_backend.HOST_CALLS["jpeg_decode"]``.
"""

import io
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from gsplat_tpu_torch import _backend
from gsplat_tpu_torch.datasets import image_io

from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "jpeg")
SIZES = ((97, 61), (1, 1), (17, 9), (2, 2), (33, 17))


def _pattern(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 7.0) * 60 + np.cos(yy / 5.0) * 50 + 120)[..., None] + np.arange(3) * 30
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def _pil_jpeg(img, **opts):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **opts)
    return buf.getvalue()


def _cv2_jpeg(img, quality, factor, restart):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], params)
    assert ok
    return enc.tobytes()


def _equal_to_pil(data, what):
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = image_io.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("kind", ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1", "grey"])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_decode_matches_pil(quality, kind, restart):
    for w, h in SIZES:
        img = _pattern(h, w, seed=w + quality)
        if kind in ("4:4:0", "4:1:1"):
            factor = {"4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, "4:1:1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}[kind]
            data = _cv2_jpeg(img, quality, factor, restart)
        else:
            opts = {"quality": quality}
            if restart:
                opts["restart_marker_blocks"] = 2
            if kind == "grey":
                img = img[..., 0]
            else:
                opts["subsampling"] = kind
            data = _pil_jpeg(img, **opts)
        _equal_to_pil(data, f"{w}x{h} {kind} q{quality} restart {restart}")


def _fixture_names():
    return sorted(f[:-4] for f in os.listdir(ASSETS) if f.endswith(".jpg"))


@pytest.mark.parametrize("name", _fixture_names())
def test_committed_fixtures(name):
    path = os.path.join(ASSETS, name + ".jpg")
    want = image_io.read_png(os.path.join(ASSETS, name + ".png"))
    np.testing.assert_array_equal(image_io.read_jpeg(path), want)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), want)


def test_fixtures_cover_the_scope():
    names = _fixture_names()
    assert len(names) == 7 and "garden_1080p_q85" in names
    assert image_io.read_jpeg(os.path.join(ASSETS, "garden_1080p_q85.jpg")).shape == (1080, 1920, 3)
    with open(os.path.join(ASSETS, "sof1_16bit_tables_47x33.jpg"), "rb") as f:
        assert b"\xff\xc1" in f.read()  # extended sequential


def _sof_patched(data, marker=None, precision=None):
    """`data` with its SOF0 marker byte or its precision byte replaced."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("case,match", [
    ("progressive", r"SOF2 \(0xFFC2, progressive Huffman\)"),
    ("cmyk", "4 components"),
    ("arithmetic", r"SOF9 \(0xFFC9, extended sequential arithmetic\)"),
    ("lossless", r"SOF3 \(0xFFC3, lossless Huffman\)"),
    ("12-bit", "12-bit"),
])
def test_refusals(case, match):
    img = _pattern(21, 30, 7)
    if case == "progressive":
        data = _pil_jpeg(img, progressive=True)
    elif case == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    elif case == "arithmetic":
        data = _sof_patched(_pil_jpeg(img), marker=0xC9)
    elif case == "lossless":
        data = _sof_patched(_pil_jpeg(img), marker=0xC3)
    else:
        data = _sof_patched(_pil_jpeg(img), precision=12)
    with pytest.raises(RuntimeError, match=match):
        image_io.decode_jpeg(data)


def test_not_a_jpeg_and_truncated():
    with pytest.raises(RuntimeError, match="SOI"):
        image_io.decode_jpeg(b"\x89PNG\r\n\x1a\n")
    data = _pil_jpeg(_pattern(40, 40, 8))
    with pytest.raises(RuntimeError, match="truncated|EOI"):
        image_io.decode_jpeg(data[: len(data) // 2])


def test_load_image_without_pil(tmp_path, monkeypatch):
    """load_image dispatches a JPEG to the port's decoder: it reads with
    PIL's import blocked, and each call is counted."""
    import builtins

    img = _pattern(16, 24, 9)
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(_pil_jpeg(img, quality=80))
    want = np.asarray(Image.open(path).convert("RGB"))
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *args, **kwargs)

    before = _backend.HOST_CALLS["jpeg_decode"]
    monkeypatch.setattr(builtins, "__import__", no_pil)
    np.testing.assert_array_equal(image_io.load_image(path), want)
    assert _backend.HOST_CALLS["jpeg_decode"] == before + 1
    # another format still needs PIL
    other = str(tmp_path / "x.bmp")
    with open(other, "wb") as f:
        f.write(b"BM" + bytes(60))
    with pytest.raises(RuntimeError, match="neither a PNG nor a JPEG"):
        image_io.load_image(other)
