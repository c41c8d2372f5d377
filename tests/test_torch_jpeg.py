"""The port's JPEG decoder (gsplat_tpu_torch/csrc/jpeg_decode.cpp through
datasets/image_io.py::decode_jpeg, built with g++ here) against PIL, bit
for bit.

- Files PIL writes in the test at quality 50, 75 and 95, subsampling
  4:4:4, 4:2:2 and 4:2:0, and grey, with and without restart markers,
  baseline and progressive, at 97x61, 1x1, 17x9, 2x2 and 33x17; 4:4:0
  and 4:1:1 files written by cv2 (PIL cannot write them) at the same
  sizes: the decoder's RGB equals
  ``np.asarray(PIL.Image.open(f).convert("RGB"))``.
- A progressive file decodes to the bits of the baseline file of the same
  image, quality and subsampling (libjpeg codes the same quantized
  coefficients in both).
- The committed fixtures (tests/assets/jpeg/, their README): each equals
  its PIL decoding stored beside it as a PNG (the progressive 1080p frame:
  the baseline frame's PNG).
- A progressive file whose last refinement scan is cut (libjpeg would
  smooth its blocks), CMYK, arithmetic-coded, lossless and 12-bit files
  raise RuntimeError naming the unrefined bits, the component count, the
  SOF marker or the precision; so does a baseline or progressive file
  cut short.
- `load_image` reads a JPEG without PIL (its import blocked), and each
  decode adds one to ``_backend.HOST_CALLS["jpeg_decode"]``.
"""

import io
import json
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


def _cv2_jpeg(img, quality, factor, restart, progressive=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], params)
    assert ok
    return enc.tobytes()


def _equal_to_pil(data, what):
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = image_io.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


KINDS = ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1", "grey"]


def _encode(img, quality, kind, restart, progressive):
    if kind in ("4:4:0", "4:1:1"):
        factor = {"4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, "4:1:1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}[kind]
        return _cv2_jpeg(img, quality, factor, restart, progressive)
    opts = {"quality": quality, "progressive": progressive}
    if restart:
        opts["restart_marker_blocks"] = 2
    if kind == "grey":
        img = img[..., 0]
    else:
        opts["subsampling"] = kind
    return _pil_jpeg(img, **opts)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_decode_matches_pil(quality, kind, restart, progressive):
    for w, h in SIZES:
        data = _encode(_pattern(h, w, seed=w + quality), quality, kind, restart, progressive)
        if progressive:
            assert b"\xff\xc2" in data
        _equal_to_pil(data, f"{w}x{h} {kind} q{quality} restart {restart} progressive {progressive}")


@pytest.mark.parametrize("kind", KINDS)
def test_progressive_equals_baseline(kind):
    """libjpeg's progressive mode codes the baseline mode's quantized
    coefficients, so both files decode to the same bits."""
    for quality in (50, 75, 95):
        for w, h in SIZES + ((160, 96),):
            img = _pattern(h, w, seed=3 * w + quality)
            base, prog = (_encode(img, quality, kind, False, p) for p in (False, True))
            assert base != prog
            np.testing.assert_array_equal(image_io.decode_jpeg(prog), image_io.decode_jpeg(base),
                                          err_msg=f"{w}x{h} {kind} q{quality}")


def _fixture_names():
    return sorted(f[:-4] for f in os.listdir(ASSETS) if f.endswith(".jpg"))


def _fixture_png(name):
    """The PNG a fixture is held to: its own, or the one same_png.json names."""
    with open(os.path.join(ASSETS, "same_png.json")) as f:
        return os.path.join(ASSETS, json.load(f).get(name, name) + ".png")


@pytest.mark.parametrize("name", _fixture_names())
def test_committed_fixtures(name):
    path = os.path.join(ASSETS, name + ".jpg")
    want = image_io.read_png(_fixture_png(name))
    np.testing.assert_array_equal(image_io.read_jpeg(path), want)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), want)


def test_fixtures_cover_the_scope():
    names = _fixture_names()
    assert len(names) == 10 and "garden_1080p_q85" in names
    for name in ("garden_1080p_q85", "garden_1080p_q85_progressive"):
        assert image_io.read_jpeg(os.path.join(ASSETS, name + ".jpg")).shape == (1080, 1920, 3)
    assert _fixture_png("garden_1080p_q85_progressive").endswith("garden_1080p_q85.png")

    def sof(name):
        with open(os.path.join(ASSETS, name + ".jpg"), "rb") as f:
            data = f.read()
        return [m for m in (0xC0, 0xC1, 0xC2) if bytes([0xFF, m]) in data]

    assert sof("sof1_16bit_tables_47x33") == [0xC1]  # extended sequential
    for name in ("prog_q80_420_restart_97x61", "prog_grey_q75_45x31", "garden_1080p_q85_progressive"):
        assert sof(name) == [0xC2], name


def _sof_patched(data, marker=None, precision=None):
    """`data` with its SOF0 marker byte or its precision byte replaced."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def _scans(data):
    """The offsets at which each SOS segment of `data` starts, and EOI's."""
    starts, i = [], 2
    while True:
        while data[i] != 0xFF:  # entropy-coded data
            i += 1
        m = data[i + 1]
        if m == 0x00 or 0xD0 <= m <= 0xD7 or m == 0xFF:
            i += 1 if m == 0xFF else 2
            continue
        if m == 0xD9:
            return starts, i
        if m == 0xDA:
            starts.append(i)
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")


def _unrefined(data):
    """A progressive file with its last scan, the luma AC band's refinement
    to bit 0, cut and EOI appended: libjpeg smooths such a file's blocks."""
    starts, _ = _scans(data)
    return data[:starts[-1]] + b"\xff\xd9"


@pytest.mark.parametrize("case,match", [
    ("unrefined", "coefficient bits left unrefined: libjpeg would smooth these blocks"),
    ("cmyk", "4 components"),
    ("arithmetic", r"SOF9 \(0xFFC9, extended sequential arithmetic\)"),
    ("lossless", r"SOF3 \(0xFFC3, lossless Huffman\)"),
    ("12-bit", "12-bit"),
])
def test_refusals(case, match):
    img = _pattern(21, 30, 7)
    if case == "unrefined":
        data = _unrefined(_pil_jpeg(img, progressive=True))
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
    for progressive in (False, True):
        data = _pil_jpeg(_pattern(40, 40, 8), progressive=progressive)
        with pytest.raises(RuntimeError, match="truncated|EOI"):
            image_io.decode_jpeg(data[: len(data) // 2])
        if progressive:  # cut at a scan's end: every scan whole, but no EOI
            starts, eoi = _scans(data)
            for cut in starts[1:] + [eoi]:
                with pytest.raises(RuntimeError, match="truncated|EOI"):
                    image_io.decode_jpeg(data[:cut])


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
