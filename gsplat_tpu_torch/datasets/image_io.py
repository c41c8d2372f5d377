"""Image files for the datasets without PIL: a PNG reader and writer on
``zlib`` and numpy.

The reader takes 8-bit, non-interlaced PNGs of grey, grey + alpha, RGB and
RGBA pixels and returns RGB (grey repeated, alpha dropped, as PIL's
``convert("RGB")`` does), or with ``as_stored=True`` the channels as the
file stores them (grey [H, W], grey + alpha, RGB and RGBA [H, W, 2 | 3 |
4], what ``np.asarray(PIL.Image.open(path))`` gives). It undoes all five row filters. Where every row
is None, Sub (a wrapping cumulative sum along the row) or Up (one add of
the row above), each row is a few whole-row numpy operations. Average and
Paeth depend on the pixel to the left as reconstructed; an image with such
rows is undone along its anti-diagonals, one step over a column of rows
each (width + height - 1 steps): several times an Up-filtered decode, but
no loop over its pixels.

The writer filters every row with Up unless asked for another filter, so
that its files decode with whole-row operations; `encode_png` returns the
same file's bytes in memory.

JPEGs are decoded by the port's own C++ decoder (`decode_jpeg`,
``csrc/jpeg_decode.cpp``, built with g++ at first use): baseline,
extended-sequential and progressive Huffman files give PIL's
``convert("RGB")`` bits; arithmetic, lossless, 12-bit and CMYK files, a
progressive file whose scans leave coefficient bits unrefined (libjpeg
would smooth its blocks) and a file cut short raise ``RuntimeError``
naming what they are. No JPEG goes to PIL. Other formats go through PIL
where it can be imported.

`resize_bilinear` is PIL's bilinear resize and `remap_bilinear` cv2's
bilinear remap, for the datasets' resize and undistortion.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        pos += 12 + length


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the row filters of `raw` (each row a filter byte, then `stride`
    bytes) into [height, stride] uint8."""
    rows = raw.reshape(height, stride + 1)
    kinds, filt = rows[:, 0], rows[:, 1:]
    bad = np.nonzero(kinds > 4)[0]
    if bad.size:
        raise ValueError(f"{path}: row {bad[0]} has filter type {kinds[bad[0]]}, not 0-4")
    if (kinds >= 3).any():
        return _unfilter_wavefront(kinds, filt, bpp)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        f, kind = filt[r], kinds[r]
        if kind == 0:
            cur = f
        elif kind == 1:  # Sub: a running sum per channel, mod 256
            cur = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:  # Up
            cur = f + prior
        out[r] = cur
        prior = out[r]
    return out


def _unfilter_wavefront(kinds: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """All five filters at once, for images with Average or Paeth rows.

    A pixel depends on its left neighbour (a), the one above (b) and the
    one above-left (c), all as reconstructed, so pixel x of row r is ready
    at step x + r. The rows are stored skewed and transposed (pixel x of
    row r at [x + r + 2, r + 1], zeros left of each row and in the row
    above the image), so that step t is one contiguous slice over the rows
    it reaches: a whole image takes width + height - 1 steps of numpy
    operations over a column, not one per pixel. Each step computes only
    the predictors of the filter types the image uses."""
    height, stride = filt.shape
    width = stride // bpp
    cols = width + height + 1
    f = np.zeros((cols, height + 1, bpp), np.int16)
    q = np.zeros((cols, height + 1, bpp), np.int16)
    src = filt.reshape(height, width, bpp)
    for r in range(height):
        f[r + 2 : r + 2 + width, r + 1] = src[r]
    used = [int(k) for k in np.unique(kinds)]
    rows_of = {k: (kinds == k)[:, None] for k in used}
    for t in range(2, cols):
        lo, hi = max(1, t - width), min(height, t - 1)  # q rows (image row + 1) this step reaches
        if lo > hi:
            continue
        a, b, c = q[t - 1, lo : hi + 1], q[t - 1, lo - 1 : hi], q[t - 2, lo - 1 : hi]
        pred = None
        for k in used:
            if k == 0:
                p = 0
            elif k == 1:
                p = a
            elif k == 2:
                p = b
            elif k == 3:
                p = (a + b) >> 1
            else:
                pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)  # |p - a|, |p - b|, |p - c|
                p = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred = p if pred is None else np.where(rows_of[k][lo - 1 : hi], p, pred)
        q[t, lo : hi + 1] = (f[t, lo : hi + 1] + pred) & 0xFF
    out = np.empty((height, width, bpp), np.uint8)
    for r in range(height):
        out[r] = q[r + 2 : r + 2 + width, r + 1]
    return out.reshape(height, stride)


def read_png(path: str, as_stored: bool = False) -> np.ndarray:
    """An 8-bit, non-interlaced PNG as RGB uint8 [H, W, 3]; with
    ``as_stored`` its channels as stored: [H, W] grey, [H, W, 2 | 3 | 4]
    grey + alpha, RGB or RGBA."""
    with open(path, "rb") as f:
        return decode_png(f.read(), as_stored, path)


def decode_png(data: bytes, as_stored: bool = False, path: str = "<bytes>") -> np.ndarray:
    """`read_png` of a PNG file's bytes (``path`` names it in errors)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {colour}, interlace {interlace}: only 8-bit, "
            "non-interlaced grey, grey + alpha, RGB and RGBA PNGs are read"
        )
    ch = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * ch + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data for {width}x{height}x{ch}")
    img = _unfilter(raw, height, width * ch, ch, path).reshape(height, width, ch)
    if as_stored:
        return img[..., 0] if ch == 1 else img
    if ch <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filter_rows(rows: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """Rows [h, stride] uint8 filtered with one filter type (wrapping mod
    256): the inverse of `_unfilter` for rows that all carry it."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]  # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]  # up
    c = np.zeros_like(x)
    c[1:] = a[:-1]  # up-left
    if filter_type == 0:
        pred = np.zeros_like(x)
    elif filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) >> 1
    else:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type: int = 2) -> bytes:
    """uint8 [H, W] grey or [H, W, 2 | 3 | 4] grey + alpha or RGB(A) as the
    bytes of a PNG file whose rows all carry `filter_type` (0 None, 1 Sub,
    2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"a PNG takes uint8 pixels, got {img.dtype}")
    if filter_type not in range(5):
        raise ValueError(f"filter_type must be 0-4, got {filter_type}")
    if img.ndim == 2:
        img = img[..., None]
    ch = img.shape[2]
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    h, w = img.shape[:2]
    filt = np.empty((h, w * ch + 1), np.uint8)
    filt[:, 0] = filter_type
    filt[:, 1:] = _filter_rows(img.reshape(h, w * ch), ch, filter_type)
    body = (
        PNG_SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(filt.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
    return body


def write_png(path: str, img: np.ndarray, filter_type: int = 2) -> int:
    """Write `encode_png(img, filter_type)` to `path`. Returns the file's
    size in bytes."""
    body = encode_png(img, filter_type)
    with open(path, "wb") as f:
        f.write(body)
    return len(body)


# Pillow's fixed point for 8-bit resampling (libImaging/Resample.c)
_RESAMPLE_BITS = 22


def _bilinear_taps(in_size: int, out_size: int):
    """PIL's BILINEAR coefficients along one axis
    (``precompute_coeffs`` + ``normalize_coeffs_8bpc``): for each output
    index its first input index [out] and its taps' int64 weights [out,
    ksize] (0 past the output's last tap), the triangle filter over a
    support scaled by max(scale, 1), normalised, times 2**22 and rounded
    half away from zero."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    w = np.maximum(1.0 - np.abs((x[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale)), 0.0)
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    k = np.where(w < 0, np.trunc(-0.5 + w * (1 << _RESAMPLE_BITS)), np.trunc(0.5 + w * (1 << _RESAMPLE_BITS)))
    return xmin, k.astype(np.int64)


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of PIL's 8-bit resampling along `axis` (0 rows, 1 columns):
    each output is the sum of its taps times their integer weights, plus
    2**21, shifted right by 22 and clipped to uint8. The taps are gathered
    one tap position at a time over every output (int32 suffices: the
    weights are non-negative and sum to ~2**22)."""
    in_size = img.shape[axis]
    first, k = _bilinear_taps(in_size, out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1 :], 1 << (_RESAMPLE_BITS - 1), np.int32)
    for t in range(k.shape[1]):
        if not k[:, t].any():
            continue
        idx = np.minimum(first + t, in_size - 1)  # a 0 weight past an output's last tap
        acc += np.take(img, idx, axis=axis) * k[:, t].astype(np.int32).reshape(shape)
    return np.clip(acc >> _RESAMPLE_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] resized to ``size`` = (width, height) as
    ``PIL.Image.fromarray(img).resize(size, Resampling.BILINEAR)`` does, bit
    for bit, downscaling (an antialiased triangle over the scale) and
    upscaling: two passes, the horizontal one first, each in PIL's 22-bit
    fixed point; a pass whose axis keeps its size is skipped."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_bilinear takes uint8 [H, W] or [H, W, C], got {img.dtype} {img.shape}")
    w, h = int(size[0]), int(size[1])
    if w <= 0 or h <= 0:
        raise ValueError(f"resize_bilinear: size {size} must be positive")
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, 1, w)
    if h != img.shape[0]:
        out = _resample_axis(out, 0, h)
    return np.ascontiguousarray(out)


def remap_bilinear(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray, border: str = "constant") -> np.ndarray:
    """uint8 [H, W] or [H, W, C] sampled at (mapx, mapy) (float32 [h, w]
    each, in pixels of `img`) by bilinear interpolation: the counterpart of
    ``cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR)`` with ``borderMode``
    ``BORDER_CONSTANT`` (value 0; ``border="constant"``) or
    ``BORDER_REPLICATE`` (``border="replicate"``). Returns uint8 [h, w(, C)].

    The arithmetic, all in float32, in this order (cv2 5.0's bilinear
    remap, which no longer quantizes the fractions to 1/32 of a pixel): x0
    = floor(mapx), ax = mapx - x0 (likewise y0, ay); the four neighbours
    p00 = img[y0, x0], p01 = img[y0, x0 + 1], p10 = img[y0 + 1, x0], p11 =
    img[y0 + 1, x0 + 1], each 0 outside the image (``constant``) or at its
    clamped position (``replicate``); top = p00 + ax * (p01 - p00), bot =
    p10 + ax * (p11 - p10), v = top + ay * (bot - top); then v rounded to
    the nearest integer, ties to even, and saturated to [0, 255]; a
    non-finite coordinate gives 0. cv2 may contract a multiply and an add
    into one rounding, so a value can lie one level from its result (a few
    in a million on undistortion maps)."""
    img = np.asarray(img)
    mapx = np.asarray(mapx, np.float32)
    mapy = np.asarray(mapy, np.float32)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"remap_bilinear takes uint8 [H, W] or [H, W, C], got {img.dtype} {img.shape}")
    if mapx.shape != mapy.shape or mapx.ndim != 2:
        raise ValueError(f"mapx {mapx.shape} and mapy {mapy.shape} must be one [h, w] shape")
    if border not in ("constant", "replicate"):
        raise ValueError(f"border must be 'constant' or 'replicate', got {border!r}")
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else img.shape[2]
    # two pixels of border (zeros, or the edge repeated) on each side: a
    # neighbour's position clipped into [-2, W + 1] reads what it would
    # read at its own position
    pad = np.pad(img.reshape(H, W, C), ((2, 2), (2, 2), (0, 0)), mode="constant" if border == "constant" else "edge")
    src = pad.reshape(-1, C).astype(np.float32)
    # a non-finite coordinate reads 0, as in cv2 (either border)
    finite = np.isfinite(mapx) & np.isfinite(mapy)
    if not finite.all():
        mapx, mapy = np.where(finite, mapx, np.float32(-1e9)), np.where(finite, mapy, np.float32(-1e9))
    fx, fy = np.floor(mapx), np.floor(mapy)
    ax, ay = (mapx - fx).reshape(-1, 1), (mapy - fy).reshape(-1, 1)
    x0 = np.clip(fx, -2, W).astype(np.int64).reshape(-1) + 2
    y0 = np.clip(fy, -2, H).astype(np.int64).reshape(-1) + 2
    i00 = y0 * (W + 4) + x0
    p00, p01 = np.take(src, i00, axis=0), np.take(src, i00 + 1, axis=0)
    p10, p11 = np.take(src, i00 + (W + 4), axis=0), np.take(src, i00 + (W + 5), axis=0)
    p01 -= p00
    p01 *= ax
    top = p00 + p01
    p11 -= p10
    p11 *= ax
    bot = p10 + p11
    bot -= top
    bot *= ay
    top += bot
    out = np.clip(np.rint(top), 0, 255).astype(np.uint8).reshape(mapx.shape + (C,))
    out[~finite] = 0
    return out[..., 0] if img.ndim == 2 else out


_JD_INFO = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
_JD_DECODE = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int32]


def _jpeg_lib():
    from .._backend import host_library

    lib = host_library("jpeg_decode")
    if lib.jd_info.argtypes is None:
        lib.jd_info.argtypes, lib.jd_info.restype = _JD_INFO, ctypes.c_int
        lib.jd_decode.argtypes, lib.jd_decode.restype = _JD_DECODE, ctypes.c_int
    return lib


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A JPEG file's bytes as RGB uint8 [H, W, 3], the bits of
    ``np.asarray(PIL.Image.open(path).convert("RGB"))`` for baseline,
    extended-sequential and progressive Huffman files of 1 or 3
    components. Other JPEGs (arithmetic, lossless, 12-bit, CMYK) raise
    RuntimeError naming the SOF marker or the component count, a
    progressive file with unrefined coefficient bits naming them, a file
    cut short saying so (``path`` names the file).
    Each call adds one to ``_backend.HOST_CALLS["jpeg_decode"]``."""
    from .._backend import HOST_CALLS

    lib = _jpeg_lib()
    HOST_CALLS["jpeg_decode"] += 1
    err = ctypes.create_string_buffer(256)
    info = np.zeros(5, np.int32)
    if lib.jd_info(data, len(data), info.ctypes.data, err, len(err)):
        raise RuntimeError(f"{path}: {err.value.decode()}")
    w, h = int(info[0]), int(info[1])
    out = np.empty((h, w, 3), np.uint8)
    if lib.jd_decode(data, len(data), out.ctypes.data, out.size, err, len(err)):
        raise RuntimeError(f"{path}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """`decode_jpeg` of a file."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def load_image(path: str) -> np.ndarray:
    """An image file as RGB uint8 [H, W, 3]: PNGs by `read_png`, JPEGs by
    `read_jpeg`, anything else through PIL, which must then be importable."""
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE))
    if head == PNG_SIGNATURE:
        return read_png(path)
    if head.startswith(JPEG_SIGNATURE):
        return read_jpeg(path)
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise RuntimeError(
            f"{os.path.basename(path)} is neither a PNG nor a JPEG and no decoder for it is installed: the port "
            "reads PNGs and JPEGs itself and other formats only through PIL, which cannot be imported here"
        ) from e
    with PILImage.open(path) as im:
        return np.asarray(im.convert("RGB"))
