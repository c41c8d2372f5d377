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
same file's bytes in memory. Other formats (JPEG) go
through PIL where it can be imported; without it ``load_image`` raises a
``RuntimeError`` that names the missing decoder.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
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


def load_image(path: str) -> np.ndarray:
    """An image file as RGB uint8 [H, W, 3]: PNGs by `read_png`, anything
    else through PIL, which must then be importable."""
    with open(path, "rb") as f:
        is_png = f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE
    if is_png:
        return read_png(path)
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise RuntimeError(
            f"{os.path.basename(path)} is not a PNG and no decoder for it is installed: the port reads "
            "PNGs itself and other formats (JPEG) only through PIL, which cannot be imported here"
        ) from e
    with PILImage.open(path) as im:
        return np.asarray(im.convert("RGB"))
