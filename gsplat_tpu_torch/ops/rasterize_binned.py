"""Binned rasterizer: forward compositing and its backward over the sorted
entry stream (port of gsplat_tpu/ops/rasterize_binned.py).

The binning engine (ops/binning.py) builds the (tile, depth, gid)-sorted
stream; the forward kernel (csrc/rasterize_fwd.cu; `_fwd_plain` is its
plain version) composites each (camera, tile) range into its pixels.
Semantics are those of ops/rasterize_ref.py (the oracle).

Gradients go through `_BinnedRaster`, a torch.autograd.Function over
bin -> forward -> (backward -> reduce): the backward kernel
(csrc/rasterize_bwd.cu; `_bwd_plain`) writes one row of per-entry
gradients per stream slot, and the reduce kernel (csrc/gid_reduce.cu;
`_reduce_plain`) sums the slots of each Gaussian in the gid order that the
binning sort already gives (`Binned.order`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .. import _backend
from .binning import Binned, bin_gaussians
from .rasterize_ref import ALPHA_MAX, ALPHA_MIN, TRANSMITTANCE_EPS

TILE_SIZES = (8, 16, 32)
MAX_CHANNELS = 32  # rendering.rasterization's channel_chunk default caps D here
# the plain versions' loop split: tiles per group (at 16x16 pixels per
# tile; scaled so a group holds as many pixels at every tile size), entries
# per chunk
PLAIN_TILE_GROUP = 256
PLAIN_CHUNK = 128


def _plain_split(tile_size: int) -> Tuple[int, int]:
    return max(1, PLAIN_TILE_GROUP * 256 // (tile_size * tile_size)), PLAIN_CHUNK


def _to_image(x: torch.Tensor, n_cams: int, th: int, tw: int, ts: int, W: int, H: int) -> torch.Tensor:
    """[C*th*tw, ts*ts, ...] tile layout -> [C, H, W, ...] image layout."""
    x = x.reshape((n_cams, th, tw, ts, ts) + x.shape[2:])
    x = x.transpose(2, 3).reshape((n_cams, th * ts, tw * ts) + x.shape[5:])
    return x[:, :H, :W].contiguous()


def _check(what: str, dev: torch.device, checks) -> None:
    """Raise unless each (tensor, dtype, shape or None) of `checks` is a
    contiguous tensor of that dtype (and shape) on `dev`."""
    for t, dt, shape in checks:
        if t.dtype is not dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{what} input of dtype {t.dtype} on {t.device}: expected contiguous {dt} on {dev}")
        if shape is not None and t.shape != shape:
            raise ValueError(f"{what} input of shape {tuple(t.shape)}: expected {shape}")


def _fwd_plain(
    entries: torch.Tensor,  # [NF, M] f32
    offs: torch.Tensor,  # [T] i32
    cnts: torch.Tensor,  # [T] i32
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
):
    """Plain torch version of the forward kernel: tiles in groups of
    PLAIN_TILE_GROUP, each group's ranges in chunks of PLAIN_CHUNK entries,
    carrying T between chunks. Returns (image [C,H,W,D] with the background
    added, T_final [C,H,W], last [C,H,W] i32 absolute stream index or -1,
    n_pairs), where n_pairs counts the (pixel, entry) pairs that compositing
    had to evaluate: those not behind the pixel's termination."""
    dev = entries.device
    tile_group, chunk = _plain_split(tile_size)
    ts = tile_size
    P = ts * ts
    D = entries.shape[0] - 6
    th = -(-image_height // ts)
    tw = -(-image_width // ts)
    n_t = n_cams * th * tw
    M = entries.shape[1]
    pix = torch.arange(P, device=dev)
    lx, ly = pix % ts, pix // ts

    img = torch.zeros((n_t, P, D), dtype=torch.float32, device=dev)
    T_out = torch.ones((n_t, P), dtype=torch.float32, device=dev)
    last = torch.full((n_t, P), -1, dtype=torch.int32, device=dev)
    n_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    maxes = [
        int(v) for v in
        torch.nn.functional.pad(cnts, (0, -n_t % tile_group)).reshape(-1, tile_group).amax(dim=1).tolist()
    ] if n_t else []
    for gi, nmax in enumerate(maxes):
        if nmax == 0:
            continue
        tiles = torch.arange(gi * tile_group, min((gi + 1) * tile_group, n_t), device=dev)
        o = offs[tiles].to(torch.int64)
        n = cnts[tiles].to(torch.int64)
        rem = tiles % (th * tw)
        px = ((rem % tw) * ts)[:, None] + lx + 0.5  # [g, P]
        py = ((rem // tw) * ts)[:, None] + ly + 0.5
        T = torch.ones(px.shape, dtype=torch.float32, device=dev)
        acc = torch.zeros(px.shape + (D,), dtype=torch.float32, device=dev)
        t_fin = torch.ones_like(T)
        lst = torch.full(px.shape, -1, dtype=torch.int64, device=dev)
        for k0 in range(0, nmax, chunk):
            j = k0 + torch.arange(chunk, device=dev)
            inr = j[None, :] < n[:, None]  # [g, K]
            idx = o[:, None] + j[None, :]
            e = entries[:, idx.clamp(0, max(M - 1, 0))]  # [NF, g, K]
            gx, gy, ca, cb, cc, op = (e[r][:, None, :] for r in range(6))
            dx = px[..., None] - gx  # [g, P, K]
            dy = py[..., None] - gy
            sig = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
            alpha = torch.clamp_max(op * torch.exp(-sig), ALPHA_MAX)
            valid = inr[:, None, :] & (alpha >= ALPHA_MIN) & (sig >= 0.0)
            one_m = torch.where(valid, 1.0 - alpha, 1.0)
            T_incl = T[..., None] * torch.cumprod(one_m, dim=-1)
            T_excl = torch.cat([T[..., None], T_incl[..., :-1]], dim=-1)
            accept = valid & (T_incl > TRANSMITTANCE_EPS)
            w = torch.where(accept, T_excl * alpha, 0.0)
            acc += torch.einsum("gpk,dgk->gpd", w, e[6:])
            t_fin = torch.minimum(t_fin, torch.where(accept, T_incl, 1.0).amin(dim=-1))
            lst = torch.maximum(lst, torch.where(accept, idx[:, None, :], -1).amax(dim=-1))
            n_pairs += ((T_excl > TRANSMITTANCE_EPS) & inr[:, None, :]).sum()
            T = T_incl[..., -1]
            if bool((T <= TRANSMITTANCE_EPS).all()):
                break
        img[tiles] = acc
        T_out[tiles] = t_fin
        last[tiles] = lst.to(torch.int32)

    img, T_out, last = (
        _to_image(x, n_cams, th, tw, ts, image_width, image_height) for x in (img, T_out, last)
    )
    if backgrounds is not None:
        img = img + T_out[..., None] * backgrounds[:, None, None, :]
    return img, T_out, last, int(n_pairs)


_FWD_ARGS = (
    [ctypes.c_void_p, ctypes.c_longlong]  # entries, M (row stride)
    + [ctypes.c_void_p] * 2  # offs, cnts
    + [ctypes.c_int] * 7  # C, th, tw, ts, W, H, D
    + [ctypes.c_void_p] * 4  # image, T, last, stream
)


def _fwd_cuda(
    entries: torch.Tensor,
    offs: torch.Tensor,
    cnts: torch.Tensor,
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
):
    """Launch csrc/rasterize_fwd.cu: one block per (camera, tile), P pixels
    of a tile column a thread. Returns (image [C,H,W,D] without background,
    T_final [C,H,W], last [C,H,W] i32)."""
    dev = entries.device
    if dev.type != "cuda":
        raise ValueError(f"the forward kernel takes CUDA tensors, got {dev}")
    if tile_size not in TILE_SIZES:
        raise ValueError(f"tile_size must be one of {TILE_SIZES}, got {tile_size}")
    D = entries.shape[0] - 6
    if not 1 <= D <= MAX_CHANNELS:
        raise ValueError(f"the forward kernel takes 1..{MAX_CHANNELS} channels, got {D}")
    th = -(-image_height // tile_size)
    tw = -(-image_width // tile_size)
    T = n_cams * th * tw
    _check("forward", dev, [(entries, torch.float32, None), (offs, torch.int32, (T,)),
                            (cnts, torch.int32, (T,))])
    img = torch.empty((n_cams, image_height, image_width, D), dtype=torch.float32, device=dev)
    T_out = torch.empty((n_cams, image_height, image_width), dtype=torch.float32, device=dev)
    last = torch.empty((n_cams, image_height, image_width), dtype=torch.int32, device=dev)
    if T == 0:
        return img, T_out, last
    fn = _backend.kernel("rasterize_fwd", "rasterize_fwd_launch", _FWD_ARGS)
    code = fn(
        entries.data_ptr(), entries.shape[1], offs.data_ptr(), cnts.data_ptr(),
        n_cams, th, tw, tile_size, image_width, image_height, D,
        img.data_ptr(), T_out.data_ptr(), last.data_ptr(), _backend.stream(dev),
    )
    _backend.check_launch(code, "rasterize_fwd")
    _backend.LAUNCHES["rasterize_fwd"] += 1
    return img, T_out, last


def _to_tiles(x: torch.Tensor, th: int, tw: int, ts: int, fill) -> torch.Tensor:
    """[C, H, W, ...] image layout -> [C*th*tw, ts*ts, ...] tile layout (the
    forward's pixel order), pixels past the image edge set to `fill`."""
    C, H, W = x.shape[:3]
    rest = tuple(x.shape[3:])
    full = x.new_full((C, th * ts, tw * ts) + rest, fill)
    full[:, :H, :W] = x
    full = full.reshape((C, th, ts, tw, ts) + rest).transpose(2, 3)
    return full.reshape((C * th * tw, ts * ts) + rest)


def _bwd_plain(
    entries: torch.Tensor,  # [6 + D, M] f32
    offs: torch.Tensor,  # [T] i32
    cnts: torch.Tensor,  # [T] i32
    T_fin: torch.Tensor,  # [C, H, W] f32, the forward's T_final
    last: torch.Tensor,  # [C, H, W] i32, the forward's last accepted index
    v_img: torch.Tensor,  # [C, H, W, D] cotangent of the image (no background)
    v_T: torch.Tensor,  # [C, H, W] cotangent of T_final
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
    absgrad: bool = False,
):
    """Plain torch version of the backward kernel: tiles in groups of
    PLAIN_TILE_GROUP, each group's ranges walked back to front in chunks of
    PLAIN_CHUNK entries, carrying the product of the later (1 - alpha) and
    the sum of the later w * cv per pixel. T before an entry is T_final over
    the product of (1 - alpha) from that entry on. Returns (rows
    [6 + D (+2), M], (n_eval, n_acc)): one row of per-entry gradients per
    stream slot (zero where no pixel accepted the entry), the (pixel, entry)
    pairs evaluated (those at or before the pixel's `last`) and the pairs
    accepted."""
    dev = entries.device
    tile_group, chunk = _plain_split(tile_size)
    ts = tile_size
    P = ts * ts
    D = entries.shape[0] - 6
    M = entries.shape[1]
    th = -(-image_height // ts)
    tw = -(-image_width // ts)
    n_t = n_cams * th * tw
    pix = torch.arange(P, device=dev)
    lx, ly = pix % ts, pix // ts

    Tt = _to_tiles(T_fin, th, tw, ts, 1.0)
    Lt = _to_tiles(last.to(torch.int64), th, tw, ts, -1)
    Vt = _to_tiles(v_img, th, tw, ts, 0.0)
    VLt = _to_tiles(v_T * T_fin, th, tw, ts, 0.0)  # v_logT
    rows = torch.zeros((6 + D + (2 if absgrad else 0), M), dtype=torch.float32, device=dev)
    n_eval = torch.zeros((), dtype=torch.int64, device=dev)
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    if n_t == 0:
        return rows, (0, 0)
    # entries past a tile's largest `last` were accepted by no pixel
    nact = torch.clamp(
        torch.minimum(cnts.to(torch.int64), Lt.amax(dim=1) + 1 - offs.to(torch.int64)), min=0
    )
    maxes = torch.nn.functional.pad(nact, (0, -n_t % tile_group)).reshape(-1, tile_group).amax(dim=1).tolist()
    for gi, nmax in enumerate(int(v) for v in maxes):
        if nmax == 0:
            continue
        tiles = torch.arange(gi * tile_group, min((gi + 1) * tile_group, n_t), device=dev)
        o = offs[tiles].to(torch.int64)
        n = nact[tiles]
        rem = tiles % (th * tw)
        px = ((rem % tw) * ts)[:, None] + lx + 0.5  # [g, P]
        py = ((rem // tw) * ts)[:, None] + ly + 0.5
        T_g, L_g, V_g, VL_g = Tt[tiles], Lt[tiles], Vt[tiles], VLt[tiles]
        S = torch.ones(px.shape, dtype=torch.float32, device=dev)
        ssum = torch.zeros(px.shape, dtype=torch.float32, device=dev)
        for k0 in reversed(range(0, nmax, chunk)):
            j = k0 + torch.arange(chunk, device=dev)
            inr = j[None, :] < n[:, None]  # [g, K]
            idx = o[:, None] + j[None, :]
            e = entries[:, idx.clamp(0, max(M - 1, 0))]  # [NF, g, K]
            gx, gy, ca, cb, cc, op = (e[r][:, None, :] for r in range(6))
            dx = px[..., None] - gx  # [g, P, K]
            dy = py[..., None] - gy
            sig = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
            eneg = torch.exp(-sig)
            araw = op * eneg
            alpha = torch.clamp_max(araw, ALPHA_MAX)
            seen = inr[:, None, :] & (idx[:, None, :] <= L_g[..., None])
            accept = seen & (alpha >= ALPHA_MIN) & (sig >= 0.0)
            n_eval += seen.sum()
            n_acc += accept.sum()
            one_m = torch.where(accept, 1.0 - alpha, 1.0)
            S_incl = torch.flip(torch.cumprod(torch.flip(one_m, [-1]), dim=-1), [-1]) * S[..., None]
            Tk = T_g[..., None] / S_incl
            w = torch.where(accept, alpha * Tk, 0.0)
            cv = torch.einsum("gpd,dgk->gpk", V_g, e[6:])
            wcv = w * cv
            later = torch.flip(torch.cumsum(torch.flip(wcv, [-1]), dim=-1), [-1]) - wcv + ssum[..., None]
            v_alpha = torch.where(accept, Tk * cv - (later + VL_g[..., None]) / one_m, 0.0)
            notclamp = accept & (araw < ALPHA_MAX)
            v_sig = torch.where(notclamp, -alpha * v_alpha, 0.0)
            vals = [
                (-(ca * dx + cb * dy) * v_sig).sum(dim=1),
                (-(cb * dx + cc * dy) * v_sig).sum(dim=1),
                (0.5 * dx * dx * v_sig).sum(dim=1),
                (dx * dy * v_sig).sum(dim=1),
                (0.5 * dy * dy * v_sig).sum(dim=1),
                torch.where(notclamp, eneg * v_alpha, 0.0).sum(dim=1),
            ]
            vals = torch.cat([torch.stack(vals), torch.einsum("gpk,gpd->dgk", w, V_g)])
            if absgrad:
                vals = torch.cat([vals, vals[:2].abs()])
            rows[:, idx[inr]] = vals[:, inr]
            S = S_incl[..., 0]
            ssum = ssum + wcv.sum(dim=-1)
    return rows, (int(n_eval), int(n_acc))


_BWD_ARGS = (
    [ctypes.c_void_p, ctypes.c_longlong]  # entries, M (row stride)
    + [ctypes.c_void_p] * 2  # offs, cnts
    + [ctypes.c_int] * 7  # C, th, tw, ts, W, H, D
    + [ctypes.c_void_p] * 4  # T_final, last, v_img, v_T
    + [ctypes.c_int]  # absgrad
    + [ctypes.c_void_p] * 2  # rows, stream
)


def _bwd_cuda(
    entries: torch.Tensor,
    offs: torch.Tensor,
    cnts: torch.Tensor,
    T_fin: torch.Tensor,
    last: torch.Tensor,
    v_img: torch.Tensor,
    v_T: torch.Tensor,
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
    absgrad: bool = False,
) -> torch.Tensor:
    """Launch csrc/rasterize_bwd.cu: one block per (camera, tile), one
    thread per pixel. Returns rows [6 + D (+2), M] as `_bwd_plain` does."""
    dev = entries.device
    if dev.type != "cuda":
        raise ValueError(f"the backward kernel takes CUDA tensors, got {dev}")
    if tile_size not in TILE_SIZES:
        raise ValueError(f"tile_size must be one of {TILE_SIZES}, got {tile_size}")
    D = entries.shape[0] - 6
    if not 1 <= D <= MAX_CHANNELS:
        raise ValueError(f"the backward kernel takes 1..{MAX_CHANNELS} channels, got {D}")
    th = -(-image_height // tile_size)
    tw = -(-image_width // tile_size)
    T = n_cams * th * tw
    img_shape = (n_cams, image_height, image_width)
    checks = [
        (entries, torch.float32, None), (offs, torch.int32, (T,)), (cnts, torch.int32, (T,)),
        (T_fin, torch.float32, img_shape), (last, torch.int32, img_shape),
        (v_img, torch.float32, img_shape + (D,)), (v_T, torch.float32, img_shape),
    ]
    _check("backward", dev, checks)
    rows = torch.zeros((6 + D + (2 if absgrad else 0), entries.shape[1]), dtype=torch.float32, device=dev)
    if T == 0 or entries.shape[1] == 0:
        return rows
    fn = _backend.kernel("rasterize_bwd", "rasterize_bwd_launch", _BWD_ARGS)
    code = fn(
        entries.data_ptr(), entries.shape[1], offs.data_ptr(), cnts.data_ptr(),
        n_cams, th, tw, tile_size, image_width, image_height, D,
        T_fin.data_ptr(), last.data_ptr(), v_img.data_ptr(), v_T.data_ptr(), int(absgrad),
        rows.data_ptr(), _backend.stream(dev),
    )
    _backend.check_launch(code, "rasterize_bwd")
    _backend.LAUNCHES["rasterize_bwd"] += 1
    return rows


def _reduce_plain(rows: torch.Tensor, gids: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain version of the reduce kernel, and the one PyTorch call that
    computes the same function: index_add_ of the per-slot rows [R, M] into
    per-Gaussian rows [R, n_out]. Slots with the culled sentinel gid
    (n_out) land in a dropped extra row."""
    out = torch.zeros((n_out + 1, rows.shape[0]), dtype=torch.float32, device=rows.device)
    out.index_add_(0, gids.to(torch.int64), rows.T)
    return out[:n_out].T.contiguous()


def gid_segments(gids: torch.Tensor, n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each Gaussian's slots: a stable sort of the per-slot gids (so a
    segment keeps stream order) and the segment starts. Returns (perm [M]
    i64, starts [n_out + 1] i64); Gaussian g owns perm[starts[g]:starts[g+1]]
    and the culled sentinel gids sort past starts[n_out]."""
    gids_sorted, perm = torch.sort(gids, stable=True)
    starts = torch.searchsorted(
        gids_sorted, torch.arange(n_out + 1, dtype=gids.dtype, device=gids.device)
    )
    return perm, starts


def gid_order(gids: torch.Tensor, n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reduce's ``order`` for slots that come with no stream order: from
    `gid_segments`, each slot's place in gid order (the inverse of its
    permutation) and the segment starts. Returns (dst [M] i64, starts
    [n_out + 1] i64)."""
    perm, starts = gid_segments(gids, n_out)
    dst = torch.empty_like(perm)
    dst[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return dst, starts


REDUCE_MAX_ROWS = 64  # csrc/gid_reduce.cu: a slot's padded row of at most 16 float4s

_PARTIALS_ARGS = [ctypes.c_longlong, ctypes.c_int]  # M, R -> the partials' floats
_REDUCE_ARGS = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]  # rows, M, R, Rp
    + [ctypes.c_void_p] * 2  # dst, starts
    + [ctypes.c_int]  # n_out
    + [ctypes.c_void_p] * 4  # scratch, partials, out, stream
)


def reduce_row_floats(R: int) -> int:
    """Floats of a slot's row in the reduce's gid-order scratch: R rounded
    up to whole 32-byte sectors above 16 rows (the 2DGS rows: a scattered
    row of whole sectors wrote faster on an H100 than 20% fewer bytes in
    part-sectors), else to whole 16-byte vectors (the 3DGS rows, where a
    sector's rounding would add a third)."""
    return -(-R // 8) * 8 if R > 16 else -(-R // 4) * 4


def _reduce_cuda(rows: torch.Tensor, dst: torch.Tensor, starts: torch.Tensor, n_out: int) -> torch.Tensor:
    """Launch csrc/gid_reduce.cu: pass 1 scatters each slot's values into
    a gid-ordered [M, Rp] scratch at dst[k] (16-byte stores), pass 2 sums
    each Gaussian's contiguous segment [starts[g], starts[g+1]) of it (a
    lane a short segment, a warp a medium one, LONG-slot chunks a long
    one). ``dst`` is a permutation of the M slots and ``starts`` ascending
    with starts[0] = 0 (`binning.Binned.order`, `isect.Isect.order`,
    `gid_order`). Returns [R, n_out]."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the reduce kernel takes CUDA tensors, got {dev}")
    R, M = rows.shape
    checks = [(rows, torch.float32, None), (dst, torch.int64, (M,)), (starts, torch.int64, (n_out + 1,))]
    _check("reduce", dev, checks)
    if R > REDUCE_MAX_ROWS:
        raise ValueError(f"the reduce kernel takes at most {REDUCE_MAX_ROWS} rows, got {R}")
    out = torch.empty((R, n_out), dtype=torch.float32, device=dev)
    if n_out == 0 or R == 0:
        return out
    Rp = reduce_row_floats(R)
    scratch = torch.empty(max(M * Rp, 4), dtype=torch.float32, device=dev)
    size = _backend.kernel("gid_reduce", "gid_reduce_partials_size", _PARTIALS_ARGS, ctypes.c_longlong)
    partials = torch.empty(max(size(M, R), 4), dtype=torch.float32, device=dev)
    fn = _backend.kernel("gid_reduce", "gid_reduce_launch", _REDUCE_ARGS)
    code = fn(
        rows.data_ptr(), M, R, Rp, dst.data_ptr(), starts.data_ptr(), n_out,
        scratch.data_ptr(), partials.data_ptr(), out.data_ptr(), _backend.stream(dev),
    )
    _backend.check_launch(code, "gid_reduce")
    _backend.LAUNCHES["gid_reduce"] += 1
    return out


def reduce_by_gid(
    rows: torch.Tensor, gids: torch.Tensor, n_out: int,
    order: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Per-slot rows [R, M] -> per-Gaussian sums [R, n_out] (0 for a
    Gaussian with no slot; slots with the culled sentinel gid n_out are
    dropped). CUDA tensors go through the reduce kernel, CPU tensors
    through its plain version. ``order = (dst, starts)`` is the stream's
    own gid order (`Binned.order`, `Isect.order`): slot k's place in it and
    each Gaussian's segment; without it the kernel's caller sorts the gids
    (`gid_order`). The plain version needs no order."""
    if _backend.use_kernel(rows.device):
        return _reduce_cuda(rows, *(order if order is not None else gid_order(gids, n_out)), n_out)
    return _reduce_plain(rows, gids, n_out)


def _split(means2d, conics):
    if isinstance(means2d, (tuple, list)):
        mean_x, mean_y = means2d
    else:
        mean_x, mean_y = means2d[..., 0], means2d[..., 1]
    if isinstance(conics, (tuple, list)):
        con_a, con_b, con_c = conics
    else:
        con_a, con_b, con_c = conics[..., 0], conics[..., 1], conics[..., 2]
    return mean_x, mean_y, con_a, con_b, con_c


def _raster_binned_fwd(
    means2d, conics, colors, opacities, radii, depths,
    image_width: int, image_height: int, tile_size: int, capacity: int,
    backgrounds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Binned]:
    """Bin, then composite. Returns (image [C,H,W,D], T_final [C,H,W],
    last [C,H,W], binned); ``last`` is what the backward reads."""
    mean_x, mean_y, con_a, con_b, con_c = _split(means2d, conics)
    device = _backend.common_device(
        mean_x, mean_y, con_a, con_b, con_c, colors, opacities, depths, radii, backgrounds
    )
    if tile_size not in TILE_SIZES:
        raise ValueError(f"tile_size must be one of {TILE_SIZES}, got {tile_size}")
    if colors.shape[-1] > MAX_CHANNELS:
        raise ValueError(
            f"at most {MAX_CHANNELS} channels per call, got {colors.shape[-1]}: "
            "split them (rasterization's channel_chunk does)"
        )
    C = mean_x.shape[0]
    th = -(-image_height // tile_size)
    tw = -(-image_width // tile_size)
    binned = bin_gaussians(
        mean_x, mean_y, con_a, con_b, con_c, opacities, colors, radii, depths,
        tile_size, tw, th, capacity=capacity,
    )
    args = (binned.entries, binned.offs, binned.cnts, C, image_width, image_height, tile_size)
    if _backend.use_kernel(device):
        img, T_out, last = _fwd_cuda(*args)
    else:
        img, T_out, last, _ = _fwd_plain(*args)
    if backgrounds is not None:
        img = img + T_out[..., None] * backgrounds[:, None, None, :]
    return img, T_out, last, binned


class _BinnedRaster(torch.autograd.Function):
    """bin -> forward kernel, with the backward kernel and the reduce kernel
    (in the binning sort's gid order) as its gradient (JAX: the custom VJP
    `_raster_binned`).
    Binning reads detached inputs. Returns the image without background
    and T_final; the caller adds the background. Radii and depths get no
    gradient."""

    @staticmethod
    def forward(ctx, mean_x, mean_y, con_a, con_b, con_c, opacities, colors,
                abs_x, abs_y, radii, depths, geom, aux):
        image_width, image_height, tile_size, capacity = geom
        img, T_out, last, binned = _raster_binned_fwd(
            (mean_x, mean_y), (con_a, con_b, con_c), colors, opacities, radii,
            depths, image_width, image_height, tile_size, capacity,
        )
        aux["n_isects"] = binned.n_isects
        aux["slab_required"] = binned.slab_required
        ctx.save_for_backward(binned.entries, binned.gids, binned.offs, binned.cnts, T_out, last,
                              *binned.order)
        ctx.geom = geom
        ctx.n_gauss = mean_x.shape[1]
        ctx.absgrad = abs_x is not None
        return img, T_out

    @staticmethod
    @once_differentiable
    def backward(ctx, v_img, v_T):
        entries, gids, offs, cnts, T_out, last, dst, starts = ctx.saved_tensors
        image_width, image_height, tile_size, _ = ctx.geom
        C = T_out.shape[0]
        D = entries.shape[0] - 6
        N = ctx.n_gauss
        if v_img is None:
            v_img = torch.zeros(T_out.shape + (D,), dtype=torch.float32, device=T_out.device)
        if v_T is None:
            v_T = torch.zeros_like(T_out)
        args = (
            entries, offs, cnts, T_out, last, v_img.contiguous(), v_T.contiguous(),
            C, image_width, image_height, tile_size, ctx.absgrad,
        )
        if _backend.use_kernel(entries.device):
            rows = _bwd_cuda(*args)
        else:
            rows, _ = _bwd_plain(*args)
        red = reduce_by_gid(rows, gids, C * N, order=(dst, starts))
        grads = [red[r].reshape(C, N) for r in range(6)]
        v_colors = red[6 : 6 + D].T.reshape(C, N, D)
        if ctx.absgrad:
            v_abs = [red[6 + D].reshape(C, N), red[7 + D].reshape(C, N)]
        else:
            v_abs = [None, None]
        return (*grads, v_colors, *v_abs, None, None, None, None)


def rasterize_to_pixels_binned(
    means2d,  # [C, N, 2] or (mean_x, mean_y) [C, N] tuple
    conics,  # [C, N, 3] or (a, b, c) tuple
    colors: torch.Tensor,  # [C, N, D]
    opacities: torch.Tensor,  # [C, N]
    radii: torch.Tensor,  # [C, N] i32
    depths: torch.Tensor,  # [C, N]
    image_width: int,
    image_height: int,
    tile_size: int,
    capacity: int,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
    abs_carrier=None,  # (x, y) [C, N] zeros; its gradient is the per-tile absgrad
):
    """Rasterize via the binning engine (emit -> key sort -> forward kernel).

    Returns (render_colors [C,H,W,D], render_alphas [C,H,W,1], aux) where
    aux = {"n_isects", "slab_required"}. Semantics identical to
    rasterize_to_pixels_ref. With grad mode on and an input that requires
    grad, the call goes through `_BinnedRaster` (backward and reduce
    kernels); the gradient of ``abs_carrier`` is then the reference's
    absgrad statistic, the sum over tiles of |per-tile d mean2d|. Without a
    gradient it is the forward alone. Either way the background is
    composited after the forward kernel, as in JAX.
    """
    mean_x, mean_y, con_a, con_b, con_c = _split(means2d, conics)
    ins = (mean_x, mean_y, con_a, con_b, con_c, opacities, colors)
    abs_x, abs_y = abs_carrier if abs_carrier is not None else (None, None)
    diff = [t for t in ins + (abs_x, abs_y, backgrounds) if t is not None]
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in diff)):
        img, T_out, _, binned = _raster_binned_fwd(
            means2d, conics, colors, opacities, radii, depths, image_width,
            image_height, tile_size, capacity, backgrounds=backgrounds,
        )
        aux = {"n_isects": binned.n_isects, "slab_required": binned.slab_required}
        return img, (1.0 - T_out)[..., None], aux
    aux = {}
    img, T_out = _BinnedRaster.apply(
        *ins, abs_x, abs_y, radii, depths,
        (image_width, image_height, tile_size, capacity), aux,
    )
    if backgrounds is not None:
        img = img + T_out[..., None] * backgrounds[:, None, None, :]
    return img, (1.0 - T_out)[..., None], aux
