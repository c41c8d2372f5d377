"""Binned rasterizer, forward: front-to-back compositing over the sorted
entry stream (port of the forward of gsplat_tpu/ops/rasterize_binned.py).

The binning engine (ops/binning.py) builds the (tile, depth, gid)-sorted
stream; the forward kernel (csrc/rasterize_fwd.cu; `_fwd_plain` is its
plain version) composites each (camera, tile) range into its pixels.
Semantics are those of ops/rasterize_ref.py (the oracle).

Only the forward is ported: the backward and the per-Gaussian gradient
reduce come with the training slice, so a call that would need a gradient
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _backend
from .binning import Binned, bin_gaussians
from .rasterize_ref import ALPHA_MAX, ALPHA_MIN, TRANSMITTANCE_EPS

TILE_SIZES = (8, 16, 32)
MAX_CHANNELS = 32  # rendering.rasterization's channel_chunk default caps D here
# the plain forward's loop split: tiles per group, entries per chunk
PLAIN_TILE_GROUP = 256
PLAIN_CHUNK = 128


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
    tile_group, chunk = PLAIN_TILE_GROUP, PLAIN_CHUNK
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

    def to_image(x):
        x = x.reshape((n_cams, th, tw, ts, ts) + x.shape[2:])
        x = x.transpose(2, 3).reshape((n_cams, th * ts, tw * ts) + x.shape[5:])
        return x[:, :image_height, :image_width].contiguous()

    img, T_out, last = to_image(img), to_image(T_out), to_image(last)
    if backgrounds is not None:
        img = img + T_out[..., None] * backgrounds[:, None, None, :]
    return img, T_out, last, int(n_pairs)


_FWD_ARGS = (
    [ctypes.c_void_p, ctypes.c_longlong]  # entries, M (row stride)
    + [ctypes.c_void_p] * 2  # offs, cnts
    + [ctypes.c_int] * 7  # C, th, tw, ts, W, H, D
    + [ctypes.c_void_p] * 5  # backgrounds (or null), image, T, last, stream
)


def _fwd_cuda(
    entries: torch.Tensor,
    offs: torch.Tensor,
    cnts: torch.Tensor,
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
    backgrounds: Optional[torch.Tensor] = None,
):
    """Launch csrc/rasterize_fwd.cu: one block per (camera, tile), one
    thread per pixel. Returns (image [C,H,W,D] with the background added,
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
    checks = [(entries, torch.float32, None), (offs, torch.int32, (T,)), (cnts, torch.int32, (T,))]
    if backgrounds is not None:
        backgrounds = backgrounds.to(torch.float32).contiguous()
        checks.append((backgrounds, torch.float32, (n_cams, D)))
    for t, dt, shape in checks:
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"forward input of dtype {t.dtype} on {t.device}: expected contiguous {dt} on {dev}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"forward input of shape {tuple(t.shape)}: expected {shape}")
    img = torch.empty((n_cams, image_height, image_width, D), dtype=torch.float32, device=dev)
    T_out = torch.empty((n_cams, image_height, image_width), dtype=torch.float32, device=dev)
    last = torch.empty((n_cams, image_height, image_width), dtype=torch.int32, device=dev)
    if T == 0:
        return img, T_out, last
    fn = _backend.kernel("rasterize_fwd", "rasterize_fwd_launch", _FWD_ARGS)
    code = fn(
        entries.data_ptr(), entries.shape[1], offs.data_ptr(), cnts.data_ptr(),
        n_cams, th, tw, tile_size, image_width, image_height, D,
        backgrounds.data_ptr() if backgrounds is not None else None,
        img.data_ptr(), T_out.data_ptr(), last.data_ptr(), _backend.stream(dev),
    )
    _backend.check_launch(code, "rasterize_fwd")
    _backend.LAUNCHES["rasterize_fwd"] += 1
    return img, T_out, last


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
    last [C,H,W], binned); ``last`` is what the backward of the training
    slice reads."""
    mean_x, mean_y, con_a, con_b, con_c = _split(means2d, conics)
    ins = (mean_x, mean_y, con_a, con_b, con_c, colors, opacities, depths)
    device = _backend.common_device(*ins, radii, backgrounds)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins + (backgrounds,) if t is not None):
        raise NotImplementedError(
            "the binned backend's backward is not ported yet: it comes with "
            "port slice 2 (training); call under torch.no_grad() or use "
            "backend='oracle'"
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
    args = (binned.entries, binned.offs, binned.cnts, C, image_width, image_height, tile_size, backgrounds)
    if _backend.use_kernel(device):
        img, T_out, last = _fwd_cuda(*args)
    else:
        img, T_out, last, _ = _fwd_plain(*args)
    return img, T_out, last, binned


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
    abs_carrier=None,
):
    """Rasterize via the binning engine (emit -> key sort -> forward kernel).

    Returns (render_colors [C,H,W,D], render_alphas [C,H,W,1], aux) where
    aux = {"n_isects", "slab_required"}. Semantics identical to
    rasterize_to_pixels_ref. Forward only: with grad mode on and an input
    that requires grad it raises NotImplementedError.
    """
    if abs_carrier is not None:
        raise NotImplementedError(
            "abs_carrier (absgrad) comes with port slice 2 (training)"
        )
    img, T_out, _, binned = _raster_binned_fwd(
        means2d, conics, colors, opacities, radii, depths, image_width,
        image_height, tile_size, capacity, backgrounds=backgrounds,
    )
    aux = {"n_isects": binned.n_isects, "slab_required": binned.slab_required}
    return img, (1.0 - T_out)[..., None], aux
