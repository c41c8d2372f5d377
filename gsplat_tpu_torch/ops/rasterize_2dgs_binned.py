"""2DGS (surfel) rasterizer on the binning engine (port of
gsplat_tpu/ops/rasterize_2dgs_binned.py).

The binning engine (ops/binning.py, ``payload_rows``, ``cull=False``)
packs the surfel rows, emits the keys and gids, orders them by one key sort
by (camera-tile, depth, gid) and gathers the rows into the per-entry
stream; the forward kernel (csrc/rasterize_2dgs_fwd.cu;
`_fwd2_plain` is its plain version) composites each tile's range, and the
backward kernel (csrc/rasterize_2dgs_bwd.cu; `_bwd2_plain`) writes one row
of per-entry gradients per stream slot, which the gid reduce kernel
(ops/rasterize_binned.py::reduce_by_gid) sums per Gaussian.

Stream rows (NF = 12 + L): mx, my, M00..M22 (the ray transform, row-major),
opacity, then the L = D + 3 linear features: the D colours (the depth is
the last one) and the 3 camera-frame normals. Per pixel:
  - sigma = 0.5 min(u^2 + v^2, 2 |d|^2), with (u, v) the ray-plane
    intersection from the cross product of h_u = -M0 + px M2 and
    h_v = -M1 + py M2, and d the offset from the projected centre;
  - the 3DGS acceptance and termination (alpha in [1/255, 0.999],
    transmittance after the entry > 1e-4);
  - the distortion 2 sum_k w_k (m_k W_<k - WM_<k) with running prefix sums,
    and the median (the depth of the last accepted entry whose
    transmittance before it is > 0.5), m the last colour channel.
The backward rebuilds the distortion's prefixes from the totals
(W_tot = 1 - T_final, WM_tot = the composited depth channel) and gives the
median no gradient. Semantics are those of ops/rasterize_2dgs_ref.py.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .. import _backend
from .binning import Binned, bin_gaussians
from .rasterize_binned import TILE_SIZES, _check, _plain_split, _to_image, _to_tiles, reduce_by_gid
from .rasterize_ref import ALPHA_MAX, ALPHA_MIN, TRANSMITTANCE_EPS

NFIX = 12  # stream rows before the features: mx, my, M (9), opacity
MAX_CHANNELS = 32  # colour channels D per call; the kernels take L = D + 3 <= 35


def _sigma(e, px, py):
    """The surfel sigma of stream rows `e` (a sequence of the 12 fixed rows,
    broadcastable against the pixel centres px, py). Returns (sig, use3d,
    u, v, crz, dx, dy, hu, hv); the kernels compute it in this order."""
    gx, gy = e[0], e[1]
    m = e[2:11]
    dx = px - gx
    dy = py - gy
    hu = [-m[0] + px * m[6], -m[1] + px * m[7], -m[2] + px * m[8]]
    hv = [-m[3] + py * m[6], -m[4] + py * m[7], -m[5] + py * m[8]]
    cr0 = hu[1] * hv[2] - hu[2] * hv[1]
    cr1 = hu[2] * hv[0] - hu[0] * hv[2]
    cr2 = hu[0] * hv[1] - hu[1] * hv[0]
    crz = torch.where(torch.abs(cr2) < 1e-12, 1e-12, cr2)
    u = cr0 / crz
    v = cr1 / crz
    sig3 = u * u + v * v
    sig2 = 2.0 * (dx * dx + dy * dy)
    use3d = sig3 <= sig2
    sig = 0.5 * torch.minimum(sig3, sig2)
    return sig, use3d, u, v, crz, dx, dy, hu, hv


def surfel_payload(mean_x, mean_y, Ms, opacities, colors, normals):
    """The stream's payload rows, each [C, N]: mx, my, M (Ms [C, N, 9]),
    opacity, colours [C, N, D], normals [C, N, 3]."""
    return [mean_x, mean_y, *Ms.unbind(-1), opacities, *colors.unbind(-1), *normals.unbind(-1)]


def _dims(image_width: int, image_height: int, tile_size: int) -> Tuple[int, int]:
    return -(-image_height // tile_size), -(-image_width // tile_size)


def _fwd2_plain(
    entries: torch.Tensor,  # [12 + L, M] f32
    offs: torch.Tensor,  # [T] i32
    cnts: torch.Tensor,  # [T] i32
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
):
    """Plain torch version of the forward kernel: tiles in groups, each
    group's ranges in chunks of entries, carrying T and the distortion's
    running sums between chunks. Returns (features [C,H,W,L], T_final
    [C,H,W], last [C,H,W] i32 absolute stream index or -1, distortion
    [C,H,W], median [C,H,W], n_pairs), n_pairs counting the (pixel, entry)
    pairs not behind the pixel's termination."""
    dev = entries.device
    tile_group, chunk = _plain_split(tile_size)
    ts = tile_size
    P = ts * ts
    L = entries.shape[0] - NFIX
    md = L - 4  # the depth: the last of the D = L - 3 colour channels
    th, tw = _dims(image_width, image_height, ts)
    n_t = n_cams * th * tw
    M = entries.shape[1]
    pix = torch.arange(P, device=dev)
    lx, ly = pix % ts, pix // ts
    karange = torch.arange(chunk, device=dev)

    feat_t = torch.zeros((n_t, P, L), dtype=torch.float32, device=dev)
    T_out = torch.ones((n_t, P), dtype=torch.float32, device=dev)
    last = torch.full((n_t, P), -1, dtype=torch.int32, device=dev)
    dist_out = torch.zeros((n_t, P), dtype=torch.float32, device=dev)
    med_out = torch.zeros((n_t, P), dtype=torch.float32, device=dev)
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
        px = (((rem % tw) * ts)[:, None] + lx + 0.5)[..., None]  # [g, P, 1]
        py = (((rem // tw) * ts)[:, None] + ly + 0.5)[..., None]
        shape = px.shape[:2]
        T = torch.ones(shape, dtype=torch.float32, device=dev)
        acc = torch.zeros(shape + (L,), dtype=torch.float32, device=dev)
        t_fin = torch.ones_like(T)
        lst = torch.full(shape, -1, dtype=torch.int64, device=dev)
        dist = torch.zeros_like(T)
        med = torch.zeros_like(T)
        wsum = torch.zeros_like(T)
        wmsum = torch.zeros_like(T)
        for k0 in range(0, nmax, chunk):
            j = k0 + karange
            inr = j[None, :] < n[:, None]  # [g, K]
            idx = o[:, None] + j[None, :]
            e = entries[:, idx.clamp(0, max(M - 1, 0))][:, :, None, :]  # [NF, g, 1, K]
            sig = _sigma(e, px, py)[0]  # [g, P, K]
            alpha = torch.clamp_max(e[11] * torch.exp(-sig), ALPHA_MAX)
            valid = inr[:, None, :] & (alpha >= ALPHA_MIN) & (sig >= 0.0)
            one_m = torch.where(valid, 1.0 - alpha, 1.0)
            T_incl = T[..., None] * torch.cumprod(one_m, dim=-1)
            T_excl = torch.cat([T[..., None], T_incl[..., :-1]], dim=-1)
            accept = valid & (T_incl > TRANSMITTANCE_EPS)
            w = torch.where(accept, T_excl * alpha, 0.0)
            acc += torch.einsum("gpk,lgk->gpl", w, e[NFIX:, :, 0])
            mrow = e[NFIX + md]  # [g, 1, K]
            wm = w * mrow
            w_pref = torch.cumsum(w, dim=-1) - w + wsum[..., None]
            wm_pref = torch.cumsum(wm, dim=-1) - wm + wmsum[..., None]
            dist = dist + (2.0 * (wm * w_pref - w * wm_pref)).sum(dim=-1)
            hit = accept & (T_excl > 0.5)
            pos = torch.where(hit, karange, -1).amax(dim=-1)  # [g, P]
            m_at = torch.gather(mrow.expand(w.shape), -1, pos.clamp_min(0)[..., None])[..., 0]
            med = torch.where(pos >= 0, m_at, med)
            t_fin = torch.minimum(t_fin, torch.where(accept, T_incl, 1.0).amin(dim=-1))
            lst = torch.maximum(lst, torch.where(accept, idx[:, None, :], -1).amax(dim=-1))
            n_pairs += ((T_excl > TRANSMITTANCE_EPS) & inr[:, None, :]).sum()
            wsum = wsum + w.sum(dim=-1)
            wmsum = wmsum + wm.sum(dim=-1)
            T = T_incl[..., -1]
            if bool((T <= TRANSMITTANCE_EPS).all()):
                break
        feat_t[tiles] = acc
        T_out[tiles] = t_fin
        last[tiles] = lst.to(torch.int32)
        dist_out[tiles] = dist
        med_out[tiles] = med

    outs = [
        _to_image(x, n_cams, th, tw, ts, image_width, image_height)
        for x in (feat_t, T_out, last, dist_out, med_out)
    ]
    return (*outs, int(n_pairs))


def _kernel_dims(entries: torch.Tensor, tile_size: int, what: str) -> int:
    """L of a stream the kernels take, or raise."""
    if entries.device.type != "cuda":
        raise ValueError(f"the 2DGS {what} kernel takes CUDA tensors, got {entries.device}")
    if tile_size not in TILE_SIZES:
        raise ValueError(f"tile_size must be one of {TILE_SIZES}, got {tile_size}")
    L = entries.shape[0] - NFIX
    if not 4 <= L <= MAX_CHANNELS + 3:
        raise ValueError(f"the 2DGS {what} kernel takes 1..{MAX_CHANNELS} colour channels, got {L - 3}")
    return L


_FWD2_ARGS = (
    [ctypes.c_void_p, ctypes.c_longlong]  # entries, M (row stride)
    + [ctypes.c_void_p] * 2  # offs, cnts
    + [ctypes.c_int] * 7  # C, th, tw, ts, W, H, L
    + [ctypes.c_void_p] * 6  # features, T, last, distortion, median, stream
)


def _fwd2_cuda(
    entries: torch.Tensor,
    offs: torch.Tensor,
    cnts: torch.Tensor,
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
):
    """Launch csrc/rasterize_2dgs_fwd.cu: one block per (camera, tile), one
    thread per pixel. Returns (features, T_final, last, distortion, median)
    as `_fwd2_plain` does."""
    dev = entries.device
    L = _kernel_dims(entries, tile_size, "forward")
    th, tw = _dims(image_width, image_height, tile_size)
    T = n_cams * th * tw
    _check("2DGS forward", dev, [(entries, torch.float32, None), (offs, torch.int32, (T,)), (cnts, torch.int32, (T,))])
    img = (n_cams, image_height, image_width)
    feat = torch.empty(img + (L,), dtype=torch.float32, device=dev)
    T_out = torch.empty(img, dtype=torch.float32, device=dev)
    last = torch.empty(img, dtype=torch.int32, device=dev)
    dist = torch.empty(img, dtype=torch.float32, device=dev)
    med = torch.empty(img, dtype=torch.float32, device=dev)
    if T == 0:
        return feat, T_out, last, dist, med
    fn = _backend.kernel("rasterize_2dgs_fwd", "rasterize_2dgs_fwd_launch", _FWD2_ARGS)
    code = fn(
        entries.data_ptr(), entries.shape[1], offs.data_ptr(), cnts.data_ptr(),
        n_cams, th, tw, tile_size, image_width, image_height, L,
        feat.data_ptr(), T_out.data_ptr(), last.data_ptr(), dist.data_ptr(), med.data_ptr(),
        _backend.stream(dev),
    )
    _backend.check_launch(code, "rasterize_2dgs_fwd")
    _backend.LAUNCHES["rasterize_2dgs_fwd"] += 1
    return feat, T_out, last, dist, med


def _bwd2_plain(
    entries: torch.Tensor,  # [12 + L, M] f32
    offs: torch.Tensor,  # [T] i32
    cnts: torch.Tensor,  # [T] i32
    T_fin: torch.Tensor,  # [C, H, W] the forward's T_final
    last: torch.Tensor,  # [C, H, W] i32 the forward's last accepted index
    wm_tot: torch.Tensor,  # [C, H, W] the forward's composited depth channel
    v_feat: torch.Tensor,  # [C, H, W, L] cotangent of the features
    v_T: torch.Tensor,  # [C, H, W] cotangent of T_final
    v_dist: torch.Tensor,  # [C, H, W] cotangent of the distortion
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
):
    """Plain torch version of the backward kernel: tiles in groups, each
    group's ranges walked back to front in chunks of entries, carrying per
    pixel the product of the later (1 - alpha) and the later sums of w, w m
    and w G. Returns (rows [12 + L, M], (n_eval, n_acc)): per stream slot
    the gradients of mx, my, M (9), opacity and the L features (zero where
    no pixel accepted the entry), the (pixel, entry) pairs evaluated (at or
    before the pixel's `last`) and those accepted."""
    dev = entries.device
    tile_group, chunk = _plain_split(tile_size)
    ts = tile_size
    P = ts * ts
    L = entries.shape[0] - NFIX
    md = L - 4
    M = entries.shape[1]
    th, tw = _dims(image_width, image_height, ts)
    n_t = n_cams * th * tw
    pix = torch.arange(P, device=dev)
    lx, ly = pix % ts, pix // ts

    Tt = _to_tiles(T_fin, th, tw, ts, 1.0)
    Lt = _to_tiles(last.to(torch.int64), th, tw, ts, -1)
    WMt = _to_tiles(wm_tot, th, tw, ts, 0.0)
    Vt = _to_tiles(v_feat, th, tw, ts, 0.0)
    VLt = _to_tiles(v_T * T_fin, th, tw, ts, 0.0)  # v_logT
    VDt = _to_tiles(v_dist, th, tw, ts, 0.0)
    rows = torch.zeros((NFIX + L, M), dtype=torch.float32, device=dev)
    n_eval = torch.zeros((), dtype=torch.int64, device=dev)
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    if n_t == 0:
        return rows, (0, 0)

    def later(x):  # sum over the later entries of the chunk, exclusive
        return torch.flip(torch.cumsum(torch.flip(x, [-1]), dim=-1), [-1]) - x

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
        px = (((rem % tw) * ts)[:, None] + lx + 0.5)[..., None]  # [g, P, 1]
        py = (((rem // tw) * ts)[:, None] + ly + 0.5)[..., None]
        T_g, L_g, V_g = Tt[tiles][..., None], Lt[tiles][..., None], Vt[tiles]
        VL_g, VD_g = VLt[tiles][..., None], VDt[tiles][..., None]
        W_tot = 1.0 - T_g
        WM_tot = WMt[tiles][..., None]
        S = torch.ones(px.shape[:2], dtype=torch.float32, device=dev)
        sG = torch.zeros_like(S)
        sW = torch.zeros_like(S)
        sWM = torch.zeros_like(S)
        for k0 in reversed(range(0, nmax, chunk)):
            j = k0 + torch.arange(chunk, device=dev)
            inr = j[None, :] < n[:, None]  # [g, K]
            idx = o[:, None] + j[None, :]
            e = entries[:, idx.clamp(0, max(M - 1, 0))][:, :, None, :]  # [NF, g, 1, K]
            sig, use3d, u, v, crz, dx, dy, hu, hv = _sigma(e, px, py)
            eneg = torch.exp(-sig)
            araw = e[11] * eneg
            alpha = torch.clamp_max(araw, ALPHA_MAX)
            seen = inr[:, None, :] & (idx[:, None, :] <= L_g)
            accept = seen & (alpha >= ALPHA_MIN) & (sig >= 0.0)
            n_eval += seen.sum()
            n_acc += accept.sum()
            one_m = torch.where(accept, 1.0 - alpha, 1.0)
            S_incl = torch.flip(torch.cumprod(torch.flip(one_m, [-1]), dim=-1), [-1]) * S[..., None]
            Tk = T_g / S_incl
            w = torch.where(accept, alpha * Tk, 0.0)
            feat = e[NFIX:, :, 0]  # [L, g, K]
            cv = torch.einsum("gpl,lgk->gpk", V_g, feat)
            mrow = e[NFIX + md]
            wm = w * mrow
            S_w = later(w) + sW[..., None]
            S_wm = later(wm) + sWM[..., None]
            W_pref = W_tot - w - S_w
            WM_pref = WM_tot - wm - S_wm
            G = cv + VD_g * 2.0 * (mrow * W_pref - WM_pref + (S_wm - mrow * S_w))
            d = w * G
            S_excl = later(d) + sG[..., None]
            v_alpha = torch.where(accept, Tk * G - (S_excl + VL_g) / one_m, 0.0)
            notclamp = accept & (araw < ALPHA_MAX)
            v_sig = torch.where(notclamp, -alpha * v_alpha, 0.0)
            v_op = torch.where(notclamp, eneg * v_alpha, 0.0).sum(dim=1)
            v_feat_r = torch.einsum("gpk,gpl->lgk", w, V_g)
            v_feat_r[md] += (VD_g * 2.0 * w * (W_pref - S_w)).sum(dim=1)
            v_u = torch.where(use3d, u * v_sig, 0.0)
            v_v = torch.where(use3d, v * v_sig, 0.0)
            v_cr = [v_u / crz, v_v / crz, -(u * v_u + v * v_v) / crz]
            v_hu = [
                hv[1] * v_cr[2] - hv[2] * v_cr[1],
                hv[2] * v_cr[0] - hv[0] * v_cr[2],
                hv[0] * v_cr[1] - hv[1] * v_cr[0],
            ]
            v_hv = [
                v_cr[1] * hu[2] - v_cr[2] * hu[1],
                v_cr[2] * hu[0] - v_cr[0] * hu[2],
                v_cr[0] * hu[1] - v_cr[1] * hu[0],
            ]
            vals = (
                [
                    -torch.where(use3d, 0.0, 2.0 * dx * v_sig).sum(dim=1),
                    -torch.where(use3d, 0.0, 2.0 * dy * v_sig).sum(dim=1),
                ]
                + [-v_hu[c].sum(dim=1) for c in range(3)]
                + [-v_hv[c].sum(dim=1) for c in range(3)]
                + [(px * v_hu[c] + py * v_hv[c]).sum(dim=1) for c in range(3)]
                + [v_op]
            )
            vals = torch.cat([torch.stack(vals), v_feat_r])  # [12 + L, g, K]
            rows[:, idx[inr]] = vals[:, inr]
            S = S_incl[..., 0]
            sG = sG + d.sum(dim=-1)
            sW = sW + w.sum(dim=-1)
            sWM = sWM + wm.sum(dim=-1)
    return rows, (int(n_eval), int(n_acc))


_BWD2_ARGS = (
    [ctypes.c_void_p, ctypes.c_longlong]  # entries, M (row stride)
    + [ctypes.c_void_p] * 2  # offs, cnts
    + [ctypes.c_int] * 7  # C, th, tw, ts, W, H, L
    + [ctypes.c_void_p] * 8  # T_final, last, wm_tot, v_feat, v_T, v_dist, rows, stream
)


def _bwd2_cuda(
    entries: torch.Tensor,
    offs: torch.Tensor,
    cnts: torch.Tensor,
    T_fin: torch.Tensor,
    last: torch.Tensor,
    wm_tot: torch.Tensor,
    v_feat: torch.Tensor,
    v_T: torch.Tensor,
    v_dist: torch.Tensor,
    n_cams: int,
    image_width: int,
    image_height: int,
    tile_size: int,
) -> torch.Tensor:
    """Launch csrc/rasterize_2dgs_bwd.cu: one block per (camera, tile), one
    thread per pixel. Returns rows [12 + L, M] as `_bwd2_plain` does."""
    dev = entries.device
    L = _kernel_dims(entries, tile_size, "backward")
    th, tw = _dims(image_width, image_height, tile_size)
    T = n_cams * th * tw
    img = (n_cams, image_height, image_width)
    _check("2DGS backward", dev, [
        (entries, torch.float32, None), (offs, torch.int32, (T,)), (cnts, torch.int32, (T,)),
        (T_fin, torch.float32, img), (last, torch.int32, img), (wm_tot, torch.float32, img),
        (v_feat, torch.float32, img + (L,)), (v_T, torch.float32, img), (v_dist, torch.float32, img),
    ])
    rows = torch.zeros((NFIX + L, entries.shape[1]), dtype=torch.float32, device=dev)
    if T == 0 or entries.shape[1] == 0:
        return rows
    fn = _backend.kernel("rasterize_2dgs_bwd", "rasterize_2dgs_bwd_launch", _BWD2_ARGS)
    code = fn(
        entries.data_ptr(), entries.shape[1], offs.data_ptr(), cnts.data_ptr(),
        n_cams, th, tw, tile_size, image_width, image_height, L,
        T_fin.data_ptr(), last.data_ptr(), wm_tot.data_ptr(), v_feat.data_ptr(),
        v_T.data_ptr(), v_dist.data_ptr(), rows.data_ptr(), _backend.stream(dev),
    )
    _backend.check_launch(code, "rasterize_2dgs_bwd")
    _backend.LAUNCHES["rasterize_2dgs_bwd"] += 1
    return rows


def _raster_2dgs_fwd(
    mean_x, mean_y, Ms, opacities, colors, normals, radii, depths,
    image_width: int, image_height: int, tile_size: int, capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Binned]:
    """Bin the surfel rows (no cull: a surfel's alpha >= 1/255 support
    reaches far past its dual-conic extents, so the radii rectangle is
    the tightest exact one), then composite. Returns (features [C,H,W,L],
    T_final, last, distortion, median, binned)."""
    device = _backend.common_device(
        mean_x, mean_y, Ms, opacities, colors, normals, radii, depths
    )
    if tile_size not in TILE_SIZES:
        raise ValueError(f"tile_size must be one of {TILE_SIZES}, got {tile_size}")
    if not 1 <= colors.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"1..{MAX_CHANNELS} colour channels per call, got {colors.shape[-1]}")
    C = mean_x.shape[0]
    th, tw = _dims(image_width, image_height, tile_size)
    binned = bin_gaussians(
        mean_x, mean_y, None, None, None, None, None, radii, depths,
        tile_size, tw, th, capacity=capacity, cull=False,
        payload_rows=surfel_payload(mean_x, mean_y, Ms, opacities, colors, normals),
    )
    args = (binned.entries, binned.offs, binned.cnts, C, image_width, image_height, tile_size)
    if _backend.use_kernel(device):
        outs = _fwd2_cuda(*args)
    else:
        outs = _fwd2_plain(*args)[:5]
    return (*outs, binned)


class _Binned2DGS(torch.autograd.Function):
    """bin -> 2DGS forward kernel, with the 2DGS backward kernel and the
    reduce kernel (in the binning sort's gid order) as its gradient (JAX:
    the custom VJP `_raster_2dgs_binned`). Binning reads detached inputs. Returns the
    features without background, T_final, the distortion and the median
    (which has no gradient); radii and depths get none either."""

    @staticmethod
    def forward(ctx, mean_x, mean_y, Ms, opacities, colors, normals, radii, depths, geom, aux):
        image_width, image_height, tile_size, capacity = geom
        feat, T_out, last, dist, med, binned = _raster_2dgs_fwd(
            mean_x, mean_y, Ms, opacities, colors, normals, radii, depths,
            image_width, image_height, tile_size, capacity,
        )
        aux["n_isects"] = binned.n_isects
        aux["slab_required"] = binned.slab_required
        D = colors.shape[-1]
        ctx.save_for_backward(
            binned.entries, binned.gids, binned.offs, binned.cnts, T_out, last,
            feat[..., D - 1].contiguous(), *binned.order,
        )
        ctx.geom = geom
        ctx.n_gauss = mean_x.shape[1]
        ctx.mark_non_differentiable(med)
        return feat, T_out, dist, med

    @staticmethod
    @once_differentiable
    def backward(ctx, v_feat, v_T, v_dist, _v_med):
        entries, gids, offs, cnts, T_out, last, wm_tot, dst, starts = ctx.saved_tensors
        image_width, image_height, tile_size, _ = ctx.geom
        C = T_out.shape[0]
        L = entries.shape[0] - NFIX
        D = L - 3
        N = ctx.n_gauss

        def dense(v, shape):
            return torch.zeros(shape, dtype=torch.float32, device=T_out.device) if v is None else v.contiguous()

        args = (
            entries, offs, cnts, T_out, last, wm_tot, dense(v_feat, T_out.shape + (L,)),
            dense(v_T, T_out.shape), dense(v_dist, T_out.shape),
            C, image_width, image_height, tile_size,
        )
        if _backend.use_kernel(entries.device):
            rows = _bwd2_cuda(*args)
        else:
            rows, _ = _bwd2_plain(*args)
        red = reduce_by_gid(rows, gids, C * N, order=(dst, starts))  # [12 + L, C * N]
        v_feat_g = red[NFIX:].T.reshape(C, N, L)
        return (
            red[0].reshape(C, N), red[1].reshape(C, N), red[2:11].T.reshape(C, N, 9),
            red[11].reshape(C, N), v_feat_g[..., :D], v_feat_g[..., D:],
            None, None, None, None,
        )


def rasterize_to_pixels_2dgs_binned(
    means2d,  # [C, N, 2] or (mean_x, mean_y) [C, N] tuple
    ray_transforms,  # [C, N, 3, 3] or a tuple of the 9 [C, N] rows
    colors: torch.Tensor,  # [C, N, D], the last channel the depth
    normals: torch.Tensor,  # [C, N, 3]
    opacities: torch.Tensor,  # [C, N]
    radii: torch.Tensor,  # [C, N] i32
    depths: torch.Tensor,  # [C, N]
    image_width: int,
    image_height: int,
    tile_size: int,
    capacity: int,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
):
    """Rasterize surfels via the binning engine. Returns (render_colors
    [C,H,W,D], render_alphas [C,H,W,1], render_normals [C,H,W,3] in the
    camera frame, render_distort [C,H,W,1], render_median [C,H,W,1], aux)
    with aux = {"n_isects", "slab_required"}. Semantics identical to
    rasterize_to_pixels_2dgs_ref. With grad mode on and an input that
    requires grad, the call goes through `_Binned2DGS` (backward and reduce
    kernels). The background is composited outside the kernels."""
    if isinstance(means2d, (tuple, list)):
        mean_x, mean_y = means2d
    else:
        mean_x, mean_y = means2d[..., 0], means2d[..., 1]
    if isinstance(ray_transforms, (tuple, list)):
        Ms = torch.stack(list(ray_transforms), dim=-1)
    else:
        Ms = ray_transforms.reshape(ray_transforms.shape[:-2] + (9,))
    D = colors.shape[-1]
    ins = (mean_x, mean_y, Ms, opacities, colors, normals)
    geom = (image_width, image_height, tile_size, capacity)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        aux = {}
        feat, T_out, dist, med = _Binned2DGS.apply(*ins, radii, depths, geom, aux)
    else:
        feat, T_out, _, dist, med, binned = _raster_2dgs_fwd(*ins, radii, depths, *geom)
        aux = {"n_isects": binned.n_isects, "slab_required": binned.slab_required}
    render = feat[..., :D]
    if backgrounds is not None:
        render = render + T_out[..., None] * backgrounds[:, None, None, :]
    return (
        render, (1.0 - T_out)[..., None], feat[..., D:], dist[..., None], med[..., None], aux,
    )
