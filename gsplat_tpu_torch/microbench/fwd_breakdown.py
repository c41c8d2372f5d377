"""The binned forward at four levels of work (port of
scripts/exp_fwd_breakdown.py; kernel csrc/mb_fwd_breakdown.cu).

The TPU script (``make_kernel`` :67, pallas_call :146) runs the production
binned stream (garden grid5, 1920x1080, tile 32, C = 1) through four
kernels of growing work over the same reads, to tell a forward bound by
reading its stream from one bound by its arithmetic: L0 reads only (a
checksum of the batches), L1 adds sigma and alpha, L2 the slice-local
transmittance and the weights, L3 the colour contraction. Output [T, 8, P]
(P = ts^2 pixels of each of T tiles).

`fwd_breakdown(level, entries, offs, cnts, tw, th, ts)` takes the port's
binned stream (`ops.binning.bin_gaussians`: entries [NF, M] with NF <= 16,
the layout csrc/rasterize_fwd.cu reads) and keeps the TPU's arithmetic:
each tile reads every 512-entry batch from floor(off / 512) 512 to off + n
(entries past M read as 0, rows past NF as the TPU's zero padding to 16),
evaluates every entry of them masked to [off, off + n), and restarts the
transmittance at each 128-entry slice of the stream. So the CPU tests feed
one stream to the port and to the script's kernel body and compare.

Bound on the card: the larger of the bytes (the distinct batches' NF rows,
the offsets and the [T, 8, P] output) and the operations the stream needs:
the pairs of each tile's P pixels with its n entries times
`FLOPS_PER_PAIR[level]` (at L3 with the stream's colour rows) at 67 TFLOP/s and one exponential a pair at the
SFU's rate (L1-L3); L0 one add a staged value. `measure` times
`fwd_3dgs` (``ops.rasterize_binned._fwd_cuda``) on the same stream beside
the four levels, which answers the script's question for this card.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Optional

import numpy as np
import torch

from .. import _backend
from .._helper import load_test_data
from ..ops import binning
from ..ops import rasterize_binned as rb
from ..ops.projection import fully_fused_projection_soa
from ..ops.rasterize_binned import _check as check_inputs
from . import bound_ms, compare, median_ms, rejects
from ..ops.rasterize_ref import ALPHA_MAX, ALPHA_MIN, TRANSMITTANCE_EPS

KB = 512  # entries a batch
LANES = 128  # entries a slice
ROWS = 16  # the TPU's padded row count
# f32 flops a (pixel, entry) pair, counted from the kernel: L1 the offsets
# 2, sigma 9, alpha 3 (the exponential's argument, the opacity product, the
# clamp) and its three tests; L2 + 1 - alpha, the product, its test, w and
# the sum; L3 + a multiply-add for each colour row the stream has (`work`)
FLOPS_PER_PAIR = {1: 17, 2: 22, 3: 22}
TILE_GROUP = 16  # tiles the plain version evaluates at once


def _batches(offs: torch.Tensor, cnts: torch.Tensor):
    """(first aligned entry, batch count) of each tile."""
    off, n = offs.long(), cnts.long()
    astart = off // KB * KB
    return astart, (off + n - astart + KB - 1) // KB


def fwd_breakdown_plain(level: int, entries: torch.Tensor, offs: torch.Tensor, cnts: torch.Tensor, tw: int,
                        th: int, ts: int, tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The script's kernel body over the port's stream, `TILE_GROUP` tiles
    at a time; the rows of `tiles` (default: all) of the [T, 8, P] output."""
    dev = entries.device
    NF, M = entries.shape
    P = ts * ts
    tiles = torch.arange(offs.shape[0], device=dev) if tiles is None else tiles.to(dev)
    e_pad = torch.zeros((ROWS, M + KB), dtype=torch.float32, device=dev)
    e_pad[:NF, :M] = entries
    pix = torch.arange(P, device=dev)
    lx, ly = pix % ts, pix // ts
    out = torch.zeros((len(tiles), 8, P), dtype=torch.float32, device=dev)
    astart_all, nb_all = _batches(offs, cnts)
    for g0 in range(0, len(tiles), TILE_GROUP):
        t = tiles[g0:g0 + TILE_GROUP]
        off, n = offs[t].long(), cnts[t].long()
        astart, nb = astart_all[t], nb_all[t]
        rem = t % (th * tw)
        px = (((rem % tw) * ts)[:, None] + lx + 0.5).float()  # [g, P]
        py = (((rem // tw) * ts)[:, None] + ly + 0.5).float()
        local = torch.zeros(len(t), dtype=torch.float32, device=dev)
        acc = torch.zeros((len(t), 8, P), dtype=torch.float32, device=dev)
        for b in range(int(nb.max()) if len(t) else 0):
            active = b < nb  # [g]
            cols = astart[:, None] + b * KB + torch.arange(KB, device=dev)  # [g, KB]
            eb = e_pad[:, cols] * active[None, :, None]  # [16, g, KB]
            if level == 0:
                local += eb.sum(dim=(0, 2))
                continue
            for s in range(KB // LANES):
                e = eb[:, :, s * LANES:(s + 1) * LANES]  # [16, g, 128]
                gidx = cols[:, s * LANES:(s + 1) * LANES]
                inr = active[:, None] & (gidx >= off[:, None]) & (gidx < (off + n)[:, None])  # [g, 128]
                gx, gy, ca, cb, cc, op = (e[r][:, None, :] for r in range(6))
                dx = px[..., None] - gx  # [g, P, 128]
                dy = py[..., None] - gy
                sig = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
                alpha = torch.clamp_max(op * torch.exp(-sig), ALPHA_MAX)
                valid = inr[:, None, :] & (alpha >= ALPHA_MIN) & (sig >= 0.0)
                if level == 1:
                    local += torch.where(valid, alpha, 0.0).sum(dim=(1, 2))
                    continue
                Tm = torch.cumprod(torch.where(valid, 1.0 - alpha, 1.0), dim=-1)
                T_excl = torch.cat([torch.ones_like(Tm[..., :1]), Tm[..., :-1]], dim=-1)
                w = torch.where(valid & (Tm > TRANSMITTANCE_EPS), T_excl * alpha, 0.0)
                if level == 2:
                    local += w.sum(dim=(1, 2))
                else:
                    acc += torch.einsum("gpk,dgk->gdp", w, e[6:14])
        out[g0:g0 + len(t)] = acc if level == 3 else (local * 1e-9)[:, None, None].expand(len(t), 8, P)
    return out


_ARGS = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 2
         + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)


def _fwd_breakdown_cuda(level: int, entries: torch.Tensor, offs: torch.Tensor, cnts: torch.Tensor, tw: int,
                        th: int, ts: int) -> torch.Tensor:
    dev = entries.device
    if dev.type != "cuda":
        raise ValueError(f"the fwd_breakdown kernel takes CUDA tensors, got {dev}")
    NF, M = entries.shape
    T = offs.shape[0]
    check_inputs("fwd_breakdown", dev, [(entries, torch.float32, None), (offs, torch.int32, (T,)),
                                        (cnts, torch.int32, (T,))])
    if not 6 <= NF <= ROWS or ts * ts > 1024 or (ts * ts) % 32:
        raise ValueError(f"fwd_breakdown takes 6..{ROWS} rows and ts^2 <= 1024 a multiple of 32: {NF}, {ts}")
    out = torch.empty((T, 8, ts * ts), dtype=torch.float32, device=dev)
    fn = _backend.kernel("mb_fwd_breakdown", "fwd_breakdown_launch", _ARGS)
    _backend.check_launch(fn(level, entries.data_ptr(), M, NF, offs.data_ptr(), cnts.data_ptr(), T, tw, th, ts,
                             out.data_ptr(), _backend.stream(dev)), f"fwd_breakdown_L{level}")
    _backend.LAUNCHES[f"fwd_breakdown_L{level}"] += 1
    return out


def fwd_breakdown(level: int, entries: torch.Tensor, offs: torch.Tensor, cnts: torch.Tensor, tw: int, th: int,
                  ts: int) -> torch.Tensor:
    """Level 0-3 over the stream: the kernel for CUDA tensors, the plain
    version for CPU tensors; [T, 8, ts^2]."""
    if level not in (0, 1, 2, 3):
        raise ValueError(f"level must be 0-3, got {level}")
    dev = _backend.common_device(entries, offs, cnts)
    if _backend.use_kernel(dev):
        return _fwd_breakdown_cuda(level, entries, offs, cnts, tw, th, ts)
    return fwd_breakdown_plain(level, entries, offs, cnts, tw, th, ts)


def work(level: int, entries: torch.Tensor, offs: torch.Tensor, cnts: torch.Tensor, ts: int):
    """(bytes, f32 flops, exponentials) this stream needs at `level`."""
    NF, M = entries.shape
    T, P = offs.shape[0], ts * ts
    astart, nb = _batches(offs, cnts)
    # the distinct batches the tiles read, clipped to the stream's end
    within = torch.arange(int(nb.sum()), device=offs.device) - (torch.cumsum(nb, 0) - nb).repeat_interleave(nb)
    ids = torch.unique((astart // KB).repeat_interleave(nb) + within)
    cols = int(torch.clamp(M - ids * KB, 0, KB).sum())
    nbytes = 4 * NF * cols + 8 * T + 4 * T * 8 * P
    if level == 0:  # one add a staged value of the NF rows
        return nbytes, NF * KB * int(nb.sum()), 0
    pairs = P * int(cnts.long().sum())
    per_pair = FLOPS_PER_PAIR[level] + (2 * min(NF - 6, 8) if level == 3 else 0)
    return nbytes, per_pair * pairs, pairs


# On the card. Kernel against plain: L0-L2 are each tile's sum in another
# order, held to 1e-5 of that tile's sum of |terms| (L1 and L2 sum
# non-negative terms, so it is the tile's |value|; L0's is the plain
# version on |entries|, capped at the largest tile's |value|); at L3 an entry on the T = 1e-4 edge can flip when
# a product rounds otherwise (the forward kernels' FWD_MAX_ABS), 2e-4 of
# the largest |value|. `check` shows each per-tile gate rejecting a result
# with the smallest tile's value moved by 1e-4 of its sum of |terms|.
TOL = {0: 1e-5, 1: 1e-5, 2: 1e-5, 3: 2e-4}
TILE_SUBSET = 256  # seeded tiles of the production stream the plain version checks
PRODUCTION = (5, 1920, 1080, 32)  # garden scene_grid, W, H, tile


@functools.lru_cache(maxsize=None)
def stream(grid: int, W: int, H: int, ts: int):
    """(entries, offs, cnts, tw, th, W, H) of camera 0 of the garden
    fixture at `grid` on the card, its intrinsics scaled by W over the
    fixture's width (as the TPU script scales them), W x H, binned at tile
    `ts` with culling and the capacity the script sizes (slab_required +
    1024)."""
    means, quats, scales, opac, colors, viewmats, Ks, W0, _ = load_test_data(scene_grid=grid)
    Ks = Ks.copy()
    Ks[:, :2, :] *= W / W0
    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    with torch.no_grad():
        p = fully_fused_projection_soa(t(means), t(quats), t(scales), t(viewmats[:1]), t(Ks[:1]), W, H)
        tw, th = -(-W // ts), -(-H // ts)
        args = (p["mean_x"], p["mean_y"], p["conic_a"], p["conic_b"], p["conic_c"], t(opac)[None],
                t(colors)[None], p["radii"], p["depth"], ts, tw, th)
        need = binning.bin_gaussians(*args, capacity=512, cull=True).slab_required
        bk = binning.bin_gaussians(*args, capacity=int(need) + 1024, cull=True)
    return bk.entries, bk.offs, bk.cnts, tw, th, W, H


def check(small: bool):
    """Each level against its plain version (small: garden scene_grid 1 at
    648x420, every tile; else the production stream on `TILE_SUBSET`
    seeded tiles), {kernel: max abs error}, and each per-tile gate on a
    perturbed result, {"rejects ...": its max abs error}."""
    if small:
        entries, offs, cnts, tw, th, _, _ = stream(1, 648, 420, 32)
        tiles = torch.arange(offs.shape[0], device=offs.device)
    else:
        entries, offs, cnts, tw, th, _, _ = stream(*PRODUCTION)
        g = torch.Generator().manual_seed(0)
        tiles = torch.randperm(offs.shape[0], generator=g)[:TILE_SUBSET].sort().values.to(offs.device)
    errs = {}
    for level in range(4):
        got = fwd_breakdown(level, entries, offs, cnts, tw, th, 32)[tiles]
        want = fwd_breakdown_plain(level, entries, offs, cnts, tw, th, 32, tiles=tiles)
        name = f"fwd_breakdown_L{level}"
        if level == 3:
            errs[name] = compare(name, got, want, TOL[level])
            continue
        # each tile's sum of |terms|, no more than the largest tile's |value|
        terms = torch.clamp(fwd_breakdown_plain(0, entries.abs(), offs, cnts, tw, th, 32, tiles=tiles),
                            max=float(want.abs().max())) if level == 0 else want.abs()
        errs[name] = compare(name, got, want, TOL[level], terms)
        small_tile = int(torch.where(terms[:, 0, 0] > 0, terms[:, 0, 0], float("inf")).argmin())
        wrong = got.clone()
        wrong[small_tile] += 1e-4 * terms[small_tile]
        errs[f"rejects L{level} with its smallest tile moved by 1e-4 of its |terms|"] = rejects(
            f"{name}'s gate", wrong, want, TOL[level], terms)
    return errs


def measure(runs: int = 7):
    """The four levels on the production stream, one row each (the plain
    version's ms: one run over the whole stream), and info: fwd_3dgs's ms
    on it (tile 32) and on the stream binned at tile 16, with their
    entries."""
    grid, W, H, ts = PRODUCTION
    entries, offs, cnts, tw, th, _, _ = stream(*PRODUCTION)
    rows = []
    for level in range(4):
        ms = median_ms(lambda: fwd_breakdown(level, entries, offs, cnts, tw, th, ts), runs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd_breakdown_plain(level, entries, offs, cnts, tw, th, ts)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        nbytes, flops, ex2 = work(level, entries, offs, cnts, ts)
        b, by = bound_ms(nbytes=nbytes, flops=flops, ex2=ex2)
        rows.append(dict(name=f"fwd_breakdown_L{level}", ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b,
                         bound_by=by, rate=None, work=f"{nbytes} bytes, {flops} flops, {ex2} exponentials"))
    fwd = {ts: median_ms(lambda: rb._fwd_cuda(entries, offs, cnts, 1, W, H, ts), runs)}
    e16, o16, c16, *_ = stream(grid, W, H, 16)
    fwd[16] = median_ms(lambda: rb._fwd_cuda(e16, o16, c16, 1, W, H, 16), runs)
    return rows, {"n_isects": {ts: int(cnts.sum()), 16: int(c16.sum())}, "fwd_3dgs_ms": fwd}


def describe(info) -> str:
    """`measure`'s info as one line."""
    n, fwd = info["n_isects"], info["fwd_3dgs_ms"]
    return (f"fwd_3dgs on the breakdown's stream ({n[32]} entries, tile 32): {fwd[32]:.4f} ms; binned at tile 16 "
            f"({n[16]} entries): {fwd[16]:.4f} ms")
