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
the layout csrc/rasterize_fwd.cu reads) and keeps the TPU's arithmetic. Its
plain version, as the TPU kernel, reads every 512-entry batch of a tile
from floor(off / 512) 512 to off + n (entries past M read as 0, rows past
NF as the TPU's zero padding to 16), evaluates every entry of them masked
to [off, off + n), and restarts the transmittance at each 128-entry slice
of the stream. So the CPU tests feed one stream to the port and to the
script's kernel body and compare.

The kernel walks a work list (`breakdown_plan`, a pure function of offs
and cnts made on the host, once a stream, by the caller, who passes it as
`plan=`; `check_plan` holds it to the stream): each tile's range cut into items of at most
`ITEM_SLICES` slices (L0: of whole batches), the heaviest items first, a
block an item; at L1-L3 only the entries [off, off + n), since the entries
masked out contributed nothing. A split tile's items write partials that a
second pass adds in item order.

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
from typing import NamedTuple, Optional

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


ITEM_SLICES = 8  # a work item's most slices (1,024 entries; L0: two batches)


class BreakdownPlan(NamedTuple):
    """`breakdown_plan`'s work list for one level of one stream, int32
    tensors on the stream's device."""
    level: int
    T: int  # the stream's tiles
    M: int  # the stream's entries
    items: torch.Tensor  # [n, 4]: tile, first entry, end entry, partial slot or -1; heaviest first
    finish: torch.Tensor  # [m, 4]: tile, first slot, slots, 0: the split tiles and the tiles with no item
    slots: int  # partials: the items of the split tiles


def item_units(level: int):
    """(entries a unit, units an item) of `breakdown_plan`'s cut: slices of
    128 at L1-L3, batches of 512 at L0."""
    return (KB, max(1, ITEM_SLICES * LANES // KB)) if level == 0 else (LANES, ITEM_SLICES)


def breakdown_plan(level: int, offs: torch.Tensor, cnts: torch.Tensor, M: int) -> BreakdownPlan:
    """The kernel's work list for `level` over a stream of M entries, on
    offs' device. Each tile's range, [off, min(off + n, M)) at L1-L3
    (entries past M read as zeros and add nothing) and its batches
    [floor(off / 512) 512, min(that + 512 nb, M)) at L0, is cut from its
    first slice into items of `ITEM_SLICES` slices (`item_units`; L0: of
    the whole batches in 128 x ITEM_SLICES entries, at least one), the
    first and last one part-full where the range starts or ends mid-slice;
    a tile of several items gets one partial slot an item, in item order,
    and a `finish` row; a tile of no entries gets no item and a `finish`
    row of no slots. The items are ordered by their entries, most first
    (ties in tile order). Reads offs and cnts to the host."""
    if level not in (0, 1, 2, 3):
        raise ValueError(f"breakdown_plan takes a level 0-3, got {level}")
    off = offs.detach().cpu().numpy().astype(np.int64)
    n = cnts.detach().cpu().numpy().astype(np.int64)
    T = off.shape[0]
    if (off < 0).any() or (n < 0).any() or M >= 2 ** 31:
        raise ValueError("breakdown_plan takes offs, cnts >= 0 and M < 2^31")
    unit, per = item_units(level)
    if level == 0:
        lo = off // KB * KB
        hi = np.minimum(lo + (off + n - lo + KB - 1) // KB * KB, M)
    else:
        lo = off
        hi = np.minimum(off + n, M)
    live = hi > lo
    first = lo // unit
    k = np.where(live, -(-((np.maximum(hi, lo + 1) - 1) // unit - first + 1) // per), 0)  # items a tile
    tile = np.repeat(np.arange(T), k)
    j = np.arange(int(k.sum())) - np.repeat(np.cumsum(k) - k, k)  # item within its tile
    start = np.maximum(lo[tile], (first[tile] + j * per) * unit)
    end = np.minimum(hi[tile], (first[tile] + (j + 1) * per) * unit)
    split = k[tile] > 1
    slot = np.where(split, np.cumsum(split) - 1, -1)
    order = np.argsort(-(end - start), kind="stable")
    items = np.stack([tile, start, end, slot], axis=1)[order]
    fin_tiles = np.nonzero((k == 0) | (k > 1))[0]
    first_slot = np.cumsum(np.where(k > 1, k, 0)) - np.where(k > 1, k, 0)
    finish = np.stack([fin_tiles, first_slot[fin_tiles], np.where(k > 1, k, 0)[fin_tiles],
                       np.zeros_like(fin_tiles)], axis=1)
    as_i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32).reshape(-1, 4)).to(offs.device)  # noqa: E731
    return BreakdownPlan(level, T, int(M), as_i32(items), as_i32(finish), int(split.sum()))


def check_plan(plan: BreakdownPlan, level: int, entries: torch.Tensor, offs: torch.Tensor):
    """Raises unless `plan` is `breakdown_plan`'s for `level` over a stream
    of entries' M and offs' T, its lists contiguous int32 [n, 4] on the
    stream's device: the kernel trusts every tile and entry it names."""
    T, M = offs.shape[0], entries.shape[1]
    if (plan.level, plan.T, plan.M) != (level, T, M):
        raise ValueError(f"fwd_breakdown L{level} over T {T}, M {M} given the plan of L{plan.level} over "
                         f"T {plan.T}, M {plan.M}")
    for name, a in (("items", plan.items), ("finish", plan.finish)):
        if a.dtype != torch.int32 or a.dim() != 2 or a.shape[1] != 4 or not a.is_contiguous() \
                or a.device != offs.device:
            raise ValueError(f"fwd_breakdown's plan.{name} must be contiguous int32 [n, 4] on {offs.device}, got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")


_ARGS = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 4
         + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3)


def _fwd_breakdown_cuda(level: int, entries: torch.Tensor, offs: torch.Tensor, cnts: torch.Tensor, tw: int,
                        th: int, ts: int, plan: Optional[BreakdownPlan]) -> torch.Tensor:
    dev = entries.device
    if dev.type != "cuda":
        raise ValueError(f"the fwd_breakdown kernel takes CUDA tensors, got {dev}")
    NF, M = entries.shape
    T = offs.shape[0]
    check_inputs("fwd_breakdown", dev, [(entries, torch.float32, None), (offs, torch.int32, (T,)),
                                        (cnts, torch.int32, (T,))])
    if not 6 <= NF <= ROWS or ts * ts > 1024 or (ts * ts) % 32:
        raise ValueError(f"fwd_breakdown takes 6..{ROWS} rows and ts^2 <= 1024 a multiple of 32: {NF}, {ts}")
    if plan is None:
        raise ValueError("the fwd_breakdown kernel takes the stream's plan: breakdown_plan(level, offs, cnts, M)")
    check_plan(plan, level, entries, offs)
    P = ts * ts
    out = torch.empty((T, 8, P), dtype=torch.float32, device=dev)
    partial = torch.empty(max(plan.slots, 1) * (8 * P if level == 3 else 1), dtype=torch.float32, device=dev)
    fn = _backend.kernel("mb_fwd_breakdown", "fwd_breakdown_launch", _ARGS)
    _backend.check_launch(fn(level, entries.data_ptr(), M, NF, tw, th, ts, plan.items.data_ptr(), plan.items.shape[0],
                             plan.finish.data_ptr(), plan.finish.shape[0], partial.data_ptr(), out.data_ptr(),
                             _backend.stream(dev)), f"fwd_breakdown_L{level}")
    _backend.LAUNCHES[f"fwd_breakdown_L{level}"] += 1
    return out


def fwd_breakdown(level: int, entries: torch.Tensor, offs: torch.Tensor, cnts: torch.Tensor, tw: int, th: int,
                  ts: int, plan: Optional[BreakdownPlan] = None) -> torch.Tensor:
    """Level 0-3 over the stream: the kernel for CUDA tensors, over `plan`
    (`breakdown_plan`'s for this level and stream, made once by the
    caller), the plain version for CPU tensors, which needs none; a plan
    given is held to the stream on either (`check_plan`). [T, 8, ts^2]."""
    if level not in (0, 1, 2, 3):
        raise ValueError(f"level must be 0-3, got {level}")
    dev = _backend.common_device(entries, offs, cnts)
    if _backend.use_kernel(dev):
        return _fwd_breakdown_cuda(level, entries, offs, cnts, tw, th, ts, plan)
    if plan is not None:
        check_plan(plan, level, entries, offs)
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


def gate_scale(level: int, want: torch.Tensor, entries, offs, cnts, tw: int, th: int, ts: int, tiles):
    """`compare`'s scale for the plain version's rows `want` of `tiles`:
    at L0-L2 each tile's sum of |terms| (L0's no more than the largest
    tile's |value|), at L3 None (the largest |value|)."""
    if level == 3:
        return None
    if level == 0:
        return torch.clamp(fwd_breakdown_plain(0, entries.abs(), offs, cnts, tw, th, ts, tiles=tiles),
                           max=float(want.abs().max()))
    return want.abs()


def edge_tiles(offs: torch.Tensor, cnts: torch.Tensor) -> torch.Tensor:
    """The tiles a check must hold whatever its seed: the two heaviest, the
    first empty one, and the heaviest of those whose range starts and ends
    mid-slice over more than one slice (each where the stream has one)."""
    off, n = offs.long().cpu(), cnts.long().cpu()
    picks = torch.argsort(n, descending=True, stable=True)[:2].tolist()
    empty = torch.nonzero(n == 0).flatten()
    mid = (off % LANES != 0) & ((off + n) % LANES != 0) & (off // LANES != (off + n) // LANES)
    if len(empty):
        picks.append(int(empty[0]))
    if bool(mid.any()):
        picks.append(int(torch.argmax(torch.where(mid, n, -1))))
    return torch.tensor(sorted(set(picks)), dtype=torch.long)


def check(small: bool):
    """Each level against its plain version (small: garden scene_grid 1 at
    648x420, every tile; else the production stream on `TILE_SUBSET`
    seeded tiles and its `edge_tiles`), {kernel: max abs error}, two
    launches to the same bits, and each per-tile gate on a perturbed
    result, {"rejects ...": its max abs error}."""
    if small:
        entries, offs, cnts, tw, th, _, _ = stream(1, 648, 420, 32)
        tiles = torch.arange(offs.shape[0], device=offs.device)
    else:
        entries, offs, cnts, tw, th, _, _ = stream(*PRODUCTION)
        g = torch.Generator().manual_seed(0)
        seeded = torch.randperm(offs.shape[0], generator=g)[:TILE_SUBSET]
        tiles = torch.unique(torch.cat([seeded, edge_tiles(offs, cnts)])).to(offs.device)
    errs = {}
    for level in range(4):
        plan = breakdown_plan(level, offs, cnts, entries.shape[1])
        full = fwd_breakdown(level, entries, offs, cnts, tw, th, 32, plan=plan)
        again = fwd_breakdown(level, entries, offs, cnts, tw, th, 32, plan=plan)
        if not torch.equal(full, again):
            raise AssertionError(f"fwd_breakdown_L{level}: two launches differ at {int((full != again).sum())} values")
        got = full[tiles]
        want = fwd_breakdown_plain(level, entries, offs, cnts, tw, th, 32, tiles=tiles)
        name = f"fwd_breakdown_L{level}"
        terms = gate_scale(level, want, entries, offs, cnts, tw, th, 32, tiles)
        errs[name] = compare(name, got, want, TOL[level], terms)
        if level == 3:
            continue
        small_tile = int(torch.where(terms[:, 0, 0] > 0, terms[:, 0, 0], float("inf")).argmin())
        wrong = got.clone()
        wrong[small_tile] += 1e-4 * terms[small_tile]
        errs[f"rejects L{level} with its smallest tile moved by 1e-4 of its |terms|"] = rejects(
            f"{name}'s gate", wrong, want, TOL[level], terms)
    return errs


def measure(runs: int = 7):
    """The four levels on the production stream, one row each (each
    level's plan made once, before its timed calls; the plain version's
    ms: one run over the whole stream), and info: fwd_3dgs's ms
    on it (tile 32) and on the stream binned at tile 16, with their
    entries."""
    grid, W, H, ts = PRODUCTION
    entries, offs, cnts, tw, th, _, _ = stream(*PRODUCTION)
    rows = []
    for level in range(4):
        plan = breakdown_plan(level, offs, cnts, entries.shape[1])  # made once a stream, outside the timed calls
        ms = median_ms(lambda: fwd_breakdown(level, entries, offs, cnts, tw, th, ts, plan=plan), runs)
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
