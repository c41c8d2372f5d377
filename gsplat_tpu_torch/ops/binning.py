"""Binning engine: per-entry emission, one key sort, per-tile offsets (port
of gsplat_tpu/ops/binning.py).

The stream it builds is the JAX package's: every (camera, Gaussian, tile)
entry of a Gaussian's tile rectangle, tight-culled against the exact
ellipse, sorted by (tile, depth, gid), with the payload rows the
rasterizer reads carried along.

  1. Rectangles, per-Gaussian entry counts and the block rule (GB Gaussians
     per block, SB-rounded slabs) are plain torch, as in the JAX package
     where they sit outside the Pallas call. The rule fixes `slab_required`
     and which whole blocks a too-small capacity truncates, so both match
     the JAX package; the port itself sizes its buffers exactly.
     The sanitised payload is packed once as rows of a [C*N, F] table
     (`pack_rows`, F a multiple of 8 floats: a row is whole 32-byte
     sectors).
  2. The emit kernel (csrc/emit.cu; `_emit_plain` is its plain version)
     writes each entry's 64-bit key and gid, and nothing of the payload, at
     an exclusive prefix sum of the counts, so the emission order is
     ascending flat gid.
  3. `torch.sort` of the 64-bit key `tile << 32 | depth bits` (stable) and
     `torch.searchsorted` for the tile offsets; then the gather kernel
     (csrc/emit_gather.cu; `_gather_plain`) writes the sorted gids and the
     [NF, M] entry rows from the packed table, zero past n_isects, in one
     pass. A stable sort over gid-ordered emission gives the JAX package's
     (tile, depth, gid) order exactly, and its permutation is also each
     slot's place in gid order: the gid reduce of the backward needs no
     second sort (`Binned.order`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .. import _backend

GB = 1024  # gaussians per emit block (the JAX package's block rule)
SB = 512  # slab alignment quantum of that rule
ALPHA_CULL = 1.0 / 255.0
ROW_ALIGN = 8  # floats: a packed row is a whole number of 32-byte sectors


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pack_rows(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-Gaussian values [C, N] each -> one row per (camera, Gaussian):
    [C*N, F] f32, F = len(rows) rounded up to ROW_ALIGN, zero-padded."""
    nf = len(rows)
    F = -(-nf // ROW_ALIGN) * ROW_ALIGN
    zero = rows[0].new_zeros(()).expand(rows[0].shape)
    # stacked as [F, C*N] (contiguous writes), then transposed in one copy;
    # stacking along a last axis of F writes each value F floats apart
    packed = torch.stack([r.detach().to(torch.float32) for r in rows] + [zero] * (F - nf))
    return packed.reshape(F, -1).T.contiguous()


class Binned(NamedTuple):
    """Sorted per-entry stream.

    entries: [NF, M] f32 - per-entry features in (cam, tile, depth, gid)
        order: rows = gx, gy, conic_a, conic_b, conic_c, opacity, colors[D]
        (or the caller's ``payload_rows``); zero past n_isects.
    gids: [M] i32 - flattened cam*N + gaussian index per entry; C*N past
        n_isects (culled entries).
    offs: [T] i32 - start of each (cam, tile) range in the stream.
    cnts: [T] i32 - entries per (cam, tile).
    n_isects: [] i64 tensor - true (culled) entry count.
    slab_required: int - the JAX package's slab capacity to emit without
        truncation (feed back into `capacity`).
    dst: [M] i64 and seg_starts: [C*N + 1] i64, or None - the stream in
        gid order, for the gid reduce (``order``): slot k holds emit
        position dst[k], and (camera, Gaussian) i owns emit positions
        [seg_starts[i], seg_starts[i+1]) (emission runs in ascending flat
        gid). A culled slot keeps its position inside its Gaussian's range.
    """

    entries: torch.Tensor
    gids: torch.Tensor
    offs: torch.Tensor
    cnts: torch.Tensor
    n_isects: torch.Tensor
    slab_required: int
    dst: Optional[torch.Tensor] = None
    seg_starts: Optional[torch.Tensor] = None

    @property
    def order(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """(dst, seg_starts), the reduce's ``order``, or None."""
        return None if self.dst is None else (self.dst, self.seg_starts)


class EmitPlan(NamedTuple):
    """What the emit kernel and its plain version take: per flattened
    (camera, Gaussian) id, its tile rectangle, entry count and write
    positions, plus the sanitised payload packed as one row per id (what
    the gather kernel and the cull read)."""

    tminx: torch.Tensor  # [CN] i32
    tminy: torch.Tensor  # [CN] i32
    rw: torch.Tensor  # [CN] i32 rectangle width in tiles
    counts: torch.Tensor  # [CN] i32 entries to emit (0 if dead or truncated)
    starts: torch.Tensor  # [CN + 1] i64 exclusive prefix sum of counts, then n_emit
    n_emit: int  # total entries emitted (culled ones included)
    depth: torch.Tensor  # [CN] f32
    packed: torch.Tensor  # [CN, F] f32 payload rows (pack_rows), F a multiple of 8
    nf: int  # payload values a row (NF)
    N: int
    tile_size: int
    tile_width: int
    n_tiles: int  # tiles per camera
    sentinel: int  # key of a culled entry: (C * n_tiles) << 32, sorts last
    cull: bool


def _fin(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x.detach(), nan=0.0, posinf=0.0, neginf=0.0)


def plan_emit(
    mean_x, mean_y,  # [C, N] f32
    con_a, con_b, con_c,  # [C, N]
    opacities,  # [C, N]
    colors,  # [C, N, D]
    radii,  # [C, N] i32
    depths,  # [C, N] f32
    tile_size: int,
    tile_width: int,
    tile_height: int,
    capacity: int,
    cull: bool = True,
    payload_rows=None,
):
    """Rectangles, counts, block rule and write positions. Returns
    ``(plan, slab_required)``.

    ``payload_rows`` (a sequence of [C, N] tensors) replaces the 3DGS
    payload rows; that is how 2DGS surfels ride the same engine. The exact
    ellipse cull reads the 3DGS layout, so a custom payload needs
    ``cull=False``."""
    if payload_rows is not None and cull:
        raise ValueError("a custom payload_rows needs cull=False")
    _backend.common_device(
        mean_x, mean_y, con_a, con_b, con_c, opacities, colors, radii, depths,
        *(payload_rows or ()),
    )
    C, N = mean_x.shape
    CN = C * N
    capA = _round_up(max(capacity, SB), SB)

    mx, my = _fin(mean_x), _fin(mean_y)
    if cull:
        # Tight per-axis extent: the ellipse {0.5 x^T conic x <= tau},
        # tau = ln(255 * op), bounds the alpha >= 1/255 region exactly; its
        # AABB half-widths are sqrt(2 tau Sigma_xx/yy) with Sigma = conic^-1.
        cca, ccb, ccc = _fin(con_a), _fin(con_b), _fin(con_c)
        det = cca * ccc - ccb * ccb
        tau = torch.log(torch.clamp_min(_fin(opacities), 1e-12) * 255.0)
        ok = (det > 1e-24) & (cca > 0) & (ccc > 0)
        sdet = torch.where(ok, det, 1.0)
        ext_x = torch.sqrt(torch.clamp_min(2.0 * tau * ccc / sdet, 0.0)) + 0.5
        ext_y = torch.sqrt(torch.clamp_min(2.0 * tau * cca / sdet, 0.0)) + 0.5
        rad = radii.to(torch.float32)
        ext_x = torch.where(ok, torch.minimum(ext_x, rad), rad)
        ext_y = torch.where(ok, torch.minimum(ext_y, rad), rad)
        alive = (radii > 0) & (tau > 0.0)
    else:
        ext_x = ext_y = radii.to(torch.float32)
        alive = radii > 0
    # the `m/ts - r/ts` form, so cull=False emits exactly the rect that the
    # oracle's tile test and the JAX package's isect_tiles use
    rx, ry = ext_x / tile_size, ext_y / tile_size
    tminx = torch.clamp(torch.floor(mx / tile_size - rx), 0, tile_width)
    tmaxx = torch.clamp(torch.ceil(mx / tile_size + rx), 0, tile_width)
    tminy = torch.clamp(torch.floor(my / tile_size - ry), 0, tile_height)
    tmaxy = torch.clamp(torch.ceil(my / tile_size + ry), 0, tile_height)
    rw = (tmaxx - tminx).to(torch.int32)
    rh = (tmaxy - tminy).to(torch.int32)
    tpg = torch.where(alive, rw * rh, 0).reshape(-1)  # [CN] i32

    # the JAX package's block rule: blocks of GB ids, each block's entries
    # in an SB-rounded slab; a block is emitted iff its slab ends within capA
    NB = -(-CN // GB)
    per_block = torch.nn.functional.pad(tpg.to(torch.int64), (0, NB * GB - CN))
    block_tot = per_block.reshape(NB, GB).sum(dim=1)
    slab_end = torch.cumsum((block_tot + SB - 1) // SB * SB, dim=0)
    fits = slab_end <= capA
    counts = torch.where(fits.repeat_interleave(GB)[:CN], tpg, 0)
    starts = torch.nn.functional.pad(torch.cumsum(counts.to(torch.int64), dim=0), (1, 0))
    n_emit, slab_required = (
        torch.stack([starts[-1], slab_end[-1] if NB else slab_end.new_zeros(())]).tolist()
    )

    if payload_rows is None:
        rows = [mean_x, mean_y, con_a, con_b, con_c, opacities] + list(colors.unbind(-1))
    else:
        rows = list(payload_rows)
    plan = EmitPlan(
        tminx=tminx.reshape(-1).to(torch.int32),
        tminy=tminy.reshape(-1).to(torch.int32),
        rw=rw.reshape(-1),
        counts=counts.to(torch.int32),
        starts=starts,
        n_emit=int(n_emit),
        depth=_fin(depths).reshape(-1).to(torch.float32),
        packed=pack_rows([_fin(r).reshape(-1) for r in rows]),
        nf=len(rows),
        N=N,
        tile_size=tile_size,
        tile_width=tile_width,
        n_tiles=tile_width * tile_height,
        sentinel=(C * tile_width * tile_height) << 32,
        cull=cull,
    )
    return plan, int(slab_required)


def _emit_plain(plan: EmitPlan):
    """Plain torch version of the emit kernel: repeat_interleave + the same
    cull. Returns (keys [M] i64, gids [M] i32)."""
    dev = plan.counts.device
    CN = plan.counts.shape[0]
    M = plan.n_emit
    src = torch.repeat_interleave(
        torch.arange(CN, device=dev), plan.counts.to(torch.int64), output_size=M
    )
    local = torch.arange(M, device=dev) - plan.starts[src]
    rwi = plan.rw.to(torch.int64)[src].clamp_min(1)
    tx = plan.tminx.to(torch.int64)[src] + local % rwi
    ty = plan.tminy.to(torch.int64)[src] + local // rwi
    tile_key = (src // plan.N) * plan.n_tiles + ty * plan.tile_width + tx

    valid = torch.ones(M, dtype=torch.bool, device=dev)
    if plan.cull:
        # exact min of the conic quadratic over the tile's pixel-centre box;
        # drop entries whose best-case alpha stays below 1/255 (the
        # rasterizer's per-pixel test would reject them anyway)
        ts = plan.tile_size
        gx, gy, ca, cb, cc, op = plan.packed[src, :6].unbind(-1)
        x0 = tx.to(torch.float32) * ts + 0.5 - gx
        x1 = x0 + (ts - 1)
        y0 = ty.to(torch.float32) * ts + 0.5 - gy
        y1 = y0 + (ts - 1)

        def q(dx, dy):
            return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

        safe_cc = torch.where(torch.abs(cc) > 1e-12, cc, 1.0)
        safe_ca = torch.where(torch.abs(ca) > 1e-12, ca, 1.0)
        ye0 = torch.clamp(-cb * x0 / safe_cc, min=y0, max=y1)
        ye1 = torch.clamp(-cb * x1 / safe_cc, min=y0, max=y1)
        xe0 = torch.clamp(-cb * y0 / safe_ca, min=x0, max=x1)
        xe1 = torch.clamp(-cb * y1 / safe_ca, min=x0, max=x1)
        minq = torch.minimum(
            torch.minimum(q(x0, ye0), q(x1, ye1)),
            torch.minimum(q(xe0, y0), q(xe1, y1)),
        )
        inside = (x0 <= 0) & (0 <= x1) & (y0 <= 0) & (0 <= y1)
        minq = torch.where(inside, 0.0, minq)
        valid = op * torch.exp(-minq) >= torch.tensor(ALPHA_CULL, dtype=torch.float32)

    # depth bits in signed int32 order, shifted to [0, 2^32)
    dlow = plan.depth.view(torch.int32).to(torch.int64)[src] + (1 << 31)
    keys = torch.where(valid, (tile_key << 32) | dlow, plan.sentinel)
    gids = torch.where(valid, src, CN).to(torch.int32)
    return keys, gids


_EMIT_ARGS = (
    [ctypes.c_void_p] * 6  # starts, tminx, tminy, rw, depth, packed
    + [ctypes.c_int] * 7  # F, CN, N, n_tiles, tile_width, tile_size, cull
    + [ctypes.c_longlong] * 2  # M, sentinel key
    + [ctypes.c_void_p] * 3  # keys, gids, stream
)


def _check_inputs(what: str, dev: torch.device, checks) -> None:
    for t, dt in checks:
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{what} input of dtype {t.dtype} on {t.device}: expected contiguous {dt} on {dev}")


def _emit_cuda(plan: EmitPlan):
    """Launch csrc/emit.cu: threads over emit positions, at most four a
    thread. Same outputs as `_emit_plain`."""
    dev = plan.counts.device
    if dev.type != "cuda":
        raise ValueError(f"the emit kernel takes CUDA tensors, got {dev}")
    CN, F = plan.packed.shape
    M = plan.n_emit
    keys = torch.empty(M, dtype=torch.int64, device=dev)
    gids = torch.empty(M, dtype=torch.int32, device=dev)
    if M == 0:
        return keys, gids
    ins = [plan.starts, plan.tminx, plan.tminy, plan.rw, plan.depth, plan.packed]
    _check_inputs("emit", dev, zip(ins, (torch.int64,) + (torch.int32,) * 3 + (torch.float32,) * 2))
    fn = _backend.kernel("emit", "emit_launch", _EMIT_ARGS)
    code = fn(
        *[t.data_ptr() for t in ins],
        F, CN, plan.N, plan.n_tiles, plan.tile_width, plan.tile_size, int(plan.cull),
        M, plan.sentinel, keys.data_ptr(), gids.data_ptr(), _backend.stream(dev),
    )
    _backend.check_launch(code, "emit")
    _backend.LAUNCHES["emit"] += 1
    return keys, gids


def _emit(plan: EmitPlan):
    """The emit kernel for CUDA tensors, its plain version for CPU tensors."""
    if _backend.use_kernel(plan.counts.device):
        return _emit_cuda(plan)
    return _emit_plain(plan)


def _gather_plain(packed: torch.Tensor, nf: int, perm: torch.Tensor, gids: torch.Tensor,
                  n_isects: torch.Tensor):
    """Plain torch version of the gather kernel. Returns (gids_s [M] i32 =
    gids[perm], entries [nf, M] f32 = packed[gids_s, :nf] transposed, zero
    past n_isects)."""
    gids_s = gids[perm]
    live = torch.arange(gids_s.shape[0], device=gids_s.device) < n_isects
    rows = packed[torch.where(live, gids_s, 0).to(torch.int64), :nf]
    return gids_s, torch.where(live[:, None], rows, 0.0).T.contiguous()


_GATHER_ARGS = (
    [ctypes.c_void_p] * 3  # perm, gids, packed
    + [ctypes.c_int] * 2  # F, nf
    + [ctypes.c_void_p, ctypes.c_longlong]  # n_isects (device), M
    + [ctypes.c_void_p] * 3  # gids_s, entries, stream
)


def _gather_cuda(packed: torch.Tensor, nf: int, perm: torch.Tensor, gids: torch.Tensor,
                 n_isects: torch.Tensor):
    """Launch csrc/emit_gather.cu: a thread per slot, n_isects read on the
    card. Same outputs as `_gather_plain`."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"the gather kernel takes CUDA tensors, got {dev}")
    M = perm.shape[0]
    F = packed.shape[1]
    gids_s = torch.empty(M, dtype=torch.int32, device=dev)
    entries = torch.empty((nf, M), dtype=torch.float32, device=dev)
    if M == 0:
        return gids_s, entries
    if gids.shape != (M,) or n_isects.numel() != 1:
        raise ValueError(f"gather: perm of {M} slots, gids of shape {tuple(gids.shape)}, "
                         f"n_isects of {n_isects.numel()} values")
    _check_inputs("gather", dev, ((perm, torch.int64), (gids, torch.int32), (packed, torch.float32),
                                  (n_isects, torch.int64)))
    fn = _backend.kernel("emit_gather", "emit_gather_launch", _GATHER_ARGS)
    code = fn(
        perm.data_ptr(), gids.data_ptr(), packed.data_ptr(), F, nf, n_isects.data_ptr(), M,
        gids_s.data_ptr(), entries.data_ptr(), _backend.stream(dev),
    )
    _backend.check_launch(code, "emit_gather")
    _backend.LAUNCHES["emit_gather"] += 1
    return gids_s, entries


def _gather(packed, nf, perm, gids, n_isects):
    """The gather kernel for CUDA tensors, its plain version for CPU tensors."""
    if _backend.use_kernel(packed.device):
        return _gather_cuda(packed, nf, perm, gids, n_isects)
    return _gather_plain(packed, nf, perm, gids, n_isects)


def segment_starts(plan: EmitPlan) -> torch.Tensor:
    """[CN + 1] i64: each (camera, Gaussian)'s first emit position, then
    the count of emitted entries (its write offsets closed)."""
    return plan.starts


def emit_entries(
    mean_x, mean_y,  # [C, N] f32
    con_a, con_b, con_c,  # [C, N]
    opacities,  # [C, N]
    colors,  # [C, N, D]
    radii,  # [C, N] i32
    depths,  # [C, N] f32
    tile_size: int,
    tile_width: int,
    tile_height: int,
    capacity: int,
    cull: bool = True,
    payload_rows=None,
):
    """Emit stage: keys and gids, unsorted. Returns ``(ops, plan,
    slab_required)`` with ``ops = (keys, gids)`` ready for
    :func:`sort_entries` with the plan's packed payload. CUDA tensors go
    through the emit kernel, CPU tensors through its plain version.
    ``payload_rows`` as in :func:`plan_emit`."""
    plan, slab_required = plan_emit(
        mean_x, mean_y, con_a, con_b, con_c, opacities, colors, radii,
        depths, tile_size, tile_width, tile_height, capacity, cull,
        payload_rows,
    )
    return _emit(plan), plan, slab_required


def sort_entries(
    ops: Sequence[torch.Tensor],
    packed: torch.Tensor,
    nf: int,
    T: int,
    slab_required: int,
    starts: Optional[torch.Tensor] = None,
) -> Binned:
    """Sort the emitted entries ``ops = (keys, gids)`` by (tile, depth,
    gid), build the per-tile offset table (one stable key sort + a
    searchsorted), then gather the sorted gids and the payload's first
    ``nf`` values of each live slot from ``packed`` (the plan's table; the
    gather kernel for CUDA tensors, its plain version for CPU tensors).
    With ``starts`` (`segment_starts` of the plan) the result carries the
    reduce's order: ``dst``, the sort's permutation, and ``seg_starts``."""
    keys, gids = ops
    keys_s, perm = torch.sort(keys, stable=True)
    bounds = torch.searchsorted(
        keys_s, torch.arange(T + 1, device=keys.device, dtype=torch.int64) << 32
    ).to(torch.int32)
    offs = bounds[:-1]
    cnts = bounds[1:] - bounds[:-1]
    n_isects = bounds[-1].to(torch.int64)
    # culled entries sort past n_isects: the gather zeroes their payload, as
    # the JAX package zeroes its sentinel tail
    gids_s, entries = _gather(packed, nf, perm, gids, n_isects)
    return Binned(
        entries=entries,
        gids=gids_s,
        offs=offs,
        cnts=cnts,
        n_isects=n_isects,
        slab_required=slab_required,
        dst=None if starts is None else perm,
        seg_starts=starts,
    )


def bin_gaussians(
    mean_x, mean_y,  # [C, N] f32
    con_a, con_b, con_c,  # [C, N]
    opacities,  # [C, N]
    colors,  # [C, N, D]
    radii,  # [C, N] i32
    depths,  # [C, N] f32
    tile_size: int,
    tile_width: int,
    tile_height: int,
    capacity: int,
    cull: bool = True,
    payload_rows=None,
) -> Binned:
    """Emit + sort the per-entry stream. ``capacity`` is the JAX package's
    slab budget; the returned ``slab_required`` is the budget needed
    without truncation; ``order`` is set. ``payload_rows`` as in
    :func:`plan_emit`."""
    plan, slab_required = plan_emit(
        mean_x, mean_y, con_a, con_b, con_c, opacities, colors, radii,
        depths, tile_size, tile_width, tile_height, capacity, cull,
        payload_rows,
    )
    return sort_entries(
        _emit(plan), plan.packed, plan.nf, mean_x.shape[0] * tile_width * tile_height,
        slab_required, segment_starts(plan),
    )
