"""Tile intersection and depth-ordered binning for the tiled backend (port
of gsplat_tpu/ops/isect.py).

Every (camera, Gaussian) with radius > 0 covers the tile rectangle
[floor((mean - r) / ts), ceil((mean + r) / ts)) clamped to the grid; one
entry is emitted per covered tile, in (camera, Gaussian) order and
row-major over the rectangle. The entries are sorted by the 64-bit key
``tile << 32 | depth bits`` (one stable ``torch.sort``), and
``torch.searchsorted`` gives each (camera, tile) its range. There is no
exact ellipse-vs-tile cull: the stream is the JAX package's.

The JAX package emits into a fixed ``capacity`` buffer padded with
sentinel entries. The port sizes its buffers exactly: ``min(n_isects,
capacity)`` entries. Past ``capacity`` the same entries are dropped as in
JAX (the last ones in (camera, Gaussian) expansion order, before the
sort), and ``n_isects`` still counts them all, so a caller can grow the
capacity.

The expansion runs in ascending flat gid, so the sort's permutation is
also each entry's place in gid order: ``Isect.order`` hands it, with each
(camera, Gaussian)'s range of the expansion, to the gid reduce of the
backward, which then needs no second sort.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class Isect(NamedTuple):
    """Depth-sorted tile intersection list, ``M = min(n_isects, capacity)``
    entries.

    tile_keys: [M] i32, ``cam * n_tiles + tile`` per entry, ascending.
    depth_keys: [M] i32, the f32 depth bits (the secondary key).
    flatten_ids: [M] i32, ``cam * N + gaussian`` per entry.
    offsets: [C, th, tw] i32, start of each (camera, tile) range.
    ends: [C, th, tw] i32, end of each range.
    n_isects: [] i64 tensor, the true entry count (> M when truncated).
    tiles_per_gauss: [C, N] i32.
    dst: [M] i64 and seg_starts: [C*N + 1] i64 - the stream in gid order,
        for the gid reduce (``order``): entry k is expansion entry dst[k],
        and (camera, Gaussian) i owns expansion entries
        [seg_starts[i], seg_starts[i+1]).
    """

    tile_keys: torch.Tensor
    depth_keys: torch.Tensor
    flatten_ids: torch.Tensor
    offsets: torch.Tensor
    ends: torch.Tensor
    n_isects: torch.Tensor
    tiles_per_gauss: torch.Tensor
    dst: Optional[torch.Tensor] = None
    seg_starts: Optional[torch.Tensor] = None

    @property
    def order(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """(dst, seg_starts), the reduce's ``order``, or None."""
        return None if self.dst is None else (self.dst, self.seg_starts)


def isect_tiles(
    means2d,  # [C, N, 2] or (mean_x [C, N], mean_y [C, N])
    radii: torch.Tensor,  # [C, N] i32
    depths: torch.Tensor,  # [C, N]
    tile_size: int,
    tile_width: int,
    tile_height: int,
    capacity: int,
) -> Isect:
    """Bin Gaussians into the tiles they overlap, sorted by (camera, tile,
    depth); ties keep (camera, Gaussian) order. Reads detached inputs."""
    if isinstance(means2d, (tuple, list)):
        mean_x, mean_y = means2d
    else:
        mean_x, mean_y = means2d[..., 0], means2d[..., 1]
    mean_x, mean_y, depths = mean_x.detach(), mean_y.detach(), depths.detach()
    dev = mean_x.device
    C, N = mean_x.shape
    CN = C * N
    n_tiles = tile_width * tile_height

    tile_r = radii / tile_size
    tminx = torch.clamp(torch.floor(mean_x / tile_size - tile_r), 0, tile_width).to(torch.int32)
    tmaxx = torch.clamp(torch.ceil(mean_x / tile_size + tile_r), 0, tile_width).to(torch.int32)
    tminy = torch.clamp(torch.floor(mean_y / tile_size - tile_r), 0, tile_height).to(torch.int32)
    tmaxy = torch.clamp(torch.ceil(mean_y / tile_size + tile_r), 0, tile_height).to(torch.int32)
    rect_w = tmaxx - tminx
    tiles_per_gauss = torch.where(radii > 0, rect_w * (tmaxy - tminy), 0).to(torch.int32)

    tpg = tiles_per_gauss.reshape(-1).to(torch.int64)
    cum = torch.cumsum(tpg, dim=0)
    n_isects = cum[-1] if CN else torch.zeros((), dtype=torch.int64, device=dev)
    M = min(int(n_isects), capacity)

    # entry e belongs to source src[e] and is its local[e]-th covered tile;
    # only the first M entries of the expansion are made
    starts = cum - tpg
    kept = torch.clamp(cum, max=M) - torch.clamp(starts, max=M)
    src = torch.repeat_interleave(torch.arange(CN, device=dev), kept, output_size=M)
    local = torch.arange(M, device=dev) - starts[src]
    rw = rect_w.reshape(-1).to(torch.int64).clamp_min(1)[src]
    tx = tminx.reshape(-1).to(torch.int64)[src] + local % rw
    ty = tminy.reshape(-1).to(torch.int64)[src] + local // rw
    tile_keys = (src // N) * n_tiles + ty * tile_width + tx
    # depths > near_plane > 0, so the bits order as the values; shifted to
    # [0, 2^32) to fill the key's low half
    dbits = depths.to(torch.float32).reshape(-1).view(torch.int32)[src]
    key = (tile_keys << 32) | (dbits.to(torch.int64) + (1 << 31))
    _, perm = torch.sort(key, stable=True)

    tile_keys = tile_keys[perm].to(torch.int32)
    bounds = torch.searchsorted(
        tile_keys, torch.arange(C * n_tiles + 1, dtype=torch.int32, device=dev)
    ).to(torch.int32)
    return Isect(
        tile_keys=tile_keys,
        depth_keys=dbits[perm],
        flatten_ids=src[perm].to(torch.int32),
        offsets=bounds[:-1].reshape(C, tile_height, tile_width),
        ends=bounds[1:].reshape(C, tile_height, tile_width),
        n_isects=n_isects,
        tiles_per_gauss=tiles_per_gauss,
        dst=perm,
        seg_starts=torch.cat([torch.clamp(starts, max=M), starts.new_full((1,), M)]),
    )


def suggest_capacity(n_isects: int, slack: float = 1.3, align: int = 4096) -> int:
    """The next capacity for an observed intersection count."""
    cap = int(n_isects * slack) + align
    return (cap + align - 1) // align * align


def isect_offset_encode(
    tile_keys: torch.Tensor,  # [M] sorted (cam * n_tiles + tile) keys
    n_cameras: int,
    tile_width: int,
    tile_height: int,
) -> torch.Tensor:
    """Sorted intersection keys -> per-(camera, tile) start offsets
    [C, th, tw] i32 (one searchsorted)."""
    n_tiles = tile_width * tile_height
    bounds = torch.searchsorted(
        tile_keys, torch.arange(n_tiles * n_cameras, dtype=tile_keys.dtype, device=tile_keys.device)
    ).to(torch.int32)
    return bounds.reshape(n_cameras, tile_height, tile_width)
