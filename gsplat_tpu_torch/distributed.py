"""Multi-GPU rendering over ``torch.distributed`` (port of
gsplat_tpu/distributed.py).

Each rank owns a shard of the Gaussians and a share of the image plane.
Projection, SH and the depth channel run on the owner rank for every
camera; one all-to-all moves each (camera, Gaussian) payload to the rank
that rasterizes the camera (:class:`_Exchange`, the counterpart of JAX's
``lax.all_to_all(split_axis=0, concat_axis=1, tiled=True)``); each rank then
rasterizes its cameras with the port's binned, tiled or oracle backend. The
backward runs the inverse exchange, so gradients reach the owner ranks. The
layouts are JAX's:

- whole cameras (:func:`rasterization_distributed`) when ``C % n == 0``:
  rank r rasterizes cameras ``[r*C/n, (r+1)*C/n)``;
- tile-row strips (JAX's ``_rasterization_distributed_strips``, taken by
  :func:`rasterization_distributed` itself) when ``n % C == 0``: each camera's tile grid is cut into ``G = n / C`` strips
  of ``ceil(th / G)`` tile rows, and rank r rasterizes strip ``r % G`` of
  camera ``r // G``. Each camera's payload is replicated G times before the
  exchange, and the strip shifts its rows into its own pixel frame;
- packed (:func:`rasterization_distributed_packed`): whole cameras, but
  each owner compacts its visible (camera, Gaussian) rows to the front of a
  ``pack_capacity`` buffer (a stable partition) and only that buffer is
  exchanged.

The 2DGS counterparts (:func:`rasterization_2dgs_distributed` and its strip
and packed forms) exchange the surfel rows the same way.

The trainers' multi-GPU training (simple_trainer.py) adds the collectives at
the end of this module: :func:`gather_blocks` assembles the ranks' blocks
into the whole batch on every rank (its backward hands each rank its own
block's gradient), :func:`shard_rows`, :func:`gather_rows` and
:func:`scatter_rows` move a pool's rows between the ranks and rank 0,
:func:`all_sum` and :func:`broadcast_generator`.

The per-rank contract, with ``n = dist.get_world_size(group)``:

- **Inputs.** Rank r passes rows ``[r*N/n, (r+1)*N/n)`` of the global
  ``means``, ``quats``, ``scales``, ``opacities`` and ``colors``, its
  ``[C, N/n, ...]`` slice of ``means2d_carrier``, ``densify_carrier`` or
  per-camera colours, and its slice of ``masks``. ``viewmats``, ``Ks`` and
  ``backgrounds`` are the same on every rank. Every rank must pass the same
  number of rows (JAX's ``shard_map`` needs ``N % n == 0`` too), the same
  cameras and image size; otherwise the call raises. The sizes are checked
  the first time a rank calls with them in a group (one all-reduce and a
  host wait); later calls with the same sizes skip the check.
- **Outputs.** Rank r returns its own block of the image: its ``C/n`` whole
  cameras, or its strip's rows of its camera (the last strip cropped at
  ``height``, a strip wholly past it with 0 rows). The blocks, concatenated
  in rank order (per camera, for strips), are the single-device
  ``[C, H, W, X]``.
- **meta.** ``radii`` is the rank's ``[C, N/n]``. ``n_isects`` is ``[n]``
  on every rank (gathered without gradient; zeros on the oracle).
  ``slab_required`` and ``pack_required`` are the maximum over ranks, as
  0-d device tensors: the call does not wait for them.
  ``isect_capacity``, ``a2a_bytes_per_device``, ``n_strips`` and
  ``strip_rows`` are JAX's values.
- **Gradients.** The backward runs the exchanges' inverses, so every rank
  calls backward on a loss that reads the same outputs (as with any
  collective).

Start one process per card, call ``torch.distributed.init_process_group``
(NCCL for CUDA tensors across cards, gloo for CPU tensors), and call
``rasterization(..., distributed=True)``; ``group`` picks another group than
the default one. Without an initialised process group the call raises; it
never renders on one device instead. The exchange hands the group the
tensors on their own device: gloo takes CUDA tensors too and stages their
all-to-all through host memory itself (two ranks on one card, where NCCL
refuses a second rank). A failed collective raises.
"""

from __future__ import annotations

import weakref
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ._backend import common_device
from .rendering import (
    check_depth_mode,
    expected_depth,
    postprocess_2dgs,
    project_and_shade,
    project_and_shade_2dgs,
    rasterize_shaded,
    rasterize_shaded_2dgs,
    resolve_backend,
)
from .utils import depth_to_normal

def world(group=None) -> Tuple[int, int]:
    """(world size, rank) of ``group`` (the default group when None).
    Raises when no process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "distributed=True needs a process group: start one process per "
            "card and call torch.distributed.init_process_group(...) first"
        )
    return dist.get_world_size(group), dist.get_rank(group)


class _Exchange(torch.autograd.Function):
    """[S, F, N_local] -> [S/n, F, n*N_local]: block r of the leading axis
    goes to rank r, and the blocks a rank receives are laid out along the
    last axis in source-rank order, which is the global Gaussian order. The
    backward sends each block's cotangent back to its source."""

    @staticmethod
    def forward(ctx, x, n, group):
        S, F, NL = x.shape
        ctx.n, ctx.group, ctx.shape = n, group, x.shape
        out = x.new_empty((n, S // n, F, NL))
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out.permute(1, 2, 0, 3).reshape(S // n, F, n * NL)

    @staticmethod
    def backward(ctx, g):
        S, F, NL = ctx.shape
        n = ctx.n
        send = g.reshape(S // n, F, n, NL).permute(2, 0, 1, 3).contiguous()
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=ctx.group)
        return out.reshape(S, F, NL), None, None


def exchange(rows: Sequence[torch.Tensor], n: int, group) -> torch.Tensor:
    """Pack the [S, N_local] f32 rows into one tensor and exchange it in one
    collective. Returns [S/n, len(rows), n*N_local]."""
    return _Exchange.apply(torch.stack(list(rows), dim=1), n, group)


def _replicate(rows: Sequence[torch.Tensor], G: int):
    """Each camera's rows G times along the camera axis ([C, N] ->
    [C*G, N]); autograd sums the G copies' cotangents."""
    return [r[:, None].expand((r.shape[0], G) + tuple(r.shape[1:])).reshape((-1,) + tuple(r.shape[1:]))
            for r in rows]


# the (N_local, C, W, H) each group has checked, by group
_CHECKED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _check_shards(group, device, *sizes: int) -> None:
    """Every rank passes the same sizes (rows, cameras, image): one
    all-reduce of the values and their negatives, and a host wait on it,
    the first time a rank calls with these sizes in this group. Later
    calls with them skip both, so a rank that goes back to sizes it has
    checked while another rank passes new ones is not caught here."""
    seen = _CHECKED.setdefault(dist.group.WORLD if group is None else group, set())
    if sizes in seen:
        return
    v = torch.tensor(list(sizes), dtype=torch.int64, device=device)
    both = torch.cat([v, -v])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    hi, lo = both[: len(sizes)], -both[len(sizes):]
    if not torch.equal(hi, lo):
        raise ValueError(
            "every rank must pass the same number of Gaussian rows (N % world "
            f"size == 0), cameras and image size; got (N_local, C, W, H) from "
            f"{lo.tolist()} to {hi.tolist()}"
        )
    seen.add(sizes)


def _gather_stats(stats: Sequence, n: int, rank: int, group, device) -> torch.Tensor:
    """[n, len(stats)] int64 on ``device``: row r holds rank r's stats (no
    gradient). No host wait: each value is filled in on the device (a
    Python int assigned by indexing is copied from the host, and that copy
    waits for the card)."""
    t = torch.zeros((n, len(stats)), dtype=torch.int64, device=device)
    for j, s in enumerate(stats):
        t[rank, j].fill_(s)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _Setup(NamedTuple):
    n: int  # world size
    rank: int
    device: torch.device
    C: int
    n_local: int
    strips: Optional[Tuple[int, int, int]]  # (G, strip_rows, strip_h), None for whole cameras
    cams: slice  # the cameras of the rank's block
    backend: str
    isect_capacity: Optional[int]


def _setup(group, tensors, viewmats, n_local, width, height, tile_size, backend, isect_capacity, packed):
    """The world, the layout, the checked shard sizes and the backend
    resolved with JAX's arguments (distributed.py:222-224): the rank's
    cameras, or one camera of strip height, over all N Gaussians."""
    n, rank = world(group)
    dev = common_device(*tensors)
    C = viewmats.shape[0]
    if packed and C % n != 0:
        raise ValueError(f"#cameras ({C}) must be divisible by the world size ({n}) in the packed exchange")
    strips = strip_layout(C, n, height, tile_size)
    _check_shards(group, dev, n_local, C, width, height)
    if strips is None:
        cams = slice(rank * (C // n), (rank + 1) * (C // n))
        backend, isect_capacity = resolve_backend(backend, isect_capacity, C // n, n_local * n, width, height)
    else:
        cam = rank // strips[0]
        cams = slice(cam, cam + 1)
        backend, isect_capacity = resolve_backend(backend, isect_capacity, 1, n_local * n, width, strips[2])
    return _Setup(n, rank, dev, C, n_local, strips, cams, backend, isect_capacity)


def strip_layout(C: int, n: int, height: int, tile_size: int) -> Optional[Tuple[int, int, int]]:
    """None for whole cameras, else (G, strip_rows, strip_h)."""
    if C % n == 0:
        return None
    if n % C != 0:
        raise ValueError(
            f"#cameras ({C}) and the world size ({n}) must divide one another: "
            "C % n == 0 shards whole cameras, n % C == 0 shards tile-row strips "
            "within each camera"
        )
    G = n // C
    th = -(-height // tile_size)
    strip_rows = -(-th // G)
    return G, strip_rows, strip_rows * tile_size


def strip_rows(g: int, strip_h: int, height: int) -> Tuple[int, int]:
    """Global rows [y0, y1) of strip g (y1 <= height; empty past it)."""
    y0 = min(g * strip_h, height)
    return y0, min(y0 + strip_h, height)


def _rank_backgrounds(backgrounds, cams: slice):
    return None if backgrounds is None else backgrounds[cams]


def _payload_rows_3dgs(s, carrier, absgrad):
    """The owner's rows of every (camera, Gaussian): (rows, number of
    colour channels). The densification carrier is added to the means here
    (absgrad=False) or rides as two more rows (absgrad=True)."""
    mean_x, mean_y = s.mean_x, s.mean_y
    if carrier is not None and not absgrad:
        mean_x = mean_x + carrier[..., 0]
        mean_y = mean_y + carrier[..., 1]
    D = s.colors.shape[-1]
    rows = [mean_x, mean_y, s.depths, *s.conics, s.radii.to(torch.float32), s.opacities]
    rows += [s.colors[..., d] for d in range(D)]
    if carrier is not None and absgrad:
        rows += [carrier[..., 0], carrier[..., 1]]
    return rows, D


def _unpack_3dgs(x, D, absgrad_rows):
    """Exchanged [C', F, M] -> the rasterizer's inputs."""
    mean_x, mean_y, depth, con_a, con_b, con_c, radf, opac = (x[:, k] for k in range(8))
    cols = x[:, 8:8 + D].transpose(1, 2)
    abs_c = (x[:, 8 + D], x[:, 9 + D]) if absgrad_rows else None
    return mean_x, mean_y, depth, con_a, con_b, con_c, radf.to(torch.int32), opac, cols, abs_c


def _pack_visible(rows: Sequence[torch.Tensor], radii: torch.Tensor, radii_row: int, pack_capacity: int):
    """Per camera, the visible columns (radii > 0) of every row moved to
    the front in their order (a stable sort on the key ``not visible``),
    cut to ``min(pack_capacity, N_local)``; the radii past a camera's
    visible count are zeroed (JAX distributed.py:712-745). The gradient
    scatters back to the source columns (zero for columns cut). Returns
    (packed rows [C, cap], visible count [C])."""
    vis = radii > 0
    cap = min(pack_capacity, vis.shape[1])
    order = torch.argsort((~vis).to(torch.int32), dim=1, stable=True)[:, :cap]
    n_vis = vis.sum(dim=1)
    packed = [torch.gather(r, 1, order) for r in rows]
    slot_ok = torch.arange(cap, device=radii.device)[None, :] < n_vis[:, None]
    packed[radii_row] = torch.where(slot_ok, packed[radii_row], 0.0)
    return packed, n_vis


def _exchange_payload(st: _Setup, rows, group):
    """The exchange of the layout: whole cameras, or each camera's rows
    replicated once for each of its strips."""
    if st.strips is None:
        return exchange(rows, st.n, group)
    return exchange(_replicate(rows, st.strips[0]), st.n, group)


def _strip_frame(st: _Setup, height: int):
    """(y_off, y0, y1, rows rasterized) of the rank's block."""
    if st.strips is None:
        return 0, 0, height, height
    G, _, strip_h = st.strips
    y0, y1 = strip_rows(st.rank % G, strip_h, height)
    return (st.rank % G) * strip_h, y0, y1, strip_h


def _meta(st: _Setup, s, aux, width, height, group, n_rows, n_vis=None) -> Dict:
    """The rank's meta: its radii, the ranks' n_isects, the largest
    slab_required (and pack_required) of any rank as device tensors, and
    JAX's capacity, layout and exchange sizes."""
    n_isects = aux.get("n_isects", 0)
    # the tiled stream's capacity signal is its n_isects (JAX's too)
    stats = [n_isects, aux.get("slab_required", n_isects)] + ([] if n_vis is None else [n_vis.max()])
    t = _gather_stats(stats, st.n, st.rank, group, st.device)
    meta = {
        "width": width,
        "height": height,
        "n_cameras": st.C,
        "radii": s.radii.detach(),
        "n_isects": t[:, 0],
        "slab_required": t[:, 1].max(),
        "isect_capacity": st.isect_capacity,
    }
    if n_vis is not None:
        meta["pack_required"] = t[:, 2].max()
    elif st.strips is not None:
        # the replicated exchange: each rank sends its rows to every other
        meta.update(n_strips=st.strips[0], strip_rows=st.strips[1],
                    a2a_bytes_per_device=n_rows * st.n_local * 4 * (st.n - 1))
    elif n_rows is not None:
        meta["a2a_bytes_per_device"] = n_rows * st.C * st.n_local * 4 * (st.n - 1) // st.n
    return meta


def _raster_3dgs(st: _Setup, s, x, D, abs_rows, width, height, tile_size):
    """The rank's block from the exchanged rows: render and alphas, the
    strip's rows cropped at ``height``, and the rasterizer's aux."""
    mean_x, mean_y, depth, con_a, con_b, con_c, radii, opac, cols, abs_c = _unpack_3dgs(x, D, abs_rows)
    y_off, y0, y1, rows_r = _strip_frame(st, height)
    if st.strips is not None:
        # the strip's own pixel frame: Gaussians outside it clip to empty
        # tile rectangles, so no mask is needed
        mean_y = mean_y - float(y_off)
    render, alphas, aux = rasterize_shaded(
        st.backend, (mean_x, mean_y), (con_a, con_b, con_c), cols, opac, radii, depth, width, rows_r, tile_size,
        st.isect_capacity, _rank_backgrounds(s.backgrounds, st.cams), abs_c,
    )
    return render[:, : y1 - y0], alphas[:, : y1 - y0], aux


def rasterization_distributed(
    means: torch.Tensor,  # [N_local, 3], this rank's rows
    quats: torch.Tensor,  # [N_local, 4]
    scales: torch.Tensor,  # [N_local, 3]
    opacities: torch.Tensor,  # [N_local]
    colors: torch.Tensor,  # [N_local, D], [N_local, K, 3] or per camera [C, N_local, D]
    viewmats: torch.Tensor,  # [C, 4, 4], the same on every rank
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    group=None,
    sh_degree: Optional[int] = None,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps2d: float = 0.3,
    tile_size: int = 16,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
    render_mode: str = "RGB",
    rasterize_mode: str = "classic",
    backend: str = "auto",
    isect_capacity: Optional[int] = None,  # per rank
    masks: Optional[torch.Tensor] = None,  # [N_local] bool
    means2d_carrier: Optional[torch.Tensor] = None,  # [C, N_local, 2] zeros
    per_camera_colors: bool = False,
    absgrad: bool = False,
    camera_model: str = "pinhole",
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Distributed 3DGS rasterization (JAX distributed.py:148): projection
    on the owner rank, one exchange, the rank's cameras rasterized. With
    fewer cameras than ranks (``n % C == 0``) it takes the strip layout
    (JAX distributed.py:385). Returns (render [C/n, H, W, X] or the strip's
    rows, alphas, meta); see the module's docstring for the per-rank
    contract."""
    st = _setup(group, (means, quats, scales, opacities, colors, viewmats, Ks, backgrounds, masks, means2d_carrier),
                viewmats, means.shape[0], width, height, tile_size, backend, isect_capacity, packed=False)
    if per_camera_colors and sh_degree is not None:
        raise ValueError("per-camera colors take sh_degree=None")
    s = project_and_shade(
        means, quats, scales, opacities, colors, viewmats, Ks, width, height, near_plane=near_plane,
        far_plane=far_plane, radius_clip=radius_clip, eps2d=eps2d, sh_degree=sh_degree, backgrounds=backgrounds,
        render_mode=render_mode, rasterize_mode=rasterize_mode, camera_model=camera_model, masks=masks,
    )
    rows, D = _payload_rows_3dgs(s, means2d_carrier, absgrad)
    x = _exchange_payload(st, rows, group)
    render, alphas, aux = _raster_3dgs(st, s, x, D, means2d_carrier is not None and absgrad, width, height,
                                       tile_size)
    if render_mode in ("ED", "RGB+ED"):
        render = expected_depth(render, alphas)
    return render, alphas, _meta(st, s, aux, width, height, group, len(rows))


def rasterization_distributed_packed(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,  # [N_local, D] or [N_local, K, 3]
    viewmats: torch.Tensor,
    Ks: torch.Tensor,
    width: int,
    height: int,
    pack_capacity: int,
    group=None,
    sh_degree: Optional[int] = None,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps2d: float = 0.3,
    tile_size: int = 16,
    backgrounds: Optional[torch.Tensor] = None,
    render_mode: str = "RGB",
    rasterize_mode: str = "classic",
    backend: str = "auto",
    isect_capacity: Optional[int] = None,
    masks: Optional[torch.Tensor] = None,
    means2d_carrier: Optional[torch.Tensor] = None,
    absgrad: bool = False,
    camera_model: str = "pinhole",
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Packed distributed 3DGS rasterization (JAX distributed.py:597): each
    owner moves its visible (camera, Gaussian) rows (radii > 0) to the front
    of a ``min(pack_capacity, N_local)`` buffer, keeping their order, and
    only that buffer is exchanged. Slots past a camera's visible count are
    culled (radii 0); visible rows past the capacity are dropped, and
    ``meta["pack_required"]``, the largest visible count of any (camera,
    rank), says how much capacity the call needed."""
    st = _setup(group, (means, quats, scales, opacities, colors, viewmats, Ks, backgrounds, masks, means2d_carrier),
                viewmats, means.shape[0], width, height, tile_size, backend, isect_capacity, packed=True)
    s = project_and_shade(
        means, quats, scales, opacities, colors, viewmats, Ks, width, height, near_plane=near_plane,
        far_plane=far_plane, radius_clip=radius_clip, eps2d=eps2d, sh_degree=sh_degree, backgrounds=backgrounds,
        render_mode=render_mode, rasterize_mode=rasterize_mode, camera_model=camera_model, masks=masks,
    )
    rows, D = _payload_rows_3dgs(s, means2d_carrier, absgrad)
    packed, n_vis = _pack_visible(rows, s.radii, 6, pack_capacity)
    x = _exchange_payload(st, packed, group)
    render, alphas, aux = _raster_3dgs(st, s, x, D, means2d_carrier is not None and absgrad, width, height,
                                       tile_size)
    if render_mode in ("ED", "RGB+ED"):
        render = expected_depth(render, alphas)
    return render, alphas, _meta(st, s, aux, width, height, group, None, n_vis)


# --- 2DGS -----------------------------------------------------------------


def _payload_rows_2dgs(s, carrier):
    means2d = s.means2d if carrier is None else s.means2d + carrier
    D = s.colors.shape[-1]
    M = s.ray_transforms.reshape(s.ray_transforms.shape[:-2] + (9,))
    rows = [means2d[..., 0], means2d[..., 1], s.depths]
    rows += [M[..., k] for k in range(9)]
    rows += [s.normals[..., k] for k in range(3)]
    rows += [s.radii.to(torch.float32), s.opacities]
    rows += [s.colors[..., d] for d in range(D)]
    return rows, D


def _unpack_2dgs(x, D):
    mean_x, mean_y, depth = x[:, 0], x[:, 1], x[:, 2]
    mrows = [x[:, 3 + k] for k in range(9)]
    normals = x[:, 12:15].transpose(1, 2)
    radii = x[:, 15].to(torch.int32)
    opac = x[:, 16]
    cols = x[:, 17:17 + D].transpose(1, 2)
    return mean_x, mean_y, depth, mrows, normals, radii, opac, cols


def _strip_normals(depth, camtoworlds, Ks, y0: int, y1: int, height: int, G: int, n: int, rank: int, group):
    """Normals from depth for a strip's rows [y0, y1) of its camera
    (``depth`` [1, y1 - y0, W, 1]). The image's central differences read one
    row of each neighbouring strip, so every rank sends its first and last
    depth rows to every rank (one differentiable exchange, made by every
    rank whatever its rows) and reads its neighbours'. Only the image's own
    border rows stay zero."""
    rows, W = depth.shape[1], depth.shape[2]
    ends = torch.stack([depth[0, 0, :, 0], depth[0, -1, :, 0]]) if rows else depth.new_zeros((2, W))
    got = exchange([e[None].expand(n, W) for e in ends], n, group)[0].reshape(2, n, W)
    # every rank's output depends on the exchange, so that every rank's
    # backward runs its inverse
    tie = got[:, :0].sum()
    g = rank % G
    above = rows > 0 and g > 0  # strip g - 1 is whole: its last row is y0 - 1
    below = rows > 0 and g + 1 < G and y1 < height  # strip g + 1 starts at y1
    parts = ([got[1, rank - 1][None, None, :, None]] if above else []) + [depth]
    parts += [got[0, rank + 1][None, None, :, None]] if below else []
    ext = torch.cat(parts, dim=1)
    if ext.shape[1] < 3:
        return depth.new_zeros((1, rows, W, 3)) + tie
    nrm = depth_to_normal(ext, camtoworlds, Ks, row0=y0 - int(above))
    return nrm[:, int(above): int(above) + rows] + tie


def _raster_2dgs(st: _Setup, s, x, D, viewmats, Ks, width, height, tile_size, render_mode, depth_mode, distloss,
                 group):
    """The rank's 2DGS block from the exchanged surfel rows: the six images
    of `rasterization_2dgs` (a strip's rows cropped at ``height``) and the
    rasterizer's aux. A strip shifts its surfels into its own pixel frame:
    ``mean_y`` and the ray transform's second row, ``M[1] <- M[1] - y_off *
    M[2]`` (JAX distributed.py:1217-1221; the kernels intersect rows
    through ``-M[1] + py * M[2]``), and its normals from depth read one
    depth row of each neighbouring strip (`_strip_normals`)."""
    mean_x, mean_y, depth, mrows, normals, radii, opac, cols = _unpack_2dgs(x, D)
    y_off, y0, y1, rows_r = _strip_frame(st, height)
    normals_fn = None
    if st.strips is not None:
        mean_y = mean_y - float(y_off)
        for c in range(3):
            mrows[3 + c] = mrows[3 + c] - y_off * mrows[6 + c]
        G = st.strips[0]
        normals_fn = lambda d: _strip_normals(  # noqa: E731
            d, torch.linalg.inv(viewmats[st.cams]), Ks[st.cams], y0, y1, height, G, st.n, st.rank, group)
    *out, aux = rasterize_shaded_2dgs(
        st.backend, (mean_x, mean_y), mrows, cols, normals, opac, radii, depth, width, rows_r, tile_size,
        st.isect_capacity, _rank_backgrounds(s.backgrounds, st.cams),
    )
    out = [o[:, : y1 - y0] for o in out]
    return postprocess_2dgs(*out, viewmats[st.cams], Ks[st.cams], render_mode, depth_mode, distloss,
                            normals_fn), aux


def rasterization_2dgs_distributed(
    means: torch.Tensor,  # [N_local, 3], this rank's rows
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,  # [N_local, D], [N_local, K, 3] or per camera [C, N_local, D]
    viewmats: torch.Tensor,  # [C, 4, 4], the same on every rank
    Ks: torch.Tensor,
    width: int,
    height: int,
    group=None,
    sh_degree: Optional[int] = None,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    tile_size: int = 16,
    backgrounds: Optional[torch.Tensor] = None,
    render_mode: str = "RGB",
    distloss: bool = False,
    depth_mode: str = "expected",
    backend: str = "auto",
    isect_capacity: Optional[int] = None,
    masks: Optional[torch.Tensor] = None,
    densify_carrier: Optional[torch.Tensor] = None,  # [C, N_local, 2] zeros
    per_camera_colors: bool = False,
):
    """Distributed 2DGS rasterization (JAX distributed.py:908, with the strip
    layout of :1107 when ``n % C == 0``): surfel projection on the owner
    rank, one exchange of the mean, depth, ray-transform, normal, radius,
    opacity and colour rows, the rank's cameras or strip rasterized
    (`_raster_2dgs`). Returns `rasterization_2dgs`'s 7-tuple for the rank's
    block."""
    st = _setup(group, (means, quats, scales, opacities, colors, viewmats, Ks, backgrounds, masks, densify_carrier),
                viewmats, means.shape[0], width, height, tile_size, backend, isect_capacity, packed=False)
    if per_camera_colors and sh_degree is not None:
        raise ValueError("per-camera colors take sh_degree=None")
    check_depth_mode(depth_mode)
    s = project_and_shade_2dgs(
        means, quats, scales, opacities, colors, viewmats, Ks, width, height, near_plane=near_plane,
        far_plane=far_plane, radius_clip=radius_clip, sh_degree=sh_degree, backgrounds=backgrounds,
        render_mode=render_mode, masks=masks,
    )
    rows, D = _payload_rows_2dgs(s, densify_carrier)
    x = _exchange_payload(st, rows, group)
    outs, aux = _raster_2dgs(st, s, x, D, viewmats, Ks, width, height, tile_size, render_mode, depth_mode, distloss,
                             group)
    # JAX's whole-camera 2DGS meta has no exchange size
    return outs + (_meta(st, s, aux, width, height, group, len(rows) if st.strips is not None else None),)


def rasterization_2dgs_distributed_packed(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,  # [N_local, D] or [N_local, K, 3]
    viewmats: torch.Tensor,
    Ks: torch.Tensor,
    width: int,
    height: int,
    pack_capacity: int,
    group=None,
    sh_degree: Optional[int] = None,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    tile_size: int = 16,
    backgrounds: Optional[torch.Tensor] = None,
    render_mode: str = "RGB",
    distloss: bool = False,
    depth_mode: str = "expected",
    backend: str = "auto",
    isect_capacity: Optional[int] = None,
    masks: Optional[torch.Tensor] = None,
    densify_carrier: Optional[torch.Tensor] = None,
):
    """Packed distributed 2DGS rasterization (JAX distributed.py:1302): the
    surfel rows of `rasterization_2dgs_distributed`, each owner's visible
    (camera, surfel) rows partitioned to the front of a
    ``min(pack_capacity, N_local)`` buffer as in
    `rasterization_distributed_packed`, with ``meta["pack_required"]``."""
    st = _setup(group, (means, quats, scales, opacities, colors, viewmats, Ks, backgrounds, masks, densify_carrier),
                viewmats, means.shape[0], width, height, tile_size, backend, isect_capacity, packed=True)
    check_depth_mode(depth_mode)
    s = project_and_shade_2dgs(
        means, quats, scales, opacities, colors, viewmats, Ks, width, height, near_plane=near_plane,
        far_plane=far_plane, radius_clip=radius_clip, sh_degree=sh_degree, backgrounds=backgrounds,
        render_mode=render_mode, masks=masks,
    )
    rows, D = _payload_rows_2dgs(s, densify_carrier)
    packed, n_vis = _pack_visible(rows, s.radii, 15, pack_capacity)
    x = _exchange_payload(st, packed, group)
    outs, aux = _raster_2dgs(st, s, x, D, viewmats, Ks, width, height, tile_size, render_mode, depth_mode, distloss,
                             group)
    return outs + (_meta(st, s, aux, width, height, group, None, n_vis),)


# --- the trainers' collectives (multi-GPU training) -------------------------


def _root(group) -> int:
    """The global rank of ``group``'s rank 0 (the rank the trainers' global
    work runs on)."""
    return 0 if group is None else dist.get_global_rank(group, 0)


class _GatherBlocks(torch.autograd.Function):
    """[...] -> [n, ...]: every rank's tensor of one shape, in rank order.
    The backward returns the rank's own slice of the incoming gradient and
    sums nothing: every rank computes the same loss from the same gathered
    tensors, so slice r of any rank's gradient is rank r's."""

    @staticmethod
    def forward(ctx, x, n, rank, group):
        ctx.rank = rank
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None, None, None


def gather_blocks(x: Optional[torch.Tensor], C: int, height: int, tile_size: int, group=None):
    """The whole ``[C, H, W, X]`` on every rank, from each rank's block of a
    distributed render (``x``, as `rasterization_distributed` returns it:
    its whole cameras, or its strip's rows), differentiably: the backward
    hands each rank the gradient of its own block. Strips are padded to
    the strip height for the gather and cropped at ``height``. None stays
    None."""
    if x is None:
        return None
    n, rank = world(group)
    strips = strip_layout(C, n, height, tile_size)
    if strips is None:
        return _GatherBlocks.apply(x, n, rank, group).reshape((C,) + tuple(x.shape[1:]))
    G, _, strip_h = strips
    pad = x.new_zeros((1, strip_h - x.shape[1]) + tuple(x.shape[2:]))
    got = _GatherBlocks.apply(torch.cat([x, pad], dim=1), n, rank, group)  # [n, 1, strip_h, W, X]
    cams = []
    for c in range(C):
        rows = [strip_rows(g, strip_h, height) for g in range(G)]
        cams.append(torch.cat([got[c * G + g, 0, : y1 - y0] for g, (y0, y1) in enumerate(rows)]))
    return torch.stack(cams)


def shard_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows ``[r*N/n, (r+1)*N/n)`` of a global ``[N, ...]``
    tensor; raises unless ``N % n == 0``."""
    n, rank = world(group)
    N = x.shape[0]
    if N % n:
        raise ValueError(f"{N} rows do not split over a world of {n} ranks (N % world size must be 0)")
    return x[rank * (N // n): (rank + 1) * (N // n)]


def gather_rows(x: torch.Tensor, group=None) -> Optional[torch.Tensor]:
    """The ranks' row blocks (each ``[N/n, ...]``, one shape on every rank)
    concatenated in rank order: the global ``[N, ...]`` on the group's rank
    0, None on the others."""
    n, rank = world(group)
    parts = [torch.empty_like(x) for _ in range(n)] if rank == 0 else None
    dist.gather(x.contiguous(), parts, dst=_root(group), group=group)
    return torch.cat(parts) if rank == 0 else None


def scatter_rows(x: Optional[torch.Tensor], rows: int, like: torch.Tensor, group=None) -> torch.Tensor:
    """Each rank's ``rows`` rows of the global ``x`` held by the group's
    rank 0 (None on the others; ``x.shape[0] == rows * n``); ``like`` gives
    the dtype, device and trailing shape."""
    n, rank = world(group)
    out = like.new_empty((rows,) + tuple(like.shape[1:]))
    parts = list(x.contiguous().split(rows)) if rank == 0 else None
    if rank == 0 and (len(parts) != n or parts[-1].shape[0] != rows):
        raise ValueError(f"{x.shape[0]} rows do not scatter as {rows} to each of {n} ranks")
    dist.scatter(out, parts, src=_root(group), group=group)
    return out


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks (a new tensor; ``x`` is unchanged)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def broadcast_generator(gen: torch.Generator, device, group=None) -> None:
    """Give every rank's ``gen`` the state of the group's rank 0 (the
    state moves on ``device``: NCCL takes no host tensor)."""
    state = gen.get_state().to(device)
    dist.broadcast(state, src=_root(group), group=group)
    gen.set_state(state.cpu())
