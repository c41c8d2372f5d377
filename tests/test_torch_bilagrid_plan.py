"""The tile plan of the bilateral grid's gradient kernels
(gsplat_tpu_torch/bilagrid.py::grad_plan, taken by csrc/bilagrid_bwd.cu's
two kernels), on the CPU with torch and numpy alone.

At each shape (1080p with the default 16 x 16 x 8 grids and two images,
small odd images, images narrower and shorter than the grid, one node
along an axis, Z from 1 to 32):
- every pixel lies in exactly one tile, and the tiles come image by image,
  cell by cell, as the cell table says;
- each tile's pixels have the same lower (x, y) corners by
  `bilagrid._corners` (the plain versions' rounding), so its node window
  is at most 2 x 2 nodes;
- each node's reach entries are exactly the (run, slot) pairs whose
  corner is that node, in ascending order;
- the plan refuses only a block's shared memory for Z, and is cached.

Then the two passes' bookkeeping: the plain version's per-pixel products
summed tile by tile into each tile's four corner slots, then node by node
through the plan's reach and cell tables in its tile order, against
`_grid_grad_plain` within chip_smoke.GRID_GRAD_TOL of each value's sum of
|terms| (the two sums add in another order): no contribution dropped or
counted twice.
"""

import numpy as np
import pytest
import torch

from chip_smoke import GRID_GRAD_TOL
from gsplat_tpu_torch import bilagrid
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

SHAPES = [
    (2, 1080, 1920, 8, 16, 16),
    (1, 23, 37, 8, 16, 16),
    (1, 5, 7, 8, 16, 16),
    (1, 23, 37, 8, 16, 1),
    (1, 23, 37, 8, 1, 16),
    (1, 23, 37, 1, 16, 16),
    (1, 23, 37, 16, 16, 16),
    (2, 23, 37, 32, 16, 16),
    (1, 23, 37, 8, 1, 1),
]


def decode(plan, B, X, Y):
    """(tiles [B * Ti, 4], x reach [X, 2], y reach [Y, 2], cell firsts,
    Ti, column runs, row runs) of a plan array."""
    Ti, Rx, Ry, zero = (int(a) for a in plan[:bilagrid.GRAD_PLAN_HEADER])
    assert zero == 0
    o = bilagrid.GRAD_PLAN_HEADER
    tiles = plan[o:o + 4 * B * Ti].reshape(-1, 4)
    o += 4 * B * Ti
    xreach = plan[o:o + 2 * X].reshape(X, 2)
    yreach = plan[o + 2 * X:o + 2 * X + 2 * Y].reshape(Y, 2)
    first = plan[o + 2 * X + 2 * Y:]
    assert len(first) == Rx * Ry + 1 and first[0] == 0 and first[-1] == Ti and np.all(np.diff(first) >= 1)
    return tiles, xreach, yreach, first, Ti, Rx, Ry


def lower_nodes(n, g):
    """Each pixel's lower and upper node along an axis, by `_corners`."""
    i0, i1, _ = bilagrid._corners((torch.arange(n, dtype=torch.float32) + 0.5) / n, g)
    return i0.numpy(), i1.numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}_{}x{}_Z{}_Y{}_X{}".format(*s))
def test_plan_covers_each_pixel_once_within_one_node_window(shape):
    B, H, W, Z, Y, X = shape
    plan = bilagrid.grad_plan(*shape)
    assert plan.dtype == np.int32 and not plan.flags.writeable
    assert bilagrid.grad_plan(*shape) is plan  # cached by shape
    tiles, xreach, yreach, first, Ti, Rx, Ry = decode(plan, B, X, Y)
    x0, x1 = lower_nodes(W, X)
    y0, y1 = lower_nodes(H, Y)
    seen = np.zeros((B * H, W), np.int32)
    for k, (row0, w0, rows, cols) in enumerate(tiles):
        assert rows >= 1 and cols >= 1
        seen[row0:row0 + rows, w0:w0 + cols] += 1
        b, h0 = divmod(int(row0), H)
        assert b == k // Ti and h0 + rows <= H
        # one lower corner a tile: its window is {x0, x1} x {y0, y1}
        assert len(set(x0[w0:w0 + cols])) == 1 and len(set(y0[h0:h0 + rows])) == 1
        assert set(x1[w0:w0 + cols]) <= {x0[w0], x0[w0] + 1} and set(y1[h0:h0 + rows]) <= {y0[h0], y0[h0] + 1}
    assert np.all(seen == 1)
    # the cells, run by run: a cell's tiles share its runs
    runs_x = [w0 for w0 in np.flatnonzero(np.diff(x0, prepend=-1))]
    runs_y = [h0 for h0 in np.flatnonzero(np.diff(y0, prepend=-1))]
    assert (Rx, Ry) == (len(runs_x), len(runs_y))
    for cell in range(Rx * Ry):
        ry, rx = divmod(cell, Rx)
        for row0, w0, rows, cols in tiles[first[cell]:first[cell + 1]]:
            assert w0 == runs_x[rx] and y0[row0 % H] == y0[runs_y[ry]]
    # each node's reach: the (run, slot) pairs whose corner it is
    for reach, lo, hi, runs, g in ((xreach, x0, x1, runs_x, X), (yreach, y0, y1, runs_y, Y)):
        for k in range(g):
            want = sorted([2 * r for r, s in enumerate(runs) if lo[s] == k]
                          + [2 * r + 1 for r, s in enumerate(runs) if hi[s] == k])
            assert list(reach[k][reach[k] >= 0]) == want and list(reach[k][len(want):]) == [-1] * (2 - len(want))


def test_plan_refuses_only_shared_memory():
    top = max(z for z in range(1, 4096) if max(bilagrid.grad_smem(z)) <= bilagrid.SMEM_LIMIT)
    assert top >= 32
    bilagrid.grad_plan(1, 23, 37, top, 16, 16)
    with pytest.raises(ValueError, match="shared memory"):
        bilagrid.grad_plan(1, 23, 37, top + 1, 16, 16)
    # nothing else in range is refused: empty images, one node, any SM count
    for shape in [(0, 23, 37, 8, 16, 16), (1, 0, 37, 8, 16, 16), (1, 23, 0, 8, 16, 16), (1, 1, 1, 1, 1, 1),
                  (3, 2, 2, 8, 64, 64)]:
        for sms in (1, 132):
            bilagrid.grad_plan(*shape, sms=sms)


@pytest.mark.parametrize("shape", [(2, 23, 37, 8, 16, 16), (1, 23, 37, 3, 1, 1), (1, 5, 7, 4, 16, 16),
                                   (1, 40, 70, 32, 5, 6)], ids=lambda s: "B{}_{}x{}_Z{}_Y{}_X{}".format(*s))
def test_tile_partials_summed_by_node_match_plain(shape):
    B, H, W, Z, Y, X = shape
    rng = np.random.default_rng(7)
    v = torch.tensor(rng.standard_normal((B, H, W, 12)).astype(np.float32))
    gray = torch.tensor(rng.random((B, H, W)).astype(np.float32))
    gray[:, 0], gray[:, -1] = 0.0, 1.0  # the bottom and the top node
    tiles, xreach, yreach, first, Ti, Rx, Ry = decode(bilagrid.grad_plan(*shape, sms=4), B, X, Y)
    # the plain version's per-pixel terms, [B, H, W, 2 z, 2 y, 2 x, 12], and their levels
    fx = bilagrid._corners((torch.arange(W) + 0.5) / W, X)[2]
    fy = bilagrid._corners((torch.arange(H) + 0.5) / H, Y)[2]
    z0, z1, fz = bilagrid._corners(gray, Z)
    wz = torch.stack([1 - fz, fz], -1)[..., :, None, None, None]
    wy = torch.stack([1 - fy, fy], -1)[None, :, None, None, :, None, None]
    wx = torch.stack([1 - fx, fx], -1)[None, None, :, None, None, :, None]
    terms = ((v[..., None, None, None, :] * wz) * wy) * wx
    levels = torch.stack([z0, z1], -1)
    # pass 1: a tile's partials [4 corners, Z, 12], its pixels in order
    partial = torch.zeros(B * Ti, 4, Z, 12)
    for k, (row0, w0, rows, cols) in enumerate(tiles):
        b, h0 = divmod(int(row0), H)
        t = terms[b, h0:h0 + rows, w0:w0 + cols].reshape(-1, 2, 4, 12)
        lv = levels[b, h0:h0 + rows, w0:w0 + cols].reshape(-1, 2)
        for s in range(2):
            for corner in range(4):
                partial[k, corner].index_add_(0, lv[:, s], t[:, s, corner])
    # pass 2: each node's tiles in the plan's order
    got = torch.zeros(B, Z, Y, X, 12)
    for b in range(B):
        for y in range(Y):
            for x in range(X):
                for ey in yreach[y][yreach[y] >= 0]:
                    for ex in xreach[x][xreach[x] >= 0]:
                        cell = (ey >> 1) * Rx + (ex >> 1)
                        for k in range(b * Ti + first[cell], b * Ti + first[cell + 1]):
                            got[b, :, y, x] += partial[k, (ey & 1) * 2 + (ex & 1)]
    want = bilagrid._grid_grad_plain(v, gray, (B, Z, Y, X, 12))
    scale = bilagrid._grid_grad_plain(v.abs(), gray, (B, Z, Y, X, 12))
    assert torch.all((got - want).abs() <= GRID_GRAD_TOL * scale)
    assert float(scale.min()) >= 0 and float(got.abs().sum()) > 0
