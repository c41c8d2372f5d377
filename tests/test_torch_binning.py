"""Port binning engine (gsplat_tpu_torch.ops.binning) vs the JAX package.

The JAX bin_gaussians runs its Pallas emit kernel in interpret mode on the
CPU; the port runs the emit kernel's plain torch version. Both get the same
projected inputs (seeded numpy, projected once by the JAX package) and must
produce the same stream exactly: n_isects, slab_required, offs, cnts, and
gids and entries up to n_isects. Past n_isects the JAX stream holds its
capacity padding; the port sizes its buffers exactly, and holds only culled
entries there (gid C*N, zero payload).

The port's emit writes keys and gids only; after the sort a gather
(`_gather_plain` here, csrc/emit_gather.cu on the card) builds the entry
rows from the packed payload table. The gather is also held to the payload
rows indexed by the sorted gids directly.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gsplat_tpu.ops.binning import bin_gaussians as jax_bin
from gsplat_tpu.ops.projection import fully_fused_projection
from gsplat_tpu_torch import _backend
from gsplat_tpu_torch.ops import binning
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)


def _projected(seed=0, N=250, C=2, W=64, H=48, D=3):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.3 + 0.05).astype(np.float32)
    opac = rng.random((N,)).astype(np.float32)
    colors = rng.random((C, N, D)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[:, 2, 3] = 4.0
    viewmats[1, 0, 3] = 0.3
    Ks = np.tile(
        np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32),
        (C, 1, 1),
    )
    radii, means2d, depths, conics, _ = fully_fused_projection(
        *map(jnp.asarray, (means, quats, scales, viewmats, Ks)), W, H
    )
    m2, co = np.array(means2d), np.array(conics)
    return (
        m2[..., 0], m2[..., 1], co[..., 0], co[..., 1], co[..., 2],
        np.ascontiguousarray(np.broadcast_to(opac[None], (C, N))), colors,
        np.array(radii), np.array(depths),
    )


def _both(args, ts, W, H, capacity, cull):
    tw, th = -(-W // ts), -(-H // ts)
    want = jax_bin(*map(jnp.asarray, args), ts, tw, th, capacity=capacity, cull=cull)
    got = binning.bin_gaussians(
        *map(torch.from_numpy, args), ts, tw, th, capacity=capacity, cull=cull
    )
    return want, got


def _assert_same_stream(want, got, CN):
    n = int(want.n_isects)
    assert int(got.n_isects) == n
    assert got.slab_required == int(want.slab_required)
    np.testing.assert_array_equal(got.offs.numpy(), np.asarray(want.offs))
    np.testing.assert_array_equal(got.cnts.numpy(), np.asarray(want.cnts))
    np.testing.assert_array_equal(got.gids[:n].numpy(), np.asarray(want.gids)[0, :n])
    np.testing.assert_array_equal(
        got.entries[:, :n].numpy(), np.asarray(want.entries)[:, :n]
    )
    assert (got.gids[n:] == CN).all()
    assert (got.entries[:, n:] == 0).all()


@pytest.mark.parametrize("cull", [False, True])
def test_bin_gaussians_matches_jax(cull):
    C, W, H, ts = 2, 64, 48, 16
    args = _projected(C=C, W=W, H=H)
    want, got = _both(args, ts, W, H, capacity=8192, cull=cull)
    assert int(want.n_isects) > 0
    _assert_same_stream(want, got, CN=C * args[0].shape[1])


def test_cull_shrinks_the_stream():
    args = _projected()
    _, full = _both(args, 16, 64, 48, capacity=8192, cull=False)
    _, culled = _both(args, 16, 64, 48, capacity=8192, cull=True)
    assert int(culled.n_isects) < int(full.n_isects)


@pytest.mark.parametrize("cull", [False, True])
def test_truncation_matches_jax(cull):
    """capacity < slab_required: both drop the same whole GB-blocks."""
    C, W, H, ts = 2, 64, 48, 16
    # 1200 Gaussians x 2 cameras = 3 blocks of GB=1024 ids
    args = _projected(seed=3, N=1200, C=C, W=W, H=H)
    _, full = _both(args, ts, W, H, capacity=1 << 20, cull=cull)
    need = full.slab_required
    assert need >= int(full.n_isects)
    want, got = _both(args, ts, W, H, capacity=max(512, need // 2), cull=cull)
    assert got.slab_required == need
    assert 0 < int(got.n_isects) < int(full.n_isects)
    _assert_same_stream(want, got, CN=C * args[0].shape[1])


def test_cpu_binning_launches_no_kernel():
    _backend.reset_launch_counts()
    _both(_projected(), 16, 64, 48, capacity=8192, cull=True)
    counts = _backend.launch_counts()
    assert counts["emit"] == 0 and set(counts.values()) == {0}


GATHER_CASES = ("truncated", "2dgs_payload", "all_culled", "empty")


def _gather_inputs(case):
    """(plan_emit's positional inputs, keyword inputs, payload rows) of one
    gather case, on 2 cameras at 64x48 with 16-pixel tiles."""
    C, W, H = 2, 64, 48
    if case == "truncated":
        # 1200 Gaussians x 2 cameras = 3 blocks of GB = 1024 ids, half the slab
        args = list(map(torch.from_numpy, _projected(seed=3, N=1200, C=C, W=W, H=H)))
        need = binning.plan_emit(*args, 16, 4, 3, 1 << 20)[1]
        kw = dict(capacity=max(512, need // 2), cull=True)
    elif case == "2dgs_payload":
        # the 19 rows of a 2DGS surfel payload (12 fixed + RGB, depth and 3
        # normals), seeded values; no cull, as the 2DGS path bins
        args = list(map(torch.from_numpy, _projected(seed=4, C=C, W=W, H=H)))
        rng = np.random.default_rng(4)
        rows = [args[0], args[1]] + [torch.from_numpy(rng.standard_normal(args[0].shape).astype(np.float32))
                                     for _ in range(17)]
        return args[:2] + [None] * 5 + args[7:], dict(capacity=8192, cull=False, payload_rows=rows), rows
    elif case == "all_culled":
        # Gaussians off the image's corners, each a thin ellipse along the
        # anti-diagonal (axes 40 and 1 px): the tight rectangle reaches into
        # the image, the ellipse never does, so the cull drops every entry
        N = 4
        mx = torch.tensor([[-60.0, 124.0, -60.0, 124.0]] * C)
        my = torch.tensor([[-60.0, -60.0, 108.0, 108.0]] * C)
        flip = torch.tensor([[1.0, -1.0, -1.0, 1.0]] * C)  # the ellipse's axis points away from the image
        a = torch.full((C, N), 1601.0 / 3200.0)
        b = flip * (1599.0 / 3200.0)
        args = [mx, my, a, b, a.clone(), torch.full((C, N), 0.9), torch.rand(C, N, 3, generator=torch.Generator().manual_seed(5)),
                torch.full((C, N), 100, dtype=torch.int32), torch.full((C, N), 4.0)]
        kw = dict(capacity=8192, cull=True)
    else:
        args = list(map(torch.from_numpy, _projected(seed=6, C=C, W=W, H=H)))
        args[7] = torch.zeros_like(args[7])  # every radius 0: nothing emitted
        kw = dict(capacity=8192, cull=True)
    rows = args[:6] + list(args[6].unbind(-1))
    return args, kw, rows


@pytest.mark.parametrize("case", GATHER_CASES)
def test_plain_gather_matches_direct_payload(case):
    """sort_entries' gather (the plain version) against the payload rows
    indexed by the sorted gids directly, zero past n_isects: the stream the
    parent's emit built by duplicating and permuting every row."""
    args, kw, rows = _gather_inputs(case)
    tw, th = 4, 3
    plan, slab = binning.plan_emit(*args, 16, tw, th, **kw)
    keys, gids = binning._emit_plain(plan)
    b = binning.sort_entries((keys, gids), plan.packed, plan.nf, 2 * tw * th, slab, binning.segment_starts(plan))
    n, M = int(b.n_isects), plan.n_emit
    payload = torch.stack([binning._fin(r).reshape(-1) for r in rows]).to(torch.float32)  # [NF, CN]
    assert plan.nf == payload.shape[0] and plan.packed.shape[1] % binning.ROW_ALIGN == 0
    assert torch.equal(b.gids, gids[b.dst])
    want = torch.zeros((plan.nf, M))
    want[:, :n] = payload[:, b.gids[:n].to(torch.int64)]
    assert b.entries.shape == (plan.nf, M) and b.entries.is_contiguous()
    assert torch.equal(b.entries, want)
    CN = payload.shape[1]
    assert (b.gids[:n] < CN).all() and (b.gids[n:] == CN).all()
    if case == "truncated":
        assert 0 < n < int(binning.bin_gaussians(*args, 16, tw, th, capacity=1 << 20).n_isects)
    elif case == "2dgs_payload":
        assert plan.nf == 19 and n == M > 0
    elif case == "all_culled":
        assert M > 0 and n == 0 and (b.entries == 0).all()
    else:
        assert M == 0 and n == 0


def test_gather_cuda_refuses_cpu_tensors():
    args, kw, _ = _gather_inputs("2dgs_payload")
    plan, _ = binning.plan_emit(*args, 16, 4, 3, **kw)
    keys, gids = binning._emit_plain(plan)
    perm = torch.sort(keys, stable=True)[1]
    with pytest.raises(ValueError, match="CUDA"):
        binning._gather_cuda(plan.packed, plan.nf, perm, gids, torch.tensor(plan.n_emit))
