"""Port binning engine (gsplat_tpu_torch.ops.binning) vs the JAX package.

The JAX bin_gaussians runs its Pallas emit kernel in interpret mode on the
CPU; the port runs the emit kernel's plain torch version. Both get the same
projected inputs (seeded numpy, projected once by the JAX package) and must
produce the same stream exactly: n_isects, slab_required, offs, cnts, and
gids and entries up to n_isects. Past n_isects the JAX stream holds its
capacity padding; the port sizes its buffers exactly, and holds only culled
entries there (gid C*N, zero payload).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gsplat_tpu.ops.binning import bin_gaussians as jax_bin
from gsplat_tpu.ops.projection import fully_fused_projection
from gsplat_tpu_torch import _backend
from gsplat_tpu_torch.ops import binning


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
