"""Port tile intersection (gsplat_tpu_torch.ops.isect) vs the JAX package's.

The scene is tests/test_rasterize_tiled.py's `_scene` (N=250, C=2, 64x48,
projected by the JAX package). The port sizes its buffers exactly, so its
record holds min(n_isects, capacity) entries where JAX pads `capacity`
with sentinels: tile keys, depth keys, offsets, ends, tiles per Gaussian
and n_isects must equal JAX's over those entries. `jax.lax.sort` is not
stable, so within a run of equal (tile, depth) keys the flatten ids are
compared as multisets (the port keeps (camera, Gaussian) order there).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gsplat_tpu.ops.isect import isect_offset_encode as jax_offset_encode
from gsplat_tpu.ops.isect import isect_tiles as jax_isect
from gsplat_tpu.ops.isect import suggest_capacity as jax_suggest
from gsplat_tpu_torch.ops.isect import isect_offset_encode, isect_tiles, suggest_capacity

from test_rasterize_tiled import _scene
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

TS, TW, TH = 16, 4, 3  # 64x48 at tile size 16


@pytest.fixture(scope="module")
def scene():
    radii, means2d, depths, _, _, _ = _scene(np.random.default_rng(0))
    return np.asarray(means2d), np.asarray(radii), np.asarray(depths)


def _T(a):
    return torch.from_numpy(np.array(a))


def _check_ids(got, want_keys, want_ids):
    """flatten ids equal as multisets within each run of equal keys."""
    keys = want_keys.astype(np.int64)
    order_w = np.lexsort((want_ids, keys))
    order_g = np.lexsort((got, keys))
    np.testing.assert_array_equal(got[order_g], want_ids[order_w])


@pytest.mark.parametrize("cap", [8192, 1000])
def test_isect_tiles_matches_jax(scene, cap):
    """The record at a capacity above n_isects and one that truncates."""
    m2d, radii, depths = scene
    want = jax_isect(jnp.asarray(m2d), jnp.asarray(radii), jnp.asarray(depths), TS, TW, TH, cap)
    got = isect_tiles(_T(m2d), _T(radii), _T(depths), TS, TW, TH, cap)
    n = int(want.n_isects)
    M = min(n, cap)
    assert int(got.n_isects) == n > 1000  # the second case truncates
    assert got.flatten_ids.shape == (M,) and got.flatten_ids.dtype == torch.int32
    np.testing.assert_array_equal(got.tiles_per_gauss.numpy(), np.asarray(want.tiles_per_gauss))
    np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
    np.testing.assert_array_equal(got.ends.numpy(), np.asarray(want.ends))
    np.testing.assert_array_equal(got.tile_keys.numpy(), np.asarray(want.tile_keys)[:M])
    np.testing.assert_array_equal(got.depth_keys.numpy(), np.asarray(want.depth_keys)[:M])
    key = (np.asarray(want.tile_keys)[:M].astype(np.int64) << 32) + np.asarray(want.depth_keys)[:M]
    _check_ids(got.flatten_ids.numpy(), key, np.asarray(want.flatten_ids)[:M])
    assert int(got.ends.max()) == M


def test_isect_tiles_soa_and_empty(scene):
    """means2d as an (x, y) pair gives the same record; a scene with every
    radius 0 gives an empty stream with all ranges empty, as JAX's."""
    m2d, radii, depths = scene
    a = isect_tiles(_T(m2d), _T(radii), _T(depths), TS, TW, TH, 8192)
    b = isect_tiles((_T(m2d[..., 0]), _T(m2d[..., 1])), _T(radii), _T(depths), TS, TW, TH, 8192)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    zero = np.zeros_like(radii)
    want = jax_isect(jnp.asarray(m2d), jnp.asarray(zero), jnp.asarray(depths), TS, TW, TH, 256)
    got = isect_tiles(_T(m2d), _T(zero), _T(depths), TS, TW, TH, 256)
    assert int(got.n_isects) == int(want.n_isects) == 0 and got.flatten_ids.shape == (0,)
    np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
    np.testing.assert_array_equal(got.ends.numpy(), np.asarray(want.ends))


def test_isect_offset_encode_matches_jax(scene):
    m2d, radii, depths = scene
    got = isect_tiles(_T(m2d), _T(radii), _T(depths), TS, TW, TH, 8192)
    C = m2d.shape[0]
    offs = isect_offset_encode(got.tile_keys, C, TW, TH)
    np.testing.assert_array_equal(offs.numpy(), got.offsets.numpy())
    want = jax_offset_encode(jnp.asarray(got.tile_keys.numpy()), C, TW, TH)
    np.testing.assert_array_equal(offs.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [0, 1, 4095, 1663, 3_005_853])
def test_suggest_capacity_matches_jax(n):
    assert suggest_capacity(n) == jax_suggest(n)
    assert suggest_capacity(n, slack=2.0, align=512) == jax_suggest(n, slack=2.0, align=512)


@pytest.mark.parametrize("cap", [8192, 1000])
def test_isect_order_places_entries_in_segments(scene, cap):
    """The stream's own gid order (`Isect.order`, from the key sort over the
    expansion): a permutation of the M kept entries, each inside the
    expansion range of its (camera, Gaussian), the ranges those of
    tiles_per_gauss clipped at the capacity; the reduce kernel's two passes
    on it give index_add_'s sums and JAX's _reduce_call's (interpret mode)
    for seeded rows; reduce_by_gid with the order equals the call without."""
    from gsplat_tpu_torch.ops import rasterize_binned as trb
    from test_torch_rasterize_binned_bwd import assert_in_segments, jax_reduce, two_pass_reduce

    m2d, radii, depths = scene
    got = isect_tiles(_T(m2d), _T(radii), _T(depths), TS, TW, TH, cap)
    M = got.flatten_ids.shape[0]
    CN = radii.size
    assert M == min(int(got.n_isects), cap) and (cap == 8192) == (M == int(got.n_isects))
    dst, starts = got.order
    assert dst.dtype == starts.dtype == torch.int64 and starts.shape == (CN + 1,)
    cum = np.cumsum(got.tiles_per_gauss.numpy().reshape(-1).astype(np.int64))
    np.testing.assert_array_equal(starts.numpy(), np.minimum(np.concatenate([[0], cum]), M))
    assert_in_segments(dst, starts, got.flatten_ids, torch.ones(M, dtype=torch.bool))
    rows = torch.from_numpy(np.random.default_rng(cap).standard_normal((9, M)).astype(np.float32))
    want = trb._reduce_plain(rows, got.flatten_ids, CN)
    np.testing.assert_allclose(two_pass_reduce(rows, dst, starts, CN).numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(want.numpy(), jax_reduce(rows.numpy(), got.flatten_ids.numpy(), CN),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(trb.reduce_by_gid(rows, got.flatten_ids, CN, order=got.order),
                       trb.reduce_by_gid(rows, got.flatten_ids, CN))
