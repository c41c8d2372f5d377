"""Port binned forward (gsplat_tpu_torch.ops.rasterize_binned) vs the JAX package.

The JAX rasterize_to_pixels_binned runs its Pallas kernels in interpret mode
on the CPU; the port runs the forward kernel's plain torch version. Same
projected inputs (seeded numpy, projected once by the JAX package). Images
and alphas must agree within rtol/atol 1e-5 with the JAX binned path and
with the JAX oracle (the transmittance products round in another order),
and `last` must equal the JAX forward's residual where the two streams are
equal (always, here).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gsplat_tpu.ops import rasterize_binned as jrb
from gsplat_tpu.ops.projection import fully_fused_projection
from gsplat_tpu.ops.rasterize_ref import rasterize_to_pixels_ref as jax_ref
from gsplat_tpu_torch.ops import rasterize_binned as trb
from gsplat_tpu_torch.ops.rasterize import rasterize_to_pixels
from gsplat_tpu_torch.ops.rasterize_ref import rasterize_to_pixels_ref
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-5)
C, W, H, CAP = 2, 64, 48, 8192


def _scene(seed=0, N=250, D=3):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.3 + 0.05).astype(np.float32)
    opac = rng.random((N,)).astype(np.float32)
    colors = rng.random((C, N, D)).astype(np.float32)
    bg = rng.random((C, D)).astype(np.float32)
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
    opc = np.ascontiguousarray(np.broadcast_to(opac[None], (C, N)))
    return [
        np.array(means2d), np.array(conics), colors, opc, np.array(radii),
        np.array(depths),
    ], bg


CASES = [  # (tile_size, D, backgrounds)
    (16, 3, True),
    (16, 1, False),
    (16, 4, True),
    (32, 3, False),
    (32, 4, True),
    (32, 1, True),
]


@pytest.mark.parametrize("ts,D,use_bg", CASES)
def test_binned_forward_matches_jax(ts, D, use_bg):
    args, bg = _scene(D=D)
    bg = bg if use_bg else None
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    jbg = None if bg is None else jnp.asarray(bg)
    tbg = None if bg is None else torch.from_numpy(bg)

    r_j, a_j, aux_j = jrb.rasterize_to_pixels_binned(
        *jargs, W, H, ts, capacity=CAP, backgrounds=jbg
    )
    r_o, a_o = jax_ref(*jargs, W, H, ts, jbg)
    r_t, a_t, aux_t = trb.rasterize_to_pixels_binned(
        *targs, W, H, ts, capacity=CAP, backgrounds=tbg
    )
    assert int(aux_t["n_isects"]) == int(aux_j["n_isects"]) > 0
    assert aux_t["slab_required"] == int(aux_j["slab_required"])
    assert tuple(r_t.shape) == (C, H, W, D) and tuple(a_t.shape) == (C, H, W, 1)
    for got, want in ((r_t, r_j), (a_t, a_j), (r_t, r_o), (a_t, a_o)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the port's own oracle and its dispatcher agree too
    r_p, a_p = rasterize_to_pixels_ref(*targs, W, H, ts, tbg)
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_o), **TOL)
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_o), **TOL)
    r_d, _, aux_d = rasterize_to_pixels(
        *targs, W, H, ts, capacity=CAP, backgrounds=tbg, backend="binned"
    )
    assert torch.equal(r_d, r_t) and int(aux_d["n_isects"]) == int(aux_t["n_isects"])


def _jax_last(args, ts, D):
    """`last` from the JAX forward's residual, in image layout."""
    m2, co, colors, opc, radii, depths = args
    N = m2.shape[1]
    th, tw = -(-H // ts), -(-W // ts)
    P, Dp = ts * ts, -(-D // 8) * 8
    F = -(-(6 + Dp) // 8) * 8
    rows = [m2[..., 0], m2[..., 1], co[..., 0], co[..., 1], co[..., 2], opc]
    rows += [colors[..., d] for d in range(D)]
    rows += [np.zeros((C, N), np.float32)] * (F - len(rows))
    packed = jnp.asarray(np.stack([r.reshape(-1) for r in rows]))
    GR = -(-(7 + D) // 8) * 8
    cfg = (C, N, C * th * tw, th, tw, ts, P, D, Dp, F, 512, 128, P, CAP, GR,
           True, False, True, True, False, False)
    _, res = jrb._raster_binned_fwd(
        cfg, packed, jnp.zeros((2, C * N), jnp.float32), jnp.asarray(radii),
        jnp.asarray(depths),
    )
    last = np.asarray(res[4]).reshape(C, th, tw, ts, ts).transpose(0, 1, 3, 2, 4)
    return last.reshape(C, th * ts, tw * ts)[:, :H, :W]


@pytest.mark.parametrize("ts", [16, 32])
def test_last_matches_jax_residual(ts):
    D = 3
    args, _ = _scene(seed=1, D=D)
    want = _jax_last(args, ts, D)
    _, _, last, binned = trb._raster_binned_fwd(
        *map(torch.from_numpy, args), W, H, ts, CAP
    )
    assert int(binned.n_isects) > 0
    assert (want >= 0).any()
    np.testing.assert_array_equal(last.numpy(), want)


def test_plain_forward_chunking_is_exact(monkeypatch):
    """Tile groups and entry chunks only split the loop: tiny ones (T
    carried across many chunk boundaries) give the default's result within
    f32 product-rounding (1e-6)."""
    args, bg = _scene(seed=2)
    _, _, _, binned = trb._raster_binned_fwd(*map(torch.from_numpy, args), W, H, 16, CAP)
    fwd_args = (binned.entries, binned.offs, binned.cnts, C, W, H, 16, torch.from_numpy(bg))
    ref = trb._fwd_plain(*fwd_args)
    monkeypatch.setattr(trb, "PLAIN_TILE_GROUP", 3)
    monkeypatch.setattr(trb, "PLAIN_CHUNK", 7)
    small = trb._fwd_plain(*fwd_args)
    for a, b in zip(ref[:2], small[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(ref[2], small[2])
    assert ref[3] == small[3] > 0


def test_rejects_unsupported_shapes():
    args, _ = _scene(D=3)
    targs = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="tile_size"):
        trb.rasterize_to_pixels_binned(*targs, W, H, 12, capacity=CAP)
    wide = [*targs[:2], torch.zeros(C, targs[0].shape[1], 33), *targs[3:]]
    with pytest.raises(ValueError, match="channels"):
        trb.rasterize_to_pixels_binned(*wide, W, H, 16, capacity=CAP)
