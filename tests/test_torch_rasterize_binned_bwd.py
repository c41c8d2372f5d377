"""Port binned backward (gsplat_tpu_torch.ops.rasterize_binned) vs the JAX package.

The JAX rasterize_to_pixels_binned VJP runs its Pallas kernels in interpret
mode on the CPU (at the size of tests/test_rasterize_binned.py's VJP test:
N=150, 48x32); the port runs the backward and reduce kernels' plain torch
versions. Same projected inputs (seeded numpy, projected once by the JAX
package), same cotangents. Tolerances:
- gradients: rtol 1e-3, atol 1e-4 x the largest |gradient| of the input,
  as tests/test_rasterize_binned.py holds JAX's own kernel to its oracle;
- absgrad: rtol 1e-4, atol 1e-5, as JAX's absgrad test;
- reduce: rtol 1e-6, atol 1e-6 (the same sums in another order), also
  for a torch emulation of the reduce kernel's two passes (scatter into
  gid order at each slot's `dst`, then a sum over each segment of
  `starts`) on the stream's own order (`Binned.order`) and on the gids'
  sort (`gid_order`).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu import rasterization as jax_rasterization
from gsplat_tpu.ops import rasterize_binned as jrb
from gsplat_tpu.ops.projection import fully_fused_projection
from gsplat_tpu.ops.rasterize_ref import rasterize_to_pixels_ref as jax_ref
from gsplat_tpu.ops.rasterize_ref import rasterize_to_pixels_ref_absgrad as jax_ref_absgrad
from gsplat_tpu_torch import _backend, rasterization
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops import rasterize_binned as trb
from gsplat_tpu_torch.ops.rasterize_ref import (
    rasterize_to_pixels_ref,
    rasterize_to_pixels_ref_absgrad,
)
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

C, W, H, TS, D, CAP = 1, 48, 32, 16, 3, 8192
NAMES = ("means2d", "conics", "colors", "opacities")


def _scene(seed, N):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.3 + 0.05).astype(np.float32)
    opac = rng.random((N,)).astype(np.float32)
    colors = rng.random((C, N, D)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[:, 2, 3] = 4.0
    Ks = np.tile(np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32), (C, 1, 1))
    radii, means2d, depths, conics, _ = fully_fused_projection(
        *map(jnp.asarray, (means, quats, scales, viewmats, Ks)), W, H
    )
    opc = np.ascontiguousarray(np.broadcast_to(opac[None], (C, N)))
    return dict(
        diff=[np.array(means2d), np.array(conics), colors, opc],
        radii=np.array(radii), depths=np.array(depths),
        bg=rng.random((C, D)).astype(np.float32),
        wr=rng.standard_normal((C, H, W, D)).astype(np.float32),
        wa=rng.standard_normal((C, H, W, 1)).astype(np.float32),
    )


def _jax_grads(s, raster, **kw):
    def loss(*diff):
        r, a = raster(*diff, jnp.asarray(s["radii"]), jnp.asarray(s["depths"]), W, H, TS, **kw)[:2]
        return jnp.sum(r * s["wr"]) + jnp.sum(a * s["wa"])

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, s["diff"]))
    return [np.asarray(g) for g in grads]


def _port_grads(s, bg, binned=True):
    diff = [torch.tensor(a, requires_grad=True) for a in s["diff"]]
    radii, depths = torch.from_numpy(s["radii"]), torch.from_numpy(s["depths"])
    if binned:
        r, a, aux = trb.rasterize_to_pixels_binned(*diff, radii, depths, W, H, TS, CAP, backgrounds=bg)
        assert int(aux["n_isects"]) > 0
    else:
        r, a = rasterize_to_pixels_ref(*diff, radii, depths, W, H, TS, bg)
    ((r * torch.from_numpy(s["wr"])).sum() + (a * torch.from_numpy(s["wa"])).sum()).backward()
    return [t.grad.numpy() for t in diff]


def _close(got, want, name):
    s = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * s, err_msg=name)


@pytest.fixture(scope="module")
def scene():
    s = _scene(0, 150)
    bg = jnp.asarray(s["bg"])
    s["oracle"] = _jax_grads(s, lambda *a: jax_ref(*a, bg))
    return s


@pytest.mark.parametrize("cull", [False, True])
def test_binned_vjp_matches_jax(scene, cull):
    """Port binned gradients (background composited outside the Function)
    against JAX's binned VJP (interpret mode) with and without its tight
    cull, and against JAX's oracle VJP."""
    want = _jax_grads(
        scene, jrb.rasterize_to_pixels_binned, capacity=CAP,
        backgrounds=jnp.asarray(scene["bg"]), cull=cull,
    )
    got = _port_grads(scene, torch.from_numpy(scene["bg"]))
    for g, w, o, name in zip(got, want, scene["oracle"], NAMES):
        assert np.isfinite(g).all()
        _close(g, w, name)
        _close(g, o, name)


def test_port_oracle_vjp_matches_jax(scene):
    got = _port_grads(scene, torch.from_numpy(scene["bg"]), binned=False)
    for g, o, name in zip(got, scene["oracle"], NAMES):
        _close(g, o, name)


def test_absgrad_matches_jax():
    """The abs carrier's gradient (per-tile |d mean2d| summed over tiles)
    from the binned backward and from the port's oracle, against JAX's
    rasterize_to_pixels_ref_absgrad."""
    s = _scene(1, 120)
    zeros = np.zeros((C, D), np.float32)

    def loss(carrier):
        r, a = jax_ref_absgrad(
            *map(jnp.asarray, s["diff"]), jnp.asarray(s["radii"]), jnp.asarray(s["depths"]),
            W, H, TS, jnp.asarray(zeros), carrier,
        )
        return jnp.sum(r * s["wr"]) + jnp.sum(a * s["wa"])

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.zeros((C, 120, 2), jnp.float32)))
    assert (want > 0).any()
    T = lambda a: torch.from_numpy(a)  # noqa: E731
    for backend in ("binned", "oracle"):
        carrier = torch.zeros((C, 120, 2), requires_grad=True)
        if backend == "binned":
            r, a, _ = trb.rasterize_to_pixels_binned(
                *map(T, s["diff"]), T(s["radii"]), T(s["depths"]), W, H, TS, CAP,
                backgrounds=T(zeros), abs_carrier=(carrier[..., 0], carrier[..., 1]),
            )
        else:
            r, a = rasterize_to_pixels_ref_absgrad(
                *map(T, s["diff"]), T(s["radii"]), T(s["depths"]), W, H, TS, T(zeros), carrier,
            )
        ((r * T(s["wr"])).sum() + (a * T(s["wa"])).sum()).backward()
        np.testing.assert_allclose(carrier.grad.numpy(), want, rtol=1e-4, atol=1e-5, err_msg=backend)


def jax_reduce(rows, gids, n_out):
    """JAX's _reduce_call (interpret mode) on per-slot rows [R, M] and gids
    [M] in any order (n_out = the culled sentinel): the slots stably sorted
    by gid, as its caller does. Returns [R, n_out]."""
    n_rows, M = rows.shape
    order = np.argsort(gids, kind="stable")
    GR = -(-(1 + n_rows) // 8) * 8
    capA2 = -(-M // jrb.RK) * jrb.RK
    vg = np.zeros((GR, capA2), np.float32)
    vg[0] = float(1 << 24)
    vg[0, :M] = gids[order]
    vg[1 : 1 + n_rows, :M] = rows[:, order]
    gid_row = jnp.asarray(vg[0].astype(np.int32))
    return np.asarray(jrb._reduce_call(gid_row, jnp.asarray(vg), M=n_out, GR=GR, interpret=True))[1 : 1 + n_rows]


def two_pass_reduce(rows, dst, starts, n_out):
    """The reduce kernel's two passes (csrc/gid_reduce.cu) in torch: pass 1
    writes slot k's values as row dst[k] of a gid-ordered [M, Rp] scratch
    (Rp = trb.reduce_row_floats(R), zero-padded); pass 2 sums each
    Gaussian's rows [starts[g], starts[g+1]) front to back. Positions past
    starts[n_out] are never read."""
    R, M = rows.shape
    assert sorted(dst.tolist()) == list(range(M))  # a permutation of the slots
    assert starts.shape == (n_out + 1,) and int(starts[0]) == 0 and bool((starts.diff() >= 0).all())
    assert int(starts[-1]) <= M
    scratch = torch.zeros((M, trb.reduce_row_floats(R)), dtype=torch.float32)
    scratch[dst, :R] = rows.T
    out = torch.zeros((R, n_out), dtype=torch.float32)
    for g in range(n_out):
        for k in range(int(starts[g]), int(starts[g + 1])):
            out[:, g] += scratch[k, :R]
    return out


def assert_in_segments(dst, starts, gids, live):
    """Every live slot k lies inside the segment of its gid: starts[gids[k]]
    <= dst[k] < starts[gids[k] + 1]."""
    g = gids[live].to(torch.int64)
    d = dst[live]
    assert bool((starts[g] <= d).all()) and bool((d < starts[g + 1]).all())


@pytest.mark.parametrize("n_rows", [9, 13])
def test_reduce_plain_matches_jax(n_rows):
    """_reduce_plain against JAX's _reduce_call (interpret mode) on random
    gid-sorted rows with culled-sentinel slots at the end, and
    reduce_by_gid on the same slots in shuffled order."""
    rng = np.random.default_rng(n_rows)
    n_out, M = 1500, 3500
    gids = np.sort(rng.integers(0, n_out, M - 200)).astype(np.int32)
    gids = np.concatenate([gids, np.full(200, n_out, np.int32)])  # culled tail
    rows = rng.standard_normal((n_rows, M)).astype(np.float32)
    GR = -(-(1 + n_rows) // 8) * 8
    capA2 = -(-M // jrb.RK) * jrb.RK
    vg = np.zeros((GR, capA2), np.float32)
    vg[0] = float(1 << 24)
    vg[0, :M] = gids
    vg[1 : 1 + n_rows, :M] = rows
    gid_row = jnp.asarray(vg[0].astype(np.int32))
    want = np.asarray(jrb._reduce_call(gid_row, jnp.asarray(vg), M=n_out, GR=GR, interpret=True))[1 : 1 + n_rows]
    got = trb._reduce_plain(torch.from_numpy(rows), torch.from_numpy(gids), n_out)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    perm = rng.permutation(M)
    shuffled = trb.reduce_by_gid(torch.from_numpy(rows[:, perm]), torch.from_numpy(gids[perm]), n_out)
    np.testing.assert_allclose(shuffled.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (np.bincount(gids[gids < n_out], minlength=n_out) == 0).any()  # empty segments give 0
    # the kernel's two passes on the gids' sort (the route without a stream order)
    g_sh = torch.from_numpy(gids[perm])
    dst, starts = trb.gid_order(g_sh, n_out)
    assert_in_segments(dst, starts, g_sh, g_sh < n_out)
    emu = two_pass_reduce(torch.from_numpy(rows[:, perm]), dst, starts, n_out)
    np.testing.assert_allclose(emu.numpy(), want, rtol=1e-6, atol=1e-6)


def test_gid_segments():
    gids = torch.tensor([3, 0, 5, 3, 0, 3], dtype=torch.int32)  # 5 = culled sentinel
    perm, starts = trb.gid_segments(gids, 5)
    assert starts.tolist() == [0, 2, 2, 2, 5, 5]
    assert perm[:5].tolist() == [1, 4, 0, 3, 5]  # stable: stream order within a segment


def test_chunked_channels_vjp_matches_jax():
    """D = 40 through rasterization's channel_chunk (two binned calls, the
    alpha from the first) against JAX's oracle rasterization."""
    rng = np.random.default_rng(3)
    N, Cc, Dw = 150, 2, 40
    means = rng.standard_normal((N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.3 + 0.05).astype(np.float32)
    opac = rng.random((N,)).astype(np.float32)
    colors = rng.random((N, Dw)).astype(np.float32)
    vm = np.tile(np.eye(4, dtype=np.float32), (Cc, 1, 1))
    vm[:, 2, 3] = 4.0
    vm[1, 0, 3] = 0.3
    Ks = np.tile(np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32), (Cc, 1, 1))
    bg = rng.random((Cc, Dw)).astype(np.float32)
    wr = rng.standard_normal((Cc, H, W, Dw)).astype(np.float32)
    wa = rng.standard_normal((Cc, H, W, 1)).astype(np.float32)

    def jloss(m, c, o):
        r, a, _ = jax_rasterization(
            m, jnp.asarray(quats), jnp.asarray(scales), o, c, jnp.asarray(vm), jnp.asarray(Ks),
            W, H, backgrounds=jnp.asarray(bg), backend="oracle",
        )
        return jnp.sum(r * wr) + jnp.sum(a * wa)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*map(jnp.asarray, (means, colors, opac)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (means, colors, opac)]
    r, a, _ = rasterization(
        leaves[0], torch.from_numpy(quats), torch.from_numpy(scales), leaves[2], leaves[1],
        torch.from_numpy(vm), torch.from_numpy(Ks), W, H, backgrounds=torch.from_numpy(bg),
        backend="binned", isect_capacity=CAP, channel_chunk=32,
    )
    assert r.shape == (Cc, H, W, Dw)
    ((r * torch.from_numpy(wr)).sum() + (a * torch.from_numpy(wa)).sum()).backward()
    for t, w, name in zip(leaves, want, ("means", "colors", "opacities")):
        _close(t.grad.numpy(), np.asarray(w), name)


def test_plain_backward_chunking_is_exact(scene, monkeypatch):
    """Tile groups and entry chunks only split the back-to-front loop: tiny
    ones (products and sums carried across many chunk boundaries) give the
    default's rows within f32 rounding."""
    diff = [torch.from_numpy(a) for a in scene["diff"]]
    radii, depths = torch.from_numpy(scene["radii"]), torch.from_numpy(scene["depths"])
    _, T_out, last, binned = trb._raster_binned_fwd(*diff, radii, depths, W, H, TS, CAP)
    v_img = torch.from_numpy(scene["wr"])
    v_T = -torch.from_numpy(scene["wa"])[..., 0]
    args = (binned.entries, binned.offs, binned.cnts, T_out, last, v_img, v_T, C, W, H, TS, True)
    ref, pairs = trb._bwd_plain(*args)
    monkeypatch.setattr(trb, "PLAIN_TILE_GROUP", 2)
    monkeypatch.setattr(trb, "PLAIN_CHUNK", 5)
    small, pairs_small = trb._bwd_plain(*args)
    assert pairs == pairs_small and pairs[0] >= pairs[1] > 0
    for r in range(ref.shape[0]):
        s = max(float(ref[r].abs().max()), 1e-6)
        np.testing.assert_allclose(small[r].numpy(), ref[r].numpy(), rtol=1e-4, atol=1e-5 * s)
    np.testing.assert_array_equal(ref[-2:].numpy(), np.abs(ref[:2].numpy()))


def test_no_grad_path_launches_no_backward_and_matches():
    """Without a gradient the forward alone runs (background inside the
    forward); with one, the Function's image plus T * bg is the same."""
    s = _scene(2, 100)
    args = [torch.from_numpy(a) for a in s["diff"]] + [torch.from_numpy(s["radii"]), torch.from_numpy(s["depths"])]
    bg = torch.from_numpy(s["bg"])
    with torch.no_grad():
        r0, a0, aux0 = trb.rasterize_to_pixels_binned(*args, W, H, TS, CAP, backgrounds=bg)
    args[2] = args[2].clone().requires_grad_(True)
    r1, a1, aux1 = trb.rasterize_to_pixels_binned(*args, W, H, TS, CAP, backgrounds=bg)
    assert r1.requires_grad and a1.requires_grad
    np.testing.assert_allclose(r1.detach().numpy(), r0.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(a1.detach(), a0)
    assert int(aux1["n_isects"]) == int(aux0["n_isects"]) and aux1["slab_required"] == aux0["slab_required"]
    _backend.reset_launch_counts()
    r1.sum().backward()
    assert set(_backend.launch_counts().values()) == {0}


def test_kernel_wrappers_refuse_cpu_tensors():
    s = _scene(2, 100)
    args = [torch.from_numpy(a) for a in s["diff"]] + [torch.from_numpy(s["radii"]), torch.from_numpy(s["depths"])]
    _, T_out, last, b = trb._raster_binned_fwd(*args, W, H, TS, CAP)
    v_img = torch.zeros(C, H, W, D)
    with pytest.raises(ValueError, match="CUDA"):
        trb._bwd_cuda(b.entries, b.offs, b.cnts, T_out, last, v_img, T_out, C, W, H, TS)
    # the reduce on the stream's own order and on the gids' sort
    for order in (b.order, trb.gid_order(b.gids, C * 100)):
        with pytest.raises(ValueError, match="CUDA"):
            trb._reduce_cuda(torch.zeros(9, b.gids.shape[0]), *order, C * 100)


@pytest.fixture(scope="module")
def culled_stream():
    """tests/test_rasterize_binned.py's scene (C=2, 64x48) with N=1200, so
    that its 2,400 (camera, Gaussian) ids fill three emit blocks of 1,024,
    binned with the exact cull; per capacity (one that emits every block,
    one that truncates the last), the stream and the plain backward's slot
    rows for seeded cotangents, with absgrad."""
    from test_rasterize_binned import _scene as binned_scene

    Cs, Ws, Hs, N = 2, 64, 48, 1200
    radii, m2d, depths, conics, colors, opac = (
        np.asarray(x) for x in binned_scene(np.random.default_rng(4), N=N))
    mx, my = torch.from_numpy(m2d[..., 0].copy()), torch.from_numpy(m2d[..., 1].copy())
    con = [torch.from_numpy(conics[..., i].copy()) for i in range(3)]
    args = (mx, my, *con, torch.from_numpy(opac), torch.from_numpy(colors), torch.from_numpy(radii),
            torch.from_numpy(depths))
    full = tbin.bin_gaussians(*args, TS, 4, 3, capacity=1 << 16, cull=True)
    rng = np.random.default_rng(5)
    out = {}
    for cap in (1 << 16, full.slab_required - tbin.SB):
        b = tbin.bin_gaussians(*args, TS, 4, 3, capacity=cap, cull=True)
        _, T_out, last, _ = trb._fwd_plain(b.entries, b.offs, b.cnts, Cs, Ws, Hs, TS)
        v_img = torch.from_numpy(rng.standard_normal((Cs, Hs, Ws, 3)).astype(np.float32))
        v_T = torch.from_numpy(rng.standard_normal((Cs, Hs, Ws)).astype(np.float32))
        rows, _ = trb._bwd_plain(b.entries, b.offs, b.cnts, T_out, last, v_img, v_T, Cs, Ws, Hs, TS, True)
        out[cap] = (b, rows, Cs * N)
    return out


@pytest.mark.parametrize("which", ["full", "truncated"])
def test_binned_order_places_slots_in_segments(culled_stream, which):
    """The binned stream's own gid order (`Binned.order`, from the binning
    sort): a permutation of the slots with every live slot inside its
    Gaussian's segment, culled slots (past n_isects, zero rows) inside some
    segment; the kernel's two passes on it give index_add_'s sums and JAX's
    _reduce_call's; reduce_by_gid with the order equals the call without."""
    caps = sorted(culled_stream)
    b, rows, n_out = culled_stream[caps[-1] if which == "full" else caps[0]]
    M = b.gids.shape[0]
    n_isects = int(b.n_isects)
    assert n_isects < M  # the cull dropped entries; they sort past n_isects
    if which == "truncated":
        assert b.slab_required > caps[0] and 0 < M < culled_stream[caps[-1]][0].gids.shape[0]
    dst, starts = b.order
    live = torch.arange(M) < n_isects
    assert_in_segments(dst, starts, b.gids, live)
    assert bool((b.gids[~live] == n_out).all()) and bool((dst[~live] < starts[-1]).all())
    assert int(starts[-1]) == M  # every emitted slot has its place
    assert not rows[:, n_isects:].any()  # the culled slots' rows are zero
    want = trb._reduce_plain(rows, b.gids, n_out)
    np.testing.assert_allclose(two_pass_reduce(rows, dst, starts, n_out).numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(want.numpy(), jax_reduce(rows.numpy(), b.gids.numpy(), n_out),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(trb.reduce_by_gid(rows, b.gids, n_out, order=b.order),
                       trb.reduce_by_gid(rows, b.gids, n_out))
