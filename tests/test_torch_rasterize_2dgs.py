"""Port 2DGS rasterizers (gsplat_tpu_torch.ops.rasterize_2dgs_{ref,binned})
vs the JAX package.

The JAX binned 2DGS rasterizer runs its Pallas kernels in interpret mode on
the CPU; the port runs its kernels' plain torch versions. Same projected
inputs (seeded numpy, projected once by the JAX package), same seeded
cotangents. Tolerances:
- emit: the sorted 2DGS stream equal to JAX's, entry for entry;
- oracle (JAX's run eagerly: jitting it reorders its sums, by up to
  4.9e-5 in the depth channel): values within atol 1e-5 (depth-weighted
  outputs 1e-4: the distortion and the median carry the depth's
  magnitude), gradients within rtol 1e-4 and atol 1e-5 x the largest
  |gradient|;
- binned: the five outputs by count-based flip gates (max abs < 1e-2, a
  share < 1e-3 of values off by > 2e-4: the cross-product sigma flips a
  borderline alpha >= 1/255 acceptance between float orderings; the median
  is a selection output), gradients: 99.5% of values within rtol 1e-3
  and atol 1e-3 x max(1, the largest |gradient|), none off by more than
  0.05 x that (the gates of tests/test_rasterize_2dgs_tiled.py; an
  edge-on surfel's ray-transform gradient sums pixel-scaled terms that
  cancel, and JAX's own binned VJP moves a few such values by ~1% from
  its oracle);
- the plain versions' loop split: within f32 rounding of the default.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu.ops.binning import emit_entries as jax_emit
from gsplat_tpu.ops.binning import sort_entries as jax_sort
from gsplat_tpu.ops.projection_2dgs import fully_fused_projection_2dgs
from gsplat_tpu.ops.rasterize_2dgs_binned import rasterize_to_pixels_2dgs_binned as jax_binned
from gsplat_tpu.ops.rasterize_2dgs_ref import rasterize_to_pixels_2dgs_ref as jax_ref
from gsplat_tpu_torch import _backend
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.ops import rasterize_2dgs_binned as r2
from gsplat_tpu_torch.ops import rasterize_binned as trb
from gsplat_tpu_torch.ops.rasterize import rasterize_to_pixels_2dgs
from gsplat_tpu_torch.ops.rasterize_2dgs_ref import rasterize_to_pixels_2dgs_ref
import torch_prefetch as prefetch
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

N, C, W, H, CAP = 300, 2, 64, 48, 16384
# a ragged image: the last tile row holds 45 % ts pixel rows (5 at tile 8,
# 13 at tile 16), which the kernel's P pixels of a column a thread (2 at
# tile 8, 4 at 16) do not divide, and the last tile column 61 % ts
RAGGED_W, RAGGED_H, RAGGED_N = 61, 45, 120
NAMES = ("means2d", "ray_transforms", "colors", "normals", "opacities")
OUTS = ("colors", "alphas", "normals", "distort", "median")


def _scene(seed=0, W=W, H=H, N=N):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.3 + 0.05).astype(np.float32)
    opac = rng.random((N,)).astype(np.float32)
    colors = rng.random((C, N, 3)).astype(np.float32)
    vm = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    vm[:, 2, 3] = 4.0
    vm[1, 0, 3] = 0.3
    Ks = np.tile(np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32), (C, 1, 1))
    radii, means2d, depths, Ms, normals = fully_fused_projection_2dgs(
        *map(jnp.asarray, (means, quats, scales, vm, Ks)), W, H
    )
    depths = np.asarray(depths)
    cols = np.concatenate([colors, depths[..., None]], axis=-1)
    return dict(
        diff=[np.array(means2d), np.array(Ms), cols, np.array(normals),
              np.ascontiguousarray(np.broadcast_to(opac[None], (C, N)))],
        radii=np.array(radii), depths=depths,
        bg=rng.random((C, 4)).astype(np.float32),
        cot=[rng.standard_normal(s).astype(np.float32)
             for s in ((C, H, W, 4), (C, H, W, 1), (C, H, W, 3), (C, H, W, 1))],
    )


@pytest.fixture(scope="module")
def scene():
    return _scene(0)


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax(s, fn, ts, jit=True, **kw):
    """(outputs, gradients w.r.t. the five inputs of the weighted sum of the
    first four outputs), the background on; jitted unless told not to."""
    rd = (jnp.asarray(s["radii"]), jnp.asarray(s["depths"]))

    def run(*diff):
        return fn(*diff, *rd, W, H, ts, **kw)

    def loss(*diff):
        o = run(*diff)
        return sum(jnp.sum(x * w) for x, w in zip(o[:4], s["cot"]))

    diff = list(map(jnp.asarray, s["diff"]))
    grad = jax.grad(loss, argnums=(0, 1, 2, 3, 4))
    if jit:
        run, grad = jax.jit(run), jax.jit(grad)
    outs = [np.asarray(x) for x in run(*diff)[:5]]
    return outs, [np.asarray(g) for g in grad(*diff)]


def _port(s, fn, ts, **kw):
    leaves = [torch.tensor(a, requires_grad=True) for a in s["diff"]]
    o = fn(*leaves, _T(s["radii"]), _T(s["depths"]), W, H, ts, **kw)
    sum((x * _T(w)).sum() for x, w in zip(o[:4], s["cot"])).backward()
    return [x.detach().numpy() for x in o[:5]], [t.grad.numpy() for t in leaves], o


_ORACLES = {}


def _jax_oracle(scene, ts):
    """JAX's oracle at tile size `ts` (a surfel's support reaches past its
    radius, so the tile rectangle changes the image), computed once; at
    ts 16 eagerly, for test_oracle_2dgs_matches_jax's tight tolerances."""
    if ts not in _ORACLES:
        _ORACLES[ts] = _jax(scene, jax_ref, ts, jit=ts != 16, backgrounds=jnp.asarray(scene["bg"]))
    return _ORACLES[ts]


def _jax_refs():
    """JAX's oracle at tile sizes 16 and 32 and its binned backend at both,
    on _scene(0): {("oracle" | "binned", ts): (outputs, gradients)}."""
    scene = _scene(0)
    bg = jnp.asarray(scene["bg"])
    refs = {("oracle", ts): _jax_oracle(scene, ts) for ts in (16, 32)}
    refs.update({("binned", ts): _jax(scene, jax_binned, ts, capacity=CAP, backgrounds=bg) for ts in (16, 32)})
    return refs


# computed once per session in the background from collection on
# (tests/torch_prefetch.py): the eager oracle alone takes ~1 min
prefetch.start("rasterize_2dgs_refs", [os.path.abspath(__file__), "--refs"])


@pytest.fixture(scope="module")
def jax_refs():
    return prefetch.result("rasterize_2dgs_refs")


@pytest.fixture(scope="module")
def jax_oracle(jax_refs):
    return jax_refs[("oracle", 16)]


@pytest.fixture(scope="module", params=[16, 32])
def jax_binned_ref(jax_refs, request):
    """(ts, JAX binned, JAX oracle) at tile size ts."""
    ts = request.param
    return ts, jax_refs[("binned", ts)], jax_refs[("oracle", ts)]


def _flip_gate(got, want, name):
    d = np.abs(got - want)
    assert d.max() < 1e-2, f"{name} max {d.max():.2e}"
    assert (d > 2e-4).mean() < 1e-3, f"{name} flips {(d > 2e-4).mean():.2%}"


def _grad_close(got, want, name):
    """99.5% of values within rtol 1e-3 + atol 1e-3 x scale, none off by more
    than 0.05 x scale (scale = max(1, max |want|))."""
    s = max(float(np.abs(want).max()), 1.0)
    assert np.isfinite(got).all(), name
    d = np.abs(got - want)
    off = d > 1e-3 * np.abs(want) + 1e-3 * s
    assert off.mean() <= 5e-3, f"{name}: {off.sum()} of {off.size} values off, max abs {d.max():.3e}"
    assert d.max() <= 0.05 * s, f"{name}: max abs {d.max():.3e} against scale {s:.3e}"


def test_oracle_2dgs_matches_jax(scene, jax_oracle):
    outs, grads, _ = _port(scene, rasterize_to_pixels_2dgs_ref, 16, backgrounds=_T(scene["bg"]))
    want_o, want_g = jax_oracle
    for got, want, name in zip(outs, want_o, OUTS):
        atol = 1e-4 if name in ("distort", "median") else 1e-5
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=name)
    for got, want, name in zip(grads, want_g, NAMES):
        s = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * s, err_msg=name)


def test_binned_2dgs_matches_jax(scene, jax_binned_ref):
    """Port binned (emit -> sort -> plain forward; plain backward -> gid
    reduce) against JAX's binned VJP in interpret mode, at ts 16 and 32,
    and against JAX's oracle; gradients include the distortion's."""
    ts, (want_o, want_g), jax_oracle = jax_binned_ref
    outs, grads, o = _port(
        scene, r2.rasterize_to_pixels_2dgs_binned, ts, capacity=CAP, backgrounds=_T(scene["bg"])
    )
    assert int(o[5]["n_isects"]) > 0 and o[5]["slab_required"] >= int(o[5]["n_isects"])
    for got, want, oracle, name in zip(outs, want_o, jax_oracle[0], OUTS):
        _flip_gate(got, want, name)
        _flip_gate(got, oracle, name + " vs oracle")
    for got, want, oracle, name in zip(grads, want_g, jax_oracle[1], NAMES):
        _grad_close(got, want, name)
        _grad_close(got, oracle, name + " vs oracle")


@pytest.mark.parametrize("ts", [16, 32])
def test_emit_2dgs_payload_matches_jax(scene, ts):
    """The 2DGS stream: JAX's emit_entries(payload_rows=..., cull=False) and
    sort_entries against the port's bin_gaussians with the same payload,
    at tile sizes 16 and 32."""
    m2d, Ms, cols, nrm, opc = scene["diff"]
    rows = [m2d[..., 0], m2d[..., 1]] + [Ms[..., r, c] for r in range(3) for c in range(3)]
    rows += [opc] + [cols[..., d] for d in range(4)] + [nrm[..., d] for d in range(3)]
    tw, th = -(-W // ts), -(-H // ts)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    ops, slab = jax_emit(
        j(rows[0]), j(rows[1]), None, None, None, None, None, j(scene["radii"]), j(scene["depths"]),
        ts, tw, th, capacity=CAP, cull=False, payload_rows=[j(r) for r in rows],
    )
    want = jax_sort(ops, C * tw * th, slab)
    got = binning.bin_gaussians(
        _T(rows[0]), _T(rows[1]), None, None, None, None, None, _T(scene["radii"]), _T(scene["depths"]),
        ts, tw, th, capacity=CAP, cull=False, payload_rows=[_T(r) for r in rows],
    )
    n = int(want.n_isects)
    assert n > 0 and int(got.n_isects) == n
    assert got.slab_required == int(want.slab_required)
    np.testing.assert_array_equal(got.offs.numpy(), np.asarray(want.offs))
    np.testing.assert_array_equal(got.cnts.numpy(), np.asarray(want.cnts))
    np.testing.assert_array_equal(got.gids[:n].numpy(), np.asarray(want.gids)[0, :n])
    np.testing.assert_array_equal(got.entries[:, :n].numpy(), np.asarray(want.entries)[:, :n])
    assert got.entries.shape[0] == 19


def test_custom_payload_needs_no_cull(scene):
    m2d = _T(scene["diff"][0])
    with pytest.raises(ValueError, match="cull=False"):
        binning.plan_emit(
            m2d[..., 0], m2d[..., 1], None, None, None, None, None, _T(scene["radii"]),
            _T(scene["depths"]), 16, 4, 3, CAP, cull=True, payload_rows=[m2d[..., 0]],
        )
    # a payload of fewer rows than the 3DGS layout's six needs no cull rows
    plan, _ = binning.plan_emit(
        m2d[..., 0], m2d[..., 1], None, None, None, None, None, _T(scene["radii"]),
        _T(scene["depths"]), 16, 4, 3, CAP, cull=False, payload_rows=[m2d[..., 0]],
    )
    keys, gids = binning._emit_plain(plan)
    assert keys.shape == gids.shape == (plan.n_emit,) and (gids < C * N).all()
    assert plan.nf == 1 and plan.packed.shape == (C * N, binning.ROW_ALIGN)
    b = binning.sort_entries((keys, gids), plan.packed, plan.nf, C * 4 * 3, 0)
    assert b.entries.shape == (1, plan.n_emit)
    assert torch.equal(b.entries[0], m2d[..., 0].reshape(-1)[b.gids.to(torch.int64)])


def test_rasterize_to_pixels_2dgs_dispatch(scene):
    args = [_T(a) for a in scene["diff"]] + [_T(scene["radii"]), _T(scene["depths"]), W, H, 16]
    with torch.no_grad():
        o_auto = rasterize_to_pixels_2dgs(*args)
        o_ref = rasterize_to_pixels_2dgs_ref(*args)
        o_bin = rasterize_to_pixels_2dgs(*args, capacity=CAP)
    assert o_auto[5] == {}
    for a, b in zip(o_auto[:5], o_ref):
        assert torch.equal(a, b)
    assert int(o_bin[5]["n_isects"]) > 0
    for got, want, name in zip(o_bin[:5], o_ref, OUTS):
        _flip_gate(got.numpy(), want.numpy(), name)
    # the tiled backend, which raised until its slice: the binned stream's
    # entries in the same order, so the same outputs
    with torch.no_grad():
        o_til = rasterize_to_pixels_2dgs(*args, capacity=CAP, backend="tiled")
    assert set(o_til[5]) == {"n_isects"} and int(o_til[5]["n_isects"]) == int(o_bin[5]["n_isects"])
    for a, b in zip(o_til[:5], o_bin[:5]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="capacity"):
        rasterize_to_pixels_2dgs(*args, backend="binned")
    cols = torch.zeros(C, N, 33)
    with pytest.raises(ValueError, match="colour channels"):
        r2.rasterize_to_pixels_2dgs_binned(*args[:2], cols, *args[3:], capacity=CAP)


def _stream(scene, ts=16):
    diff = [_T(a) for a in scene["diff"]]
    Ms = diff[1].reshape(C, N, 9)
    return r2._raster_2dgs_fwd(
        diff[0][..., 0], diff[0][..., 1], Ms, diff[4], diff[2], diff[3],
        _T(scene["radii"]), _T(scene["depths"]), W, H, ts, CAP,
    )


_RAGGED = {}


def ragged_case(ts):
    """(the ragged scene, JAX's eager oracle's five outputs at tile size
    ts), computed once per ts. The oracle, not JAX's binned or tiled
    kernels: on this seeded scene those (in interpret mode) round the
    cancelling cross products otherwise and put 0.25% of the colour values
    more than 2e-4 from JAX's own oracle, past the flip gate, where the
    port's kernels' plain versions put 0.07%."""
    if ts not in _RAGGED:
        s = _scene(1, W=RAGGED_W, H=RAGGED_H, N=RAGGED_N)
        args = map(jnp.asarray, s["diff"] + [s["radii"], s["depths"]])
        want = jax_ref(*args, RAGGED_W, RAGGED_H, ts, backgrounds=jnp.asarray(s["bg"]))
        _RAGGED[ts] = s, [np.asarray(x) for x in want[:5]]
    return _RAGGED[ts]


@pytest.mark.parametrize("ts", [8, 16])
def test_binned_2dgs_forward_ragged_matches_jax(ts):
    """The binned forward (emit -> sort -> the forward kernel's plain
    version) on a ragged image, where chip_smoke.py holds the kernel to
    this plain version, against JAX's oracle: the five outputs by the flip
    gates."""
    s, want = ragged_case(ts)
    with torch.no_grad():
        got = r2.rasterize_to_pixels_2dgs_binned(*map(_T, s["diff"] + [s["radii"], s["depths"]]), RAGGED_W,
                                                 RAGGED_H, ts, capacity=CAP, backgrounds=_T(s["bg"]))
    assert int(got[5]["n_isects"]) > 0
    for g, w, name in zip(got[:5], want, OUTS):
        assert tuple(g.shape) == w.shape, name
        _flip_gate(g.numpy(), w, name)


def test_plain_chunking_is_exact(scene, monkeypatch):
    """Tile groups and entry chunks only split the plain versions' loops:
    tiny ones (T, the distortion's sums, the median and the backward's
    carries crossing many chunk boundaries) give the default's outputs and
    rows within f32 rounding."""
    feat, T_out, last, dist, med, b = _stream(scene)
    fargs = (b.entries, b.offs, b.cnts, C, W, H, 16)
    cot = [_T(c) for c in scene["cot"]]
    v_feat = torch.cat([cot[0], cot[2]], dim=-1)
    bargs = (b.entries, b.offs, b.cnts, T_out, last, feat[..., 3].contiguous(), v_feat,
             -cot[1][..., 0], cot[3][..., 0], C, W, H, 16)
    ref_f = r2._fwd2_plain(*fargs)
    ref_b, pairs = r2._bwd2_plain(*bargs)
    monkeypatch.setattr(trb, "PLAIN_TILE_GROUP", 2)
    monkeypatch.setattr(trb, "PLAIN_CHUNK", 5)
    small_f = r2._fwd2_plain(*fargs)
    small_b, pairs_small = r2._bwd2_plain(*bargs)
    assert pairs == pairs_small and pairs[0] >= pairs[1] > 0
    assert ref_f[5] == small_f[5] > 0
    assert torch.equal(ref_f[2], small_f[2]) and torch.equal(ref_f[4], small_f[4])
    for i in (0, 1, 3):
        np.testing.assert_allclose(small_f[i].numpy(), ref_f[i].numpy(), rtol=1e-5, atol=1e-5)
    for r in range(ref_b.shape[0]):
        s = max(float(ref_b[r].abs().max()), 1e-6)
        np.testing.assert_allclose(small_b[r].numpy(), ref_b[r].numpy(), rtol=1e-4, atol=1e-4 * s)


def test_no_grad_path_matches_and_launches_nothing(scene):
    args = [_T(a) for a in scene["diff"]] + [_T(scene["radii"]), _T(scene["depths"]), W, H, 16, CAP]
    bg = _T(scene["bg"])
    _backend.reset_launch_counts()
    with torch.no_grad():
        o0 = r2.rasterize_to_pixels_2dgs_binned(*args, backgrounds=bg)
    args[2] = args[2].clone().requires_grad_(True)
    o1 = r2.rasterize_to_pixels_2dgs_binned(*args, backgrounds=bg)
    assert o1[0].requires_grad and not o1[4].requires_grad
    for a, b in zip(o0[:5], o1[:5]):
        assert torch.equal(a, b.detach())
    assert int(o0[5]["n_isects"]) == int(o1[5]["n_isects"])
    (o1[0].sum() + o1[3].sum()).backward()
    assert set(_backend.launch_counts().values()) == {0}
    assert not _backend.BUILD_LOG


def test_kernel_wrappers_refuse_cpu_tensors(scene):
    feat, T_out, last, dist, med, b = _stream(scene)
    with pytest.raises(ValueError, match="CUDA"):
        r2._fwd2_cuda(b.entries, b.offs, b.cnts, C, W, H, 16)
    with pytest.raises(ValueError, match="CUDA"):
        r2._bwd2_cuda(b.entries, b.offs, b.cnts, T_out, last, dist, feat, T_out, dist, C, W, H, 16)


if __name__ == "__main__" and sys.argv[1:2] == ["--refs"]:
    prefetch.as_test_process()
    prefetch.write(sys.argv[sys.argv.index("--out") + 1], _jax_refs())
