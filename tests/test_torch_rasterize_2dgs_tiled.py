"""Port tiled 2DGS rasterizer (gsplat_tpu_torch.ops.rasterize_2dgs_tiled)
vs the JAX package's.

The JAX rasterize_to_pixels_2dgs_tiled runs its Pallas kernels in
interpret mode on the CPU, so its outputs and its VJP for seeded
cotangents are computed once, in a module-scoped fixture; the port runs
its kernels' plain torch versions. Same inputs: the 2DGS scene of
tests/test_torch_rasterize_2dgs.py (N=300, C=2, 64x48, projected by the
JAX package, a background on), each package's own `isect_tiles`; and
`rasterization_2dgs` on tests/test_torch_rendering_2dgs.py's scene.
Tolerances: the count gates of tests/test_rasterize_2dgs_tiled.py
(`_mostly_close`: 99.5% of values within atol, per-output caps; the
cross-product sigma flips a borderline alpha >= 1/255 acceptance between
float orderings, and the median is a selection output). Against the
port's own binned 2DGS backend, whose stream holds the same entries in the
same order, outputs are equal and gradients within rtol 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu.ops.isect import isect_tiles as jax_isect
from gsplat_tpu.ops.projection_2dgs import fully_fused_projection_2dgs as jax_proj_2dgs
from gsplat_tpu.ops.rasterize_2dgs_tiled import rasterize_to_pixels_2dgs_tiled as jax_tiled
from gsplat_tpu.rendering import rasterization_2dgs as jax_r2
from gsplat_tpu_torch import _backend, rasterization_2dgs
from gsplat_tpu_torch.ops import rasterize_2dgs_tiled as r2t
from gsplat_tpu_torch.ops.isect import isect_tiles
from gsplat_tpu_torch.ops.rasterize import rasterize_to_pixels_2dgs
from gsplat_tpu_torch.ops.rasterize_2dgs_binned import rasterize_to_pixels_2dgs_binned
from gsplat_tpu_torch.ops.rasterize_tiled import pack_rows, stream_ranges

from test_rasterize_2dgs_tiled import _mostly_close
from test_torch_rasterize_2dgs import C, H, NAMES, RAGGED_H, RAGGED_W, W, _flip_gate, _scene, ragged_case
from test_torch_rasterize_2dgs import OUTS as OUTS_2DGS
from test_torch_rendering_2dgs import CASES, _args, _inputs, _kw
from test_torch_rendering_2dgs import H as R2_H
from test_torch_rendering_2dgs import OUTS as R2_OUTS
from test_torch_rendering_2dgs import W as R2_W
from test_torch_rendering_2dgs import _flip_gate as _r2_flip_gate
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

TS, TW, TH, CAP = 16, 4, 3, 16384
# per output: atol, max abs (tests/test_rasterize_2dgs_tiled.py)
OUT_GATES = {"colors": (2e-4, 6e-3), "alphas": (1e-4, 6e-3), "normals": (1e-4, 6e-3),
             "distort": (5e-4, 5e-2), "median": (1e-5, 5.0)}


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def ref():
    """The scene and JAX's five outputs and five input gradients (the
    weighted sum of the first four outputs; the median takes none)."""
    s = _scene(0)
    diff = [jnp.asarray(a) for a in s["diff"]]
    isect = jax_isect(diff[0], jnp.asarray(s["radii"]), jnp.asarray(s["depths"]), TS, TW, TH, CAP)

    def run(*d):
        return jax_tiled(*d, W, H, TS, isect, backgrounds=jnp.asarray(s["bg"]))

    outs, vjp = jax.vjp(run, *diff)
    cot = tuple(jnp.asarray(c) for c in s["cot"]) + (jnp.zeros((C, H, W, 1)),)
    s["outs"] = [np.asarray(x) for x in outs]
    s["grads"] = [np.asarray(g) for g in vjp(cot)]
    s["n_isects"] = int(isect.n_isects)
    return s


def _port(s, fn=r2t.rasterize_to_pixels_2dgs_tiled, grad=True):
    """(outputs, input gradients of the weighted sum, the record)."""
    leaves = [_T(a).requires_grad_(grad) for a in s["diff"]]
    isect = isect_tiles(leaves[0], _T(s["radii"]), _T(s["depths"]), TS, TW, TH, CAP)
    if fn is rasterize_to_pixels_2dgs_binned:
        o = fn(*leaves, _T(s["radii"]), _T(s["depths"]), W, H, TS, CAP, backgrounds=_T(s["bg"]))
    else:
        o = fn(*leaves, W, H, TS, isect, backgrounds=_T(s["bg"]))
    if grad:
        sum((x * _T(w)).sum() for x, w in zip(o[:4], s["cot"])).backward()
    return [x.detach() for x in o[:5]], [t.grad for t in leaves], isect


def test_2dgs_tiled_matches_jax(ref):
    outs, _, isect = _port(ref, grad=False)
    assert int(isect.n_isects) == ref["n_isects"] > 0
    for got, want, (name, (atol, mx)) in zip(outs, ref["outs"], OUT_GATES.items()):
        assert got.shape == want.shape, name
        _mostly_close(got.numpy(), want, atol=atol, max_abs=mx)


def test_2dgs_tiled_vjp_matches_jax(ref):
    """Gradients w.r.t. means2d, the ray transforms, colours (with the
    depth), normals and opacities through _Tiled2DGS (plain backward + gid
    reduce), the distortion's included."""
    _, grads, _ = _port(ref)
    for name, got, want in zip(NAMES, grads, ref["grads"]):
        s = max(float(np.abs(want).max()), 1.0)
        assert np.isfinite(got.numpy()).all(), name
        _mostly_close(got.numpy(), want, atol=2e-3 * s, frac=0.995, max_abs=0.05 * s)


def test_2dgs_tiled_equals_binned(ref):
    """The binned 2DGS stream (no cull) holds the same entries in the same
    (tile, depth, gid) order: equal outputs, the same gradients."""
    o_t, g_t, _ = _port(ref)
    o_b, g_b, _ = _port(ref, rasterize_to_pixels_2dgs_binned)
    for a, b in zip(o_t, o_b):
        assert torch.equal(a, b)
    for name, a, b in zip(NAMES, g_t, g_b):
        s = max(float(b.abs().max()), 1e-6)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5 * s, err_msg=name)


def test_rasterization_2dgs_tiled_matches_jax():
    """rasterization_2dgs(backend="tiled") end to end (SH, RGB+ED, a
    background, the distortion on, two cameras):
    - equal to the port's binned backend, which
      tests/test_torch_rendering_2dgs.py holds to JAX's eager oracle;
    - against JAX's oracle, jitted (the eager one takes ~20 s here), by
      that file's flip gates; not the normals from depth, which difference
      the depth and so amplify the jitted oracle's reordered sums (JAX's
      own tiled kernels, run in interpret mode, round the cancelling cross
      products otherwise and sit up to 5e-3 from the oracle at a few
      pixels of this scene; the port's, 8.6e-4);
    - the meta keys of JAX's tiled backend: n_isects from JAX's isect_tiles
      on JAX's projection, the capacity, no slab_required."""
    scene = _inputs(0)
    colors, kw = CASES["RGB+ED-sh3-bg-distloss"]
    targs = _args(scene, colors, torch.from_numpy)
    with torch.no_grad():
        got = rasterization_2dgs(*targs, backend="tiled", isect_capacity=8192, **_kw(scene, kw, torch.from_numpy))
        binned = rasterization_2dgs(*targs, backend="binned", isect_capacity=8192, **_kw(scene, kw, torch.from_numpy))
    for g, b, name in zip(got[:6], binned[:6], R2_OUTS):
        assert torch.equal(g, b), name
    jkw = _kw(scene, kw, jnp.asarray)
    bg = jkw.pop("backgrounds")
    oracle = jax.jit(lambda *a: jax_r2(*a[:7], R2_W, R2_H, backend="oracle", backgrounds=a[7], **jkw)[:6])
    want = oracle(*_args(scene, colors, jnp.asarray)[:7], bg)
    for g, w, name in zip(got[:6], want, R2_OUTS):
        assert tuple(g.shape) == w.shape, name
        if name != "normals_from_depth":
            _r2_flip_gate(g.numpy(), np.asarray(w), name)
    radii, m2d, depths, _, _ = jax_proj_2dgs(
        *map(jnp.asarray, (scene["means"], scene["quats"], scene["scales"], scene["viewmats"], scene["Ks"])),
        R2_W, R2_H)
    jisect = jax_isect(m2d, radii, depths, 16, 3, 2, 8192)
    assert int(got[6]["n_isects"]) == int(jisect.n_isects) > 0
    assert got[6]["isect_capacity"] == 8192 and "slab_required" not in got[6]


@pytest.mark.parametrize("ts", [8, 16])
def test_2dgs_tiled_forward_ragged_matches_jax(ts):
    """The tiled forward (the port's isect_tiles -> the forward kernel's
    plain version) on the ragged image of
    tests/test_torch_rasterize_2dgs.py, where chip_smoke.py holds the
    kernel to this plain version, against JAX's oracle by that file's flip
    gates (ragged_case says why the oracle)."""
    s, want = ragged_case(ts)
    leaves = [_T(a) for a in s["diff"]]
    isect = isect_tiles(leaves[0], _T(s["radii"]), _T(s["depths"]), ts, -(-RAGGED_W // ts), -(-RAGGED_H // ts),
                        CAP)
    with torch.no_grad():
        got = r2t.rasterize_to_pixels_2dgs_tiled(*leaves, RAGGED_W, RAGGED_H, ts, isect, backgrounds=_T(s["bg"]))
    assert int(isect.n_isects) > 0
    for g, w, name in zip(got[:5], want, OUTS_2DGS):
        assert tuple(g.shape) == w.shape, name
        _flip_gate(g.numpy(), w, name)


def test_rasterize_to_pixels_2dgs_tiled_dispatch(ref):
    args = [_T(a) for a in ref["diff"]] + [_T(ref["radii"]), _T(ref["depths"]), W, H, TS]
    with torch.no_grad():
        o = rasterize_to_pixels_2dgs(*args, capacity=CAP, backgrounds=_T(ref["bg"]), backend="tiled")
    outs, _, _ = _port(ref, grad=False)
    assert set(o[5]) == {"n_isects"} and int(o[5]["n_isects"]) == ref["n_isects"]
    for a, b in zip(o[:5], outs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="capacity"):
        rasterize_to_pixels_2dgs(*args, backend="tiled")


def test_2dgs_tiled_empty_scene(ref):
    """Every radius 0: the background alone, no coverage, no distortion,
    zero gradients."""
    leaves = [_T(a).requires_grad_(True) for a in ref["diff"]]
    radii = torch.zeros(leaves[4].shape, dtype=torch.int32)
    isect = isect_tiles(leaves[0], radii, _T(ref["depths"]), TS, TW, TH, CAP)
    assert isect.flatten_ids.shape == (0,)
    o = r2t.rasterize_to_pixels_2dgs_tiled(*leaves, W, H, TS, isect, backgrounds=_T(ref["bg"]))
    sum(x.sum() for x in o[:4]).backward()
    assert torch.equal(o[0].detach(), _T(ref["bg"])[:, None, None, :].expand(C, H, W, 4))
    for x in o[1:]:
        assert not x.detach().any()
    assert not any(t.grad.any() for t in leaves)


def test_no_grad_path_matches_and_launches_nothing(ref):
    _backend.reset_launch_counts()
    o0, _, _ = _port(ref, grad=False)
    o1, _, _ = _port(ref)
    for a, b in zip(o0, o1):
        assert torch.equal(a, b)
    assert set(_backend.launch_counts().values()) == {0}
    assert not _backend.BUILD_LOG


def test_kernel_wrappers_refuse_cpu_tensors(ref):
    m2d, Ms, cols, nrm, opc = (_T(a) for a in ref["diff"])
    isect = isect_tiles(m2d, _T(ref["radii"]), _T(ref["depths"]), TS, TW, TH, CAP)
    offs, cnts = stream_ranges(isect)
    packed = pack_rows(r2t.surfel_payload(m2d[..., 0], m2d[..., 1], Ms.reshape(C, -1, 9), opc, cols, nrm))
    assert packed.shape[1] == 24  # 12 + L = 19 rows, 96 bytes
    ids = isect.flatten_ids
    with pytest.raises(ValueError, match="CUDA"):
        r2t._tiled2_fwd_cuda(packed, 7, ids, offs, cnts, C, W, H, TS)
    feat, T, last, dist, _, _ = r2t._tiled2_fwd_plain(packed, 7, ids, offs, cnts, C, W, H, TS)
    with pytest.raises(ValueError, match="CUDA"):
        r2t._tiled2_bwd_cuda(packed, 7, ids, offs, cnts, T, last, dist, feat, T, dist, C, W, H, TS)
