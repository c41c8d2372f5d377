"""Port tiled rasterizer (gsplat_tpu_torch.ops.rasterize_tiled) vs the JAX
package's.

The JAX rasterize_to_pixels_tiled runs its Pallas kernels in interpret mode
on the CPU (seconds a call), so each JAX reference is computed once, in a
module-scoped fixture; the port runs its kernels' plain torch versions.
Same inputs: tests/test_rasterize_tiled.py's `_scene` (N=250, C=2, 64x48,
projected by the JAX package), the intersection record built by each
package's own `isect_tiles`. Tolerances (those of tests/test_rasterize_tiled.py):
- forward, D = 3 and 8, with and without a background: atol 2e-5, rtol
  1e-5 (JAX returns exp(log T), the port T: about one ulp apart);
- gradients for seeded cotangents: atol 1e-3 x max(1, max |JAX|), rtol
  1e-3;
- the absgrad statistic: rtol 1e-4, atol 1e-5;
- `rasterization(backend="tiled")`: atol 2e-4, rtol 1e-3 (RGB+ED divides
  the depth channel by alpha).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu import rasterization as jax_rasterization
from gsplat_tpu.ops.isect import isect_tiles as jax_isect
from gsplat_tpu.ops.rasterize_tiled import rasterize_to_pixels_tiled as jax_tiled
from gsplat_tpu_torch import _backend, rasterization
from gsplat_tpu_torch.ops import rasterize_tiled as rt
from gsplat_tpu_torch.ops.isect import isect_tiles
from gsplat_tpu_torch.ops.rasterize import rasterize_to_pixels
from gsplat_tpu_torch.ops.rasterize_ref import rasterize_to_pixels_ref

from test_rasterize_tiled import _scene
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

C, W, H, TS, CAP = 2, 64, 48, 16, 8192
TW, TH = 4, 3
FWD = dict(atol=2e-5, rtol=1e-5)
NAMES = ("means2d", "conics", "colors", "opacities")


def _T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ref():
    """Per D in (3, 8): the scene, a background, seeded cotangents and JAX's
    outputs: the forward without a background (D = 3 and 8), with one
    (D = 8), and at D = 3 one VJP with the background and an absgrad
    carrier, whose forward is the D = 3 background case."""
    rng = np.random.default_rng(0)
    out = {}
    for D in (3, 8):
        radii, m2d, depths, conics, colors, opac = _scene(rng, D=D)
        bg = rng.random((C, D)).astype(np.float32)
        isect = jax_isect(m2d, radii, depths, TS, TW, TH, capacity=CAP)
        r = dict(scene=[np.asarray(x) for x in (m2d, conics, colors, opac, radii, depths)], bg=bg,
                 n_isects=int(isect.n_isects))
        r["fwd", False] = [np.asarray(x) for x in jax_tiled(m2d, conics, colors, opac, W, H, TS, isect)]
        if D == 8:
            r["fwd", True] = [np.asarray(x) for x in jax_tiled(
                m2d, conics, colors, opac, W, H, TS, isect, backgrounds=jnp.asarray(bg))]
        else:
            wr = rng.standard_normal((C, H, W, D)).astype(np.float32)
            wa = rng.standard_normal((C, H, W, 1)).astype(np.float32)

            def run(m, c, col, o, car):
                return jax_tiled(m, c, col, o, W, H, TS, isect, backgrounds=jnp.asarray(bg),
                                 abs_carrier=(car[..., 0], car[..., 1]))

            outs, vjp = jax.vjp(run, m2d, conics, colors, opac, jnp.zeros_like(m2d))
            r["fwd", True] = [np.asarray(x) for x in outs]
            r["grads"] = [np.asarray(g) for g in vjp((jnp.asarray(wr), jnp.asarray(wa)))]
            r["cot"] = (wr, wa)
        out[D] = r
    return out


def _port(r, bg=None, abs_carrier=False, grad=False):
    m2d, conics, colors, opac, radii, depths = (_T(a) for a in r["scene"])
    isect = isect_tiles(m2d, radii, depths, TS, TW, TH, CAP)
    leaves = [m2d, conics, colors, opac, torch.zeros_like(m2d)]
    if grad:
        for t in leaves:
            t.requires_grad_(True)
    carrier = (leaves[4][..., 0], leaves[4][..., 1]) if abs_carrier else None
    img, alpha = rt.rasterize_to_pixels_tiled(
        leaves[0], leaves[1], leaves[2], leaves[3], W, H, TS, isect,
        backgrounds=None if bg is None else _T(bg), abs_carrier=carrier,
    )
    return img, alpha, isect, leaves


@pytest.mark.parametrize("D", [3, 8])
@pytest.mark.parametrize("use_bg", [False, True])
def test_tiled_forward_matches_jax(ref, D, use_bg):
    r = ref[D]
    with torch.no_grad():
        img, alpha, isect, _ = _port(r, bg=r["bg"] if use_bg else None)
    assert int(isect.n_isects) == r["n_isects"] > 0
    assert tuple(img.shape) == (C, H, W, D) and tuple(alpha.shape) == (C, H, W, 1)
    want_img, want_alpha = r["fwd", use_bg]
    np.testing.assert_allclose(img.numpy(), want_img, **FWD)
    np.testing.assert_allclose(alpha.numpy(), want_alpha, **FWD)
    # the port's oracle agrees too
    m2d, conics, colors, opac, radii, depths = (_T(a) for a in r["scene"])
    with torch.no_grad():
        img_o, alpha_o = rasterize_to_pixels_ref(
            m2d, conics, colors, opac, radii, depths, W, H, TS, _T(r["bg"]) if use_bg else None)
    np.testing.assert_allclose(img.numpy(), img_o.numpy(), **FWD)
    np.testing.assert_allclose(alpha.numpy(), alpha_o.numpy(), **FWD)


def test_tiled_vjp_matches_jax(ref):
    """Gradients w.r.t. means2d, conics, colours and opacities (the
    background on), through _TiledRaster: plain backward + gid reduce."""
    r = ref[3]
    img, alpha, _, leaves = _port(r, bg=r["bg"], abs_carrier=True, grad=True)
    np.testing.assert_allclose(img.detach().numpy(), r["fwd", True][0], **FWD)
    wr, wa = r["cot"]
    ((img * _T(wr)).sum() + (alpha * _T(wa)).sum()).backward()
    for name, t, want in zip(NAMES, leaves, r["grads"]):
        s = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-3 * s, rtol=1e-3, err_msg=name)


def test_tiled_absgrad_matches_jax(ref):
    """The carrier's gradient is the per-tile |d mean2d| summed over tiles,
    as JAX's; it is >= |the mean's gradient| and leaves the forward and the
    other gradients as they are without it."""
    r = ref[3]
    img, alpha, _, leaves = _port(r, bg=r["bg"], abs_carrier=True, grad=True)
    wr, wa = r["cot"]
    ((img * _T(wr)).sum() + (alpha * _T(wa)).sum()).backward()
    got = leaves[4].grad.numpy()
    np.testing.assert_allclose(got, r["grads"][4], rtol=1e-4, atol=1e-5)
    assert (got >= 0).all() and (got - np.abs(leaves[0].grad.numpy()) >= -1e-5).all()
    img0, alpha0, _, leaves0 = _port(r, bg=r["bg"], grad=True)
    assert torch.equal(img0, img)
    ((img0 * _T(wr)).sum() + (alpha0 * _T(wa)).sum()).backward()
    np.testing.assert_allclose(leaves0[0].grad.numpy(), leaves[0].grad.numpy(), atol=1e-6)


def test_tiled_empty_scene():
    """Every radius 0: an empty stream, the background alone and zero
    gradients (what tests/test_rasterize_tiled.py::test_tiled_empty_scene
    holds JAX's tiled backend to)."""
    N, D = 16, 3
    m2d = torch.zeros((1, N, 2), requires_grad=True)
    conics = torch.tensor([1.0, 0.0, 1.0]).repeat(1, N, 1)
    colors, opac = torch.ones((1, N, D)), torch.full((1, N), 0.5)
    radii, depths = torch.zeros((1, N), dtype=torch.int32), torch.ones((1, N))
    isect = isect_tiles(m2d, radii, depths, 16, 2, 2, 256)
    assert isect.flatten_ids.shape == (0,)
    img, alpha = rt.rasterize_to_pixels_tiled(m2d, conics, colors, opac, 32, 32, 16, isect,
                                              backgrounds=torch.full((1, D), 0.25))
    (img.sum() + alpha.sum()).backward()
    assert tuple(img.shape) == (1, 32, 32, D)
    assert float(img.detach().min()) == float(img.detach().max()) == 0.25
    assert not alpha.detach().any() and not m2d.grad.any()


def test_rasterization_tiled_matches_jax():
    """rasterization(backend="tiled") end to end against JAX's: SH colours,
    RGB+ED with a background, antialiased, and the meta keys."""
    rng = np.random.default_rng(5)
    N, W2, H2 = 150, 48, 32
    means = rng.standard_normal((N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.3 + 0.05).astype(np.float32)
    opac = rng.random((N,)).astype(np.float32)
    sh = (rng.standard_normal((N, 4, 3)) * 0.3).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)[None].copy()
    vm[0, 2, 3] = 4.0
    Ks = np.array([[[25.0, 0, W2 / 2], [0, 25.0, H2 / 2], [0, 0, 1]]], np.float32)
    bg = rng.random((1, 3)).astype(np.float32)
    arrays = (means, quats, scales, opac, sh, vm, Ks)
    kw = dict(sh_degree=1, render_mode="RGB+ED", rasterize_mode="antialiased", backend="tiled",
              isect_capacity=4096)
    want = jax_rasterization(*map(jnp.asarray, arrays), W2, H2, backgrounds=jnp.asarray(bg), **kw)
    with torch.no_grad():
        got = rasterization(*map(_T, arrays), W2, H2, backgrounds=_T(bg), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-4, rtol=1e-3)
    for k in ("tile_width", "tile_height", "isect_capacity"):
        assert got[2][k] == want[2][k], k
    assert int(got[2]["n_isects"]) == int(want[2]["n_isects"]) > 0
    assert "slab_required" not in got[2]


def test_rasterize_to_pixels_tiled_dispatch(ref):
    """ops.rasterize_to_pixels(backend="tiled") builds the record and
    returns aux {"n_isects"}; it needs a capacity."""
    r = ref[8]
    args = [_T(a) for a in r["scene"]]
    with torch.no_grad():
        img, alpha, aux = rasterize_to_pixels(*args, W, H, TS, capacity=CAP, backgrounds=_T(r["bg"]),
                                              backend="tiled")
        direct, _, _, _ = _port(r, bg=r["bg"])
    assert set(aux) == {"n_isects"} and int(aux["n_isects"]) == r["n_isects"]
    assert torch.equal(img, direct)
    np.testing.assert_allclose(alpha.numpy(), r["fwd", True][1], **FWD)
    with pytest.raises(ValueError, match="capacity"):
        rasterize_to_pixels(*args, W, H, TS, backend="tiled")


def test_no_grad_path_matches_and_launches_nothing(ref):
    r = ref[3]
    _backend.reset_launch_counts()
    with torch.no_grad():
        img0, alpha0, _, _ = _port(r, bg=r["bg"])
    img1, alpha1, _, leaves = _port(r, bg=r["bg"], grad=True)
    assert img1.requires_grad and torch.equal(img0, img1.detach()) and torch.equal(alpha0, alpha1.detach())
    img1.sum().backward()
    assert set(_backend.launch_counts().values()) == {0}
    assert not _backend.BUILD_LOG


def test_kernel_wrappers_refuse_cpu_tensors(ref):
    m2d, conics, colors, opac, radii, depths = (_T(a) for a in ref[3]["scene"])
    isect = isect_tiles(m2d, radii, depths, TS, TW, TH, CAP)
    offs, cnts = rt.stream_ranges(isect)
    rows = [m2d[..., 0], m2d[..., 1], *conics.unbind(-1), opac, *colors.unbind(-1)]
    packed = rt.pack_rows(rows)
    assert tuple(packed.shape) == (C * m2d.shape[1], 16)
    assert torch.equal(packed[:, :9], torch.stack(rows, -1).reshape(-1, 9)) and not packed[:, 9:].any()
    ids = isect.flatten_ids
    with pytest.raises(ValueError, match="CUDA"):
        rt._tiled_fwd_cuda(packed, 3, ids, offs, cnts, C, W, H, TS)
    img, T, last, _ = rt._tiled_fwd_plain(packed, 3, ids, offs, cnts, C, W, H, TS)
    with pytest.raises(ValueError, match="CUDA"):
        rt._tiled_bwd_cuda(packed, 3, ids, offs, cnts, T, last, img, T, C, W, H, TS)


@pytest.mark.parametrize("cap", [CAP, 1000])
def test_tiled_reduce_on_stream_order(ref, cap):
    """The tiled backward's slot rows (its plain version, seeded cotangents,
    absgrad) summed per Gaussian on the stream's own gid order
    (`Isect.order`): the reduce kernel's two passes give index_add_'s sums
    and JAX's _reduce_call's (interpret mode), at a capacity that keeps
    every entry and at one that truncates; every slot lies inside its
    Gaussian's segment; the autograd path's reduce_by_gid with the order
    equals the call without."""
    from gsplat_tpu_torch.ops import rasterize_binned as trb
    from test_torch_rasterize_binned_bwd import assert_in_segments, jax_reduce, two_pass_reduce

    r = ref[3]
    m2d, conics, colors, opac, radii, depths = (_T(a) for a in r["scene"])
    isect = isect_tiles(m2d, radii, depths, TS, TW, TH, cap)
    M = isect.flatten_ids.shape[0]
    assert (M < r["n_isects"]) == (cap == 1000)
    D = colors.shape[-1]
    packed = rt.pack_rows([m2d[..., 0], m2d[..., 1], *conics.unbind(-1), opac, *colors.unbind(-1)])
    offs, cnts = rt.stream_ranges(isect)
    _, T_out, last, _ = rt._tiled_fwd_plain(packed, D, isect.flatten_ids, offs, cnts, C, W, H, TS)
    wr, wa = r["cot"]
    rows, _ = rt._tiled_bwd_plain(packed, D, isect.flatten_ids, offs, cnts, T_out, last, _T(wr),
                                  -_T(wa)[..., 0], C, W, H, TS, True)
    CN = radii.numel()
    dst, starts = isect.order
    assert_in_segments(dst, starts, isect.flatten_ids, torch.ones(M, dtype=torch.bool))
    want = trb._reduce_plain(rows, isect.flatten_ids, CN)
    np.testing.assert_allclose(two_pass_reduce(rows, dst, starts, CN).numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(want.numpy(), jax_reduce(rows.numpy(), isect.flatten_ids.numpy(), CN),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(trb.reduce_by_gid(rows, isect.flatten_ids, CN, order=isect.order),
                       trb.reduce_by_gid(rows, isect.flatten_ids, CN))
