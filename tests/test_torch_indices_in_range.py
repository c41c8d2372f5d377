"""Port rasterize_to_indices_in_range(_2dgs) (gsplat_tpu_torch.ops.
rasterize_ref, rasterize_2dgs_ref) vs the JAX package.

The scene is tests/test_indices_in_range.py's (N=200, C=2, 64x48) with
20 Gaussians at exactly the depth of 20 others and 10 behind the camera
(negative depths, whose int32 bit patterns sort before the positive ones
and in reverse). The JAX projection's outputs go into both packages'
functions, five depth-rank windows each, chained through JAX's
new_transmittances:
- sel equal;
- alpha and new_transmittances within rtol 1e-5 (atol 1e-7, far below the
  1/255 acceptance threshold);
- contrib equal: a flip would be allowed only within 1e-6 relative of a
  threshold (alpha at 1/255, the transmittance at 1e-4), and none occurs
  on these scenes (the count is asserted to be 0).
Chaining the port's own windows reproduces the port's oracle render within
atol 2e-4 and rtol 1e-4, the JAX package's tolerance for its own chaining,
3DGS and 2DGS.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu.ops.projection import fully_fused_projection as jax_proj
from gsplat_tpu.ops.projection_2dgs import fully_fused_projection_2dgs as jax_proj2
from gsplat_tpu.ops.rasterize_2dgs_ref import rasterize_to_indices_in_range_2dgs as jax_idx2
from gsplat_tpu.ops.rasterize_ref import rasterize_to_indices_in_range as jax_idx
from gsplat_tpu_torch.ops.rasterize_2dgs_ref import (
    rasterize_to_indices_in_range_2dgs,
    rasterize_to_pixels_2dgs_ref,
)
from gsplat_tpu_torch.ops.rasterize_ref import (
    rasterize_to_indices_in_range,
    rasterize_to_pixels_ref,
)

from torch_exp_warmup import one_torch_thread, warm_exp  # noqa: F401 (one_torch_thread: an autouse fixture)

N, C, W, H = 200, 2, 64, 48
N_WINDOWS = 5


def _scene():
    rng = np.random.default_rng(0)
    means = rng.standard_normal((N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.25 + 0.05).astype(np.float32)
    opac = (rng.random((N,)) * 0.8 + 0.1).astype(np.float32)
    colors = rng.random((C, N, 3)).astype(np.float32)
    means[20:40, 2] = means[0:20, 2]  # equal depths (the cameras do not rotate)
    means[40:50, 2] = -6.0 - rng.random(10).astype(np.float32)  # behind the camera
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[:, 2, 3] = 4.0
    viewmats[1, 0, 3] = 0.4
    Ks = np.tile(np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32), (C, 1, 1))
    return means, quats, scales, opac, colors, viewmats, Ks


@pytest.fixture(params=["3dgs", "2dgs"])
def case(request):
    return _windows(request.param)


@functools.lru_cache(maxsize=None)
def _windows(kind):
    """Both packages' windows on the JAX projection of the scene, built once
    per process and kind (under `--dist load` a module-scoped fixture is
    rebuilt whenever a worker comes back to this module)."""
    warm_exp()
    means, quats, scales, opac, colors, viewmats, Ks = _scene()
    args = tuple(map(jnp.asarray, (means, quats, scales, viewmats, Ks)))
    # the projection's outputs are both packages' inputs: jitted (eagerly
    # each op compiles on its own); the windows stay eager
    if kind == "3dgs":
        radii, means2d, depths, geom, _ = jax.jit(jax_proj, static_argnums=(5, 6))(*args, W, H)
        jfn, tfn = jax_idx, rasterize_to_indices_in_range
        normals = None
    else:
        radii, means2d, depths, geom, normals = jax.jit(jax_proj2, static_argnums=(5, 6))(*args, W, H)
        jfn, tfn = jax_idx2, rasterize_to_indices_in_range_2dgs
    opc = np.broadcast_to(opac[None], (C, N)).copy()
    ins = [np.array(x) for x in (means2d, geom, opc, radii, depths)]
    assert (ins[4] < 0).any() and (ins[4] > 0).any()
    bounds = np.linspace(0, N, N_WINDOWS + 1).astype(int)
    T = np.ones((C, H, W), np.float32)
    windows = []
    for s, e in zip(bounds[:-1], bounds[1:]):
        want = [np.array(x) for x in jfn(int(s), int(e), jnp.asarray(T), *map(jnp.asarray, ins), W, H, 16)]
        got = tfn(int(s), int(e), torch.from_numpy(T), *map(torch.from_numpy, ins), W, H, 16)
        windows.append((want, [g.numpy() for g in got]))
        T = want[3].reshape(C, H, W).copy()
    return dict(kind=kind, ins=ins, colors=colors, normals=normals, windows=windows, tfn=tfn)


def test_sel_matches_jax(case):
    for want, got in case["windows"]:
        np.testing.assert_array_equal(got[2], want[2])
    # the equal depths keep index order and the negative depths sort first
    depths = case["ins"][4]
    order = np.concatenate([w[2] for w, _ in case["windows"]], axis=1)
    for c in range(C):
        assert (depths[c, order[c, :10]] < 0).all()
        assert list(order[c, :10]) == list(np.argsort(-depths[c, 40:50], kind="stable") + 40)


def test_alpha_and_transmittance_match_jax(case):
    for want, got in case["windows"]:
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-7)


def test_contrib_matches_jax(case):
    flips = sum(int((got[0] != want[0]).sum()) for want, got in case["windows"])
    n = sum(int(want[0].sum()) for want, _ in case["windows"])
    assert n > 1000  # the scene hits pixels
    assert flips == 0


def _chain(tfn, ins, colors):
    """Composite each window's accepted pairs with the running
    transmittance, then pass the termination stream on."""
    T = torch.ones((C, H, W))
    alpha_acc = torch.zeros((C, H * W))
    render = torch.zeros((C, H * W, colors.shape[-1]))
    bounds = np.linspace(0, N, N_WINDOWS + 1).astype(int)
    for s, e in zip(bounds[:-1], bounds[1:]):
        contrib, alpha, sel, new_T = tfn(int(s), int(e), T, *ins, W, H, 16)
        one_m = torch.where(contrib, 1.0 - alpha, 1.0)
        T_incl = torch.cumprod(one_m, dim=-1)
        t_excl = T.reshape(C, -1)[..., None] * torch.cat([torch.ones_like(T_incl[..., :1]), T_incl[..., :-1]], -1)
        w = torch.where(contrib, alpha * t_excl, 0.0)
        render = render + torch.einsum("cpr,crd->cpd", w, torch.gather(colors, 1, sel[..., None].expand(-1, -1, 3)))
        alpha_acc = alpha_acc + w.sum(dim=-1)
        T = new_T.reshape(C, H, W)
    return render.reshape(C, H, W, -1), alpha_acc.reshape(C, H, W, 1)


def test_chained_windows_reproduce_the_oracle(case):
    ins = [torch.from_numpy(x) for x in case["ins"]]
    colors = torch.from_numpy(case["colors"])
    render, alphas = _chain(case["tfn"], ins, colors)
    means2d, geom, opc, radii, depths = ins
    if case["kind"] == "3dgs":
        want = rasterize_to_pixels_ref(means2d, geom, colors, opc, radii, depths, W, H, 16)
    else:
        want = rasterize_to_pixels_2dgs_ref(
            means2d, geom, colors, torch.from_numpy(np.array(case["normals"])), opc, radii, depths, W, H, 16
        )
    torch.testing.assert_close(render, want[0], atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(alphas, want[1], atol=2e-4, rtol=1e-4)
    first = case["tfn"](0, N // N_WINDOWS, torch.ones((C, H, W)), *ins, W, H, 16)[0]
    every = case["tfn"](0, N, torch.ones((C, H, W)), *ins, W, H, 16)[0]
    assert int(first.sum()) < int(every.sum())  # the windows split the work


# Gaussian 3675 of garden grid1 (camera 0, 648x420) after the port's 2DGS
# projection on the H100: a surfel just past the near plane whose projected
# mean lies 1.7e6 pixels off the image. At pixel (611, 38) the f32 cross
# product h_u x h_v cancels to -918 from products of 4.8e9, so its sigma
# depends on the order of the f32 operations (ROADMAP Queue 3).
NEAR_SURFEL = dict(
    means2d=[1706394.75, 261810.875],
    M=[-6.796965599060059, 1.0925617218017578, -0.010386987589299679,
       0.13399001955986023, 0.1547764539718628, 2.2972089936956763e-05,
       -1144.9671630859375, -177.8770751953125, 0.010054945945739746],
    opacity=0.6561444997787476,
    radius=5286219,
    depth=0.010054945945739746,
)


def test_near_plane_surfel_follows_jax_f32_loss():
    """The port's 2DGS oracle windows and accumulate_2dgs give the JAX
    package's alpha for NEAR_SURFEL at pixel (611, 38) (rtol 1e-5), and the
    port's binned arithmetic (`_sigma`, the 2DGS kernels' order of
    operations) gives JAX's binned sigma (`_sigma_2dgs`, eager) bit for bit.
    Both packages' f32 forms lose the alpha there: a float64 evaluation of
    the same f32 inputs, which moves by less than 1e-5 when M moves by half
    an f32 ulp, lies more than 0.1 from each."""
    from gsplat_tpu.ops.accumulate import accumulate_2dgs as jax_acc2
    from gsplat_tpu.ops.rasterize_2dgs_tiled import _sigma_2dgs
    from gsplat_tpu_torch.ops.accumulate import accumulate_2dgs
    from gsplat_tpu_torch.ops.rasterize_2dgs_binned import _sigma
    from gsplat_tpu_torch.ops.rasterize_2dgs_ref import surfel_sigma

    warm_exp()
    s = NEAR_SURFEL
    w, h, x, y = 648, 40, 611, 38
    m2 = np.array(s["means2d"], np.float32).reshape(1, 1, 2)
    M = np.array(s["M"], np.float32).reshape(1, 1, 3, 3)
    op = np.array([[s["opacity"]]], np.float32)
    radii = np.array([[s["radius"]]], np.int32)
    depths = np.array([[s["depth"]]], np.float32)
    feat = np.ones((1, 1, 3), np.float32)
    T = np.ones((1, h, w), np.float32)
    pix = y * w + x

    j_contrib, j_alpha, _, _ = jax_idx2(0, 1, *map(jnp.asarray, (T, m2, M, op, radii, depths)), w, h)
    t_contrib, t_alpha, _, _ = rasterize_to_indices_in_range_2dgs(
        0, 1, *map(torch.from_numpy, (T, m2, M, op, radii, depths)), w, h)
    a_idx = float(t_alpha[0, pix, 0])
    assert bool(t_contrib[0, pix, 0]) == bool(np.asarray(j_contrib)[0, pix, 0])
    np.testing.assert_allclose(a_idx, float(np.asarray(j_alpha)[0, pix, 0]), rtol=1e-5)

    ids = np.zeros(1, np.int32)
    j_out = jax_acc2(*map(jnp.asarray, (m2, M, op, feat, feat)), jnp.asarray(ids),
                     jnp.asarray(np.array([pix], np.int32)), jnp.asarray(ids), w, h)
    t_out = accumulate_2dgs(*map(torch.from_numpy, (m2, M, op, feat, feat)), torch.zeros(1, dtype=torch.int64),
                            torch.tensor([pix]), torch.zeros(1, dtype=torch.int64), w, h)
    a_acc = float(t_out[1].reshape(-1)[pix])
    np.testing.assert_allclose(a_acc, float(np.asarray(j_out[1]).reshape(-1)[pix]), rtol=1e-5)
    np.testing.assert_allclose(a_idx, a_acc, rtol=1e-5)

    rows = np.concatenate([m2.reshape(-1), M.reshape(-1), op.reshape(-1)]).astype(np.float32)
    j_sig = float(np.asarray(_sigma_2dgs(jnp.asarray(rows[:, None]), jnp.float32(x + 0.5), jnp.float32(y + 0.5), 3)[0])[0, 0])
    t_sig = float(_sigma(list(torch.from_numpy(rows)), torch.tensor(x + 0.5), torch.tensor(y + 0.5))[0])
    assert t_sig == j_sig

    def alpha64(Md):
        sig = surfel_sigma(torch.from_numpy(m2).double(), Md, torch.tensor([x + 0.5], dtype=torch.float64),
                           torch.tensor([y + 0.5], dtype=torch.float64))
        return float(torch.clamp_max(s["opacity"] * torch.exp(-sig), 0.999).reshape(-1)[0])

    Md = torch.from_numpy(M).double()
    a64 = alpha64(Md)
    gen = torch.Generator().manual_seed(0)
    for _ in range(8):
        step = (torch.rand(Md.shape, generator=gen, dtype=torch.float64) * 2 - 1) * 2.0**-24
        assert abs(alpha64(Md * (1 + step)) - a64) < 1e-5
    a_bin = min(s["opacity"] * float(np.exp(-np.float32(t_sig))), 0.999)
    assert abs(a_acc - a64) > 0.1 and abs(a_bin - a64) > 0.1
