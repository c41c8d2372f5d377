"""Port packed projections and `proj` (gsplat_tpu_torch.ops.projection,
projection_2dgs) vs the JAX package.

The same seeded numpy inputs go through both packages on the CPU, and the
whole packed buffer is compared, padding included: the padded slots hold
the first invalid entries in flat order in both packages.
- camera ids, Gaussian ids, radii and nnz equal;
- 3DGS floats within test_torch_projection.py's TOL (rtol/atol 1e-5);
  2DGS floats within rtol 1e-5 and atol 1e-5 x the output's largest
  |value|, test_torch_projection_2dgs.py's tolerance;
- with a capacity below nnz, the buffer is the full buffer's first slots
  (the highest flat indices dropped), in both packages;
- gradients of a seeded weighting of the live slots' floats w.r.t. means,
  quats, scales and viewmats within rtol 1e-4 and atol 1e-5 x the largest
  |gradient| (autograd and JAX's VJP sum the chain in other orders);
- `proj` for the three camera models within TOL.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gsplat_tpu.ops import projection as jproj
from gsplat_tpu.ops import projection_2dgs as jproj2
from gsplat_tpu_torch.ops import projection as tproj
from gsplat_tpu_torch.ops import projection_2dgs as tproj2

from test_torch_projection import TOL, _scene
from test_torch_projection_2dgs import _inputs as _inputs_2dgs
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

CASES = {
    "pinhole": dict(),
    "ortho": dict(camera_model="ortho"),
    "fisheye": dict(camera_model="fisheye"),
    "compensation": dict(calc_compensations=True),
}
W2, H2 = 64, 48


def _scene3():
    """test_torch_projection.py's scene with the means spread 3x sideways,
    so the frustum culls some pairs and the padding holds real rows."""
    means, quats, scales, viewmats, Ks, W, H = _scene()
    means = means * np.array([3.0, 3.0, 1.0], np.float32)
    return means, quats, scales, viewmats, Ks, W, H


def _check(got, want, tol_fn):
    names = ["camera_ids", "gaussian_ids", "radii"]
    for g, w, name in zip(got[:3], want[:3], names):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[-1].dtype == torch.int32 and got[-1].dim() == 0
    assert int(got[-1]) == int(want[-1])
    for i, (g, w) in enumerate(zip(got[3:-1], want[3:-1])):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, err_msg=f"output {i + 3}", **tol_fn(w))


def _tol_2dgs(w):
    return dict(rtol=1e-5, atol=1e-5 * max(float(np.abs(w).max()), 1e-6))


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_projection_matches_jax(case):
    means, quats, scales, viewmats, Ks, W, H = _scene3()
    C, N = viewmats.shape[0], means.shape[0]
    want = jproj.fully_fused_projection_packed(
        *map(jnp.asarray, (means, quats, scales, viewmats, Ks)), W, H, C * N, **CASES[case]
    )
    got = tproj.fully_fused_projection_packed(
        *map(torch.from_numpy, (means, quats, scales, viewmats, Ks)), W, H, C * N, **CASES[case]
    )
    assert 0 < int(got[-1]) < C * N  # some pairs culled: padding is compared too
    _check(got, want, lambda w: TOL)
    dense = tproj.fully_fused_projection(
        *map(torch.from_numpy, (means, quats, scales, viewmats, Ks)), W, H, **CASES[case]
    )
    nnz = int(got[-1])
    cam, gau = got[0][:nnz].long(), got[1][:nnz].long()
    assert torch.equal(got[2][:nnz], dense[0][cam, gau]) and bool((got[2][:nnz] > 0).all())
    assert torch.equal(got[3][:nnz], dense[1][cam, gau])


def test_packed_projection_2dgs_matches_jax():
    args = _inputs_2dgs(0)
    C, N = args[3].shape[0], args[0].shape[0]
    want = jproj2.fully_fused_projection_2dgs_packed(*map(jnp.asarray, args), W2, H2, C * N)
    got = tproj2.fully_fused_projection_2dgs_packed(*map(torch.from_numpy, args), W2, H2, C * N)
    assert 0 < int(got[-1]) < C * N
    assert got[5].shape == (C * N, 3, 3) and got[6].shape == (C * N, 3)
    _check(got, want, _tol_2dgs)


@pytest.mark.parametrize("kind", ["3dgs", "2dgs"])
def test_packed_projection_truncates(kind):
    """A capacity below nnz keeps the lowest flat indices: the buffer is the
    full buffer's first `cap` slots, and nnz still counts every valid pair."""
    if kind == "3dgs":
        args, (W, H) = _scene3()[:5], _scene3()[5:]
        jfn, tfn = jproj.fully_fused_projection_packed, tproj.fully_fused_projection_packed
    else:
        args, W, H = _inputs_2dgs(0), W2, H2
        jfn, tfn = jproj2.fully_fused_projection_2dgs_packed, tproj2.fully_fused_projection_2dgs_packed
    C, N = args[3].shape[0], args[0].shape[0]
    full = tfn(*map(torch.from_numpy, args), W, H, C * N)
    nnz = int(full[-1])
    cap = nnz // 2
    got = tfn(*map(torch.from_numpy, args), W, H, cap)
    want = jfn(*map(jnp.asarray, args), W, H, cap)
    _check(got, want, (lambda w: TOL) if kind == "3dgs" else _tol_2dgs)
    assert int(got[-1]) == nnz and got[0].shape == (cap,)
    for g, f in zip(got[:-1], full[:-1]):
        assert (g is None and f is None) or torch.equal(g, f[:cap])
    assert bool((got[2] > 0).all())


@pytest.mark.parametrize("kind", ["3dgs", "2dgs"])
def test_packed_projection_gradients_match_jax(kind):
    if kind == "3dgs":
        args, (W, H) = _scene3()[:5], _scene3()[5:]
        jfn, tfn = jproj.fully_fused_projection_packed, tproj.fully_fused_projection_packed
        kw = dict(calc_compensations=True)
        outs = (3, 4, 5, 6)  # means2d, depths, conics, compensations
    else:
        args, W, H = _inputs_2dgs(0), W2, H2
        jfn, tfn = jproj2.fully_fused_projection_2dgs_packed, tproj2.fully_fused_projection_2dgs_packed
        kw = {}
        outs = (3, 4, 5, 6)  # means2d, depths, ray_transforms, normals
    C, N = args[3].shape[0], args[0].shape[0]
    cap = C * N
    nnz = int(tfn(*map(torch.from_numpy, args), W, H, cap, **kw)[-1])
    shapes = [tuple(o.shape) for o in (tfn(*map(torch.from_numpy, args), W, H, cap, **kw)[i] for i in outs)]
    rng = np.random.default_rng(11)
    weights = []
    for s in shapes:
        w = rng.standard_normal(s).astype(np.float32)
        w[nnz:] = 0.0  # the live slots only
        weights.append(w)

    def jloss(*a):
        out = jfn(*a, Ks_j, W, H, cap, **kw)
        return sum(jnp.sum(out[i] * w) for i, w in zip(outs, weights))

    Ks_j = jnp.asarray(args[4])
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args[:4]))
    leaves = [torch.tensor(a, requires_grad=True) for a in args[:4]]
    out = tfn(*leaves, torch.from_numpy(args[4]), W, H, cap, **kw)
    sum((out[i] * torch.from_numpy(w)).sum() for i, w in zip(outs, weights)).backward()
    for t, w, name in zip(leaves, want, ("means", "quats", "scales", "viewmats")):
        w = np.asarray(w)
        assert np.isfinite(t.grad.numpy()).all(), name
        np.testing.assert_allclose(
            t.grad.numpy(), w, rtol=1e-4, atol=1e-5 * max(float(np.abs(w).max()), 1e-6), err_msg=name
        )


@pytest.mark.parametrize("camera_model", ["pinhole", "ortho", "fisheye"])
def test_proj_matches_jax(camera_model):
    rng = np.random.default_rng(3)
    C, N, W, H = 2, 50, 64, 48
    means = (rng.standard_normal((C, N, 3)) * 0.5 + [0.0, 0.0, 4.0]).astype(np.float32)
    L = rng.standard_normal((C, N, 3, 3)).astype(np.float32) * 0.2
    covars = L @ np.swapaxes(L, -1, -2) + 1e-3 * np.eye(3, dtype=np.float32)
    Ks = np.tile(np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32), (C, 1, 1))
    want = jproj.proj(*map(jnp.asarray, (means, covars, Ks)), W, H, camera_model)
    got = tproj.proj(*map(torch.from_numpy, (means, covars, Ks)), W, H, camera_model)
    assert got[0].shape == (C, N, 2) and got[1].shape == (C, N, 2, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    with pytest.raises(ValueError, match="camera_model"):
        tproj.proj(*map(torch.from_numpy, (means, covars, Ks)), W, H, "bogus")
