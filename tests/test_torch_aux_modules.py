"""Port pose, appearance and bilateral-grid modules (gsplat_tpu_torch.modules,
gsplat_tpu_torch.bilagrid) vs the JAX package's, from JAX's own parameters
(carried across by checkpoint.aux_modules_from_numpy).

The JAX functions run jitted, as in the JAX trainer's step.
- rotation_6d_to_matrix, CameraOptModule (apply_camera_opt), the bilateral
  grid's slice_grid, total_variation_loss and color_correct: values and
  gradients within rtol 1e-5 (atol 1e-6 x the largest |value|);
- AppearanceOptModule (apply_appearance_opt) at sh_degree 0, 1 and 3 and
  with embed_ids=None: values and gradients within rtol 1e-4 (the MLP
  sums its products in other orders), atol 1e-6 x the largest |value|;
- an image id past the table (16 images, test_every 8: ids up to 15
  against 14 rows): JAX's gather clamps it and its gradient drops the
  row's update; the port's take_rows, the pose, appearance and grid
  modules give the same values and gradients;
- the MLP's and the pose module's products, forward and gradient, run
  with TF32 off while the caller allows it;
- the grid slice's autograd Function (bilagrid._GridSlice) at the default
  8 z levels, with an image id past the table and white and black pixels
  (luminance on the grid's top and bottom node): values and both
  gradients within rtol 1e-5 of JAX's VJP, the same bits from two calls,
  the grids' gradient of its plain version (csrc/bilagrid_bwd.cu's
  counterpart) within rtol 1e-5 of grid_sample's own backward, and no
  kernel launched on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import bilagrid as jbg
from gsplat_tpu import modules as jm
from gsplat_tpu_torch import _backend, bilagrid as tbg
from gsplat_tpu_torch.checkpoint import aux_modules_from_numpy, splats_from_numpy
from gsplat_tpu_torch.modules import AppearanceOptModule, CameraOptModule, rotation_6d_to_matrix, take_rows

from test_torch_mcmc import _spy_tf32
from torch_exp_warmup import one_torch_thread, warm_exp  # noqa: F401 (one_torch_thread: an autouse fixture)


def _close(got, want, rtol=1e-5, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * max(float(np.abs(want).max()), 1e-12), err_msg=name)


def _vjp(jfn, jargs, cot):
    """JAX's value and VJP of `jfn`, jitted as the JAX trainer's step runs
    these modules (op by op, each op would compile on its own: ~8 s a
    test)."""
    out, vjp = jax.vjp(jax.jit(jfn), *jargs)
    return out, vjp(jnp.asarray(cot))


def _c2w(rng, n):
    m = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    q = rng.standard_normal((n, 4))
    from gsplat_tpu_torch.datasets.colmap_io import qvec_to_rotmat

    m[:, :3, :3] = np.stack([qvec_to_rotmat(x) for x in q])
    m[:, :3, 3] = rng.standard_normal((n, 3))
    return m


def test_rotation_6d_matches_jax():
    rng = np.random.default_rng(0)
    d6 = rng.standard_normal((7, 6)).astype(np.float32)
    cot = rng.standard_normal((7, 3, 3)).astype(np.float32)
    want, (g_want,) = _vjp(jm.rotation_6d_to_matrix, [jnp.asarray(d6)], cot)
    x = torch.from_numpy(d6).requires_grad_(True)
    got = rotation_6d_to_matrix(x)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, want)
    _close(x.grad, g_want)
    r = got.detach().numpy()
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1), np.broadcast_to(np.eye(3), r.shape), atol=1e-5)


def test_camera_opt_matches_jax():
    rng = np.random.default_rng(1)
    params = jm.init_camera_opt(5, std=0.1, key=jax.random.PRNGKey(0))
    c2w = _c2w(rng, 3)
    ids = np.array([4, 0, 2], np.int32)
    cot = rng.standard_normal((3, 4, 4)).astype(np.float32)
    want, (g_p, g_c) = _vjp(lambda p, c: jm.apply_camera_opt(p, c, jnp.asarray(ids)), [params, jnp.asarray(c2w)], cot)
    mod = aux_modules_from_numpy({"pose": {k: np.asarray(v) for k, v in params.items()}}, device="cpu")["pose"]
    assert isinstance(mod, CameraOptModule)
    c = torch.from_numpy(c2w).requires_grad_(True)
    got = mod(c, torch.from_numpy(ids))
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, want, name="c2w")
    _close(mod.embeds.grad, g_p["embeds"], name="d embeds")
    _close(c.grad, g_c, name="d c2w")
    # zero embeddings (the trainer's start) leave the cameras as they are
    zero = CameraOptModule(5, device="cpu")
    torch.testing.assert_close(zero(torch.from_numpy(c2w), torch.from_numpy(ids)), torch.from_numpy(c2w))


def _app_case(seed, sh_degree=3):
    warm_exp()
    rng = np.random.default_rng(seed)
    n, F, N, C = 6, 8, 50, 2
    params = jm.init_appearance_opt(n, F, jax.random.PRNGKey(seed), embed_dim=4, sh_degree=sh_degree)
    params = {k: np.asarray(v) for k, v in params.items()}
    params["embeds"] = rng.standard_normal(params["embeds"].shape).astype(np.float32)
    params["b0"] = 0.1 * rng.standard_normal(params["b0"].shape).astype(np.float32)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    dirs = rng.standard_normal((C, N, 3)).astype(np.float32)
    return params, feats, dirs, F


@pytest.mark.parametrize("sh_degree,ids", [(3, [5, 1]), (1, [0, 3]), (0, [2, 2]), (3, None)])
def test_appearance_opt_matches_jax(sh_degree, ids):
    params, feats, dirs, F = _app_case(2)
    cot = np.random.default_rng(3).standard_normal((2, 50, 3)).astype(np.float32)
    jids = None if ids is None else jnp.asarray(ids, jnp.int32)
    want, (g_p, g_f, g_d) = _vjp(
        lambda p, f, d: jm.apply_appearance_opt(p, f, jids, d, sh_degree),
        [{k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(feats), jnp.asarray(dirs)], cot,
    )
    mod = AppearanceOptModule.from_numpy(params, F, device="cpu")
    f = torch.from_numpy(feats).requires_grad_(True)
    d = torch.from_numpy(dirs).requires_grad_(True)
    got = mod(f, None if ids is None else torch.tensor(ids), d, sh_degree)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, want, rtol=1e-4, name="colors")
    for name, p in mod.named_parameters():
        if ids is None and name == "embeds":
            assert p.grad is None or not p.grad.any()
            continue
        _close(p.grad, g_p[name], rtol=1e-4, name=f"d {name}")
    _close(f.grad, g_f, rtol=1e-4, name="d features")
    # at degree 0 the bases are constants: torch leaves dirs without a gradient
    _close(torch.zeros_like(d) if d.grad is None else d.grad, g_d, rtol=1e-4, name="d dirs")


def test_aux_products_run_without_tf32(monkeypatch):
    """The appearance MLP's and the pose module's products, forward and
    gradient, run with TF32 off (allow_tf32 read as False inside each)
    while the caller allows it, and the caller's switch is left as it
    was."""
    params, feats, dirs, F = _app_case(2)
    app = AppearanceOptModule.from_numpy(params, F, device="cpu")
    pose = CameraOptModule(4, device="cpu")
    before = torch.backends.cuda.matmul.allow_tf32
    seen = _spy_tf32(monkeypatch)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        f = torch.from_numpy(feats).requires_grad_(True)
        colors = app(f, torch.tensor([1, 3]), torch.from_numpy(dirs), 3)
        c2w = pose(torch.from_numpy(_c2w(np.random.default_rng(4), 2)), torch.tensor([0, 2]))
        (colors.sum() + c2w.sum()).backward()
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    # the MLP's layers and the pose product, each forward and backward
    assert len(seen) >= 2 * (app.n_layers + 1) and not any(seen), seen
    assert f.grad is not None and pose.embeds.grad is not None


def test_appearance_init_layout():
    """The JAX layout: w{i} [din, dout] uniform in +-sqrt(1/din), zero
    biases and embeddings; the weights drawn from the generator."""
    m = AppearanceOptModule(14, 32, embed_dim=16, sh_degree=3, device="cpu", generator=torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in m.named_parameters()}
    assert shapes == {"embeds": (14, 16), "w0": (64, 64), "b0": (64,), "w1": (64, 64), "b1": (64,),
                      "w2": (64, 3), "b2": (3,)}
    for i, din in enumerate((64, 64, 64)):
        w = getattr(m, f"w{i}")
        assert float(w.abs().max()) <= np.sqrt(1.0 / din) and float(w.std()) > 0.05
        assert not getattr(m, f"b{i}").any()
    assert not m.embeds.any()
    m2 = AppearanceOptModule(14, 32, device="cpu", generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(m2.w1, m.w1, rtol=0, atol=0)


def _grid_case(seed, n=4):
    rng = np.random.default_rng(seed)
    grids = np.asarray(jbg.init_bilateral_grid(n, grid_x=5, grid_y=4, grid_w=3)["grids"])
    grids = grids + 0.2 * rng.standard_normal(grids.shape).astype(np.float32)
    rgb = rng.random((2, 11, 13, 3)).astype(np.float32)
    return grids, rgb


def test_bilateral_grid_matches_jax():
    grids, rgb = _grid_case(4)
    ids = np.array([3, 1], np.int32)
    cot = np.random.default_rng(5).standard_normal(rgb.shape).astype(np.float32)
    want, (g_g, g_rgb) = _vjp(
        lambda g, x: jbg.slice_grid({"grids": g}, jnp.asarray(ids), x), [jnp.asarray(grids), jnp.asarray(rgb)], cot
    )
    mod = tbg.BilateralGrid.from_numpy({"grids": grids}, device="cpu")
    x = torch.from_numpy(rgb).requires_grad_(True)
    got = mod(x, torch.from_numpy(ids))
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, want, name="slice")
    _close(mod.grids.grad, g_g, name="d grids")
    _close(x.grad, g_rgb, name="d rgb")
    # identity grids change nothing
    ident = tbg.BilateralGrid(4, 5, 4, 3, device="cpu")
    torch.testing.assert_close(ident(torch.from_numpy(rgb), torch.from_numpy(ids)), torch.from_numpy(rgb))
    # total variation, value and gradient
    tv, (g_tv,) = _vjp(jbg.total_variation_loss, [jnp.asarray(grids)], np.float32(1.0))
    g = torch.from_numpy(grids).requires_grad_(True)
    got_tv = tbg.total_variation_loss(g)
    got_tv.backward()
    _close(got_tv, tv, name="tv")
    _close(g.grad, g_tv, name="d tv")
    torch.testing.assert_close(mod.tv_loss(), got_tv.detach())


def test_grid_slice_function_matches_jax():
    rng = np.random.default_rng(11)
    grids = np.asarray(jbg.init_bilateral_grid(3)["grids"])[:, :, :6, :7]  # [3, 8, 6, 7, 12]
    grids = grids + 0.2 * rng.standard_normal(grids.shape).astype(np.float32)
    rgb = rng.random((2, 23, 29, 3)).astype(np.float32)
    rgb[0, :2] = 1.0  # luminance on the top node
    rgb[1, -2:] = 0.0  # and on the bottom one
    ids = np.array([2, 4], np.int32)  # 4 is past the table: reads row 2, no gradient
    cot = rng.standard_normal(rgb.shape).astype(np.float32)
    want, (g_g, g_rgb) = _vjp(lambda g, x: jbg.slice_grid({"grids": g}, jnp.asarray(ids), x),
                              [jnp.asarray(grids), jnp.asarray(rgb)], cot)
    before = dict(_backend.LAUNCHES)
    runs = []
    for _ in range(2):
        mod = tbg.BilateralGrid.from_numpy({"grids": grids}, device="cpu")
        x = torch.from_numpy(rgb).requires_grad_(True)
        got = mod(x, torch.from_numpy(ids))
        (got * torch.from_numpy(cot)).sum().backward()
        runs.append((got.detach(), mod.grids.grad, x.grad))
    assert _backend.LAUNCHES == before
    _close(runs[0][0], want, name="slice")
    _close(runs[0][1], g_g, name="d grids")
    _close(runs[0][2], g_rgb, name="d rgb")
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    # the plain grid gradient against grid_sample's own backward
    g = torch.from_numpy(grids[[2, 2]]).requires_grad_(True)
    gray = torch.clamp((torch.from_numpy(rgb) * torch.tensor(tbg.RGB2GRAY)).sum(-1), 0.0, 1.0)
    v = torch.from_numpy(rng.standard_normal(rgb.shape[:3] + (12,)).astype(np.float32))
    out = torch.nn.functional.grid_sample(g.permute(0, 4, 1, 2, 3), tbg._coords(gray), mode="bilinear",
                                          padding_mode="border", align_corners=True)
    (ref,) = torch.autograd.grad(out, g, v.permute(0, 3, 1, 2)[:, :, None])
    _close(tbg.grid_grad(v, gray, g.shape), ref.numpy(), name="plain vs grid_sample")


def test_color_correct_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.random((9, 7, 3)).astype(np.float32)
    ref = np.clip(img @ np.array([[0.9, 0.1, 0], [0, 1.1, 0], [0.05, 0, 0.8]], np.float32) + 0.05, 0, 1)
    want = jbg.color_correct(jnp.asarray(img), jnp.asarray(ref))
    got = tbg.color_correct(torch.from_numpy(img), torch.from_numpy(ref))
    _close(got, want, rtol=1e-4, name="color_correct")


def test_out_of_range_image_id_follows_jax():
    """16 images at test_every 8 leave 14 train rows, and the train ids
    reach 15. JAX: t[[13, 15]] reads row 13 twice, and the gradient of id
    15's row is dropped (row 13 gets id 13's only). The port's take_rows,
    and the three modules through it, do the same."""
    rng = np.random.default_rng(7)
    t = rng.standard_normal((14, 5)).astype(np.float32)
    ids = np.array([13, 15], np.int32)
    cot = rng.standard_normal((2, 5)).astype(np.float32)
    want, (g_want,) = _vjp(lambda x: x[jnp.asarray(ids)], [jnp.asarray(t)], cot)
    np.testing.assert_array_equal(np.asarray(want)[1], t[13])  # the clamp
    np.testing.assert_array_equal(np.asarray(g_want)[13], cot[0])  # id 15's update dropped
    x = torch.from_numpy(t).requires_grad_(True)
    got = take_rows(x, torch.from_numpy(ids))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(g_want))
    with pytest.raises(IndexError):
        x[torch.from_numpy(ids).long()]  # plain torch indexing would raise

    # the pose module
    params = jm.init_camera_opt(14, std=0.1, key=jax.random.PRNGKey(1))
    c2w = _c2w(rng, 2)
    cot4 = rng.standard_normal((2, 4, 4)).astype(np.float32)
    want, (g_p,) = _vjp(lambda p: jm.apply_camera_opt(p, jnp.asarray(c2w), jnp.asarray(ids)), [params], cot4)
    mod = CameraOptModule.from_numpy({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    got = mod(torch.from_numpy(c2w), torch.from_numpy(ids))
    (got * torch.from_numpy(cot4)).sum().backward()
    _close(got, want, name="pose")
    _close(mod.embeds.grad, g_p["embeds"], name="d pose")

    # the appearance module
    params, feats, dirs, F = _app_case(8)
    params["embeds"] = np.concatenate([params["embeds"]] * 3)[:14]
    cot3 = rng.standard_normal((2, 50, 3)).astype(np.float32)
    want, (g_a,) = _vjp(lambda p: jm.apply_appearance_opt(p, jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(dirs), 3),
                        [{k: jnp.asarray(v) for k, v in params.items()}], cot3)
    mod = AppearanceOptModule.from_numpy(params, F, device="cpu")
    got = mod(torch.from_numpy(feats), torch.from_numpy(ids), torch.from_numpy(dirs), 3)
    (got * torch.from_numpy(cot3)).sum().backward()
    _close(got, want, rtol=1e-4, name="app")
    _close(mod.embeds.grad, g_a["embeds"], rtol=1e-4, name="d app embeds")

    # the grid
    grids, rgb = _grid_case(9, n=14)
    cot_rgb = rng.standard_normal(rgb.shape).astype(np.float32)
    want, (g_g,) = _vjp(lambda g: jbg.slice_grid({"grids": g}, jnp.asarray(ids), jnp.asarray(rgb)),
                        [jnp.asarray(grids)], cot_rgb)
    mod = tbg.BilateralGrid.from_numpy({"grids": grids}, device="cpu")
    got = mod(torch.from_numpy(rgb), torch.from_numpy(ids))
    (got * torch.from_numpy(cot_rgb)).sum().backward()
    _close(got, want, name="grid")
    _close(mod.grids.grad, g_g, name="d grid")


def test_module_loaders():
    """aux_modules_from_numpy builds each module from the JAX trainer's
    aux_params, refuses unknown keys; splats_from_numpy takes the
    appearance-mode splats (colors, features)."""
    app = {k: np.asarray(v) for k, v in jm.init_appearance_opt(3, 8, jax.random.PRNGKey(0), embed_dim=4).items()}
    mods = aux_modules_from_numpy({"pose": {"embeds": np.zeros((3, 9), np.float32)}, "app": app,
                                   "bilagrid": {k: np.asarray(v) for k, v in jbg.init_bilateral_grid(3).items()}},
                                  feature_dim=8, device="cpu")
    assert sorted(mods) == ["app", "bilagrid", "pose"] and mods["bilagrid"].grids.shape == (3, 8, 16, 16, 12)
    for name, p in mods["app"].named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), app[name])
    with pytest.raises(ValueError, match="feature_dim"):
        aux_modules_from_numpy({"app": app}, device="cpu")
    with pytest.raises(KeyError):
        aux_modules_from_numpy({"other": {}}, device="cpu")
    arrays = {"splat/means": np.zeros((4, 3), np.float32), "splat/quats": np.ones((4, 4), np.float32),
              "splat/scales": np.zeros((4, 3), np.float32), "splat/opacities": np.zeros(4, np.float32),
              "splat/colors": np.full((4, 3), 0.5, np.float32), "splat/features": np.ones((4, 8), np.float32),
              "live": np.ones(4, bool)}
    splats, live = splats_from_numpy(arrays, device="cpu")
    assert sorted(splats) == ["colors", "features", "means", "opacities", "quats", "scales"] and live.all()
