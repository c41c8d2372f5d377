"""Gradients of the port's rasterization() against the JAX package's.

The garden fixture, cut as tests/test_torch_rendering.py cuts it for the
oracle (every ~60th Gaussian, cameras / 8, 2 cameras; a random fifth of
the pool dead under `masks`). The same numpy parameters, cotangents and a
zero means2d carrier go through JAX's oracle rasterization (jax.grad) and
through the port's binned backend (the backward and reduce kernels' plain
versions) and its oracle (torch autograd). Gradients w.r.t. means, quats,
scales, opacities, sh0, shN (sh_degree 3) and the carrier must agree within
rtol 1e-3 and atol 1e-4 x the largest |gradient| of that input (the
binned backward rebuilds T by division and sums per tile), and every dead
slot's gradient must be exactly 0 in the port.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gsplat_tpu
from gsplat_tpu_torch import rasterization

from test_torch_rendering import CAP, _garden
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

KEYS = ("means", "quats", "scales", "opacities", "sh0", "shN")
CASES = {  # name -> rasterization kwargs
    "classic-RGB-masks-bg": dict(render_mode="RGB", backgrounds=True),
    "antialiased-RGB+ED-masks": dict(render_mode="RGB+ED", rasterize_mode="antialiased"),
}


@pytest.fixture(scope="module")
def garden():
    g = _garden(2250, 8)
    rng = np.random.default_rng(1)
    N = g["means"].shape[0]
    g["params"] = dict(
        means=g["means"], quats=g["quats"], scales=g["scales"], opacities=g["opacities"],
        sh0=np.ascontiguousarray(g["sh"][:, :1]), shN=np.ascontiguousarray(g["sh"][:, 1:]),
    )
    g["wr"] = rng.standard_normal((2, g["H"], g["W"], 4)).astype(np.float32)
    g["wa"] = rng.standard_normal((2, g["H"], g["W"], 1)).astype(np.float32)
    g["carrier"] = np.zeros((2, N, 2), np.float32)
    return g


def _kwargs(g, case, xp):
    kw = dict(CASES[case])
    if kw.pop("backgrounds", False):
        kw["backgrounds"] = xp(g["bg"][:, :3])
    kw["masks"] = xp(g["masks"])
    return kw


def _jax_grads(g, case):
    kw = _kwargs(g, case, jnp.asarray)
    D = 4 if kw["render_mode"] == "RGB+ED" else 3

    def loss(params, carrier):
        r, a, _ = gsplat_tpu.rasterization(
            params["means"], params["quats"], params["scales"], params["opacities"],
            jnp.concatenate([params["sh0"], params["shN"]], axis=1),
            jnp.asarray(g["viewmats"]), jnp.asarray(g["Ks"]), g["W"], g["H"],
            sh_degree=3, backend="oracle", means2d_carrier=carrier, **kw,
        )
        return jnp.sum(r * g["wr"][..., :D]) + jnp.sum(a * g["wa"])

    params = {k: jnp.asarray(v) for k, v in g["params"].items()}
    gp, gc = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(g["carrier"]))
    out = {k: np.asarray(v) for k, v in gp.items()}
    out["carrier"] = np.asarray(gc)
    return out


def _port_grads(g, case, backend):
    kw = _kwargs(g, case, torch.from_numpy)
    D = 4 if kw["render_mode"] == "RGB+ED" else 3
    params = {k: torch.tensor(v, requires_grad=True) for k, v in g["params"].items()}
    carrier = torch.zeros((2, g["means"].shape[0], 2), requires_grad=True)
    r, a, meta = rasterization(
        params["means"], params["quats"], params["scales"], params["opacities"],
        torch.cat([params["sh0"], params["shN"]], dim=1),
        torch.from_numpy(g["viewmats"]), torch.from_numpy(g["Ks"]), g["W"], g["H"],
        sh_degree=3, backend=backend, isect_capacity=CAP if backend == "binned" else None,
        means2d_carrier=carrier, **kw,
    )
    ((r * torch.from_numpy(g["wr"][..., :D])).sum() + (a * torch.from_numpy(g["wa"])).sum()).backward()
    out = {k: v.grad.numpy() for k, v in params.items()}
    out["carrier"] = carrier.grad.numpy()
    return out


@pytest.fixture(scope="module")
def jax_grads(garden):
    return {case: _jax_grads(garden, case) for case in CASES}


@pytest.fixture(scope="module")
def port_oracle_grads(garden):
    return {case: _port_grads(garden, case, "oracle") for case in CASES}


def _close(got, want, name):
    s = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * s, err_msg=name)


@pytest.mark.parametrize("backend", ["binned", "oracle"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterization_grads_match_jax(garden, jax_grads, port_oracle_grads, case, backend):
    got = port_oracle_grads[case] if backend == "oracle" else _port_grads(garden, case, backend)
    want = jax_grads[case]
    dead = ~garden["masks"]
    assert dead.any() and (~dead).any()
    for name in KEYS + ("carrier",):
        g = got[name]
        assert np.isfinite(g).all(), name
        rows = g[:, dead] if name == "carrier" else g[dead]
        assert not rows.any(), f"{name}: dead slots got a gradient"
        _close(g, want[name], name)
    assert np.abs(want["carrier"]).max() > 0 and np.abs(want["shN"]).max() > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_binned_grads_match_port_oracle(garden, port_oracle_grads, case):
    got = _port_grads(garden, case, "binned")
    for name in KEYS + ("carrier",):
        _close(got[name], port_oracle_grads[case][name], name)


def test_absgrad_carrier_binned_matches_oracle():
    """rasterization(absgrad=True): the carrier's gradient is the per-tile
    |d mean2d| sum on both port backends and JAX's oracle; the render does
    not change."""
    rng = np.random.default_rng(5)
    N, C, W, H = 120, 2, 48, 32
    means = rng.standard_normal((N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.25 + 0.05).astype(np.float32)
    opac = rng.random((N,)).astype(np.float32)
    colors = rng.random((N, 3)).astype(np.float32)
    vm = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    vm[:, 2, 3] = 4.0
    vm[1, 0, 3] = 0.3
    Ks = np.tile(np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32), (C, 1, 1))
    wr = rng.standard_normal((C, H, W, 3)).astype(np.float32)
    args = (means, quats, scales, opac, colors, vm, Ks)

    def jloss(carrier):
        r, a, _ = gsplat_tpu.rasterization(
            *map(jnp.asarray, args), W, H, backend="oracle", means2d_carrier=carrier, absgrad=True,
        )
        return jnp.sum(r * wr) + jnp.sum(a)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.zeros((C, N, 2), jnp.float32)))
    renders = []
    for backend in ("binned", "oracle"):
        carrier = torch.zeros((C, N, 2), requires_grad=True)
        r, a, _ = rasterization(
            *map(torch.from_numpy, args), W, H, backend=backend, isect_capacity=CAP,
            means2d_carrier=carrier, absgrad=True,
        )
        ((r * torch.from_numpy(wr)).sum() + a.sum()).backward()
        np.testing.assert_allclose(carrier.grad.numpy(), want, rtol=1e-4, atol=1e-5, err_msg=backend)
        renders.append(r.detach())
    with torch.no_grad():
        r0, _, _ = rasterization(*map(torch.from_numpy, args), W, H, backend="oracle")
    np.testing.assert_allclose(renders[0].numpy(), r0.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(renders[1], r0)
