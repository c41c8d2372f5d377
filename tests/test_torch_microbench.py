"""The port's micro-benchmarks (gsplat_tpu_torch/microbench/) against the
TPU kernels of scripts/exp_*.py, run through pl.pallas_call(...,
interpret=True) on the CPU at small sizes; the port's wrappers take their
plain versions here and launch no kernel.

scripts/exp_mxu_kernel_shapes.py's ``_kernel`` is imported (the script
runs it interpreted off the TPU, :184). The other scripts run their work
at import or define their kernels inside timing functions, so their
kernel bodies are restated below with the script's lines cited, with
``jnp.roll`` where the script has ``pltpu.roll`` (as
``_cumprod_lanes(native=False)`` does). Tolerances, each for its reason:

- the gathers (g1, e1's three, e4's one-hot matmul at HIGHEST): equal;
- the multiply-add chain: rtol 1e-5 (the two sides may contract a b + c
  differently over 24 steps);
- the f32 products, on signed inputs: 1e-5 of the largest |value| (sums
  in another order); TF32: the kernel body on TF32-rounded inputs, the
  same bound (the products of TF32 values are exact in f32); each gate
  rejects the other product's result;
- e5's inner math, of each |value| (sums of positive terms spanning
  orders of magnitude): f32 1e-5 (exp and sums in another order); bf16
  5e-3 (XLA may keep a fused chain in f32 between bf16 roundings, torch
  rounds each operation: 2.7e-3 measured), a gate that the f32 result
  fails (8e-2 measured: a bf16 step of sig near -15 moves exp(-sig) by 6%);
  the kernels' arithmetic walked in numpy (exp2 of the f32-scaled
  argument, subnormals flushed) within the card's gates of the plain
  version (`primitives.TOL`, `BF16_OF_LARGEST`);
- the six slice shapes: 1e-5 of the largest |value| of each of acc's rows
  (the rows differ by ~100x; the scan is a product in order here and a
  log-step product on the TPU; sums in another order);
- the forward breakdown on a binned stream of the JAX package: L0 rtol
  1e-6 (adds in another order), L1 and L2 rtol 1e-5, L3 1e-5 of the
  largest |value| (a sum per pixel in another order; the decisions round
  alike).
"""

import ctypes
import functools
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gsplat_tpu.ops import binning as jbinning
from gsplat_tpu.ops import rasterize_binned as RB
from gsplat_tpu.ops.projection import fully_fused_projection
from gsplat_tpu.ops.rasterize_tiled import _cumprod_lanes
from gsplat_tpu_torch import _backend
from gsplat_tpu_torch.microbench import fwd_breakdown as fb
from gsplat_tpu_torch.microbench import kernel_shapes as ks
from gsplat_tpu_torch.microbench import primitives as pm
from gsplat_tpu_torch.microbench import vpu_calib as vc

from torch_exp_warmup import one_torch_thread, warm_exp  # noqa: F401 (one_torch_thread: an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 128


@pytest.fixture(autouse=True)
def no_launches():
    before = dict(_backend.LAUNCHES)
    yield
    assert _backend.LAUNCHES == before


def _close(got, want, rtol, scale=None):
    """|got - want| within rtol x the largest |want|, or, given `scale` (of
    want's shape), within rtol x `scale` everywhere."""
    want = np.asarray(want, np.float64)
    got = got.numpy().astype(np.float64) if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    bad = np.abs(got - want) > rtol * np.asarray(scale, np.float64)
    assert not bad.any(), f"{int(bad.sum())} values off, max abs {np.abs(got - want).max():.3e}"


def _interpret(kernel, out_shape, *args, grid=(), in_specs=None, out_specs=None):
    kw = {} if in_specs is None else {"grid": grid, "in_specs": in_specs, "out_specs": out_specs}
    return np.asarray(pl.pallas_call(kernel, out_shape=out_shape, interpret=True, **kw)(*args))


# --------------------------------------------------------------- exp_vpu_calib
def _vpu_kernel(x_ref, o_ref):  # scripts/exp_vpu_calib.py:18-26
    x = x_ref[...]
    a = x
    b = x * 0.5
    for i in range(vc.OPS // 2):
        a = a * b + 1e-6
        b = b + a * 0.25
    o_ref[...] = a + b


def _mxu_kernel(x_ref, y_ref, o_ref, *, prec):  # scripts/exp_vpu_calib.py:29-33
    o_ref[...] = jax.lax.dot_general(
        x_ref[...], y_ref[...], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=prec,
    )


def test_fma_chain_matches_vpu_kernel():
    x = np.random.default_rng(0).random((64, 256), np.float32)
    spec = pl.BlockSpec(x.shape, lambda i: (0, 0))
    want = _interpret(_vpu_kernel, jax.ShapeDtypeStruct(x.shape, jnp.float32), jnp.asarray(x), grid=(3,),
                      in_specs=[spec], out_specs=spec)
    got = vc.fma_chain(torch.from_numpy(x), passes=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert vc.fma_count(torch.from_numpy(x), 3) == 48 * x.size * 3


@pytest.mark.parametrize("which", ["sgemm", "tf32_mma"])
def test_products_match_mxu_kernel(which):
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((64, 256), np.float32), rng.standard_normal((256, 128), np.float32)
    if which == "tf32_mma":
        xr, yr = (vc.round_tf32(torch.from_numpy(a)).numpy() for a in (x, y))
        # ten mantissa bits kept, to nearest
        assert np.abs(xr - x).max() <= 2.0 ** -11 * np.abs(x).max() and not np.array_equal(xr, x)
    else:
        xr, yr = x, y
    kern = functools.partial(_mxu_kernel, prec=jax.lax.Precision.HIGHEST)
    want = _interpret(kern, jax.ShapeDtypeStruct((64, 128), jnp.float32), jnp.asarray(xr), jnp.asarray(yr),
                      grid=(2,), in_specs=[pl.BlockSpec(x.shape, lambda i: (0, 0)),
                                           pl.BlockSpec(y.shape, lambda i: (0, 0))],
                      out_specs=pl.BlockSpec((64, 128), lambda i: (0, 0)))
    got = getattr(vc, which)(torch.from_numpy(x), torch.from_numpy(y), repeats=2)
    _close(got, want, 1e-5)
    other = vc.sgemm if which == "tf32_mma" else vc.tf32_mma
    with pytest.raises(AssertionError):  # the gate rejects the other precision's products
        _close(other(torch.from_numpy(x), torch.from_numpy(y), repeats=2), want, 1e-5)
    assert vc.gemm_flops(torch.from_numpy(x), torch.from_numpy(y), 256) == 2 * 64 * 256 * 128 * 256


# the products' shape contract (vpu_calib.gemm_plan): the script's and
# check's SMALL shapes, and shapes the tiles cannot cover
@pytest.mark.parametrize("name", ["sgemm", "tf32_mma"])
@pytest.mark.parametrize("shape", [(vc.P, vc.M, vc.K, vc.B), vc.SMALL[:1] + (vc.SMALL[2], vc.SMALL[1], vc.SMALL[3])])
def test_gemm_plan_takes_callers_shapes(name, shape):
    m, n, k, repeats = shape
    plan = vc.gemm_plan(name, m, n, k, repeats)
    (bm, bn, bk), (gx, gy, gz) = plan.tile, plan.grid
    assert (gx * bn, gy * bm) == (n, m) and k % bk == 0
    reps = repeats // gz
    assert reps * gz == repeats and reps == min(vc.GEMM_REPS, repeats)
    assert 0 < plan.smem <= vc.SMEM_LIMIT == 232_448
    if name == "tf32_mma":  # 128-byte swizzled rows of 32 TF32 values; the n128 tiles where n is not 256's multiple
        assert bk == 32 and bn == (256 if n % 256 == 0 else 128)
        assert plan.smem == vc.TF32_STAGES * (bm + bn) * bk * 4 + 1024
    else:
        assert plan.tile == (128, 128, 16)


@pytest.mark.parametrize("name", ["sgemm", "tf32_mma"])
@pytest.mark.parametrize("shape", [(64, 512, 1024, 256), (512, 64, 1024, 256), (512, 512, 1000, 256),
                                   (512, 512, 1024, 12), (0, 512, 1024, 256), (512, 512, 1024, 8 * 65536)])
def test_gemm_plan_refuses_uncovered_shapes(name, shape):
    with pytest.raises(ValueError):
        vc.gemm_plan(name, *shape)


def test_gemm_plan_refuses_unknown_kernel():
    with pytest.raises(ValueError):
        vc.gemm_plan("hgemm", 512, 512, 1024, 256)


@pytest.mark.parametrize("shape", [(64, 256, 128), vc.SMALL[:3]])
def test_tf32_staged_operands_give_plain_bits(shape):
    """The pre-pass's specified output (round_tf32(x), round_tf32(y)^T,
    K-major), multiplied in plain torch, is tf32_mma_plain bit for bit."""
    m, k, n = shape
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.standard_normal(s, np.float32)) for s in ((m, k), (k, n)))
    xs, ys = vc.tf32_staged(x, y)
    assert xs.shape == (m, k) and ys.shape == (n, k) and ys.is_contiguous()
    assert torch.equal(xs, vc.round_tf32(x)) and torch.equal(ys.T, vc.round_tf32(y))
    assert not ((xs.view(torch.int32) & 0x1FFF) != 0).any()  # 13 low bits clear: exact as TF32
    with _backend.full_f32_matmul():
        got = xs @ ys.T
    assert torch.equal(got, vc.tf32_mma_plain(x, y))


# --------------------------------------------------------------- gathers
def test_gather_rows_matches_g1():
    NB, S, L = 3, 64, 128
    rng = np.random.default_rng(2)
    tab = rng.random((NB, S, L), np.float32)
    idx = rng.integers(0, S, (NB, S, L)).astype(np.int32)

    def kern(tab_ref, idx_ref, out_ref):  # scripts/exp_r2_batch2.py:18-19
        out_ref[0] = jnp.take_along_axis(tab_ref[0], idx_ref[0], axis=0)

    spec = pl.BlockSpec((1, S, L), lambda b: (b, 0, 0))
    want = _interpret(kern, jax.ShapeDtypeStruct((NB, S, L), jnp.float32), jnp.asarray(tab), jnp.asarray(idx),
                      grid=(NB,), in_specs=[spec, spec], out_specs=spec)
    np.testing.assert_array_equal(pm.gather_rows(torch.from_numpy(tab), torch.from_numpy(idx)).numpy(), want)


def test_take_along_axis_matches_e1():
    F, W = 8, 512
    rng = np.random.default_rng(3)
    tab = np.arange(F * W, dtype=np.float32).reshape(F, W)
    idx = rng.integers(0, W, (F, W)).astype(np.int32)

    def k_taa(tab_ref, idx_ref, out_ref):  # scripts/exp_r2_primitives.py:52-53
        out_ref[...] = jnp.take_along_axis(tab_ref[...], idx_ref[...], axis=1)

    def k_taa0(tab_ref, idx_ref, out_ref):  # :57-58
        out_ref[...] = jnp.take_along_axis(tab_ref[...], idx_ref[...] % F, axis=0)

    shape = jax.ShapeDtypeStruct((F, W), jnp.float32)
    t, i = torch.from_numpy(tab), torch.from_numpy(idx)
    np.testing.assert_array_equal(pm.gather_window(t, i[None])[0].numpy(),
                                  _interpret(k_taa, shape, jnp.asarray(tab), jnp.asarray(idx)))
    np.testing.assert_array_equal(pm.gather_rows(t[None], (i % F)[None])[0].numpy(),
                                  _interpret(k_taa0, shape, jnp.asarray(tab), jnp.asarray(idx)))


def test_gather_window_matches_e1b():
    F2, W2, K, NB = 16, 1024, 256, 3  # the script's [16, 8192] window, cut
    rng = np.random.default_rng(4)
    tab = rng.random((F2, W2), np.float32)
    idx = rng.integers(0, W2, (NB, F2, K)).astype(np.int32)

    def kern2(tab_ref, idx_ref, out_ref):  # scripts/exp_r2_primitives.py:79-80
        out_ref[0] = jnp.take_along_axis(tab_ref[...], idx_ref[0], axis=1)

    want = _interpret(kern2, jax.ShapeDtypeStruct((NB, F2, K), jnp.float32), jnp.asarray(tab), jnp.asarray(idx),
                      grid=(NB,), in_specs=[pl.BlockSpec((F2, W2), lambda b: (0, 0)),
                                            pl.BlockSpec((1, F2, K), lambda b: (b, 0, 0))],
                      out_specs=pl.BlockSpec((1, F2, K), lambda b: (b, 0, 0)))
    np.testing.assert_array_equal(pm.gather_window(torch.from_numpy(tab), torch.from_numpy(idx)).numpy(), want)


def test_gather_cols_matches_e4_one_hot():
    F, G, S, NB = 16, 128, 256, 3  # the script's G 1024, S 2048, cut
    rng = np.random.default_rng(5)
    tab = rng.standard_normal((NB, F, G)).astype(np.float32)
    idx = rng.integers(0, G, (NB, 1, S)).astype(np.int32)

    def kern(tab_ref, idx_ref, out_ref):  # scripts/exp_r2_primitives.py:155-164
        tab = tab_ref[0]
        idx = idx_ref[0]
        onehot = (jax.lax.broadcasted_iota(jnp.int32, (G, S), 0) == idx).astype(jnp.float32)
        out_ref[0] = jax.lax.dot_general(
            tab, onehot, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)

    want = _interpret(kern, jax.ShapeDtypeStruct((NB, F, S), jnp.float32), jnp.asarray(tab), jnp.asarray(idx),
                      grid=(NB,), in_specs=[pl.BlockSpec((1, F, G), lambda b: (b, 0, 0)),
                                            pl.BlockSpec((1, 1, S), lambda b: (b, 0, 0))],
                      out_specs=pl.BlockSpec((1, F, S), lambda b: (b, 0, 0)))
    np.testing.assert_array_equal(pm.gather_cols(torch.from_numpy(tab), torch.from_numpy(idx)).numpy(), want)


# the gathers' shape contract (primitives.gather_plan): the scripts' and
# check's shapes, the edges the card checks, and the parent's refusals
V16, V4 = "cp.async 16 B", "cp.async 4 B"


@pytest.mark.parametrize("shape, want", [
    (pm.SIZES["g1"], (16, V16, True, 132, 131_072)),  # 64-byte pieces of a row, one 128 KB stage, a block an SM
    (pm.SMALL["g1"], (16, V16, True, 32, 16_384)),
    ((1, 8, 512), (16, V16, True, 32, 512)),  # e1's k_taa0
    ((2, 3632, 36), (16, V16, True, 6, 232_448)),  # the largest S of 16 lanes
    ((2, 3633, 36), (8, V16, True, 10, 116_256)),  # one row past it: 8 lanes
    ((2, 7264, 20), (8, V16, True, 6, 232_448)),  # the parent's largest S
    ((3, 64, 130), (16, V4, False, 27, 4096)),  # ragged L: the scalar form, a narrow last group
    ((5, 1, 3), (16, V4, False, 5, 64)),
    ((4, 100, 20), (16, V16, True, 8, 6400)),
    ((0, 64, 128), (16, V16, True, 0, 4096)),  # NB = 0: no launch
])
def test_gather_plan_rows(shape, want):
    plan = pm.gather_plan("gather_rows", shape)
    assert plan == pm.GatherPlan(*want)
    assert plan.smem <= pm.SMEM_LIMIT == 232_448
    assert pm.gather_plan("gather_rows", shape, aligned=False)[1:3] == (V4, False)


def test_gather_plan_rows_narrows_at_each_edge():
    """The card's edge shapes are those of test_gather_plan_rows; one row
    past the 16 lanes' limit the plan takes 8; every S up to the parent's
    7,264 launches."""
    edges = [s for n, s in pm.gather_edges() if n == "gather_rows"]
    assert sorted(edges) == sorted([(2, 3632, 36), (2, 3633, 36), (2, 7264, 20), (3, 64, 130), (5, 1, 3),
                                    (4, 100, 20), (0, 64, 128)])
    tops = [s for s in edges if (s[0], s[1] + 1, s[2]) in edges]
    assert len(tops) == 1 and max(s[1] for s in edges) == pm.ROWS_MAX_S == 7264
    for NB, S, L in tops:
        a, b = pm.gather_plan("gather_rows", (NB, S, L)), pm.gather_plan("gather_rows", (NB, S + 1, L))
        assert b.lanes < a.lanes
    for S in (1, 2, 907, 1815, 3631, 5000, 7263, 7264):
        for L in (1, 3, 8, 128, 130, 4096):
            assert pm.gather_plan("gather_rows", (65535, S, L)).smem <= pm.SMEM_LIMIT


@pytest.mark.parametrize("shape", [pm.SIZES["e1b"][3:] + pm.SIZES["e1b"][:3], (1, 8, 512, 512),
                                   pm.SMALL["e1b"][3:] + pm.SMALL["e1b"][:3]]
                         + [s for n, s in pm.gather_edges() if n == "gather_window"])
def test_gather_plan_window(shape):
    NB, F, W, K = shape
    plan = pm.gather_plan("gather_window", shape)
    assert plan.smem == 4 * (-(-W // 4) * 4) <= pm.SMEM_LIMIT
    assert plan.vector == (K % 4 == 0) and plan.copy == ("cp.async 16 B" if W % 4 == 0 else "cp.async 4 B")
    if NB * K == 0:
        assert plan.blocks == 0
        return
    per_f, rem = divmod(plan.blocks, F)
    chunks = NB * (K // 4 if plan.vector else K)
    assert rem == 0 and 1 <= per_f and (per_f == 1 or chunks >= 256 * (per_f - 1))
    assert per_f == 1 or plan.blocks <= min(pm.MIN_BLOCKS, 233_472 // (plan.smem + 1024)) * 132  # one wave
    if shape == (256, 16, 8192, 2048):  # e1b: 33 blocks a row, 4 an SM (by registers)
        assert plan.blocks == 528


@pytest.mark.parametrize("name, shape", [("gather_rows", (2, 7265, 8)), ("gather_rows", (65536, 8, 8)),
                                         ("gather_rows", (-1, 8, 8)), ("gather_rows", (1, 0, 8)),
                                         ("gather_rows", (1, 8, 0)), ("gather_rows", (2, 2048, 128, 4)),
                                         ("gather_window", (1, 1, 58113, 8)), ("gather_window", (1, 0, 8, 8)),
                                         ("gather_window", (1, 1, 8, -1)), ("gather_window", (-1, 1, 8, 8)),
                                         ("gather_cols", (1, 1, 8))])
def test_gather_plan_refuses_what_the_parent_refused(name, shape):
    with pytest.raises(ValueError):
        pm.gather_plan(name, shape)


# --------------------------------------------------------------- e5's inner math
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inner_math_matches_e5(dtype):
    P, K, NB = 256, 128, 3
    rng = np.random.default_rng(6)
    e = rng.random((NB, 8, K)).astype(np.float32)
    e[:, 0] *= 4.0  # gx in [0, 4)
    e[:, 1] = 0.1 + 0.9 * e[:, 1]  # ca in [0.1, 1)
    jdt = getattr(jnp, dtype)

    def kern(e_ref, out_ref):  # scripts/exp_r2_primitives.py:189-199
        e = e_ref[0].astype(jdt)
        px = jax.lax.broadcasted_iota(jnp.int32, (P, 1), 0).astype(jdt)
        acc = jnp.zeros((P, K), jdt)
        for r in range(6):
            gx, ca = e[0:1], e[1:2]
            dx = px - gx
            sig = 0.5 * ca * dx * dx + dx * gx
            acc = acc + ca * jnp.exp(-sig)
        out_ref[0] = jnp.sum(acc.astype(jnp.float32), axis=0, keepdims=True)

    warm_exp()
    want = _interpret(kern, jax.ShapeDtypeStruct((NB, 1, K), jnp.float32), jnp.asarray(e), grid=(NB,),
                      in_specs=[pl.BlockSpec((1, 8, K), lambda b: (b, 0, 0))],
                      out_specs=pl.BlockSpec((1, 1, K), lambda b: (b, 0, 0)))
    got = pm.inner_math(torch.from_numpy(e), P, getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 5e-3
    _close(got, want, tol, np.abs(want))
    other = torch.bfloat16 if dtype == "float32" else torch.float32
    with pytest.raises(AssertionError):  # the gate rejects the other precision's result
        _close(pm.inner_math(torch.from_numpy(e), P, other), want, tol, np.abs(want))
    assert pm.inner_math_ops(torch.from_numpy(e), P) == (6 * P * NB * K, 42 * P * NB * K)


def _bf16(x):
    """float32 values rounded to bf16 (nearest, ties to even), held in
    float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _ftz(x):
    """Subnormal float32 values flushed to 0, as ex2.approx.ftz.f32 flushes
    its argument and its result."""
    x = np.asarray(x, np.float32)
    return np.where(np.abs(x) < np.finfo(np.float32).tiny, np.float32(0.0), x).astype(np.float32)


def _inner_walk(e, P, bf16, arg_bf16=False):
    """csrc/mb_inner_math.cu's arithmetic in numpy, each lane of e [NB, 8, K]
    at once: the six gx + zero r and 0.5 ca made once, px stepped by an
    exact + 1 in f32 (rounded to bf16 once a pixel), the exponential as
    exp2 of the f32 product sig (-log2 e) with subnormals flushed (MUFU's
    own error is the card's to show), bf16 rounding after every operation
    and after the exponential, the first repeat's add into a 0 acc left
    out, the pixels summed in order in f32 (bf16: in `INNER_RUNS` runs,
    their sums added pairwise as the shuffles add them). `arg_bf16`: the
    scaled argument rounded to bf16 too (ex2.approx.ftz.bf16x2's form,
    which the kernel does not take)."""
    f = np.float32
    rnd = _bf16 if bf16 else (lambda x: np.asarray(x, np.float32))
    gx0, ca = rnd(e[:, 0]), rnd(e[:, 1])
    half_ca = rnd(f(0.5) * ca)
    gx = [rnd(gx0 + rnd(f(0.0) * f(r))) for r in range(pm.REPEATS)]
    neg_log2e = f(-1.4426950408889634)
    runs = pm.INNER_RUNS if bf16 else 1
    per = -(-P // runs) or 1
    sums = [np.zeros(gx0.shape, np.float32) for _ in range(runs)]
    for p in range(P):
        if p % per == 0:  # a run starts its counter at (float)p0
            px = f(p)
        pxr = rnd(px)
        acc = None
        for g in gx:
            dx = rnd(pxr - g)
            sig = rnd(rnd(rnd(half_ca * dx) * dx) + rnd(dx * g))
            arg = _ftz(sig * neg_log2e)
            term = rnd(ca * rnd(_ftz(np.exp2(_bf16(arg) if arg_bf16 else arg))))
            acc = term if acc is None else rnd(acc + term)
        sums[p // per] = (sums[p // per] + acc).astype(np.float32)
        px = f(px + f(1.0))
    while len(sums) > 1:  # the shuffles: lanes m apart added, m = 1, 2, ...
        sums = [(a + b).astype(np.float32) for a, b in zip(sums[0::2], sums[1::2])]
    return sums[0][:, None, :]


def _e5_numpy(NB, K, seed):
    rng = np.random.default_rng(seed)
    return pm.e5_input(NB, K, lambda *s: rng.random(s).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 128, 3)] + list(pm.INNER_EDGES), ids=lambda s: "P{}-K{}-NB{}".format(*s))
def test_inner_walk_matches_plain(shape, dtype):
    """The kernels' arithmetic, walked in numpy, within the card's gates of
    inner_math_plain at e5's inputs and at the edge shapes phase 14 holds
    (K odd, K = 1, NB = 1, P = 1, P = 300: bf16's px past 256): the hoisted
    values, the exact px step and the f32 scaling of the exponential's
    argument stay within the gates; the bf16 gate rejects the f32
    arithmetic and an argument rounded to bf16."""
    P, K, NB = shape
    e = _e5_numpy(NB, K, 17 + P + K + NB)
    bf16 = dtype == "bfloat16"
    got = _inner_walk(e, P, bf16)
    want = pm.inner_math_plain(torch.from_numpy(e), P, getattr(torch, dtype))
    if bf16:
        _close(got, want, pm.TOL["inner_math_bf16"], pm.bf16_scale(want).numpy())
        for wrong in (_inner_walk(e, P, False), _inner_walk(e, P, True, arg_bf16=True)):
            with pytest.raises(AssertionError):
                _close(wrong, want, pm.TOL["inner_math_bf16"], pm.bf16_scale(want).numpy())
    else:
        warm_exp()
        _close(got, want, pm.TOL["inner_math_f32"], np.abs(want.numpy()))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("K, P", [(1, 256), (2, 1), (127, 3), (128, 256), (129, 300), (255, 5)])
def test_inner_plan_covers_every_lane(K, P, bf16):
    """inner_math's launch over NB x K flattened: the threads with work
    cover every (b, lane, pixel) once (a lone last lane at odd K in bf16,
    pixel runs of a lane pair that end early or hold nothing at small P),
    all in the plan's blocks, the runs of an item in one warp; P past 2^24
    and negative sizes are refused."""
    NB = 3
    plan = pm.inner_plan(NB, K, P, bf16)
    assert (plan.lanes, plan.runs) == ((2, pm.INNER_RUNS) if bf16 else (1, 1))
    assert plan.items == NB * -(-K // plan.lanes)
    assert (plan.blocks - 1) * pm.INNER_THREADS < plan.items * plan.runs <= plan.blocks * pm.INNER_THREADS
    assert 32 % plan.runs == 0
    seen = []
    for t in range(plan.blocks * pm.INNER_THREADS):
        work = pm.inner_thread_work(t, K, P, plan)
        if work is not None:
            b, lanes, pixels = work
            seen += [(b, k, p) for k in lanes for p in pixels]
        else:
            assert t >= plan.items * plan.runs
    assert sorted(seen) == [(b, k, p) for b in range(NB) for k in range(K) for p in range(P)]
    assert pm.inner_plan(0, K, P, bf16).blocks == 0
    pm.inner_plan(NB, K, pm.INNER_MAX_P, bf16)
    for bad in ((NB, K, pm.INNER_MAX_P + 1), (NB, K, -1), (-1, K, P)):
        with pytest.raises(ValueError):
            pm.inner_plan(*bad, bf16)


# --------------------------------------------------------------- exp_mxu_kernel_shapes
@functools.lru_cache(maxsize=None)
def _shapes_script():
    spec = importlib.util.spec_from_file_location(
        "exp_mxu_kernel_shapes", os.path.join(ROOT, "scripts", "exp_mxu_kernel_shapes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ks.VARIANTS)
def test_slice_shapes_match_kernel(variant):
    P, K, NB, T = 256, 256, 2, 2
    x = np.random.default_rng(7).random((16, K)).astype(np.float32)
    kern = functools.partial(_shapes_script()._kernel, variant=variant, P=P, K=K, NB=NB, native=False)
    warm_exp()
    want = _interpret(kern, jax.ShapeDtypeStruct((8, LANES), jnp.float32), jnp.asarray(x), grid=(T,),
                      in_specs=[pl.BlockSpec((16, K), lambda t: (0, 0))],
                      out_specs=pl.BlockSpec((8, LANES), lambda t: (0, 0)))
    got = ks.slice_shapes(variant, torch.from_numpy(x), P, NB, T)
    assert got.shape == (T, 8, LANES)
    rows = np.abs(want).max(axis=1, keepdims=True) * np.ones_like(want)  # each row's largest |value|
    for t in range(T):
        _close(got[t], want, 1e-5, rows)
    assert ks.needed_pairs(variant, K, P, NB, T) == T * NB * K * (LANES if variant == "fwd_mix" else P)


# --------------------------------------------------------------- exp_fwd_breakdown
def _breakdown_kernel(level, ts, tw, th, Kb=512, F=16, Dp=8):
    """scripts/exp_fwd_breakdown.py:67-132 (make_kernel), its globals as
    arguments, pltpu.roll -> jnp.roll."""
    NS = Kb // LANES
    P = ts * ts

    def kern(offs_ref, cnts_ref, e_hbm, out_ref, ebuf, esem):
        t = pl.program_id(0)
        off = offs_ref[t]
        n = cnts_ref[t]
        astart = (off // Kb) * Kb
        nb = pl.cdiv(off + n - astart, Kb)
        rem = t % (th * tw)
        ty, tx = rem // tw, rem % tw
        pix = jax.lax.broadcasted_iota(jnp.int32, (P, 1), 0)
        px = (tx * ts + pix % ts).astype(jnp.float32) + 0.5
        py = (ty * ts + pix // ts).astype(jnp.float32) + 0.5
        kidx = jax.lax.broadcasted_iota(jnp.int32, (1, LANES), 1)

        @pl.when(nb > 0)
        def _():
            RB._ecopy(e_hbm, ebuf, esem, astart, 0, Kb).start()

        def body(b, acc):
            slot = jax.lax.rem(b, 2)

            @pl.when(b + 1 < nb)
            def _():
                RB._ecopy(e_hbm, ebuf, esem, astart + (b + 1) * Kb, 1 - slot, Kb).start()

            RB._ecopy(e_hbm, ebuf, esem, astart + b * Kb, slot, Kb).wait()
            eb = ebuf[slot]
            if level == 0:
                return acc + jnp.sum(eb) * 1e-9
            for s_ in range(NS):
                e = eb[:, s_ * LANES: (s_ + 1) * LANES]
                gx, gy = e[0:1], e[1:2]
                ca_, cb_, cc_ = e[2:3], e[3:4], e[4:5]
                op_ = e[5:6]
                dx = px - gx
                dy = py - gy
                sig = 0.5 * (ca_ * dx * dx + cc_ * dy * dy) + cb_ * dx * dy
                alpha = jnp.minimum(op_ * jnp.exp(-sig), 0.999)
                gidx = astart + b * Kb + s_ * LANES + kidx
                colmask = (gidx >= off) & (gidx < off + n)
                valid = colmask & (alpha >= 1 / 255.0) & (sig >= 0.0)
                if level == 1:
                    acc += jnp.sum(jnp.where(valid, alpha, 0.0)) * 1e-9
                    continue
                one_m = jnp.where(valid, 1.0 - alpha, 1.0)
                Tm = _cumprod_lanes(one_m, LANES, "fwd_incl", False)
                Tm_excl = jnp.where(kidx >= 1, jnp.roll(Tm, 1, 1), 1.0)
                w = jnp.where(valid & (Tm_excl * one_m > 1e-4), Tm_excl * alpha, 0.0)
                if level == 2:
                    acc += jnp.sum(w) * 1e-9
                    continue
                acc += jax.lax.dot_general(
                    e[6: 6 + Dp, :LANES] * 1.0, w,
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST,
                )
            return acc

        out_ref[0] = jax.lax.fori_loop(0, nb, body, jnp.zeros((Dp, P), jnp.float32))

    def run(entries, offs, cnts):  # :135-152
        T = offs.shape[0]
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2, grid=(T,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
            out_specs=pl.BlockSpec((1, Dp, P), lambda t, *_: (t, 0, 0)),
            scratch_shapes=[pltpu.VMEM((2, F, Kb), jnp.float32), pltpu.SemaphoreType.DMA((2,))],
        )
        return pl.pallas_call(kern, grid_spec=grid_spec, out_shape=jax.ShapeDtypeStruct((T, Dp, P), jnp.float32),
                              interpret=True)(offs, cnts, entries)

    return run


@functools.lru_cache(maxsize=None)
def _stream():
    """A binned stream of the JAX package (tests/test_rasterize_binned.py's
    scene: 250 Gaussians, 2 cameras at 64x48) at tile 32, its entries padded
    to 16 rows and to whole 512-entry batches as the script pads them."""
    rng = np.random.default_rng(8)
    N, C, W, H, ts = 250, 2, 64, 48, 32
    means = rng.standard_normal((N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.3 + 0.05).astype(np.float32)
    opac = rng.random((N,)).astype(np.float32)
    colors = rng.random((C, N, 3)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[:, 2, 3] = 4.0
    viewmats[1, 0, 3] = 0.3
    Ks = np.tile(np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32), (C, 1, 1))
    radii, m2, depths, conics, _ = jax.jit(lambda m, q, s: fully_fused_projection(
        m, q, s, jnp.asarray(viewmats), jnp.asarray(Ks), W, H))(means, quats, scales)
    tw, th = -(-W // ts), -(-H // ts)
    opc = jnp.broadcast_to(jnp.asarray(opac)[None], (C, N))
    binned = jax.jit(lambda *a: jbinning.bin_gaussians(*a, ts, tw, th, capacity=8192, cull=True))(
        m2[..., 0], m2[..., 1], conics[..., 0], conics[..., 1], conics[..., 2], opc, jnp.asarray(colors), radii,
        depths)
    ent = np.asarray(binned.entries)
    M = -(-ent.shape[1] // 512) * 512 + 512
    entries = np.zeros((16, M), np.float32)
    entries[:ent.shape[0], :ent.shape[1]] = ent
    return entries, ent.shape[0], np.array(binned.offs), np.array(binned.cnts), tw, th, ts


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_fwd_breakdown_matches_make_kernel(level):
    entries, NF, offs, cnts, tw, th, ts = _stream()
    assert cnts.sum() > 0 and (offs % 512 != 0).any()
    warm_exp()
    want = np.asarray(_breakdown_kernel(level, ts, tw, th)(jnp.asarray(entries), jnp.asarray(offs),
                                                           jnp.asarray(cnts)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    # the port reads the stream's NF rows; the script's padding rows are zeros
    got = fb.fwd_breakdown(level, t(entries[:NF]), t(offs), t(cnts), tw, th, ts)
    assert got.shape == want.shape == (len(offs), 8, ts * ts)
    if level == 3:
        _close(got, want, 1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6 if level == 0 else 1e-5)
        assert (want > 0).any()
    nbytes, flops, ex2 = fb.work(level, t(entries[:NF]), t(offs), t(cnts), ts)
    assert nbytes > 4 * len(offs) * 8 * ts * ts and flops > 0 and (ex2 > 0) == (level > 0)


# --------------------------------------------------------------- the kernels' plans
# kernel_shapes.slice_plan and fwd_breakdown.breakdown_plan are the launch
# layouts of csrc/mb_slice_shapes.cu and csrc/mb_fwd_breakdown.cu; each
# covers every (lane, pixel) pair or every needed entry once, in order, and
# a torch walk of that layout gives the plain version's result
SLICE_SHAPES = [(1024, 64), (256, 4), (144, 3), (64, 2), (9, 1), (4096, 5)]  # (P, T)


def _walk_pixels(p0, p1, ts):
    """The kernel's walk of pixels [p0, p1): px and py stepped as floats."""
    px, py = np.float32(p0 % ts + 0.5), np.float32(p0 // ts + 0.5)
    out = []
    for _ in range(p0, p1):
        out.append((float(px), float(py)))
        px = np.float32(px + 1)
        if px > ts:
            px, py = np.float32(0.5), np.float32(py + 1)
    return out


@pytest.mark.parametrize("P, T", SLICE_SHAPES)
def test_slice_plan_lanes_cover_pairs(P, T):
    """A lane warp: 4 lanes of one tile, its threads' runs of the pixels;
    every (tile, lane, pixel) once, the runs in order, the walk exact."""
    ts = int(np.sqrt(P))
    plan = ks.slice_plan("vpu_sigma", P, T, 132)
    warps_a_block = plan.threads // 32
    units = T * LANES // ks.LANES_PER_THREAD
    assert plan.cluster == 1 and plan.blocks * warps_a_block >= units > (plan.blocks - 1) * warps_a_block - 1
    assert all(ks.slice_plan(v, P, T, 132) == plan for v in ("mxu_sigma", "moments", "vpu_reduce5"))
    runs = ks.pixel_split(P, ks.RUNS)
    assert runs[0] == 0 and runs[-1] == P and all(a <= b for a, b in zip(runs, runs[1:]))
    for p0, p1 in zip(runs, runs[1:]):
        assert _walk_pixels(p0, p1, ts) == [(p % ts + 0.5, p // ts + 0.5) for p in range(p0, p1)]
    cover = np.zeros((T, LANES, P), np.int32)
    for u in range(units):
        t, k0 = divmod(u, LANES // ks.LANES_PER_THREAD)
        for p0, p1 in zip(runs, runs[1:]):
            cover[t, k0 * 4:k0 * 4 + 4, p0:p1] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("P, T", SLICE_SHAPES)
def test_slice_plan_clusters_cover_pixels(P, T):
    """The scan and fwd_mix: a cluster a tile; its ranks' pixels, the scan's
    warps' runs (two halves walked at once) and fwd_mix's threads' pixels
    cover each pixel once, in order; the owners of pixels 0-127."""
    ts = int(np.sqrt(P))
    for variant in ("scan", "fwd_mix"):
        if variant == "fwd_mix" and not LANES <= P <= 1024:
            with pytest.raises(ValueError):
                ks.slice_plan(variant, P, T, 132)
            continue
        plan = ks.slice_plan(variant, P, T, 132)
        C = plan.cluster
        assert C == ks.cluster_size(T, 132) and plan.blocks == T * C and plan.threads % 32 == 0
        assert C == 8 or T * C >= 0.9 * 132 > T * C // 2 or C == 1
        ranks = ks.pixel_split(P, C)
        seen = []
        for c0, c1 in zip(ranks, ranks[1:]):
            if variant == "scan":
                bounds = [c0 + b for b in ks.pixel_split(c1 - c0, ks.SCAN_THREADS // 32)]
                for w0, w1 in zip(bounds, bounds[1:]):
                    half = (w1 - w0 + 1) // 2
                    a, b = list(range(w0, w0 + half)), list(range(w0 + half, w1))
                    assert len(b) in (half, half - 1) or half == 0
                    assert _walk_pixels(w0, w0 + half, ts) == [(p % ts + 0.5, p // ts + 0.5) for p in a]
                    seen += a + b
            else:
                assert plan.threads >= c1 - c0 > plan.threads - 32
                seen += [c0 + i for i in range(plan.threads) if c0 + i < c1]
        assert seen == list(range(P))
        if variant == "fwd_mix":  # the rank that holds each output pixel (the kernel's `owner`)
            owner = [max(c for c in range(C) if ranks[c] <= k) for k in range(LANES)]
            assert all(ranks[o] <= k < ranks[o + 1] for k, o in enumerate(owner))


def test_slice_plan_fills_the_card():
    """The script's size: 512 blocks of 4 lane warps; the scan and fwd_mix
    on clusters of 2 (128 of 132 SMs), fwd_mix a pixel a thread; small T on
    clusters of 8."""
    assert ks.slice_plan("vpu_sigma", 1024, 64, 132) == ks.SlicePlan(512, 128, 1)
    assert ks.slice_plan("scan", 1024, 64, 132) == ks.SlicePlan(128, 512, 2)
    assert ks.slice_plan("fwd_mix", 1024, 64, 132) == ks.SlicePlan(128, 512, 2)
    assert ks.slice_plan("scan", 256, 4, 132).cluster == 8 and ks.slice_plan("scan", 1024, 132, 132).cluster == 1
    for bad in [("fwd_mix", 100, 2), ("fwd_mix", 1089, 2), ("scan", 0, 2), ("scan", 64, -1)]:
        with pytest.raises(ValueError):
            ks.slice_plan(*bad, 132)


def _contrib(variant, e, pxl, pyl, Qm):
    """[P, 8, 128]: each pixel's term of acc for one slice's entries e (the
    plain version's expressions)."""
    gx, gy, ca, cb, cc = (e[i:i + 1] for i in range(5))
    dx, dy = pxl - gx, pyl - gy
    if variant == "vpu_reduce5":
        v = ca * dx + cb * dy
        rows = [0.5 * dx * dx * v, dx * dy * v, 0.5 * dy * dy * v, (ca * dx + cb * dy) * v, (cb * dx + cc * dy) * v]
        return torch.stack(rows + [torch.zeros_like(v)] * 3, dim=1)
    if variant == "vpu_sigma":
        v = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    elif variant == "mxu_sigma":
        coef = torch.cat([0.5 * ca, cb, 0.5 * cc, -(ca * gx + cb * gy), -(cc * gy + cb * gx),
                          0.5 * ca * gx * gx + cb * gx * gy + 0.5 * cc * gy * gy, torch.zeros((2, LANES))])
        v = Qm @ coef
    elif variant == "moments":
        v = ca * dx + cb * dy
    else:  # scan
        v = torch.cumprod(1.0 - torch.clamp_max(torch.abs(ca * dx), 0.99), dim=1)
    return Qm[:, :, None] * v[:, None, :]


def _walk_fwd_mix(x, P, NB, plan, pxl, pyl):
    """fwd_mix's cluster in torch, rank by rank: rank r holds pixels
    [c0, c1) of `pixel_split(P, C)` in a block of `plan.threads` threads
    (the last ones idle where the rank is part-full); each batch, lane k's
    dep is row 0 of pixel k as its owner rank wrote it into its own `own`
    row at the previous batch's end (the kernel's `owner[k]`, found by the
    kernel's search), every other value of `own` unset (NaN); [8, 128]."""
    C = plan.cluster
    ranks = ks.pixel_split(P, C)
    owner = []
    for k in range(LANES):
        r = 0
        while ranks[r + 1] <= k:
            r += 1
        owner.append(r)
    acc = torch.zeros((P, 8))
    own = torch.full((C, LANES), float("nan"))
    for b in range(NB):
        dep = torch.zeros(LANES) if b == 0 else own[owner, torch.arange(LANES)] * 1e-20
        own = torch.full((C, LANES), float("nan"))
        for r, (c0, c1) in enumerate(zip(ranks, ranks[1:])):
            assert plan.threads >= c1 - c0 > plan.threads - 32  # a part-full last warp at most
            for s in range(x.shape[1] // LANES):
                e = x[:, s * LANES:(s + 1) * LANES] + dep[None]
                gx, gy, ca, cb, cc, op = (e[i:i + 1] for i in range(6))
                dx, dy = pxl[c0:c1] - gx, pyl[c0:c1] - gy
                sig = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
                alpha = torch.clamp_max(op * torch.exp(-sig), 0.999)
                valid = (alpha >= 1.0 / 255.0) & (sig >= 0.0)
                Tm = torch.cumprod(torch.where(valid, 1.0 - alpha, 1.0), dim=1)
                acc[c0:c1] += torch.where(valid, Tm * alpha, 0.0) @ e[6:14].T  # every pixel its own chain
            mine = torch.arange(c0, max(c0, min(c1, LANES)))
            own[r, mine] = acc[mine, 0]  # the rank's output pixels' row 0
    assert not acc[:LANES].isnan().any()  # every lane's dep came from its owner
    return acc[:LANES].T.contiguous()


def _walk_slices(variant, x, P, NB, T):
    """The kernel's layout in torch: per-batch partials of each pixel group
    (a lane warp's runs; the scan's ranks x warps), each group's running
    totals, dep from the groups' row-0 totals; fwd_mix by `_walk_fwd_mix`;
    [T, 8, 128]."""
    plan = ks.slice_plan(variant, P, T, 132)
    pxl, pyl, Qm = ks._pixels(P, x.device)
    if variant == "fwd_mix":
        return _walk_fwd_mix(x, P, NB, plan, pxl, pyl).expand(T, 8, LANES)
    if variant == "scan":
        group = torch.empty(P, dtype=torch.long)
        ranks = ks.pixel_split(P, plan.cluster)
        g = 0
        for c0, c1 in zip(ranks, ranks[1:]):
            bounds = ks.pixel_split(c1 - c0, ks.SCAN_THREADS // 32)
            for w0, w1 in zip(bounds, bounds[1:]):
                group[c0 + w0:c0 + w1] = g
                g += 1
    else:
        runs = ks.pixel_split(P, ks.RUNS)
        group = torch.repeat_interleave(torch.arange(ks.RUNS), torch.tensor(np.diff(runs)))
        g = ks.RUNS
    racc = torch.zeros((g, 8, LANES))
    with _backend.full_f32_matmul():
        for _ in range(NB):
            dep = racc[:, 0].sum(0, keepdim=True) * 1e-20
            pr = torch.zeros_like(racc)
            for s in range(x.shape[1] // LANES):
                pr.index_add_(0, group, _contrib(variant, x[:, s * LANES:(s + 1) * LANES] + dep, pxl, pyl, Qm))
            racc += pr
    return racc.sum(0).expand(T, 8, LANES)


@pytest.mark.parametrize("variant", ks.VARIANTS)
@pytest.mark.parametrize("P", [256, 144])
def test_slice_walk_matches_plain(variant, P):
    K, NB, T = 256, 2, 3
    x = torch.from_numpy(np.random.default_rng(9).random((16, K)).astype(np.float32))
    warm_exp()
    want = ks.slice_shapes_plain(variant, x, P, NB, T)
    got = _walk_slices(variant, x, P, NB, T)
    _close(got, want.numpy(), ks.TOL, ks.row_scale(want).numpy())


def _stream_tensors():
    entries, NF, offs, cnts, tw, th, ts = _stream()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return t(entries[:NF]), t(offs), t(cnts), tw, th, ts


def _check_items(plan, level, offs, cnts, M, cap):
    """Every tile's needed range, once and in order, in items of at most
    `cap` slices (L0: whole batches), the first cut at the range's first
    slice; none for a tile with nothing to read; slots and finish rows
    agree."""
    off, n = offs.long().numpy(), cnts.long().numpy()
    items, finish = plan.items.numpy(), plan.finish.numpy()
    unit, per = fb.item_units(level)
    assert cap == fb.ITEM_SLICES and (unit, per) == ((fb.KB, max(1, cap // 4)) if level == 0 else (LANES, cap))
    sizes = items[:, 2] - items[:, 1]
    assert (sizes > 0).all() and (np.diff(sizes) <= 0).all()  # heaviest first
    assert ((items[:, 2] - 1) // unit - items[:, 1] // unit < per).all()  # no item over its cap
    by_tile = {}
    for tile, a, b, slot in items.tolist():
        by_tile.setdefault(tile, []).append((a, b, slot))
    slots = []
    fin = {int(r[0]): (int(r[1]), int(r[2])) for r in finish}
    for tile in range(len(off)):
        if level == 0:
            lo = off[tile] // fb.KB * fb.KB
            hi = min(lo + (off[tile] + n[tile] - lo + fb.KB - 1) // fb.KB * fb.KB, M)
        else:
            lo, hi = off[tile], min(off[tile] + n[tile], M)
        got = sorted(by_tile.get(tile, []))
        if hi <= lo:
            assert not got and fin[tile] == (fin[tile][0], 0)
            continue
        assert got[0][0] == lo and got[-1][1] == hi and all(a[1] == b[0] for a, b in zip(got, got[1:]))
        assert len(got) == -(-((hi - 1) // unit - lo // unit + 1) // per)
        assert all((b - lo // unit * unit) % (per * unit) == 0 for _, b, _ in got[:-1])  # cut from the first slice
        if len(got) == 1:
            assert got[0][2] == -1 and tile not in fin
        else:
            assert fin[tile] == (got[0][2], len(got)) and [s for *_, s in got] == list(range(got[0][2], got[0][2] + len(got)))
            slots += [s for *_, s in got]
    assert sorted(slots) == list(range(plan.slots)) == slots


def _synthetic_stream():
    """offs / cnts with empty tiles, ranges that start and end mid-slice,
    one exactly on slice edges, one of 3,000 entries, and one past M."""
    cnts = np.array([0, 5, 130, 0, 3000, 128, 77, 1, 0, 700, 40], np.int32)
    offs = np.concatenate([[3], 3 + np.cumsum(cnts)[:-1]]).astype(np.int32)
    offs[5] = 3456  # [3456, 3584): exactly one slice
    return torch.from_numpy(offs), torch.from_numpy(cnts), int(offs[-1]) + 20  # the last tile runs past M


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("cap", [1, 2, 8])
def test_breakdown_plan_items(level, cap, monkeypatch):
    monkeypatch.setattr(fb, "ITEM_SLICES", cap)
    offs, cnts, M = _synthetic_stream()
    plan = fb.breakdown_plan(level, offs, cnts, M)
    assert (plan.level, plan.T, plan.M) == (level, len(offs), M)
    assert plan.items.dtype == plan.finish.dtype == torch.int32
    _check_items(plan, level, offs, cnts, M, cap)
    if level:
        assert fb.breakdown_plan(3, offs, cnts, M).items.equal(plan.items)
        starts = {a for _, a, _, _ in plan.items.tolist()}
        mid = [t for t in range(len(offs)) if offs[t] % LANES and (offs[t] + cnts[t]) % LANES and cnts[t] > LANES]
        assert mid and all(int(offs[t]) in starts for t in mid)  # a tile that starts mid-slice starts an item there
        heavy = max(range(len(offs)), key=lambda t: int(cnts[t]))  # 3,000 entries over 24 slices
        assert sum(1 for it in plan.items.tolist() if it[0] == heavy) == -(-24 // cap)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("cap", [1, 8])
def test_breakdown_plan_on_the_stream(level, cap, monkeypatch):
    monkeypatch.setattr(fb, "ITEM_SLICES", cap)
    entries, offs, cnts, *_ = _stream_tensors()
    M = entries.shape[1]
    plan = fb.breakdown_plan(level, offs, cnts, M)
    _check_items(plan, level, offs, cnts, M, cap)
    if cap == 1 and level:
        assert plan.slots > 0  # tiles split


def _walk_breakdown(level, entries, offs, cnts, tw, th, ts, plan):
    """The kernel's walk in torch: each item's partial (L1-L3 from its first
    entry, the transmittance restarting there and at every multiple of 128),
    in launch order; one item's tile written, a split tile's partials added
    in item order by the finish rows."""
    P = ts * ts
    pix = torch.arange(P)
    out = torch.full((len(offs), 8, P), float("nan"))
    partial = {}
    for tile, a, b, slot in plan.items.tolist():
        if level == 0:
            val = entries[:, a:b].sum()
        else:
            rem = tile % (th * tw)
            px = ((rem % tw) * ts + pix % ts + 0.5).float()[:, None]
            py = ((rem // tw) * ts + pix // ts + 0.5).float()[:, None]
            val = torch.zeros((8, P)) if level == 3 else torch.zeros(())
            lo = a
            while lo < b:
                hi = min(b, (lo // LANES + 1) * LANES)
                e = entries[:, lo:hi]
                gx, gy, ca, cb, cc, op = (e[r:r + 1] for r in range(6))
                dx, dy = px - gx, py - gy
                sig = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
                alpha = torch.clamp_max(op * torch.exp(-sig), 0.999)
                valid = (alpha >= 1.0 / 255.0) & (sig >= 0.0)
                if level == 1:
                    val = val + torch.where(valid, alpha, 0.0).sum()
                else:
                    Tm = torch.cumprod(torch.where(valid, 1.0 - alpha, 1.0), dim=1)
                    T_excl = torch.cat([torch.ones_like(Tm[:, :1]), Tm[:, :-1]], dim=1)
                    w = torch.where(valid & (Tm > 1e-4), T_excl * alpha, 0.0)
                    if level == 2:
                        val = val + w.sum()
                    else:
                        colours = torch.zeros((8, hi - lo))
                        colours[:min(e.shape[0] - 6, 8)] = e[6:14]
                        val = val + colours @ w.T
                lo = hi
        if slot < 0:
            out[tile] = val if level == 3 else val * 1e-9
        else:
            partial[slot] = val
    for tile, first, count, _ in plan.finish.tolist():
        total = torch.zeros((8, P)) if level == 3 else torch.zeros(())
        for s in range(count):
            total = total + partial[first + s]
        out[tile] = total if level == 3 else total * 1e-9
    assert not out.isnan().any()  # every tile written once
    return out


@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("cap", [1, 8])
def test_breakdown_walk_matches_plain(level, cap, monkeypatch):
    monkeypatch.setattr(fb, "ITEM_SLICES", cap)
    entries, offs, cnts, tw, th, ts = _stream_tensors()
    warm_exp()
    plan = fb.breakdown_plan(level, offs, cnts, entries.shape[1])
    want = fb.fwd_breakdown_plain(level, entries, offs, cnts, tw, th, ts)
    got = _walk_breakdown(level, entries, offs, cnts, tw, th, ts, plan)
    if level == 3:
        _close(got, want.numpy(), fb.TOL[3])
    else:
        terms = fb.fwd_breakdown_plain(0, entries.abs(), offs, cnts, tw, th, ts) if level == 0 else want.abs()
        _close(got, want.numpy(), fb.TOL[level], terms.numpy())


@pytest.mark.parametrize("level", [0, 3])
def test_fwd_breakdown_refuses_another_streams_plan(level):
    """A plan is held to the stream it is used on (its level, T and M) and
    to contiguous int32 [n, 4] lists, whichever version runs; the stream's
    own plan passes and the plain result comes back."""
    entries, offs, cnts, tw, th, ts = _stream_tensors()
    o2, c2, M2 = _synthetic_stream()
    other = fb.breakdown_plan(level, o2, c2, M2)
    own = fb.breakdown_plan(level, offs, cnts, entries.shape[1])
    short = fb.breakdown_plan(level, offs[:-1], cnts[:-1], entries.shape[1])  # a tile fewer
    wide = fb.breakdown_plan(level, offs, cnts, entries.shape[1] + 128)  # more entries
    wrong = [other, short, wide, fb.breakdown_plan(1 if level == 0 else 2, offs, cnts, entries.shape[1]),
             own._replace(items=own.items.t().contiguous().t()), own._replace(finish=own.finish.long()),
             own._replace(items=own.items.reshape(-1))]
    for plan in wrong:
        with pytest.raises(ValueError):
            fb.fwd_breakdown(level, entries, offs, cnts, tw, th, ts, plan=plan)
        with pytest.raises(ValueError):
            fb.check_plan(plan, level, entries, offs)
    fb.check_plan(own, level, entries, offs)
    got = fb.fwd_breakdown(level, entries[:, :1], offs[:1] * 0, cnts[:1] * 0, tw, th, ts,
                           plan=fb.breakdown_plan(level, offs[:1] * 0, cnts[:1] * 0, 1))
    assert got.shape == (1, 8, ts * ts) and not got.any()  # one empty tile


def _c_kinds(src, symbol):
    """The ctypes type of each parameter of `extern "C" int symbol(...)`."""
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src).group(1).split(",")
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_longlong if "long long" in p else ctypes.c_int for p in params]
    return [p.split()[-1].lstrip("*") for p in params], kinds


def test_slice_wrappers_bind_c_signatures():
    """kernel_shapes and fwd_breakdown bind their C entries with one ctypes
    type for each parameter, in order; the slice entry takes the cluster
    size alone and derives the layout that slice_plan mirrors from the
    source's own constants."""
    with open(os.path.join(_backend.CSRC, "mb_slice_shapes.cu")) as f:
        src = f.read()
    names, kinds = _c_kinds(src, "slice_shapes_launch")
    assert kinds == ks._ARGS and names[8] == "cluster"
    for const, value in (("kLpt", ks.LANES_PER_THREAD), ("kRuns", ks.RUNS), ("kLaneBlock", ks.LANE_BLOCK),
                         ("kScanThreads", ks.SCAN_THREADS), ("kMaxCluster", ks.MAX_CLUSTER)):
        assert f"constexpr int {const} = {value};" in src
    with open(os.path.join(_backend.CSRC, "mb_fwd_breakdown.cu")) as f:
        names, kinds = _c_kinds(f.read(), "fwd_breakdown_launch")
    assert kinds == fb._ARGS and names[7:11] == ["items", "n_items", "finish", "n_finish"]
