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
- the six slice shapes: 1e-5 of the largest |value| of each of acc's rows
  (the rows differ by ~100x; the scan is a product in order here and a
  log-step product on the TPU; sums in another order);
- the forward breakdown on a binned stream of the JAX package: L0 rtol
  1e-6 (adds in another order), L1 and L2 rtol 1e-5, L3 1e-5 of the
  largest |value| (a sum per pixel in another order; the decisions round
  alike).
"""

import functools
import importlib.util
import os

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
