"""The card's f32 multiply-add and matrix rates (port of
scripts/exp_vpu_calib.py; kernels in csrc/mb_calib.cu).

The TPU script asks how many f32 elementwise operations a second a kernel
really sustains (``vpu_kernel`` :18, pallas_call :47) and what a matmul
reaches at HIGHEST and at DEFAULT precision (``mxu_kernel`` :29, pallas_call
:62), each over the same block in B grid steps, to ground the operation
bounds. Here:

- `fma_chain(x, passes)`: per element a = x, b = x / 2, 24 times
  {a = a b + 1e-6; b = b + a / 4}, out = a + b: 48 chained multiply-adds,
  run ``passes`` times in a loop on the card (each pass fed a runtime zero
  times the last result, so none is hoisted or merged) with one pass's
  output. Bound: operations, 48 P K B multiply-adds at 33.5e12 a second
  (67 TFLOP/s); at the script's x [512, 1024], B = 256: 6.44e9, 0.192 ms.
- `sgemm(x, y, repeats)`: x @ y in f32 on the CUDA cores (HIGHEST's
  contract), ``repeats`` times (blocks over the repeats, a loop of
  `GEMM_REPS` in each). Bound: 2 M N K B flops at 67 TFLOP/s; at [512,
  1024] @ [1024, 512], B = 256: 1.374e11, 2.05 ms.
- `tf32_mma(x, y, repeats)`: the same product on the tensor cores in TF32
  (mma.sync m16n8k8, inputs rounded to TF32), Hopper's one-pass
  counterpart of the TPU's DEFAULT (one bf16 pass). Bound: 1.374e11 at 495
  TFLOP/s, 0.278 ms.

The yardstick of both products is one ``torch.bmm`` of the B repeats with
TF32 off and on (`_backend.full_f32_matmul` / `_backend.tf32_matmul`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _backend
from ..ops.rasterize_binned import _check as check_inputs
from . import PEAK_F32_FLOPS, PEAK_F32_FMAS, PEAK_TF32_FLOPS, bound_ms, compare, median_ms, rejects

B, P, K, OPS = 256, 512, 1024, 48  # the TPU script's repeats and block
M = 512  # y [K, M]
GEMM_REPS = 8  # repeats a block of the products loops over


def fma_chain_plain(x: torch.Tensor, passes: int = B) -> torch.Tensor:
    """One pass of the chain (every pass gives the same)."""
    a = x
    b = x * 0.5
    for _ in range(OPS // 2):
        a = a * b + 1e-6
        b = b + a * 0.25
    return a + b


def _fma_chain_cuda(x: torch.Tensor, passes: int) -> torch.Tensor:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the fma_chain kernel takes CUDA tensors, got {dev}")
    check_inputs("fma_chain", dev, [(x, torch.float32, None)])
    out = torch.empty_like(x)
    fn = _backend.kernel("mb_calib", "fma_chain_launch",
                         [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                          ctypes.c_void_p])
    _backend.check_launch(fn(x.data_ptr(), x.numel(), passes, 0.0, out.data_ptr(), _backend.stream(dev)),
                          "fma_chain")
    _backend.LAUNCHES["fma_chain"] += 1
    return out


def fma_chain(x: torch.Tensor, passes: int = B) -> torch.Tensor:
    """The kernel (``passes`` passes) for CUDA tensors, the plain version
    for CPU tensors."""
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    return _fma_chain_cuda(x, passes) if _backend.use_kernel(x.device) else fma_chain_plain(x, passes)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from zero:
    cvt.rna.tf32.f32), kept in f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def sgemm_plain(x: torch.Tensor, y: torch.Tensor, repeats: int = B) -> torch.Tensor:
    with _backend.full_f32_matmul():
        return x @ y


def tf32_mma_plain(x: torch.Tensor, y: torch.Tensor, repeats: int = B) -> torch.Tensor:
    """TF32 inputs, exact products, f32 sums."""
    with _backend.full_f32_matmul():
        return round_tf32(x) @ round_tf32(y)


_GEMM_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 2


def _gemm_cuda(name: str, x: torch.Tensor, y: torch.Tensor, repeats: int) -> torch.Tensor:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, got {dev}")
    (m, k), n = x.shape, y.shape[1]
    check_inputs(name, dev, [(x, torch.float32, None), (y, torch.float32, (k, n))])
    reps = min(GEMM_REPS, repeats)
    if m % 64 or n % 64 or k % 32 or repeats % reps:
        raise ValueError(f"{name} takes M, N multiples of 64, K of 32 and repeats of {reps}: got {m} {n} {k} "
                         f"{repeats}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = _backend.kernel("mb_calib", f"{name}_launch", _GEMM_ARGS)
    _backend.check_launch(fn(x.data_ptr(), y.data_ptr(), m, n, k, repeats, reps, 0.0, out.data_ptr(),
                             _backend.stream(dev)), name)
    _backend.LAUNCHES[name] += 1
    return out


def sgemm(x: torch.Tensor, y: torch.Tensor, repeats: int = B) -> torch.Tensor:
    """x @ y, f32 on the CUDA cores ``repeats`` times (kernel), or once in
    plain torch with TF32 off (CPU tensors)."""
    if _backend.use_kernel(_backend.common_device(x, y)):
        return _gemm_cuda("sgemm", x, y, repeats)
    return sgemm_plain(x, y, repeats)


def tf32_mma(x: torch.Tensor, y: torch.Tensor, repeats: int = B) -> torch.Tensor:
    """x @ y in TF32 on the tensor cores ``repeats`` times (kernel), or its
    plain version (CPU tensors)."""
    if _backend.use_kernel(_backend.common_device(x, y)):
        return _gemm_cuda("tf32_mma", x, y, repeats)
    return tf32_mma_plain(x, y, repeats)


def fma_count(x: torch.Tensor, passes: int = B) -> int:
    return OPS * x.numel() * passes


def gemm_flops(x: torch.Tensor, y: torch.Tensor, repeats: int = B) -> int:
    return 2 * x.shape[0] * x.shape[1] * y.shape[1] * repeats


# On the card. Kernel against plain: the chain rounds a b + c once (a
# multiply-add), the plain version twice, 1e-5 of each |value| (a chain of
# positive terms); the products, 1e-5 of the largest |value|, their sums in
# another order (TF32: on TF32-rounded inputs, exact products). The
# products' inputs are signed (randn), so that f32 products at the TF32
# gate, and TF32 products at the f32 gate, are rejected (`check` shows
# both; signed, they differ by ~3e-4 of the largest |value|, on inputs in
# [0, 1) by ~5e-5).
TOL = {"fma_chain": 1e-5, "sgemm": 1e-5, "tf32_mma": 1e-5}
SMALL = (128, 256, 128, 16)  # x [M, K], y [K, N], repeats


def inputs(small: bool):
    """(x in [0, 1) for the chain, x and y signed for the products)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    m, k, n, _ = SMALL if small else (P, K, M, B)
    return (torch.rand(m, k, device="cuda", generator=g), torch.randn(m, k, device="cuda", generator=g),
            torch.randn(k, n, device="cuda", generator=g))


def check(small: bool):
    """Each kernel against its plain version, {kernel: max abs error}, and
    each product's gate on the other product's output, {"rejects ...":
    its max abs error}."""
    xc, x, y = inputs(small)
    reps = SMALL[3] if small else B
    f32, tf32 = sgemm(x, y, reps), tf32_mma(x, y, reps)
    f32_want, tf32_want = sgemm_plain(x, y), tf32_mma_plain(x, y)
    chain = fma_chain_plain(xc)
    return {
        "fma_chain": compare("fma_chain", fma_chain(xc, reps), chain, TOL["fma_chain"], chain.abs()),
        "sgemm": compare("sgemm", f32, f32_want, TOL["sgemm"]),
        "tf32_mma": compare("tf32_mma", tf32, tf32_want, TOL["tf32_mma"]),
        "rejects sgemm's output at tf32_mma's gate": rejects("tf32_mma's gate", f32, tf32_want, TOL["tf32_mma"]),
        "rejects tf32_mma's output at sgemm's gate": rejects("sgemm's gate", tf32, f32_want, TOL["sgemm"]),
    }


def measure(runs: int = 7):
    """The kernels at the script's sizes: one row each, with its rate; the
    library call is ``torch.bmm`` of the B repeats as one batched product
    (batch stride 0), TF32 off and on."""
    xc, x, y = inputs(False)
    fmas, flops = fma_count(xc, B), gemm_flops(x, y, B)
    xb, yb = x.expand(B, -1, -1), y.expand(B, -1, -1)
    rows = []
    ms = median_ms(lambda: fma_chain(xc, B), runs)
    rows.append(dict(name="fma_chain", ms=ms, plain_ms=median_ms(lambda: fma_chain_plain(xc), runs),
                     library_ms=None, rate=fmas / ms * 1e3, unit="multiply-adds/s", peak=PEAK_F32_FMAS,
                     work=f"{fmas} multiply-adds", **dict(zip(("bound_ms", "bound_by"), bound_ms(flops=2 * fmas)))))
    for name, fn, plain, switch, peak, kind in (
            ("sgemm", sgemm, sgemm_plain, _backend.full_f32_matmul, PEAK_F32_FLOPS, "flops"),
            ("tf32_mma", tf32_mma, tf32_mma_plain, _backend.tf32_matmul, PEAK_TF32_FLOPS, "tf32_flops")):
        ms = median_ms(lambda: fn(x, y, B), runs)
        with switch():
            lib = median_ms(lambda: torch.bmm(xb, yb), runs)
        rows.append(dict(name=name, ms=ms, plain_ms=median_ms(lambda: plain(x, y), runs), library_ms=lib,
                         rate=flops / ms * 1e3, unit="flop/s", peak=peak,
                         work=f"{flops} {'TF32 ' if name == 'tf32_mma' else ''}flops",
                         **dict(zip(("bound_ms", "bound_by"), bound_ms(**{kind: flops})))))
    return rows
