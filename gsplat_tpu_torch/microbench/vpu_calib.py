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
- `sgemm(x, y, repeats)`: x @ y in f32 FFMA on the CUDA cores (HIGHEST's
  contract), ``repeats`` times (blocks over the repeats, a loop of
  `GEMM_REPS` in each): a pre-pass writes x^T to scratch, then FFMA on
  128 x 128 output tiles, 8 x 8 outputs a thread, from a ring of three
  16-deep stages of x^T and y that ``cp.async`` fills. Bound: 2 M N K B
  flops at 67 TFLOP/s; at [512, 1024] @ [1024, 512], B = 256: 1.374e11,
  2.05 ms.
- `tf32_mma(x, y, repeats)`: the same product on the tensor cores in TF32,
  Hopper's one-pass counterpart of the TPU's DEFAULT (one bf16 pass). A
  pre-pass rounds x and y to TF32 (``cvt.rna``, as `round_tf32`) into
  scratch, y transposed (`tf32_staged`); then ``wgmma.mma_async``
  m64nNk8 .tf32 from shared-memory tiles that TMA fills (a 4-stage ring,
  128-byte swizzled, one producer thread and two consumer warpgroups).
  Bound: 1.374e11 at 495 TFLOP/s, 0.278 ms.

`gemm_plan` is both kernels' shape contract: the tile, the grid and the
dynamic shared memory a call takes, or ValueError. The yardstick of both
products is one ``torch.bmm`` of the B repeats with TF32 off and on
(`_backend.full_f32_matmul` / `_backend.tf32_matmul`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

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


_CHAIN_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def _fma_chain_cuda(x: torch.Tensor, passes: int) -> torch.Tensor:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the fma_chain kernel takes CUDA tensors, got {dev}")
    check_inputs("fma_chain", dev, [(x, torch.float32, None)])
    out = torch.empty_like(x)
    fn = _backend.kernel("mb_calib", "fma_chain_launch", _CHAIN_ARGS)
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


def tf32_staged(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What `tf32_mma`'s pre-pass writes: round_tf32(x) [M, K] and
    round_tf32(y)^T [N, K] (K-major, as wgmma takes TF32 operands)."""
    return round_tf32(x), round_tf32(y).T.contiguous()


def tf32_mma_plain(x: torch.Tensor, y: torch.Tensor, repeats: int = B) -> torch.Tensor:
    """TF32 inputs, exact products, f32 sums."""
    with _backend.full_f32_matmul():
        return round_tf32(x) @ round_tf32(y)


# the kernels' tiles (csrc/mb_calib.cu): output rows x columns of a block,
# k of a stage, stages in the ring
SGEMM_TILE, SGEMM_STAGES = (128, 128, 16), 3
TF32_BM, TF32_BK, TF32_STAGES = 128, 32, 4  # two warpgroups of 64 rows; 32 TF32 = one 128-byte row
STAGE_TILE = 32  # the pre-passes' transposed tiles
SMEM_LIMIT = 232_448  # a block's shared memory on the H100


class GemmPlan(NamedTuple):
    tile: Tuple[int, int, int]  # output rows, columns of a block; k of a stage
    grid: Tuple[int, int, int]  # (N / columns, M / rows, repeats / reps): each block loops reps passes
    smem: int  # dynamic shared bytes of a block


def gemm_plan(name: str, m: int, n: int, k: int, repeats: int) -> GemmPlan:
    """The launch `name` ("sgemm" or "tf32_mma") makes for x [m, k] @ y
    [k, n] ``repeats`` times; ValueError for a shape its tiles cannot
    cover (k a multiple of 32 for the pre-passes' tiles too). sgemm: 128 x
    128 tiles, three stages of A^T [16, 128] and B [16, 128]. tf32_mma: 128
    x 256 tiles (128 x 128 where n is not a multiple of 256), four stages
    of A [128, 32] and B [n-tile, 32], 1024 bytes to align them."""
    reps = min(GEMM_REPS, repeats)
    if name == "sgemm":
        tile = SGEMM_TILE
        smem = SGEMM_STAGES * tile[2] * (tile[0] + tile[1]) * 4
    elif name == "tf32_mma":
        bn = 256 if n % 256 == 0 else 128
        tile = (TF32_BM, bn, TF32_BK)
        smem = TF32_STAGES * (TF32_BM + bn) * TF32_BK * 4 + 1024
    else:
        raise ValueError(f"no product kernel {name!r}")
    bm, bn, bk = tile[0], tile[1], max(tile[2], STAGE_TILE)
    if min(m, n, k) <= 0 or m % bm or n % bn or k % bk or repeats < 1 or repeats % reps or repeats // reps > 65535:
        raise ValueError(f"{name} takes M a multiple of {bm}, N of {bn}, K of {bk} and repeats a multiple of "
                         f"{reps} (at most {65535 * reps}): got {m} {n} {k} {repeats}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} bytes of shared memory, above {SMEM_LIMIT}")
    return GemmPlan(tile, (n // bn, m // bm, repeats // reps), smem)


_SGEMM_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 3
_TF32_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4


def _gemm_cuda(name: str, x: torch.Tensor, y: torch.Tensor, repeats: int,
               staged: Optional[list] = None) -> torch.Tensor:
    """The kernel's product; `staged` (a list) receives its pre-pass's
    scratch: sgemm's x^T, tf32_mma's (xs, ys)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, got {dev}")
    (m, k), n = x.shape, y.shape[1]
    check_inputs(name, dev, [(x, torch.float32, None), (y, torch.float32, (k, n))])
    plan = gemm_plan(name, m, n, k, repeats)
    reps = repeats // plan.grid[2]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if name == "sgemm":
        scratch = [torch.empty((k, m), dtype=torch.float32, device=dev)]
        fn = _backend.kernel("mb_calib", "sgemm_launch", _SGEMM_ARGS)
        rc = fn(x.data_ptr(), y.data_ptr(), m, n, k, repeats, reps, 0.0, scratch[0].data_ptr(), out.data_ptr(),
                _backend.stream(dev))
    else:
        scratch = [torch.empty((m, k), dtype=torch.float32, device=dev),
                   torch.empty((n, k), dtype=torch.float32, device=dev)]
        fn = _backend.kernel("mb_calib", "tf32_mma_launch", _TF32_ARGS)
        rc = fn(x.data_ptr(), y.data_ptr(), m, n, k, repeats, reps, plan.tile[1], scratch[0].data_ptr(),
                scratch[1].data_ptr(), out.data_ptr(), _backend.stream(dev))
    if staged is not None:
        staged += scratch
    _backend.check_launch(rc, name)
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
    """Each kernel against its plain version, {kernel: max abs error} (the
    products' pre-pass scratch too, bit for bit), and each product's gate
    on the other product's output, {"rejects ...": its max abs error}."""
    xc, x, y = inputs(small)
    reps = SMALL[3] if small else B
    xt, staged = [], []
    f32, tf32 = _gemm_cuda("sgemm", x, y, reps, xt), _gemm_cuda("tf32_mma", x, y, reps, staged)
    f32_want, tf32_want = sgemm_plain(x, y), tf32_mma_plain(x, y)
    xs_want, ys_want = tf32_staged(x, y)
    chain = fma_chain_plain(xc)
    return {
        "fma_chain": compare("fma_chain", fma_chain(xc, reps), chain, TOL["fma_chain"], chain.abs()),
        "sgemm": compare("sgemm", f32, f32_want, TOL["sgemm"]),
        "tf32_mma": compare("tf32_mma", tf32, tf32_want, TOL["tf32_mma"]),
        # the pre-passes' scratch: the plain staging's bits
        "sgemm's staged x^T": compare("sgemm's staged x^T", xt[0], x.T),
        "tf32_mma's staged x": compare("tf32_mma's staged x", staged[0], xs_want),
        "tf32_mma's staged y^T": compare("tf32_mma's staged y^T", staged[1], ys_want),
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
