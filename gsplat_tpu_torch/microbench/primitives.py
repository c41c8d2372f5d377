"""Gathers and the sigma / exp inner math (port of the Pallas kernels of
scripts/exp_r2_primitives.py e1, e4, e5 and scripts/exp_r2_batch2.py g1;
kernels in csrc/mb_gather.cu and csrc/mb_inner_math.cu).

The TPU scripts ask what an in-kernel gather costs (along sublanes, along
lanes, from a resident window, or as a one-hot matmul) and what bf16 buys
in the rasterizers' inner math. Here, each with the TPU function it
replaces and its bound on the card:

- `gather_rows(tab, idx)`: out[b, s, l] = tab[b, idx[b, s, l], l], tab,
  idx, out [NB, S, L] (``g1.kern``, exp_r2_batch2.py:18, pallas_call :27;
  with ``idx % F`` also e1's ``k_taa0``, exp_r2_primitives.py:57, :67). A
  table is more than a block's shared memory (1 MB at [2048, 128]): a block
  stages 8 lanes of it. Bound: bytes, 1.61 GB at [512, 2048, 128], 0.481 ms.
- `gather_window(tab, idx)`: out[b, f, k] = tab[f, idx[b, f, k]] from a
  window tab [F, W] (e1's ``kern2``, :79, :86; with one b also e1's
  ``k_taa``, :52, :67). A block stages a row (32 KB at W = 8192). Bound:
  bytes, 67.6 MB at [16, 8192], idx [256, 16, 2048]: 0.020 ms.
- `gather_cols(tab, idx)`: out[b, f, s] = tab[b, f, idx[b, 0, s]] (e4's
  ``kern``, :155, :168), a one-hot matmul at HIGHEST on the TPU: exact, so
  the port gathers (one-hot selection gets no Hopper counterpart). Bound:
  bytes, 105 MB at [512, 16, 1024], idx [512, 1, 2048]: 0.031 ms.
- `inner_math(e, P, dtype)`: out[b, 0, k] = sum over P pixels of six
  repeats of ca exp(-(0.5 ca dx dx + dx gx)), dx = px - gx, in f32 or bf16
  (e5's ``mk(dtype).kern``, :189, :204). Bound: operations, 6 P K NB
  exponentials at the SFU's rate (`PEAK_EX2_PER_S`, 4.18e12 a second): at
  NB = 2048, P = 256, K = 128, 4.03e8 and 0.096 ms; the f32 flops (2.82e9)
  bound lower.

The gathers' indices must lie inside the table (the kernels do not check;
the plain versions, ``torch.gather``, raise). One ``torch.gather`` call
computes each gather's function, so the plain version is also the
yardstick (``library ms``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _backend
from ..ops.rasterize_binned import _check as check_inputs
from . import PEAK_BYTES_PER_S, PEAK_EX2_PER_S, bound_ms, compare, median_ms, rejects

REPEATS = 6  # e5's repeats of the inner math


def _launch(source: str, symbol: str, name: str, argtypes, *args) -> None:
    """Launch `symbol` of csrc/`source`.cu and count it as kernel `name`."""
    _backend.check_launch(_backend.kernel(source, symbol, argtypes)(*args), name)
    _backend.LAUNCHES[name] += 1


def gather_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(tab, 1, idx.long())


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, s, l] = tab[b, idx[b, s, l], l] (tab f32, idx i32 [NB, S, L])."""
    dev = _backend.common_device(tab, idx)
    if not _backend.use_kernel(dev):
        return gather_rows_plain(tab, idx)
    NB, S, L = tab.shape
    check_inputs("gather_rows", dev, [(tab, torch.float32, None), (idx, torch.int32, (NB, S, L))])
    out = torch.empty_like(tab)
    _launch("mb_gather", "gather_rows_launch", "gather_rows",
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2, tab.data_ptr(), idx.data_ptr(), NB, S, L, out.data_ptr(), _backend.stream(dev))
    return out


def gather_window_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(tab.expand(idx.shape[0], -1, -1), 2, idx.long())


def gather_window(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, f, k] = tab[f, idx[b, f, k]] (tab f32 [F, W], idx i32 [NB, F,
    K])."""
    dev = _backend.common_device(tab, idx)
    if not _backend.use_kernel(dev):
        return gather_window_plain(tab, idx)
    F, W = tab.shape
    NB, _, K = idx.shape
    check_inputs("gather_window", dev, [(tab, torch.float32, None), (idx, torch.int32, (NB, F, K))])
    out = torch.empty((NB, F, K), dtype=torch.float32, device=dev)
    _launch("mb_gather", "gather_window_launch", "gather_window",
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
            tab.data_ptr(), idx.data_ptr(), NB, F, W, K, out.data_ptr(), _backend.stream(dev))
    return out


def gather_cols_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(tab, 2, idx.long().expand(-1, tab.shape[1], -1))


def gather_cols(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, f, s] = tab[b, f, idx[b, 0, s]] (tab f32 [NB, F, G], idx i32
    [NB, 1, S])."""
    dev = _backend.common_device(tab, idx)
    if not _backend.use_kernel(dev):
        return gather_cols_plain(tab, idx)
    NB, F, G = tab.shape
    S = idx.shape[2]
    check_inputs("gather_cols", dev, [(tab, torch.float32, None), (idx, torch.int32, (NB, 1, S))])
    out = torch.empty((NB, F, S), dtype=torch.float32, device=dev)
    _launch("mb_gather", "gather_cols_launch", "gather_cols",
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2, tab.data_ptr(), idx.data_ptr(), NB, F, G, S, out.data_ptr(), _backend.stream(dev))
    return out


def inner_math_plain(e: torch.Tensor, P: int, dtype=torch.float32) -> torch.Tensor:
    """e [NB, R, K] f32 (rows 0 and 1: gx, ca) -> [NB, 1, K] f32; every
    operation in `dtype` (bf16 rounds after each), the sum over P in f32."""
    x = e.to(dtype)
    gx, ca = x[:, 0:1], x[:, 1:2]  # [NB, 1, K]
    px = torch.arange(P, device=e.device).to(dtype)[None, :, None]  # [1, P, 1]
    acc = torch.zeros(px.shape[:2] + gx.shape[2:], dtype=dtype, device=e.device)
    for _ in range(REPEATS):
        dx = px - gx
        sig = 0.5 * ca * dx * dx + dx * gx
        acc = acc + ca * torch.exp(-sig)
    return acc.float().sum(dim=1, keepdim=True)


def inner_math(e: torch.Tensor, P: int, dtype=torch.float32) -> torch.Tensor:
    """The kernel (f32, or bf16 on ``__nv_bfloat162`` pairs of lanes) for
    CUDA tensors, the plain version for CPU tensors."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"inner_math runs in float32 or bfloat16, got {dtype}")
    dev = e.device
    if not _backend.use_kernel(dev):
        return inner_math_plain(e, P, dtype)
    NB, R, K = e.shape
    check_inputs("inner_math", dev, [(e, torch.float32, None)])
    out = torch.empty((NB, 1, K), dtype=torch.float32, device=dev)
    bf16 = dtype == torch.bfloat16
    _launch("mb_inner_math", "inner_math_launch", "inner_math_bf16" if bf16 else "inner_math_f32",
            [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 2,
            e.data_ptr(), NB, R, K, P, int(bf16), 0.0, out.data_ptr(), _backend.stream(dev))
    return out


def inner_math_ops(e: torch.Tensor, P: int):
    """(exponentials, f32 flops) of `inner_math`: 6 P K NB terms of 7
    flops and one exponential."""
    terms = REPEATS * P * e.shape[0] * e.shape[2]
    return terms, 7 * terms


# On the card. The gathers are held to their plain versions equal. The
# inner math, of each |value| (a sum of positive terms; the values span
# about six orders of magnitude, so a gate of the largest would hold only
# the largest): f32 1e-5, exponentials and the sum over the pixels in
# another order; bf16 3e-2, an exponential (__expf against torch's exp,
# each rounded to bf16) may land one bf16 step (2^-8 of itself) apart, one
# term can carry most of a value, and the six repeats add it in bf16, each
# add rounding to the accumulator's coarser step (1.4e-2 seen on an H100).
# The bf16 gate also keeps its first form, 1e-3 of the largest |value|
# (`BF16_OF_LARGEST`), for the largest values. `check` shows the bf16 gate
# rejecting the f32 kernel's output.
TOL = {"inner_math_f32": 1e-5, "inner_math_bf16": 3e-2}
BF16_OF_LARGEST = 1e-3
SIZES = {  # the scripts' sizes
    "g1": (512, 2048, 128),  # NB, S, L
    "e1": (8, 512),  # F, W
    "e1b": (16, 8192, 2048, 256),  # F2, W2, K, NB
    "e4": (16, 1024, 2048, 512),  # F, G, S, NB
    "e5": (256, 128, 2048),  # P, K, NB
}
SMALL = {"g1": (4, 256, 128), "e1b": (16, 8192, 2048, 8), "e4": (16, 1024, 2048, 4), "e5": (256, 128, 16)}


def inputs(small: bool):
    """Seeded inputs of each experiment on the card, {name: tensors} (the
    scripts' tables of ones would hide a wrong gather)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    sz = {**SIZES, **SMALL} if small else SIZES
    rand = lambda *s: torch.rand(*s, device="cuda", generator=g)  # noqa: E731
    ints = lambda hi, *s: torch.randint(0, hi, s, device="cuda", generator=g, dtype=torch.int32)  # noqa: E731
    NB, S, L = sz["g1"]
    F, W = sz["e1"]
    F2, W2, K2, NB2 = sz["e1b"]
    F4, G4, S4, NB4 = sz["e4"]
    P5, K5, NB5 = sz["e5"]
    e = rand(NB5, 8, K5)
    e[:, 0] *= 4.0  # gx in [0, 4): exp(-sig) stays finite
    e[:, 1] = 0.1 + 0.9 * e[:, 1]  # ca in [0.1, 1)
    return {
        "g1": (rand(NB, S, L), ints(S, NB, S, L)),
        "e1": (rand(F, W), ints(W, F, W)),
        "e1b": (rand(F2, W2), ints(W2, NB2, F2, K2)),
        "e4": (rand(NB4, F4, G4), ints(G4, NB4, 1, S4)),
        "e5": (e, P5),
    }


def check(small: bool):
    """Each kernel against its plain version, {kernel: max abs error}, and
    the bf16 gate on the f32 kernel's output, {"rejects ...": its max abs
    error}."""
    x = inputs(small)
    tab, idx = x["e1"]
    F = tab.shape[0]
    # e1's two take_along_axis kernels (one block), through the window and row gathers
    compare("e1 take_along_axis lanes", gather_window(tab, idx[None]), gather_window_plain(tab, idx[None]))
    rows_mod = (tab[None].contiguous(), (idx % F)[None].contiguous())
    compare("e1 take_along_axis sublanes", gather_rows(*rows_mod), gather_rows_plain(*rows_mod))
    e, P = x["e5"]
    f32, want32 = inner_math(e, P), inner_math_plain(e, P)
    want16 = inner_math_plain(e, P, torch.bfloat16)
    scale16 = torch.clamp(want16.abs(), max=float(want16.abs().max()) * BF16_OF_LARGEST / TOL["inner_math_bf16"])
    return {
        "gather_rows": compare("gather_rows", gather_rows(*x["g1"]), gather_rows_plain(*x["g1"])),
        "gather_window": compare("gather_window", gather_window(*x["e1b"]), gather_window_plain(*x["e1b"])),
        "gather_cols": compare("gather_cols", gather_cols(*x["e4"]), gather_cols_plain(*x["e4"])),
        "inner_math_f32": compare("inner_math_f32", f32, want32, TOL["inner_math_f32"], want32.abs()),
        "inner_math_bf16": compare("inner_math_bf16", inner_math(e, P, torch.bfloat16), want16,
                                   TOL["inner_math_bf16"], scale16),
        "rejects inner_math_f32's output at inner_math_bf16's gate": rejects(
            "inner_math_bf16's gate", f32, want16, TOL["inner_math_bf16"], scale16),
    }


def measure(runs: int = 7):
    """The kernels at the scripts' sizes: one row each, with its rate; the
    library call is one ``torch.gather`` on int64 indices made beforehand
    (the plain versions convert the int32 indices in the call)."""
    x = inputs(False)
    rows = []
    library = {
        "gather_rows": lambda tab, i64: torch.gather(tab, 1, i64),
        "gather_window": lambda tab, i64: torch.gather(tab.expand(i64.shape[0], -1, -1), 2, i64),
        "gather_cols": lambda tab, i64: torch.gather(tab, 2, i64.expand(-1, tab.shape[1], -1)),
    }
    for name, key, fn, plain in (("gather_rows", "g1", gather_rows, gather_rows_plain),
                                 ("gather_window", "e1b", gather_window, gather_window_plain),
                                 ("gather_cols", "e4", gather_cols, gather_cols_plain)):
        tab, idx = x[key]
        i64 = idx.long()
        n_out = tab.shape[0] * tab.shape[1] * idx.shape[-1] if name == "gather_cols" else idx.numel()
        nbytes = 4 * (tab.numel() + idx.numel() + n_out)
        ms = median_ms(lambda: fn(tab, idx), runs)
        b, by = bound_ms(nbytes=nbytes)
        rows.append(dict(name=name, ms=ms, plain_ms=median_ms(lambda: plain(tab, idx), runs),
                         library_ms=median_ms(lambda: library[name](tab, i64), runs), bound_ms=b, bound_by=by,
                         rate=nbytes / ms * 1e3, unit="bytes/s", peak=PEAK_BYTES_PER_S, work=f"{nbytes} bytes"))
        del i64
    # e1's two take_along_axis kernels, one [8, 512] block each (a launch's
    # cost): through gather_window (lanes) and gather_rows (sublanes, idx % F)
    tab, idx = x["e1"]
    e1 = {"gather_window": (tab, idx[None].contiguous(), lambda t, i: torch.gather(t[None], 2, i)),
          "gather_rows": (tab[None].contiguous(), (idx % tab.shape[0])[None].contiguous(),
                          lambda t, i: torch.gather(t, 1, i))}
    by = {r["name"]: r for r in rows}
    for name, (t, i, lib) in e1.items():
        fn, plain = (gather_window, gather_window_plain) if name == "gather_window" else \
            (gather_rows, gather_rows_plain)
        i64 = i.long()
        by[name].update(e1_ms=median_ms(lambda: fn(t, i), runs), e1_plain_ms=median_ms(lambda: plain(t, i), runs),
                        e1_library_ms=median_ms(lambda: lib(t, i64), runs),
                        e1_bound_ms=bound_ms(nbytes=4 * 3 * i.numel())[0])
    e, P = x["e5"]
    ex2, flops = inner_math_ops(e, P)
    for name, dt in (("inner_math_f32", torch.float32), ("inner_math_bf16", torch.bfloat16)):
        ms = median_ms(lambda: inner_math(e, P, dt), runs)
        b, by = bound_ms(nbytes=4 * (e.numel() + e.shape[0] * e.shape[2]), flops=flops, ex2=ex2)
        rows.append(dict(name=name, ms=ms, plain_ms=median_ms(lambda: inner_math_plain(e, P, dt), runs),
                         library_ms=None, bound_ms=b, bound_by=by, rate=ex2 / ms * 1e3, unit="exponentials/s",
                         peak=PEAK_EX2_PER_S, work=f"{ex2} exponentials, {flops} flops"))
    return rows
