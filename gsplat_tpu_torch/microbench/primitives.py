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
  stages a group of 16 lanes of it, or 8 where 16 do not fit
  (`gather_plan`; 16 at S = 2048). Bound: bytes, 1.61 GB at [512, 2048,
  128], 0.481 ms.
- `gather_window(tab, idx)`: out[b, f, k] = tab[f, idx[b, f, k]] from a
  window tab [F, W] (e1's ``kern2``, :79, :86; with one b also e1's
  ``k_taa``, :52, :67). A block stages a row (32 KB at W = 8192) and
  gathers its share of the row's outputs. Bound: bytes, 67.6 MB at [16,
  8192], idx [256, 16, 2048]: 0.020 ms.
- `gather_cols(tab, idx)`: out[b, f, s] = tab[b, f, idx[b, 0, s]] (e4's
  ``kern``, :155, :168), a one-hot matmul at HIGHEST on the TPU: exact, so
  the port gathers (one-hot selection gets no Hopper counterpart). Bound:
  bytes, 105 MB at [512, 16, 1024], idx [512, 1, 2048]: 0.031 ms.
- `inner_math(e, P, dtype)`: out[b, 0, k] = sum over P pixels of six
  repeats of ca exp(-(0.5 ca dx dx + dx gx)), dx = px - gx, in f32 or bf16
  (e5's ``mk(dtype).kern``, :189, :204). Bound: operations, 6 P K NB
  exponentials at the SFU's rate (`PEAK_EX2_PER_S`, 4.18e12 a second): at
  NB = 2048, P = 256, K = 128, 4.03e8 and 0.096 ms; the f32 flops (2.82e9)
  bound lower. A thread a (b, lane) over NB x K flattened, in bf16
  `INNER_RUNS` threads a (b, lane pair), each a run of the pixels
  (`inner_plan`); P <= 2^24, where the kernels' pixel counter stops being
  exact in f32.

The gathers' indices must lie inside the table (the kernels do not check;
the plain versions, ``torch.gather``, raise). One ``torch.gather`` call
computes each gather's function, so the plain version is also the
yardstick (``library ms``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from .. import _backend
from ..ops.rasterize_binned import _check as check_inputs
from . import PEAK_BYTES_PER_S, PEAK_EX2_PER_S, bound_ms, compare, median_ms, rejects, split_ms

REPEATS = 6  # e5's repeats of the inner math


def _launch(source: str, symbol: str, name: str, argtypes, *args) -> None:
    """Launch `symbol` of csrc/`source`.cu and count it as kernel `name`."""
    rc = _backend.kernel(source, symbol, argtypes)(*args)
    if rc:
        _backend.check_launch(rc, name)
    _backend.LAUNCHES[name] += 1


# the gathers' shape contract (csrc/mb_gather.cu's C entries check the same)
SMEM_LIMIT = 232_448  # a block's shared memory on the H100
SM_SMEM = 233_472  # an SM's, 1 KB of it kept for each resident block
THREADS = 256  # a block's; 2,048 an SM
MIN_BLOCKS = 4  # blocks an SM holds by registers at least (the kernels' __launch_bounds__)
ROWS_LANES = (16, 8)  # gather_rows' lane groups, widest first (64, 32 bytes of a row)
ROWS_MAX_S = SMEM_LIMIT // (4 * ROWS_LANES[-1])  # 7,264: the largest S, at 8 lanes (the parent's, too)
CHUNKS_A_BLOCK = THREADS  # gather_window: a block has at least a chunk for each thread


class GatherPlan(NamedTuple):
    lanes: int  # gather_rows: lanes a group stages (gather_window: the row's W)
    copy: str  # the staging copy: "cp.async 16 B" or, where a width or a pointer is not 16-byte aligned, "cp.async 4 B"
    vector: bool  # indices and outputs as 16-byte vectors (else 4-byte scalars)
    blocks: int  # the grid: persistent blocks (gather_rows), a multiple of F (gather_window); 0: no launch
    smem: int  # dynamic shared bytes of a block


@functools.lru_cache(maxsize=4096)
def gather_plan(name: str, shape: Tuple[int, ...], sms: int = 132, aligned: bool = True) -> GatherPlan:
    """The launch `name` makes for `shape` on a card of `sms` SMs, or
    ValueError where the kernel cannot take it (where the parent refused it:
    gather_rows S > 7,264 or NB > 65,535, gather_window W > 58,112).
    `aligned`: tab, idx and out all start on 16 bytes.

    gather_rows, shape (NB, S, L): the widest lane group of `ROWS_LANES`
    whose stage of S x lanes floats fits a block (narrowing as S grows);
    indices, outputs and the copy in 16-byte pieces where L % 4 == 0; as
    many persistent blocks as the SMs hold (by shared memory, and at most
    `MIN_BLOCKS`, which the registers always allow), at most one a group of
    NB x ceil(L / lanes).

    gather_window, shape (NB, F, W, K): a block stages one row of W floats
    (16-byte copies where W % 4 == 0) and gathers an equal share of its NB
    x K outputs (16-byte vectors where K % 4 == 0); each row gets as many
    blocks as fill the card in one wave (one where F rows alone fill it),
    each with a chunk for every thread at least."""
    if name == "gather_rows":
        NB, S, L = shape
        if NB < 0 or S < 1 or L < 1 or NB > 65535:
            raise ValueError(f"gather_rows takes 0 <= NB <= 65535, S >= 1, L >= 1: got {shape}")
        fits = [la for la in ROWS_LANES if S * la * 4 <= SMEM_LIMIT]
        if not fits:
            raise ValueError(f"gather_rows: S = {S} is above {ROWS_MAX_S}, the rows of {ROWS_LANES[-1]} lanes a "
                             "block holds")
        lanes = fits[0]
        smem = S * lanes * 4
        vector = L % 4 == 0 and aligned
        groups = NB * -(-L // lanes)
        resident = min(MIN_BLOCKS, SM_SMEM // (smem + 1024))
        return GatherPlan(lanes, "cp.async 16 B" if vector else "cp.async 4 B", vector,
                          min(groups, resident * sms), smem)
    if name == "gather_window":
        NB, F, W, K = shape
        smem = 4 * -(-W // 4) * 4
        if NB < 0 or F < 1 or W < 1 or K < 0 or smem > SMEM_LIMIT:
            raise ValueError(f"gather_window takes NB >= 0, F >= 1, 1 <= W <= {SMEM_LIMIT // 4}, K >= 0: got {shape}")
        vector = K % 4 == 0 and aligned
        chunks = NB * (K // 4 if vector else K)
        resident = min(MIN_BLOCKS, SM_SMEM // (smem + 1024))
        per_f = max(1, min(resident * sms // F, -(-chunks // CHUNKS_A_BLOCK)))
        return GatherPlan(W, "cp.async 16 B" if W % 4 == 0 and aligned else "cp.async 4 B", vector,
                          F * per_f if chunks else 0, smem)
    raise ValueError(f"no gather plan for {name!r}")


def gather_edges():
    """[(kernel, shape)]: the plan's edges, which the card holds to the plain
    versions bit for bit: gather_rows at the S where each lane group stops
    fitting (and one row past), the parent's largest S,
    ragged L (the scalar form, a narrow last group), L below a group, S = 1
    and NB = 0; gather_window at ragged W and K, the largest W, NB = 0 and
    K = 0."""
    rows = []
    for la in ROWS_LANES:
        top = SMEM_LIMIT // (4 * la)
        rows += [(2, top, 2 * la + 4), (2, top + 1, 2 * la + 4)]
    rows += [(3, 64, 130), (5, 1, 3), (4, 100, 20), (0, 64, 128)]
    window = [(3, 5, 8191, 2047), (2, 3, SMEM_LIMIT // 4, 36), (5, 2, 100, 7), (1, 1, 1, 1), (0, 4, 64, 16),
              (3, 4, 64, 0)]
    return [("gather_rows", s) for s in sorted(set(rows)) if s[1] <= ROWS_MAX_S] + \
        [("gather_window", s) for s in window]


def edge_inputs():
    """[(kernel, where, tab, idx)] on the card, from a seeded generator: each
    shape of `gather_edges`, and for each gather a table one float off
    16-byte alignment (the scalar form at a vector width)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    rand = lambda *s: torch.rand(*s, device="cuda", generator=g)  # noqa: E731
    ints = lambda hi, *s: torch.randint(0, hi, s, device="cuda", generator=g, dtype=torch.int32)  # noqa: E731
    out = []
    for name, shape in gather_edges():
        if name == "gather_rows":
            out.append((name, f"edge {list(shape)}", rand(*shape), ints(shape[1], *shape)))
        else:
            NB, F, W, K = shape
            out.append((name, f"edge {list(shape)}", rand(F, W), ints(W, NB, F, K)))
    out.append(("gather_rows", "a misaligned table [4, 256, 128]", rand(1 + 4 * 256 * 128)[1:].view(4, 256, 128),
                ints(256, 4, 256, 128)))
    out.append(("gather_window", "a misaligned table [16, 8192]", rand(1 + 16 * 8192)[1:].view(16, 8192),
                ints(8192, 8, 16, 2048)))
    return out


def dims_array(name: str, shape: Tuple[int, ...], plan: GatherPlan):
    """The C entry's `dims`: the shape, then the plan's lanes and blocks
    (gather_rows) or its blocks (gather_window), as one C int array."""
    vals = tuple(shape) + ((plan.lanes, plan.blocks) if name == "gather_rows" else (plan.blocks,))
    return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=4096)
def _dims(name: str, shape: Tuple[int, ...], device_index: int, aligned: bool):
    """`dims_array` of `gather_plan`'s launch on a CUDA device, made once a
    shape."""
    return dims_array(name, shape, gather_plan(name, shape, _backend.sm_count(device_index), aligned))


# tab, idx, out, dims, stream
_ROWS_ARGS = [ctypes.c_void_p] * 5
_WINDOW_ARGS = [ctypes.c_void_p] * 5
_COLS_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
_INNER_ARGS = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 2


def gather_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(tab, 1, idx.long())


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, s, l] = tab[b, idx[b, s, l], l] (tab f32, idx i32 [NB, S, L])."""
    dev = _backend.common_device(tab, idx)
    if not _backend.use_kernel(dev):
        return gather_rows_plain(tab, idx)
    shape = tab.shape
    check_inputs("gather_rows", dev, [(tab, torch.float32, None), (idx, torch.int32, shape)])
    out = torch.empty_like(tab)
    pt, pi, po = tab.data_ptr(), idx.data_ptr(), out.data_ptr()
    dims = _dims("gather_rows", shape, dev.index, not (pt | pi | po) & 15)
    _launch("mb_gather", "gather_rows_launch", "gather_rows", _ROWS_ARGS, pt, pi, po, dims, _backend.stream(dev))
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
    out = torch.empty_like(idx, dtype=torch.float32)
    pt, pi, po = tab.data_ptr(), idx.data_ptr(), out.data_ptr()
    dims = _dims("gather_window", (NB, F, W, K), dev.index, not (pt | pi | po) & 15)
    _launch("mb_gather", "gather_window_launch", "gather_window", _WINDOW_ARGS, pt, pi, po, dims,
            _backend.stream(dev))
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
    _launch("mb_gather", "gather_cols_launch", "gather_cols", _COLS_ARGS, tab.data_ptr(), idx.data_ptr(), NB, F, G, S,
            out.data_ptr(), _backend.stream(dev))
    return out


# inner_math's launch (csrc/mb_inner_math.cu's entry makes the same)
INNER_THREADS = 128  # a block's
INNER_RUNS = 4  # bf16: threads a lane pair, each a run of the pixels
INNER_MAX_P = 1 << 24  # the kernels step px by an exact + 1 in f32


class InnerPlan(NamedTuple):
    lanes: int  # lanes a thread: 1 (f32), 2 (bf16, a lane pair)
    runs: int  # threads an item of lanes, each a run of the pixels: 1 (f32), INNER_RUNS (bf16)
    items: int  # NB x ceil(K / lanes)
    blocks: int  # of INNER_THREADS threads; 0: no launch


@functools.lru_cache(maxsize=4096)
def inner_plan(NB: int, K: int, P: int, bf16: bool) -> InnerPlan:
    """The launch `inner_math` makes for e [NB, R, K] over P pixels, or
    ValueError where the kernel cannot take it (P > 2^24, or the threads
    past a 32-bit index)."""
    if NB < 0 or K < 0 or not 0 <= P <= INNER_MAX_P:
        raise ValueError(f"inner_math takes NB >= 0, K >= 0, 0 <= P <= {INNER_MAX_P}: got NB {NB}, K {K}, P {P}")
    lanes, runs = (2, INNER_RUNS) if bf16 else (1, 1)
    items = NB * -(-K // lanes)
    if items * runs > 2 ** 31 - 1 - INNER_THREADS:
        raise ValueError(f"inner_math: {items * runs} threads are past a 32-bit index")
    return InnerPlan(lanes, runs, items, -(-items * runs // INNER_THREADS))


def inner_thread_work(t: int, K: int, P: int, plan: InnerPlan):
    """(b, [k, ...], range of pixels) that thread `t` of the launch computes
    (the kernels' own arithmetic: the last lane of an odd K alone in bf16),
    or None for a thread past the items."""
    item, run = divmod(t, plan.runs)
    if item >= plan.items:
        return None
    per_b = -(-K // plan.lanes)
    b = item // per_b
    k = plan.lanes * (item - b * per_b)
    per = -(-P // plan.runs)
    p0 = min(P, run * per)
    return b, [k + i for i in range(plan.lanes) if k + i < K], range(p0, min(P, p0 + per))


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
    bf16 = dtype == torch.bfloat16
    inner_plan(NB, K, P, bf16)
    out = torch.empty((NB, 1, K), dtype=torch.float32, device=dev)
    _launch("mb_inner_math", "inner_math_launch", "inner_math_bf16" if bf16 else "inner_math_f32", _INNER_ARGS,
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
# calls a host or device sample of `split_ms` takes (a g1 launch is ~1 ms)
SPLIT_REPS = {"g1": 20, "e1": 200, "e1b": 100, "e4": 100, "e5": 50}
SMALL = {"g1": (4, 256, 128), "e1b": (16, 8192, 2048, 8), "e4": (16, 1024, 2048, 4), "e5": (256, 128, 16)}
# the inner math's edge shapes (P, K, NB), held at the small size: K odd (a
# lone last lane in bf16), K = 1, NB = 1, P = 1, P = 300 (bf16's px past
# 256, where it is no longer the integer)
INNER_EDGES = ((256, 129, 3), (256, 1, 4), (256, 128, 1), (1, 128, 4), (300, 128, 4))


def e5_input(NB: int, K: int, rand):
    """e5's e [NB, 8, K] from `rand(*shape)` (uniform [0, 1)): gx in [0, 4)
    (exp(-sig) stays finite), ca in [0.1, 1)."""
    e = rand(NB, 8, K)
    e[:, 0] *= 4.0
    e[:, 1] = 0.1 + 0.9 * e[:, 1]
    return e


def bf16_scale(want16: torch.Tensor) -> torch.Tensor:
    """The bf16 gate's scale of each value: its |value|, at most
    `BF16_OF_LARGEST` / TOL of the largest (so the largest values keep the
    first form of the gate, 1e-3 of the largest |value|)."""
    top = float(want16.abs().max()) if want16.numel() else 0.0
    return torch.clamp(want16.abs(), max=top * BF16_OF_LARGEST / TOL["inner_math_bf16"])


def check_inner(e: torch.Tensor, P: int, where: str):
    """Both inner-math kernels against their plain versions on `e`: (f32's
    output, the bf16 plain output, bf16's scale, {kernel: max abs error})."""
    want32 = inner_math_plain(e, P)
    want16 = inner_math_plain(e, P, torch.bfloat16)
    scale16 = bf16_scale(want16)
    f32 = inner_math(e, P)
    errs = {"inner_math_f32": compare(f"inner_math_f32 at {where}", f32, want32, TOL["inner_math_f32"],
                                      want32.abs()),
            "inner_math_bf16": compare(f"inner_math_bf16 at {where}", inner_math(e, P, torch.bfloat16), want16,
                                       TOL["inner_math_bf16"], scale16)}
    return f32, want16, scale16, errs


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
    e = e5_input(NB5, K5, rand)
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
    error}; at the small size also the two gathers at `edge_inputs` and the
    inner math at `INNER_EDGES` (its errors the largest of all shapes)."""
    x = inputs(small)
    if small:  # the plan's edges
        for name, where, tab, idx in edge_inputs():
            fn, plain = (gather_rows, gather_rows_plain) if name == "gather_rows" else \
                (gather_window, gather_window_plain)
            compare(f"{name} at {where}", fn(tab, idx), plain(tab, idx))
    tab, idx = x["e1"]
    F = tab.shape[0]
    # e1's two take_along_axis kernels (one block), through the window and row gathers
    compare("e1 take_along_axis lanes", gather_window(tab, idx[None]), gather_window_plain(tab, idx[None]))
    rows_mod = (tab[None].contiguous(), (idx % F)[None].contiguous())
    compare("e1 take_along_axis sublanes", gather_rows(*rows_mod), gather_rows_plain(*rows_mod))
    e, P = x["e5"]
    f32, want16, scale16, inner = check_inner(e, P, "small" if small else "the script's size")
    if small:
        g = torch.Generator(device="cuda").manual_seed(8)
        for P_, K_, NB_ in INNER_EDGES:
            e_ = e5_input(NB_, K_, lambda *s: torch.rand(*s, device="cuda", generator=g))
            edge = check_inner(e_, P_, f"edge P {P_}, K {K_}, NB {NB_}")[3]
            inner = {k: max(v, edge[k]) for k, v in inner.items()}
    return {
        "gather_rows": compare("gather_rows", gather_rows(*x["g1"]), gather_rows_plain(*x["g1"])),
        "gather_window": compare("gather_window", gather_window(*x["e1b"]), gather_window_plain(*x["e1b"])),
        "gather_cols": compare("gather_cols", gather_cols(*x["e4"]), gather_cols_plain(*x["e4"])),
        **inner,
        "rejects inner_math_f32's output at inner_math_bf16's gate": rejects(
            "inner_math_bf16's gate", f32, want16, TOL["inner_math_bf16"], scale16),
    }


def measure(runs: int = 7):
    """The kernels at the scripts' sizes: one row each, with its rate; the
    library call is one ``torch.gather`` on int64 indices made beforehand
    (the plain versions convert the int32 indices in the call). Each
    row's ``ms`` is one call between two events; beside it
    `split_ms`'s card's ms a launch of back-to-back launches
    (``device_ms``) and host microseconds a call (``host_us``), for the
    kernel and, for a gather, ``torch.gather`` (``library_*``)."""
    x = inputs(False)
    rows = []
    library = {
        "gather_rows": lambda tab, i64: torch.gather(tab, 1, i64),
        "gather_window": lambda tab, i64: torch.gather(tab.expand(i64.shape[0], -1, -1), 2, i64),
        "gather_cols": lambda tab, i64: torch.gather(tab, 2, i64.expand(-1, tab.shape[1], -1)),
    }

    def split(fn, lib, reps, pre=""):
        k, lb = split_ms(fn, runs, reps), split_ms(lib, runs, reps)
        return {f"{pre}ms": k["single_ms"], f"{pre}device_ms": k["device_ms"], f"{pre}host_us": k["host_us"],
                f"{pre}library_ms": lb["single_ms"], f"{pre}library_device_ms": lb["device_ms"],
                f"{pre}library_host_us": lb["host_us"]}

    for name, key, fn, plain in (("gather_rows", "g1", gather_rows, gather_rows_plain),
                                 ("gather_window", "e1b", gather_window, gather_window_plain),
                                 ("gather_cols", "e4", gather_cols, gather_cols_plain)):
        tab, idx = x[key]
        i64 = idx.long()
        n_out = tab.shape[0] * tab.shape[1] * idx.shape[-1] if name == "gather_cols" else idx.numel()
        nbytes = 4 * (tab.numel() + idx.numel() + n_out)
        t = split(lambda: fn(tab, idx), lambda: library[name](tab, i64), SPLIT_REPS[key])
        b, by = bound_ms(nbytes=nbytes)
        rows.append(dict(name=name, **t, plain_ms=median_ms(lambda: plain(tab, idx), runs), bound_ms=b, bound_by=by,
                         rate=nbytes / t["ms"] * 1e3, unit="bytes/s", peak=PEAK_BYTES_PER_S,
                         work=f"{nbytes} bytes"))
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
        by[name].update(split(lambda: fn(t, i), lambda: lib(t, i64), SPLIT_REPS["e1"], "e1_"),
                        e1_plain_ms=median_ms(lambda: plain(t, i), runs),
                        e1_bound_ms=bound_ms(nbytes=4 * 3 * i.numel())[0])
    e, P = x["e5"]
    ex2, flops = inner_math_ops(e, P)
    for name, dt in (("inner_math_f32", torch.float32), ("inner_math_bf16", torch.bfloat16)):
        t = split_ms(lambda: inner_math(e, P, dt), runs, SPLIT_REPS["e5"])
        ms = t["single_ms"]
        b, by = bound_ms(nbytes=4 * (e.numel() + e.shape[0] * e.shape[2]), flops=flops, ex2=ex2)
        rows.append(dict(name=name, ms=ms, device_ms=t["device_ms"], host_us=t["host_us"],
                         plain_ms=median_ms(lambda: inner_math_plain(e, P, dt), runs), library_ms=None, bound_ms=b,
                         bound_by=by, rate=ex2 / ms * 1e3, unit="exponentials/s", peak=PEAK_EX2_PER_S,
                         work=f"{ex2} exponentials, {flops} flops"))
    return rows
