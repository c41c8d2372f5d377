"""Per-slice building blocks of the rasterizers (port of
scripts/exp_mxu_kernel_shapes.py; kernel csrc/mb_slice_shapes.cu).

The TPU script (``_kernel`` :43, pallas_call :175) asks what each building
block of a binned kernel's 128-entry slice costs: the sigma chain on the
vector unit (``vpu_sigma``), sigma as a [P, 8] @ [8, K] product
(``mxu_sigma``), the moment contraction [P, 8]^T @ [P, K] (``moments``),
five per-lane sums over the pixels (``vpu_reduce5``), the transmittance's
product along the lanes (``scan``) and a whole forward slice (``fwd_mix``).
Each runs NB batches of K / 128 slices over P = ts^2 pixels on x [16, K],
accumulating acc [8, 128] with the loop-carried dependency dep = acc[0, :]
x 1e-20 added to each batch's entries (:57-63), over T grid steps that do
the same work. `slice_shapes(variant, x, P, NB, T)` returns the T blocks'
acc [T, 8, 128] (all equal); every contraction is f32 (HIGHEST's
contract).

The kernel spreads each tile over the card by `slice_plan` (a pure
function of the shape and the SM count): the four lane variants split a
tile's 128 lanes into warps of `LANES_PER_THREAD` lanes a thread, each
thread walking a run of the P pixels (`pixel_split`); the scan and fwd_mix,
whose chains couple every lane of a tile, split its pixels over a cluster
of `cluster_size` blocks.

Bound on the card: operations, the (pixel, lane) pairs the output needs
times the variant's f32 flops a pair (`FLOPS_PER_PAIR`, counted from the
script's expressions, a subexpression once and a product over Qm's six
non-zero rows as six multiply-adds) at 67 TFLOP/s, and fwd_mix's
exponential a pair at the SFU's rate. The pairs are T NB K P, and for
fwd_mix T NB K 128: only the first 128 pixels feed its [8, 128] output,
though the kernel, like the TPU's, evaluates all P (`needed_pairs`). At
the script's sizes (P = 1024, K = 512, NB = 64, T = 64) 2.15e9 pairs:
vpu_sigma 23 flops, 0.737 ms.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _backend
from ..ops.rasterize_binned import _check as check_inputs
from . import PEAK_F32_FLOPS, bound_ms, compare, median_ms, rejects

LANES = 128
VARIANTS = ("vpu_sigma", "mxu_sigma", "moments", "vpu_reduce5", "scan", "fwd_mix")
# f32 flops of a (pixel, lane) pair (one multiply-add is two): dx and dy
# 2, sigma 9, a contraction over Qm's six non-zero rows 12; mxu_sigma's
# sigma as six multiply-adds 12 (no dx, dy); moments' v = ca dx + cb dy 3;
# vpu_reduce5's five sums over v 18 (0.5 dx dx v 4, dx dy v 3, 0.5 dy dy v
# 4, (ca dx + cb dy) v = v v 2, (cb dx + cc dy) v 5); the scan's dx, |ca
# dx|, its clamp and 1 - it 5 and one product; fwd_mix's sigma 11, alpha 3
# (the argument, the opacity product, the clamp), the mask 2, 1 - alpha,
# the product, w and the [8, 128] colour contraction 16
FLOPS_PER_PAIR = {"vpu_sigma": 23, "mxu_sigma": 24, "moments": 17, "vpu_reduce5": 23, "scan": 18,
                  "fwd_mix": 35}
OUT_PIXELS = LANES  # fwd_mix's pixels that feed its output


def _pixels(P: int, dev):
    ts = math.isqrt(P)
    pix = torch.arange(P, device=dev)
    pxl = (pix % ts).float() + 0.5
    pyl = (pix // ts).float() + 0.5
    Qm = torch.stack([pxl * pxl, pxl * pyl, pyl * pyl, pxl, pyl, torch.ones_like(pxl),
                      torch.zeros_like(pxl), torch.zeros_like(pxl)], dim=1)  # [P, 8]
    return pxl[:, None], pyl[:, None], Qm


def slice_shapes_plain(variant: str, x: torch.Tensor, P: int, NB: int, T: int) -> torch.Tensor:
    """The script's kernel body in torch, slice by slice; [T, 8, 128]."""
    pxl, pyl, Qm = _pixels(P, x.device)
    acc = torch.zeros((8, LANES), dtype=torch.float32, device=x.device)
    z = lambda n: torch.zeros((n, LANES), dtype=torch.float32, device=x.device)  # noqa: E731
    with _backend.full_f32_matmul():
        for _ in range(NB):
            dep = acc[0:1] * 1e-20
            for s in range(x.shape[1] // LANES):
                e = x[:, s * LANES:(s + 1) * LANES] + dep
                gx, gy, ca, cb, cc = (e[i:i + 1] for i in range(5))
                dx, dy = pxl - gx, pyl - gy  # [P, 128]
                if variant == "vpu_sigma":
                    acc = acc + Qm.T @ (0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy)
                elif variant == "mxu_sigma":
                    coef = torch.cat([0.5 * ca, cb, 0.5 * cc, -(ca * gx + cb * gy), -(cc * gy + cb * gx),
                                      0.5 * ca * gx * gx + cb * gx * gy + 0.5 * cc * gy * gy, z(2)])
                    acc = acc + Qm.T @ (Qm @ coef)
                elif variant == "moments":
                    acc = acc + Qm.T @ (ca * dx + cb * dy)
                elif variant == "vpu_reduce5":
                    v = ca * dx + cb * dy
                    rows = [0.5 * dx * dx * v, dx * dy * v, 0.5 * dy * dy * v, (ca * dx + cb * dy) * v,
                            (cb * dx + cc * dy) * v]
                    acc = acc + torch.cat([r.sum(dim=0, keepdim=True) for r in rows] + [z(3)])
                elif variant == "scan":
                    one_m = 1.0 - torch.clamp_max(torch.abs(ca * dx), 0.99)
                    acc = acc + Qm.T @ torch.cumprod(one_m, dim=1)
                elif variant == "fwd_mix":
                    sig = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
                    alpha = torch.clamp_max(e[5:6] * torch.exp(-sig), 0.999)
                    valid = (alpha >= 1.0 / 255.0) & (sig >= 0.0)
                    Tm = torch.cumprod(torch.where(valid, 1.0 - alpha, 1.0), dim=1)
                    w = torch.where(valid, Tm * alpha, 0.0)
                    acc = acc + (e[6:14] @ w.T)[:, :LANES]
                else:
                    raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return acc.expand(T, 8, LANES).contiguous()


# the kernel's layout, mirrored from csrc/mb_slice_shapes.cu (kLpt, kRuns,
# kLaneBlock, kScanThreads, kMaxCluster), which derives its blocks and
# threads from the one value it is passed, the cluster size: a lane
# variant's thread holds LANES_PER_THREAD lanes and one of a warp's RUNS
# runs of the pixels, LANE_BLOCK threads a block; the scan's blocks
# SCAN_THREADS threads, a warp a pixel at a time; fwd_mix a pixel a thread;
# a tile's scan or fwd_mix over a cluster of at most MAX_CLUSTER blocks
LANES_PER_THREAD = 4
RUNS = 32
LANE_BLOCK = 128
SCAN_THREADS = 512
MAX_CLUSTER = 8
FILL = 0.9  # the share of the SMs a cluster size must give blocks to


class SlicePlan(NamedTuple):
    blocks: int
    threads: int
    cluster: int  # blocks a tile (1: a lane variant's blocks hold warps of any tile)


def pixel_split(n: int, parts: int):
    """The first item of each of `parts` runs of n items, and n: run i is
    [bounds[i], bounds[i + 1]) (the kernel's `split`)."""
    return [i * n // parts for i in range(parts + 1)]


def cluster_size(T: int, sms: int) -> int:
    """Blocks a tile for the scan and fwd_mix: the least of 1, 2, 4 and 8
    whose T C blocks give at least `FILL` of the SMs a block, else 8."""
    for c in (1, 2, 4, MAX_CLUSTER):
        if T * c >= FILL * sms:
            return c
    return MAX_CLUSTER


def slice_plan(variant: str, P: int, T: int, sms: int) -> SlicePlan:
    """The kernel's launch for `variant` over T tiles of P pixels on a card
    of `sms` SMs. The C entry takes only its `cluster` and derives the
    rest as this does."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if P < 1 or T < 0 or sms < 1:
        raise ValueError(f"slice_plan takes P >= 1, T >= 0 and sms >= 1, got {P}, {T}, {sms}")
    if variant == "fwd_mix" and not LANES <= P <= 1024:
        raise ValueError(f"fwd_mix takes {LANES} <= P <= 1024, got {P}")
    if variant not in ("scan", "fwd_mix"):
        warps = T * (LANES // LANES_PER_THREAD)
        return SlicePlan(-(-warps // (LANE_BLOCK // 32)), LANE_BLOCK, 1)
    c = cluster_size(T, sms)
    if variant == "scan":
        return SlicePlan(T * c, SCAN_THREADS, c)
    per_rank = -(-P // c)  # the most pixels a block holds
    return SlicePlan(T * c, -(-per_rank // 32) * 32, c)


_ARGS = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3


def _slice_shapes_cuda(variant: str, x: torch.Tensor, P: int, NB: int, T: int) -> torch.Tensor:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the slice_shapes kernel takes CUDA tensors, got {dev}")
    K = x.shape[1]
    check_inputs("slice_shapes", dev, [(x, torch.float32, (16, K))])
    ts = math.isqrt(P)
    if ts * ts != P or K % LANES:
        raise ValueError(f"slice_shapes takes P = ts^2 and K a multiple of {LANES}, got P {P}, K {K}")
    if x.data_ptr() % 16:
        raise ValueError("slice_shapes takes x 16-byte aligned")
    cluster = slice_plan(variant, P, T, _backend.sm_count(dev.index)).cluster
    out = torch.empty((T, 8, LANES), dtype=torch.float32, device=dev)
    sink = torch.empty(1, dtype=torch.float32, device=dev)  # fwd_mix writes it only when asked
    fn = _backend.kernel("mb_slice_shapes", "slice_shapes_launch", _ARGS)
    _backend.check_launch(fn(VARIANTS.index(variant), x.data_ptr(), K, P, ts, NB, T, 0, cluster, out.data_ptr(),
                             sink.data_ptr(), _backend.stream(dev)), f"slice_{variant}")
    _backend.LAUNCHES[f"slice_{variant}"] += 1
    return out


def slice_shapes(variant: str, x: torch.Tensor, P: int, NB: int, T: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if _backend.use_kernel(x.device):
        return _slice_shapes_cuda(variant, x, P, NB, T)
    return slice_shapes_plain(variant, x, P, NB, T)


def needed_pairs(variant: str, K: int, P: int, NB: int, T: int) -> int:
    """The (pixel, lane) pairs `variant`'s output needs."""
    return T * NB * K * (min(P, OUT_PIXELS) if variant == "fwd_mix" else P)


# On the card. Kernel against plain: 1e-5 of the largest |value| of each
# of acc's eight rows (sums, and the scan's products, in another order; the
# rows differ by ~340x, px^2 against 1, so a gate of the largest value
# would hold the small rows to ~3e-3). `check` shows the gate rejecting a
# result with one value of the smallest non-zero row moved by 1e-4 of that
# row's largest |value|.
TOL = 1e-5
DEFAULTS = {"ts": 32, "nb": 64, "k": 512, "tiles": 64}
SMALL = {"ts": 16, "nb": 3, "k": 256, "tiles": 4}
# part-full layouts: runs of 4 or 5 pixels that wrap mid-row, one or two
# pixels a scan warp, fwd_mix ranks of 18 pixels in one part-full warp,
# every rank holding output pixels
EDGE = {"ts": 12, "nb": 3, "k": 256, "tiles": 3}


def row_scale(want: torch.Tensor) -> torch.Tensor:
    """Each value's gate scale: the largest |value| of its row of acc."""
    return want.abs().amax(dim=(0, 2), keepdim=True).expand_as(want)


def _x(K: int) -> torch.Tensor:
    # the TPU script's input, np.random.default_rng(0).random((16, K))
    return torch.from_numpy(np.random.default_rng(0).random((16, K)).astype(np.float32)).cuda()


def check(small: bool, sizes=None):
    """Each variant against its plain version (small: at `SMALL` and at
    `EDGE`, "... at EDGE" keys), {kernel: max abs error}, two launches to
    the same bits, and the gate on a perturbed result, {"rejects ...": its
    max abs error}."""
    errs = {}
    for sz, tag in ((SMALL, ""), (EDGE, " at EDGE")) if small else (((sizes or DEFAULTS), ""),):
        errs.update(_check(sz, tag))
    return errs


def _check(sz, tag):
    x, P = _x(sz["k"]), sz["ts"] ** 2
    errs = {}
    for v in VARIANTS:
        got = slice_shapes(v, x, P, sz["nb"], sz["tiles"])
        again = slice_shapes(v, x, P, sz["nb"], sz["tiles"])
        if not torch.equal(got, again):
            raise AssertionError(f"slice_{v}{tag}: two launches differ at {int((got != again).sum())} values")
        want = slice_shapes_plain(v, x, P, sz["nb"], sz["tiles"])
        errs[f"slice_{v}{tag}"] = compare(f"slice_{v}{tag}", got, want, TOL, row_scale(want))
        if v == "vpu_sigma" and not tag:
            top = want.abs().amax(dim=(0, 2))
            r = int(torch.where(top > 0, top, float("inf")).argmin())
            wrong = got.clone()
            wrong[0, r, 0] += 1e-4 * top[r]
            errs[f"rejects slice_vpu_sigma with row {r} moved by 1e-4 of its largest"] = rejects(
                "slice_vpu_sigma's gate", wrong, want, TOL, row_scale(want))
    return errs


def measure(runs: int = 7, sizes=None):
    """Each variant at the script's sizes: one row each."""
    sz = sizes or DEFAULTS
    K, P, NB, T = sz["k"], sz["ts"] ** 2, sz["nb"], sz["tiles"]
    x = _x(K)
    slices = T * NB * (K // LANES)
    rows = []
    for v in VARIANTS:
        pairs = needed_pairs(v, K, P, NB, T)
        flops = FLOPS_PER_PAIR[v] * pairs
        ms = median_ms(lambda: slice_shapes(v, x, P, NB, T), runs)
        b, by = bound_ms(flops=flops, ex2=pairs if v == "fwd_mix" else 0)
        rows.append(dict(name=f"slice_{v}", ms=ms, plain_ms=median_ms(lambda: slice_shapes_plain(v, x, P, NB, T),
                                                                      max(1, runs // 3), warmup=1),
                         library_ms=None, bound_ms=b, bound_by=by, rate=flops / ms * 1e3, unit="flop/s",
                         peak=PEAK_F32_FLOPS, work=f"{pairs} pairs, {flops} flops, {ms / slices * 1e6:.2f} ns a slice"))
    return rows
