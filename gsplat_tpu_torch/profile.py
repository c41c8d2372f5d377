"""Opt-in wall-clock profiler (port of gsplat_tpu/profile.py).

``timeit`` works as a decorator or a context manager, accumulates wall
time per name into the global ``profiler`` dict, and is a no-op unless the
environment has ``TIMEIT=1`` when this module is imported. The decorator
waits for the card (``torch.cuda.synchronize``) when the wrapped
function's output holds a CUDA tensor, where the JAX package calls
``jax.block_until_ready``; the context manager times the host's wall
clock only, as the JAX package's does.
"""

from __future__ import annotations

import functools
import os
import time
from collections import defaultdict
from typing import Dict

import torch

profiler: Dict[str, float] = defaultdict(float)
profiler_counts: Dict[str, int] = defaultdict(int)

_ENABLED = os.environ.get("TIMEIT", "0") == "1"


def _cuda_devices(out, found=None):
    """The CUDA devices of the tensors in ``out`` (nested lists, tuples and
    dicts)."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (list, tuple)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    return found


def block_until_ready(out):
    """Wait until the card has computed ``out``'s CUDA tensors; returns
    ``out``."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out


class timeit:
    """Context manager / decorator accumulating wall time under a name."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _ENABLED:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _ENABLED:
            profiler[self.name] += time.perf_counter() - self.t0
            profiler_counts[self.name] += 1
        return False

    def __call__(self, fn):
        if not _ENABLED:
            return fn

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = block_until_ready(fn(*args, **kwargs))
            profiler[self.name] += time.perf_counter() - t0
            profiler_counts[self.name] += 1
            return out

        return wrapped


def report() -> str:
    lines = ["name\ttotal_s\tcalls\tper_call_ms"]
    for name, total in sorted(profiler.items(), key=lambda kv: -kv[1]):
        n = max(profiler_counts[name], 1)
        lines.append(f"{name}\t{total:.3f}\t{n}\t{total / n * 1000:.2f}")
    return "\n".join(lines)


def reset():
    profiler.clear()
    profiler_counts.clear()
