"""Devices, the build of the CUDA kernels, and their launch counts.

Every kernel of the port is one CUDA C++ source under ``csrc/`` with a
plain C entry point; it may include the shared ``csrc/*.cuh`` headers.
:func:`kernel` compiles the source with ``nvcc`` for ``sm_90a`` into
``build/gsplat_tpu_torch/`` beside the package (one shared library per
source, named by a hash of the source, the headers and the flags, so an
edited source rebuilds and an unchanged one is reused), loads it with
``ctypes`` and returns the entry point. Nothing is compiled or loaded when a
module is imported: the first launch builds, or :func:`build_all` builds
every source at once, one ``nvcc`` process per source.

Each kernel wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel and nowhere else, so a run can show that its path went through the
kernels; a source of several kernels (``SOURCE_KERNELS``) counts each apart.

The host's C++ sources (``csrc/*.cpp``: the JPEG decoder and the native
COLMAP reader of the datasets) are built the same way with ``g++``
(:func:`host_library`), and each of their calls adds one to
``HOST_CALLS[name]``; ``HOST_CALLS["colmap_numpy"]`` counts the reads that
the numpy COLMAP reader made instead of the native one.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "gsplat_tpu_torch")

_COMMON_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

# source name -> extra nvcc flags
KERNELS: Dict[str, Sequence[str]] = {
    # the exact ellipse-vs-tile cull must keep and drop the same entries as
    # the plain torch version, so no multiply-add contraction
    "emit": ("-fmad=false",),
    # the sorted stream's payload, gathered from the packed rows: copies only
    "emit_gather": (),
    "rasterize_fwd": (),
    "rasterize_bwd": (),
    "gid_reduce": (),
    # the 2DGS forwards keep their bits: no contraction anywhere. The
    # backwards decide with the same explicitly rounded surfel sigma and
    # alpha product (csrc/surfel.cuh), so they accept the forward's entries
    # whatever the flags, and contract their gradient chains
    "rasterize_2dgs_fwd": ("-fmad=false",),
    "rasterize_2dgs_bwd": (),
    # the tiled backend: the same kernel templates (csrc/raster.cuh) with
    # rows gathered by flatten_ids from a packed [C*N, F] table instead of
    # a pre-gathered stream
    "rasterize_tiled_fwd": (),
    "rasterize_tiled_bwd": (),
    "rasterize_2dgs_tiled_fwd": ("-fmad=false",),
    "rasterize_2dgs_tiled_bwd": (),
    # the bilateral grid's gradients over bilagrid.grad_plan's tiles: the
    # grids' tile partials and their node sums in a fixed order of adds, the
    # luminance's from the tile's node window
    "bilagrid_bwd": (),
    # the micro-benchmarks (microbench/), counterparts of scripts/exp_*.py
    "mb_calib": (),
    "mb_gather": (),
    "mb_inner_math": (),
    "mb_slice_shapes": (),
    "mb_fwd_breakdown": (),
}

# sources that hold several kernels: each kernel's launches count apart
SOURCE_KERNELS: Dict[str, Sequence[str]] = {
    "bilagrid_bwd": ("bilagrid_bwd", "bilagrid_lum_bwd"),
    "mb_calib": ("fma_chain", "sgemm", "tf32_mma"),
    "mb_gather": ("gather_rows", "gather_window", "gather_cols"),
    "mb_inner_math": ("inner_math_f32", "inner_math_bf16"),
    "mb_slice_shapes": tuple(f"slice_{v}" for v in ("vpu_sigma", "mxu_sigma", "moments", "vpu_reduce5", "scan",
                                                    "fwd_mix")),
    "mb_fwd_breakdown": tuple(f"fwd_breakdown_L{i}" for i in range(4)),
}

LAUNCHES: Dict[str, int] = {k: 0 for name in KERNELS for k in SOURCE_KERNELS.get(name, (name,))}

# nvcc's stderr per built source (the -Xptxas -v register/spill report)
BUILD_LOG: Dict[str, str] = {}

# the host's C++ sources (csrc/<name>.cpp), built with g++
HOST_SOURCES = ("jpeg_decode", "colmap_native")
_HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
HOST_CALLS: Dict[str, int] = {"jpeg_decode": 0, "colmap_native": 0, "colmap_numpy": 0}
_HOST_LIBS: Dict[str, ctypes.CDLL] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
# (source, symbol) -> (its library, the bound entry point, its argtypes and restype)
_BOUND: Dict[Tuple[str, str], Tuple[ctypes.CDLL, ctypes._CFuncPtr, Sequence, type]] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in HOST_CALLS:
        HOST_CALLS[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run the "
            "plain PyTorch path"
        )
    return device


def common_device(*tensors: Optional[torch.Tensor]) -> torch.device:
    """The one device all given tensors lie on (None entries are skipped)."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if dev is None:
            dev = t.device
        elif t.device != dev:
            devices = {t.device for t in tensors if t is not None}
            raise ValueError(f"inputs must lie on one device, got {sorted(map(str, devices))}")
    if dev is None:
        raise ValueError("inputs must lie on one device, got []")
    return dev


def use_kernel(device: torch.device) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (the
    plain version); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise NotImplementedError(f"no kernels for device type {device.type!r}")


def stream(device: torch.device) -> int:
    """The handle of `device`'s current CUDA stream, read with the raw query
    that torch's generated code uses (no ``torch.cuda.Stream`` object: 0.2
    against 5.3 us a call on the H100's host, scripts/torch_gather_ab.py)."""
    i = device.index
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device() if i is None else i)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@contextlib.contextmanager
def _matmul_tf32(allow: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def full_f32_matmul():
    """TF32 off for cuBLAS float32 products inside the block, the caller's
    setting restored after it. Only ``torch.backends.cuda.matmul.allow_tf32``
    is read and set: on some torch releases
    ``torch.get_float32_matmul_precision()`` raises once a process has set
    both that switch and ``torch.set_float32_matmul_precision``."""
    return _matmul_tf32(False)


def tf32_matmul():
    """TF32 on for cuBLAS float32 products inside the block (a yardstick's
    setting; the port's own products run with it off), through the same
    switch as `full_f32_matmul`."""
    return _matmul_tf32(True)


class _F32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with full_f32_matmul():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with full_f32_matmul():
            if ctx.needs_input_grad[0]:
                ga = g @ b.mT
            if ctx.needs_input_grad[1]:
                gb = a.mT @ g if b.dim() > 2 else a.reshape(-1, a.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
        return ga, gb


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., k] @ b [k, n] (or b [..., k, n] of a's batch shape) with
    TF32 off (`full_f32_matmul`), in the forward and in the products of its
    gradient."""
    return _F32Matmul.apply(a, b)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (home, "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME to the CUDA toolkit to build the "
            "port's kernels"
        )
    return found


def _library_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    flags = list(_COMMON_FLAGS) + list(KERNELS[name])
    h = hashlib.sha256()
    # the source and every shared header it may include
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is already built."""
    out = _library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(CSRC, name + ".cu")
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc()] + list(_COMMON_FLAGS) + list(KERNELS[name]) + ["-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG[name] = proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(name: str, path: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(path)
        return _LIBS[name]


def build_all() -> None:
    """Build every kernel source at once (one nvcc process each) and load
    the libraries."""
    names = [n for n in KERNELS if n not in _LIBS]
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(_build, names))
    for name, path in zip(names, paths):
        _load(name, path)


def kernel(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of csrc/<name>.cu, built on first use.
    A launch entry returns the launch's cudaError_t as an int (`restype`).

    Each (source, symbol) is bound once: its ``argtypes`` and ``restype``
    are set when it is first asked for (again only where ``_LIBS`` holds
    another library for the source), and later calls with the same
    argtypes get the same callable back; other argtypes or another restype
    raise TypeError. Wrappers pass a list made once, at module level."""
    hit = _BOUND.get((name, symbol))
    if hit is not None and hit[2] is argtypes and hit[3] is restype and hit[0] is _LIBS.get(name):
        return hit[1]
    return _bind(name, symbol, argtypes, restype)


def _bind(name: str, symbol: str, argtypes: Sequence, restype) -> ctypes._CFuncPtr:
    lib = _LIBS.get(name)
    if lib is None:
        lib = _load(name, _build(name))
    with _LOCK:
        hit = _BOUND.get((name, symbol))
        if hit is not None and (list(hit[2]) != list(argtypes) or hit[3] is not restype):
            raise TypeError(f"{name}.{symbol} is bound with argtypes {list(hit[2])} and restype {hit[3]}, asked "
                            f"for {list(argtypes)} and {restype}")
        fn = getattr(lib, symbol)
        if hit is None or hit[0] is not lib:
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _BOUND[(name, symbol)] = (lib, fn, argtypes, restype)
    return fn


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler (g++) found: set CXX to build the port's host sources")
    return found


def host_library(name: str) -> ctypes.CDLL:
    """csrc/<name>.cpp built with ``g++ -O3 -shared -fPIC -std=c++17`` into
    ``build/gsplat_tpu_torch/`` (named by a hash of the source and the
    flags, so an edited source rebuilds) and loaded, once a process. A
    failed build raises RuntimeError with the compiler's stderr."""
    lib = _HOST_LIBS.get(name)
    if lib is not None:
        return lib
    if name not in HOST_SOURCES:
        raise ValueError(f"{name!r} is not a host source: {HOST_SOURCES}")
    src = os.path.join(CSRC, name + ".cpp")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_HOST_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([_cxx()] + _HOST_FLAGS + ["-o", tmp, src], capture_output=True, text=True)
        BUILD_LOG[name] = proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    with _LOCK:
        if name not in _HOST_LIBS:
            _HOST_LIBS[name] = ctypes.CDLL(out)
        return _HOST_LIBS[name]


def check_launch(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {code}")
