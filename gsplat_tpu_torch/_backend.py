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
kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

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
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# nvcc's stderr per built source (the -Xptxas -v register/spill report)
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(
            f"inputs must lie on one device, got {sorted(map(str, devices))}"
        )
    return devices.pop()


def use_kernel(device: torch.device) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (the
    plain version); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise NotImplementedError(f"no kernels for device type {device.type!r}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@contextlib.contextmanager
def full_f32_matmul():
    """TF32 off for cuBLAS float32 products inside the block, the caller's
    setting restored after it. Only ``torch.backends.cuda.matmul.allow_tf32``
    is read and set: on some torch releases
    ``torch.get_float32_matmul_precision()`` raises once a process has set
    both that switch and ``torch.set_float32_matmul_precision``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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


def kernel(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of csrc/<name>.cu, built on first use.
    It returns the launch's cudaError_t as an int."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _load(name, _build(name))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_launch(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {code}")
