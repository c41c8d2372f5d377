"""A/B of two builds of the host JPEG decoder (csrc/jpeg_decode.cpp) on
one host: the parent's source against this tree's, decoding the same
files in alternated rounds (parent, change, change, parent), each build
made with ``_backend.host_library``'s compiler and flags.

    git show HEAD~1:gsplat_tpu_torch/csrc/jpeg_decode.cpp > build/jpeg_parent.cpp
    python scripts/torch_jpeg_ab.py --parent build/jpeg_parent.cpp --rounds 10

Prints, per file, each build's median and range of ms a decode over the
rounds and whether both decode to the same bits; the host's CPU model
first.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from gsplat_tpu_torch import _backend  # noqa: E402
from gsplat_tpu_torch.datasets import image_io  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "assets", "jpeg")
DEFAULT_FILES = [os.path.join(FIXTURES, f) for f in ("garden_1080p_q85.jpg", "garden_1080p_q85_progressive.jpg")]


def build(src: str, name: str, out_dir: str) -> ctypes.CDLL:
    out = os.path.join(out_dir, f"{name}.so")
    proc = subprocess.run([_backend._cxx()] + _backend._HOST_FLAGS + ["-o", out, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"g++ failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    lib.jd_info.argtypes, lib.jd_info.restype = image_io._JD_INFO, ctypes.c_int
    lib.jd_decode.argtypes, lib.jd_decode.restype = image_io._JD_DECODE, ctypes.c_int
    return lib


def decode(lib, data: bytes):
    """(RGB array or None where the build refuses the file, ms)."""
    err = ctypes.create_string_buffer(256)
    info = np.zeros(5, np.int32)
    if lib.jd_info(data, len(data), info.ctypes.data, err, len(err)):
        return None, 0.0
    out = np.empty((int(info[1]), int(info[0]), 3), np.uint8)
    t0 = time.perf_counter()
    rc = lib.jd_decode(data, len(data), out.ctypes.data, out.size, err, len(err))
    ms = (time.perf_counter() - t0) * 1e3
    return (None if rc else out), ms


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the parent's jpeg_decode.cpp")
    ap.add_argument("--change", default=os.path.join(_backend.CSRC, "jpeg_decode.cpp"))
    ap.add_argument("--files", nargs="+", default=DEFAULT_FILES)
    ap.add_argument("--rounds", type=int, default=10, help="rounds of parent, change, change, parent")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build", "jpeg_ab"))
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    libs = {"parent": build(args.parent, "parent", args.out_dir), "change": build(args.change, "change", args.out_dir)}
    print(f"host CPU: {cpu_model()}; {os.cpu_count()} cores", flush=True)
    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        ms = {k: [] for k in libs}
        outs = {}
        for k in libs:  # one warm-up decode each
            outs[k] = decode(libs[k], data)[0]
        for _ in range(args.rounds):
            for k in ("parent", "change", "change", "parent"):
                img, t = decode(libs[k], data)
                if img is not None:
                    ms[k].append(t)
        refused = [k for k, v in outs.items() if v is None]
        same = f"n/a ({', '.join(refused)} refuses)" if refused else np.array_equal(outs["parent"], outs["change"])
        parts = [f"{k} " + (f"{statistics.median(v):.3f} ms (range {min(v):.3f}-{max(v):.3f}, {len(v)} decodes)"
                            if v else "refused") for k, v in ms.items()]
        print(f"{os.path.basename(path)}: " + "; ".join(parts) + f"; same bits: {same}", flush=True)


if __name__ == "__main__":
    main()
