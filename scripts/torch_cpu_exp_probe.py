"""Probe the CPU torch's first large ``torch.exp`` of a process.

Each child process draws 2^22 seeded values in [-8, 0], takes ``torch.exp``
once and prints its largest relative error against numpy's float64 exp.
The parent runs ``--procs`` children under each setting (the default, the
AVX2 kernels through ATEN_CPU_CAPABILITY, one intra-op thread through
OMP_NUM_THREADS) and counts the children past 1e-6.

    python scripts/torch_cpu_exp_probe.py --procs 40
"""

import argparse
import os
import subprocess
import sys

CHILD = """
import numpy as np, torch
g = torch.Generator().manual_seed(0)
x = -torch.rand(1 << 22, generator=g) * 8
e = torch.exp(x)
ref = np.exp(x.double().numpy())
print(float((np.abs(e.double().numpy() - ref) / ref).max()), torch.get_num_threads(),
      torch.backends.cpu.get_cpu_capability())
"""

SETTINGS = {
    "default": {},
    "avx2": {"ATEN_CPU_CAPABILITY": "avx2"},
    "one_thread": {"OMP_NUM_THREADS": "1"},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=40)
    ap.add_argument("--limit", type=float, default=1e-6)
    a = ap.parse_args()
    for name, env in SETTINGS.items():
        errs = []
        for _ in range(a.procs):
            out = subprocess.run([sys.executable, "-c", CHILD], env={**os.environ, **env},
                                 capture_output=True, text=True, check=True).stdout.split()
            errs.append(float(out[0]))
            threads, capability = out[1], out[2]
        bad = sum(e > a.limit for e in errs)
        print(f"{name}: {bad} of {a.procs} processes past {a.limit} (worst {max(errs):.3e}; "
              f"{threads} threads, {capability})")


if __name__ == "__main__":
    main()
