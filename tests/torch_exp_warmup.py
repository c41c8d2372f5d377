"""A workaround for torch's CPU build (seen with torch 2.13.0+cpu on an
AVX-512 Xeon).

The first large ``torch.exp`` of a process can come back wrong by up to
~1.5e-4 relative on one intra-op thread's chunk (every element of one
contiguous 1/8 of the tensor), at random in about one process in ten;
later calls are right to an ulp, and a first large ``torch.mul`` does not
prevent it. With one intra-op thread it does not occur
(``scripts/torch_cpu_exp_probe.py`` counts it over fresh processes). Tests that
hold exp-based outputs to rtol 1e-5 call `warm_exp` before their first
comparison, so that the runtime's first call is not the one compared.
"""

import torch


def warm_exp() -> None:
    torch.exp(torch.zeros(1 << 20))
