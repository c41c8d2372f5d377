"""Workarounds for torch's CPU build (seen with torch 2.13.0+cpu on an
AVX-512 Xeon).

The first large ``torch.exp`` of a process can come back wrong by up to
~1.5e-4 relative on one intra-op thread's chunk (every element of one
contiguous 1/8 of the tensor), at random in about one process in ten;
later calls are right to an ulp, and a first large ``torch.mul`` does not
prevent it. With one intra-op thread it does not occur
(``scripts/torch_cpu_exp_probe.py`` counts it over fresh processes). Tests that
hold exp-based outputs to rtol 1e-5 call `warm_exp` before their first
comparison, so that the runtime's first call is not the one compared.

Under ``-n 6`` six test processes share the machine's cores, and each
torch op's OpenMP threads spin at its barrier: a test of thousands of
small ops (a trainer step, a scene's render) runs tens of times slower.
Test modules import the autouse fixture `one_torch_thread`, which runs
each test with one intra-op thread and restores the count after it.
"""

import pytest
import torch


def warm_exp() -> None:
    torch.exp(torch.zeros(1 << 20))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
