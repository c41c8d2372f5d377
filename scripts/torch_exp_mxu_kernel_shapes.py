"""Per-slice building blocks of the rasterizers on the H100 (the port of
scripts/exp_mxu_kernel_shapes.py; kernel csrc/mb_slice_shapes.cu through
gsplat_tpu_torch/microbench/kernel_shapes.py).

    python3 scripts/torch_exp_mxu_kernel_shapes.py [--ts 32] [--nb 64] [--k 512] [--tiles 64] [--runs 7]

At the TPU script's sizes (its defaults above, x = its seeded
``default_rng(0).random((16, K))``), the six variants vpu_sigma,
mxu_sigma, moments, vpu_reduce5, scan and fwd_mix, each held to its plain
version at a small size and at the script's (``kernel_shapes.check``, its
tolerance there), then timed with CUDA events (the median of --runs after
two warm-up calls). Printed: ms, ns a slice (the TPU script's figure),
flop/s beside the data sheet's 67 TFLOP/s, the bound, the plain version's
ms (no one PyTorch call computes these) and the card's name and power
limit.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gsplat_tpu_torch import microbench  # noqa: E402
from gsplat_tpu_torch.microbench import kernel_shapes  # noqa: E402

if __name__ == "__main__":
    microbench.main(kernel_shapes, __doc__, sizes=kernel_shapes.DEFAULTS)
