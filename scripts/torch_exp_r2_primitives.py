"""Gathers and the sigma / exp inner math on the H100 (the port of the
Pallas kernels of scripts/exp_r2_primitives.py e1, e4, e5 and
scripts/exp_r2_batch2.py g1; kernels csrc/mb_gather.cu and
csrc/mb_inner_math.cu through gsplat_tpu_torch/microbench/primitives.py).

    python3 scripts/torch_exp_r2_primitives.py [--runs 7]

At the TPU scripts' sizes: g1's gather along axis 0 per lane (tab, idx
[512, 2048, 128]), e1's take_along_axis along lanes and along sublanes
([8, 512], one block: a launch's cost) and its gather from a resident window
(tab [16, 8192], idx [256, 16, 2048]), e4's column gather (tab [512, 16,
1024], idx [512, 1, 2048]; a one-hot matmul on the TPU) and e5's inner
math in f32 and bf16 ([2048, 8, 128], 256 pixels), on seeded inputs. Each
kernel is first held to its plain version at a small size and at the
script's (``primitives.check``: the gathers to ``torch.gather``, equal;
the inner math within its tolerances there), then timed with CUDA events
(the median of --runs after two warm-up calls). Printed: ms, bytes/s or
exponentials/s beside the data sheet's, the bound, the plain version's
ms, ``torch.gather``'s ms on int64 indices made beforehand (the one
PyTorch call that computes each gather) and the card's name and power
limit.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gsplat_tpu_torch import microbench  # noqa: E402
from gsplat_tpu_torch.microbench import primitives  # noqa: E402

if __name__ == "__main__":
    microbench.main(primitives, __doc__)
