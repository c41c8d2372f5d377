"""The H100's f32 multiply-add and matrix rates, measured (the port of
scripts/exp_vpu_calib.py; kernels csrc/mb_calib.cu through
gsplat_tpu_torch/microbench/vpu_calib.py).

    python3 scripts/torch_exp_vpu_calib.py [--runs 7]

At the TPU script's sizes (x [512, 1024], y [1024, 512], 256 repeats):
`fma_chain` (48 chained multiply-adds an element each repeat), `sgemm`
(x @ y in f32 on the CUDA cores, HIGHEST's contract) and `tf32_mma` (the
same on the tensor cores in TF32, the counterpart of the TPU's one-pass
DEFAULT). Each kernel is first held to its plain version at a small size
and at the script's (``vpu_calib.check``, its tolerances there, each
product's gate shown to reject the other's output), then timed with CUDA
events (the median of --runs after two warm-up calls). Printed: ms, the
rate beside the data sheet's (33.5e12 multiply-adds, 67 TFLOP/s f32, 495
TFLOP/s TF32), the bound, the plain version's ms and the one PyTorch call
that computes the same function (``torch.bmm`` of the 256 repeats as one
batched product, TF32 off and on), and the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gsplat_tpu_torch import microbench  # noqa: E402
from gsplat_tpu_torch.microbench import vpu_calib  # noqa: E402

if __name__ == "__main__":
    microbench.main(vpu_calib, __doc__)
