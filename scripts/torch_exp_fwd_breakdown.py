"""Where the binned forward's time goes on the H100 (the port of
scripts/exp_fwd_breakdown.py; kernel csrc/mb_fwd_breakdown.cu through
gsplat_tpu_torch/microbench/fwd_breakdown.py).

    python3 scripts/torch_exp_fwd_breakdown.py [--runs 7]

The TPU script's production stream: the garden fixture at scene_grid 5
(2,794,625 Gaussians), camera 0 at 1920x1080, its colours, tile 32, C = 1,
binned by the port (emit, sort, gather: ``ops.binning.bin_gaussians``) with
the culled capacity the script sizes (``slab_required`` + 1024). Each level
(L0 the reads, L1 + sigma and alpha, L2 + the slice-local transmittance,
L3 + the colour contraction) is first held to its plain version (garden
scene_grid 1 at 648x420, every tile, and the production stream on 256
seeded tiles; ``fwd_breakdown.check``, its tolerances there), then timed
with CUDA events (the median of --runs after two warm-up calls) beside
``fwd_3dgs``'s own time (csrc/rasterize_fwd.cu, the port's forward) on the
same stream at tile 32 and on the stream binned at tile 16. Printed: ms,
the bound and what bounds it, the plain version's ms over the whole stream
(once) and the card's name and power limit. No one PyTorch call computes
these levels.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gsplat_tpu_torch import microbench  # noqa: E402
from gsplat_tpu_torch.microbench import fwd_breakdown  # noqa: E402

if __name__ == "__main__":
    microbench.main(fwd_breakdown, __doc__)
