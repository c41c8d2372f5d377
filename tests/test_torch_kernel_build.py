"""The build-flag contract of the port's CUDA kernels
(gsplat_tpu_torch/_backend.py::KERNELS), one case per source.

Every source ships under csrc/. `-fmad=false` (no multiply-add
contraction) is kept where a kernel's keep / drop decisions are written
with ordinary operators and must round as the plain torch version's ops
do: emit (the exact ellipse-vs-tile cull) and the two 2DGS forwards, which
keep their bits. The two 2DGS backwards build without it: their decisions
(csrc/surfel.cuh's surfel sigma and the alpha product in csrc/raster.cuh)
round op by op through explicit intrinsics whatever the flags, so they
accept exactly the forward's entries while their gradient chains contract
to multiply-adds. The 3DGS kernels never took the flag: their sigma is
explicit too (raster.cuh::gauss_sigma).
"""

import os

import pytest

from gsplat_tpu_torch import _backend
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

NO_FMAD = {"emit", "rasterize_2dgs_fwd", "rasterize_2dgs_tiled_fwd"}
EXPLICIT_DECISIONS = {"rasterize_2dgs_bwd", "rasterize_2dgs_tiled_bwd"}


@pytest.mark.parametrize("name", sorted(_backend.KERNELS))
def test_kernel_build_flags(name):
    assert os.path.exists(os.path.join(_backend.CSRC, name + ".cu"))
    flags = tuple(_backend.KERNELS[name])
    assert ("-fmad=false" in flags) == (name in NO_FMAD), (name, flags)
    if name in EXPLICIT_DECISIONS:
        assert "-fmad=false" not in flags
        with open(os.path.join(_backend.CSRC, "surfel.cuh")) as f:
            surfel = f.read()
        assert all(op in surfel for op in ("__fmul_rn", "__fadd_rn", "__fsub_rn", "__fdiv_rn"))
    # the library's name hashes the flags with the sources, so a change of
    # flags rebuilds
    path = _backend._library_path(name)
    assert os.path.basename(path).startswith(name + "-")
