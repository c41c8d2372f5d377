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
explicit too (raster.cuh::gauss_sigma). The bilateral grid's gradient
(bilagrid_bwd) and the micro-benchmarks (mb_*) build without the flag:
where their plain versions' rounding matters they round through explicit
intrinsics (the forward breakdown's sigma, the bf16 inner math's _rn
operations). A source of several kernels counts each kernel's launches
apart (_backend.SOURCE_KERNELS).
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


MICROBENCH = {
    "mb_calib": ("fma_chain", "sgemm", "tf32_mma"),
    "mb_gather": ("gather_rows", "gather_window", "gather_cols"),
    "mb_inner_math": ("inner_math_f32", "inner_math_bf16"),
    "mb_slice_shapes": ("slice_vpu_sigma", "slice_mxu_sigma", "slice_moments", "slice_vpu_reduce5", "slice_scan",
                        "slice_fwd_mix"),
    "mb_fwd_breakdown": ("fwd_breakdown_L0", "fwd_breakdown_L1", "fwd_breakdown_L2", "fwd_breakdown_L3"),
}


SEVERAL = {**MICROBENCH, "bilagrid_bwd": ("bilagrid_bwd", "bilagrid_lum_bwd")}


@pytest.mark.parametrize("name", sorted(SEVERAL))
def test_new_sources_and_their_launch_counts(name):
    assert tuple(_backend.KERNELS[name]) == ()
    kernels = tuple(_backend.SOURCE_KERNELS[name])
    assert kernels == SEVERAL[name]
    assert all(_backend.LAUNCHES.get(k) == 0 or _backend.LAUNCHES.get(k) is not None for k in kernels)
    assert (name in _backend.LAUNCHES) == (name in kernels)
    with open(os.path.join(_backend.CSRC, name + ".cu")) as f:
        src = f.read()
    # a plain C entry point returning the launch's error
    assert 'extern "C" int' in src and "cudaGetLastError()" in src
    if name == "mb_inner_math":
        assert all(op in src for op in ("__hmul2_rn", "__hadd2_rn", "__hsub2_rn"))
    if name == "mb_fwd_breakdown":
        assert "__fmul_rn" in src and "__fadd_rn" in src
