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

import ctypes
import os
import re

import pytest
import torch

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
        # the exponential: ex2.approx.ftz.f32 of the f32-scaled argument in
        # both kernels (no library expf or __expf; never on a bf16 argument)
        from gsplat_tpu_torch.microbench import primitives as pm

        assert "ex2.approx.ftz.f32" in src and "bf16x2" not in src
        assert not re.search(r"\b(__)?expf\(", src)
        assert f"constexpr int kThreads = {pm.INNER_THREADS};" in src and "constexpr int kMaxP = 1 << 24;" in src
        assert f"constexpr int kRuns = {pm.INNER_RUNS};" in src
        assert pm.INNER_MAX_P == 1 << 24
    if name == "mb_fwd_breakdown":
        assert "__fmul_rn" in src and "__fadd_rn" in src


def test_calibration_products_on_hopper_instructions():
    """mb_calib's TF32 product issues wgmma on .tf32 operands from tiles
    that TMA fills (cp.async.bulk.tensor, maps encoded through the runtime's
    driver entry point: no -lcuda), the f32 product stays on FFMA with a
    ring of shared-memory stages filled by cp.async, and the source keeps
    its three counted kernels."""
    assert tuple(_backend.SOURCE_KERNELS["mb_calib"]) == ("fma_chain", "sgemm", "tf32_mma")
    with open(os.path.join(_backend.CSRC, "mb_calib.cu")) as f:
        src = f.read()
    assert "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32" in src
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in src
    assert "cp.async.bulk.tensor.2d" in src and "CU_TENSOR_MAP_SWIZZLE_128B" in src
    assert "cudaGetDriverEntryPoint" in src and "-lcuda" not in " ".join(_backend._COMMON_FLAGS)
    assert "setmaxnreg.inc" in src and "setmaxnreg.dec" in src and "mbarrier.try_wait.parity" in src
    assert "cvt.rna.tf32.f32" in src and "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert "cp.async.cg.shared.global" in src and "cp.async.wait_group" in src
    assert int(re.search(r"kSgStages = (\d+)", src).group(1)) >= 2  # the next stage loads while one multiplies
    assert "mma.sync" not in src


@pytest.mark.parametrize("symbol, argtypes", [("sgemm_launch", "_SGEMM_ARGS"), ("tf32_mma_launch", "_TF32_ARGS")])
def test_calibration_wrappers_bind_c_signatures(symbol, argtypes):
    """vpu_calib binds each product's C entry with one ctypes type for each
    of its parameters, in order (a pointer, an int, a float)."""
    from gsplat_tpu_torch.microbench import vpu_calib as vc

    with open(os.path.join(_backend.CSRC, "mb_calib.cu")) as f:
        params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', f.read()).group(1).split(",")
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float if "float" in p else ctypes.c_int for p in params]
    assert getattr(vc, argtypes) == kinds


def test_gather_sources_on_hopper_copies():
    """mb_gather.cu stages rows by 16-byte cp.async (4-byte where a width or
    a pointer is not aligned) and moves indices and outputs as 16-byte
    vectors; gather_rows has a kernel for each of the plan's lane groups."""
    from gsplat_tpu_torch.microbench import primitives as pm

    with open(os.path.join(_backend.CSRC, "mb_gather.cu")) as f:
        src = f.read()
    assert "cp.async.cg.shared.global [%0], [%1], 16" in src and "cp.async.ca.shared.global [%0], [%1], 4" in src
    assert "cp.async.wait_group" in src and "cp.async.commit_group" in src
    assert "__ldcs(reinterpret_cast<const int4*>" in src and "__stcs(reinterpret_cast<float4*>" in src
    for lanes in pm.ROWS_LANES:
        assert f"rows_kernel<{lanes}>(vec)" in src
    assert f"kSmemLimit = {pm.SMEM_LIMIT}" in src and f"kThreads = {pm.THREADS}" in src
    assert f"kMinBlocks = {pm.MIN_BLOCKS}" in src and src.count("__launch_bounds__(kThreads, kMinBlocks)") == 2


@pytest.mark.parametrize("symbol, argtypes", [("gather_rows_launch", "_ROWS_ARGS"),
                                              ("gather_window_launch", "_WINDOW_ARGS"),
                                              ("gather_cols_launch", "_COLS_ARGS")])
def test_gather_wrappers_bind_c_signatures(symbol, argtypes):
    """primitives binds each gather's C entry with one ctypes type for each
    of its parameters, in order."""
    from gsplat_tpu_torch.microbench import primitives as pm

    with open(os.path.join(_backend.CSRC, "mb_gather.cu")) as f:
        params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', f.read()).group(1).split(",")
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float if "float" in p else ctypes.c_int for p in params]
    assert getattr(pm, argtypes) == kinds


@pytest.mark.parametrize("symbol, argtypes", [("bilagrid_bwd_launch", "_GRID_GRAD_ARGS"),
                                              ("bilagrid_lum_bwd_launch", "_LUM_GRAD_ARGS")])
def test_bilagrid_wrappers_bind_c_signatures(symbol, argtypes):
    """bilagrid binds each gradient kernel's C entry with one ctypes type for
    each of its parameters, in order; both take grad_plan's tiles, and the
    source keeps the plan's header and shared-memory limit."""
    from gsplat_tpu_torch import bilagrid

    with open(os.path.join(_backend.CSRC, "bilagrid_bwd.cu")) as f:
        src = f.read()
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src).group(1).split(",")
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float if "float" in p else ctypes.c_int for p in params]
    assert getattr(bilagrid, argtypes) == kinds
    assert [p.split()[-1] for p in params][2:5] == (["plan", "ntiles", "B"] if symbol == "bilagrid_bwd_launch"
                                                    else ["gray", "plan", "ntiles"])
    assert f"kHeader = {bilagrid.GRAD_PLAN_HEADER}" in src and f"kSmemLimit = {bilagrid.SMEM_LIMIT}" in src
    assert f"kThreads = {bilagrid.GRAD_THREADS}" in src and not re.search(r"\batomic\w*\(", src)
    assert f"kStages = {bilagrid.GRAD_STAGES};" in src and "kLevelPitch = 52;" in src  # bilagrid.grad_smem's layout


@pytest.fixture
def stand_in_library():
    """The C library's `abs` under a source name of its own in `_LIBS`
    (`_LIBS` and the bindings restored afterwards)."""
    libs, bound = dict(_backend._LIBS), dict(_backend._BOUND)
    _backend._LIBS["stand_in"] = ctypes.CDLL(None)
    yield "stand_in"
    _backend._LIBS.clear()
    _backend._LIBS.update(libs)
    _backend._BOUND.clear()
    _backend._BOUND.update(bound)


def test_kernel_binds_once(stand_in_library):
    args = [ctypes.c_int]
    fn = _backend.kernel(stand_in_library, "abs", args)
    assert fn(-3) == 3 and list(fn.argtypes) == [ctypes.c_int] and fn.restype is ctypes.c_int
    fn.restype = ctypes.c_long  # not set again: the same callable as it was left
    assert _backend.kernel(stand_in_library, "abs", args) is fn and fn.restype is ctypes.c_long
    assert _backend.kernel(stand_in_library, "abs", [ctypes.c_int]) is fn  # an equal list
    with pytest.raises(TypeError):
        _backend.kernel(stand_in_library, "abs", [ctypes.c_void_p])
    with pytest.raises(TypeError):
        _backend.kernel(stand_in_library, "abs", args, ctypes.c_longlong)


def test_kernel_rebinds_a_swapped_library(stand_in_library):
    """A comparison script may put another build of a source in `_LIBS`:
    its entry point is bound then, with the same argtypes."""
    args = [ctypes.c_int]
    fn = _backend.kernel(stand_in_library, "abs", args)
    other = ctypes.CDLL(None)
    _backend._LIBS[stand_in_library] = other
    fn2 = _backend.kernel(stand_in_library, "abs", args)
    assert fn2 is getattr(other, "abs") and fn2 is not fn and list(fn2.argtypes) == [ctypes.c_int] and fn2(-5) == 5


def test_common_device():
    a, b = torch.zeros(2), torch.zeros(3)
    assert _backend.common_device(a, None, b) == torch.device("cpu")
    with pytest.raises(ValueError):
        _backend.common_device(a, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        _backend.common_device(None)
