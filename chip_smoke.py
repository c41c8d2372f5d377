#!/usr/bin/env python3
"""Drive the PyTorch port's render and training paths on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the script exits
non-zero (there is no CPU fallback):

  1. device: the card's name and power limit (nvidia-smi);
  2. build: the seventeen kernel sources (csrc/emit.cu, emit_gather.cu,
     rasterize_fwd.cu, rasterize_bwd.cu, gid_reduce.cu, rasterize_2dgs_fwd.cu,
     rasterize_2dgs_bwd.cu, rasterize_tiled_fwd.cu, rasterize_tiled_bwd.cu,
     rasterize_2dgs_tiled_fwd.cu, rasterize_2dgs_tiled_bwd.cu, bilagrid_bwd.cu
     and the micro-benchmarks' mb_calib.cu, mb_gather.cu, mb_inner_math.cu,
     mb_slice_shapes.cu, mb_fwd_breakdown.cu), one nvcc process each,
     started together, into build/gsplat_tpu_torch/, with ptxas's registers
     and spills for each kernel instantiation;
  3. kernel vs plain on the card: garden scene_grid=1 at its native
     648x420, 3 cameras, tile sizes 16 and 32, sh_degree 0 and 3:
     - the emit kernel's keys and gids, and the gather kernel's sorted gids
       and entry rows, must equal their plain versions' (3DGS and 2DGS
       payloads; also a truncated capacity and an empty stream);
     - the forward kernel's image (the background composited after it, as
       the path does) and alpha within max abs 2e-4 (an entry
       at the T ~ 1e-4 termination boundary can flip when the product is
       rounded in another order) and mean abs 1e-6;
     - the backward kernel's rows, for seeded cotangents, within rtol 1e-3
       and atol 1e-4 x the row's max |plain| (T is rebuilt by division,
       which loses digits where alpha was clamped at 0.999), and the same
       bits from two launches; also with the absgrad rows, and at D = 8,
       16, 32 with a background at both tile sizes (the absgrad rows at
       16);
     - the reduce kernel against index_add_ within 1e-6 x the row's
       largest per-Gaussian sum of |values| (the two add in other orders),
       on the stream's own gid order and through a gid sort, each the same
       bits from two launches;
     - the 2DGS forward kernel (RGB and RGB+ED, D = 3 and 4): features, T
       and distortion off by more than 2e-4 x max(1, the output's max
       |plain|) at a share of at most 1e-5 of the values and by at most
       1e-2 x that anywhere (termination flips, as above), the median (a
       selection output) off at most at a share 1e-3 of the pixels;
     - the 2DGS backward kernel's rows, for seeded cotangents and a
       background's term of v_T: slots off by more than 1e-3 x |plain| +
       1e-3 x the row's max |plain| at most a share 1e-4 of the slots, none
       by more than 1e-2 x the row's max (the ray-transform rows sum
       pixel-scaled terms that cancel for an edge-on surfel); each such
       comparison, here and below, also prints how many values lie past
       that per-slot tolerance and the share of pixels whose forward
       `last` equals the plain version's;
     - binned against the oracle on a small subsample, render and the
       gradients w.r.t. the splat parameters, 3DGS and 2DGS (2DGS by the
       repo's count-based gates for its own 2DGS backends);
     - the four tiled kernels on the `isect_tiles` stream by the same
       gates (3DGS also with the absgrad rows and at D = 8, 16, 32 with a
       background; 2DGS at RGB and RGB+ED), and an empty stream, which
       launches nothing and renders the background;
     - both 2DGS pairs (binned and tiled, forward and backward, RGB and
       RGB+ED, sh_degree 3) also at 648x405 and tile sizes 8 and 16: the
       last tile row holds 5 pixel rows, which the 2DGS forward's P pixels
       of a column a thread do not divide;
  4. serving path: garden scene_grid=5 (2,794,625 Gaussians) at
     1920x1080, one camera per frame, tile size 16, sh_degree 3, through
     rasterization(backend="binned") under no_grad, with its launch counts,
     frame and stage times (the sort with, of it, the gather), one profiled
     frame and the tile-size sweep; emit, gather and forward against their
     plain versions at these shapes;
  5. training path: simple_trainer.Runner on the same 2,794,625 points
     (kNN scales, pool of round_up(1.5 N, 4096) slots) against targets
     rendered from the fixture's own splats, 12 steps of one view, tile
     16, DefaultStrategy refining at steps 5 and 10; per-step loss, live
     count and time, each kernel launched in every step, finiteness, the
     loss on view 0 falling; bench.py's fwd+bwd measure on the port; one
     profiled step; step time at tile 16 and 32; each kernel against its
     plain version at the train path's shapes; the reduce on the stream's
     own gid order (the path's call) and through a gid sort against
     index_add_ there, with its bytes bound, and through a gid sort on
     synthetic uniform and large-splat gids of the same sizes;
  6. 2DGS training: simple_trainer_2dgs.Runner2DGS on the training path's
     points and views, 12 steps with both geometry losses from step 0;
     emit, both 2DGS kernels and the gid reduce launched in every step,
     finiteness, the loss on view 0 falling, the steady step time and one
     profiled step; both 2DGS kernels against their plain versions at
     these shapes, over the whole frame (the plain versions timed once)
     and on 256 seeded tiles; the gid reduce at these shapes (on the
     stream's order and through a gid sort, against index_add_, with its
     bytes bound); the emit and gather kernels alone at these shapes with
     their bytes bounds (the gather also against index_select); the 2DGS
     forward's SASS instructions per (pixel, entry) pair
     (its entry loop's static count, cuobjdump, over its P pixels) beside
     the issue slots per pair its time allowed;
  7. 2DGS serving: rasterization_2dgs(backend="binned",
     render_mode="RGB+ED") under no_grad, launching emit and the 2DGS
     forward and nothing else, on two scenes: the serving path's splats as
     surfels (frame-sized near-plane surfels saturate every pixel at once)
     and phase 6's trained surfels (each pixel composites many); for each,
     frame and stage times (the sort with, of it, the gather), the peak
     device memory of a frame, one profiled frame, the stream's size, the
     emit and gather kernels alone on the fixture surfels with their
     bounds, and the 2DGS forward against its plain version on 256 seeded
     tiles (the other tiles' counts zeroed for both);
  8. tiled serving: rasterization(backend="auto") with no isect_capacity
     at the serving path's shapes, which must resolve to the tiled backend
     (n_isects and no slab_required in meta, the tiled forward launched in
     every frame and nothing else); the stream's length beside the binned
     stream's, stage and frame times, one profiled frame, and the tiled
     forward against its plain version on 256 seeded tiles;
  9. tiled training: Runner and Runner2DGS with backend="tiled" on the
     training path's scene, 12 steps each, the tiled forward, the tiled
     backward and the gid reduce launched in every step, with phase 5's
     checks and prints, the tiled kernels against their plain versions at
     the train shapes (the tiled 2DGS forward's SASS per pair as in phase
     6), and the reduce on the tiled streams' own order at the 3DGS and
     2DGS shapes as in phases 5-6;
 10. tiled 2DGS serving: rasterization_2dgs(backend="tiled", RGB+ED) on
     phase 9's trained surfels, with phase 8's prints and checks;
 11. the rest of the op API: fully_fused_projection_packed (with
     compensations) and fully_fused_projection_2dgs_packed at the serving
     shapes, at capacity C*N and nnz/2, each live slot and nnz equal to the
     dense projection bit for bit, truncation keeping the lowest flat
     indices, timed beside the dense projection; at garden grid1 648x420,
     rasterize_to_indices_in_range (and _2dgs) chained over depth-rank
     windows of 1024, then accumulate (accumulate_2dgs) over the pairs:
     against the windows' own composite (FWD_* gates; 2DGS by the FWD2_*
     flip gates) and against the binned forward kernel (3DGS: FWD_* gates;
     2DGS: the FWD2_* gates, every value past FWD2_TOL explained at its
     pixel by a float64 witness of the pairs whose f32 alpha either side
     loses, or the phase fails), pair counts and times;
 12. MCMC training: simple_trainer.Runner(strategy_name="mcmc") on the
     training path's scene (2,794,625 points in a 3,002,368-slot pool,
     cap_max 3,000,000, the reference's MCMC preset init_opa 0.5,
     init_scale 0.1, opacity_reg and scale_reg 0.01), 12 steps refining at
     5 and 10: emit, gather, forward, backward and reduce launched in every
     step, the live count after steps 5 and 10 as the JAX package grows it,
     the Adam moments zero at the slots step 5 activated, free slots' means
     unmoved, finiteness, view 0's loss falling, the steady step time
     beside phase 5's and each refine step's extra time; then on a clone of
     the final pool with a seeded 1% of live slots at opacity 0.001: the
     noise moving live means only, one relocate (the draws sum to the dead
     count, the live count unchanged, no live slot left at or below
     min_opacity) and compute_relocation over the pool, timed; and
     compute_relocation against float64 for ratios 1-51, with TF32 allowed
     by the caller, within the CPU port's error + 2.5e-4;
 13. the COLMAP trainer end to end: datasets/synth.py writes the training
     path's 2,794,625 splats, rendered at 1920x1080 from 10 views on a
     circle (views 0 and 8 validate), as a COLMAP scene with 1,000,000
     seeded initial points and each view's observations (render and write
     times, bytes on disk, Parser's read time); simple_trainer.main on it
     in this process (so that the launch counts can be read), 24 steps
     with the depth loss, pose, appearance and bilateral-grid modules,
     pool headroom 1.0 (the pool grows at step 0), refines at 8 and 16,
     checkpoints at 12 and 24 and the fly-through: emit, the gather, the
     binned forward and backward and the reduce launched in every step,
     the Adam moments at the old slots unchanged by the growth and zero in
     the new ones, the depth term non-zero and finite, every parameter
     finite, the first train view's loss falling, the result files, the
     steady step beside phase 5's, the growth step, a view's load on the
     host and one profiled step; emit, the gather, the forward, the
     backward and the reduce against their plain versions on the path's
     own inputs (the first train view through the pose module, the
     appearance module's per-camera colours, RGB+ED for the depth loss,
     the grown pool and its intersection budget) by phase 3's gates; the
     host's read of that frame as an Up-, a Paeth- and an
     Average-filtered PNG; the checkpoint's arrays the same bits
     after save -> load -> save; a second main resumed from ckpt_12 whose
     losses at steps 12-23 (a refine at 16 among them) lie within 1e-3
     relative of the first run's with equal live counts (not bit-equal on
     the card: SSIM's cuDNN convolutions pick their algorithms per call;
     the bilateral grid's gradients are csrc/bilagrid_bwd.cu's two kernels,
     each launched in every step and on its last step's inputs the same
     bits twice and within GRID_GRAD_TOL of its plain version);
     simple_trainer_2dgs.main for 8 steps (emit, both 2DGS kernels and
     the reduce in every step, finite, val_step8.json; emit, the gather,
     both 2DGS kernels and the reduce against their plain versions on its
     first train view by phase 3's gates); image fitting at
     its defaults for 300 steps on the binned backend (steps/s, PSNR
     rising). Every time printed beside the card's name and power limit;
 14. the micro-benchmarks (the port of scripts/exp_*.py's Pallas
     kernels; gsplat_tpu_torch/microbench/{vpu_calib,primitives,
     kernel_shapes,fwd_breakdown}.py, which scripts/torch_exp_*.py
     drive): each kernel against its plain version at a small size and at
     its TPU script's size (the gathers equal, gather_rows and
     gather_window also at the edges of primitives.gather_plan: ragged
     widths, the S where a lane group narrows, the largest S and W, NB =
     0, K = 0, a misaligned table; the forward breakdown on
     grid1 648x420 and on 256 seeded tiles of the garden grid5 1080p
     tile-32 stream; each tolerance gate shown to reject a wrong result),
     the bilateral grid's gradient at 1920x1080 (the same bits twice,
     against its plain version, timed beside grid_sample's backward), then
     every module's timing run at its TPU script's sizes with the launch counts set
     to 0 before and read after (each kernel launched; each gather also
     as the card's ms a launch and the host's us a call, beside
     torch.gather's), the calibration
     rates beside the data sheet's figures, and fwd_3dgs on the breakdown's
     stream at tile 32 and 16; both of the grid's gradient kernels
     (the grids' and the luminance's) as above;
 15. multi-GPU rendering (gsplat_tpu_torch/distributed.py) at the serving
     path's shapes: (a) an in-process NCCL group of world size 1:
     rasterization(distributed=True) binned and tiled,
     rasterization_2dgs(distributed=True, RGB+ED) binned and one 3DGS
     binned forward and backward, with the launch counts set to 0 before
     and read after (emit, the gather, the binned forward and backward,
     the reduce, the tiled forward and the 2DGS forward each launched),
     then each against the single-device call on the same inputs (whether
     the bits are equal; render and alphas by phase 3's forward gates, the
     gradients by its backward gates, 2DGS by the FWD2 count gates) and
     the frame's time beside rasterization()'s with the host's waits on
     the card in each frame (stream syncs, blocking copies); (b) two gloo
     ranks on the card, spawned here, N padded to even with a masked
     slot: C=1 as two
     strips and C=2 as whole cameras, each 3DGS binned forward and
     backward and 2DGS binned forward, and the packed exchange at
     pack_capacity = pack_required, each rank's block against its block
     of the single-device call by the same gates (a 2DGS strip rebuilt
     from the single-device projection and shifted as distributed.py
     shifts it, equal to the distributed block bit for bit, its kernel
     outputs against the single-device kernel's rows by the FWD2
     tolerance with every value past it explained by the float64 witness
     of phase 11, the strip's frame as one side; the normals from depth
     against depth_to_normal of the strips' gathered depth), each timed
     after a warm-up call (two ranks on one card: not a scaling figure);
 16. multi-GPU training (simple_trainer{,_2dgs} with distributed=True): (a)
     an in-process NCCL group of world size 1 at phase 5's full width
     (garden grid5, 1920x1080, 4,194,304 slots, refines at 5 and 10):
     Runner 12 steps and Runner2DGS 6 steps (both geometry losses from
     step 0, a refine at 5), each against the single-device runner from
     the same initial state, every step's loss and after the last step
     every splat, moment, live slot and per-slot statistic the same bits;
     the median step and its idle share (a profiled step) beside phase
     5's, and a refine's gather and scatter of the pool; the launch counts
     set to 0 before the distributed runs and read after (each training
     kernel launched); (b) two gloo ranks on the card at garden grid1 and
     1080p, spawned here, five cases of 3 steps with a refine at step 2
     (3DGS C=2 with the bilateral grid and two pool growths, 3DGS C=1 in
     strips, 3DGS packed, 2DGS C=2, MCMC; scales made anisotropic by a
     seeded draw), each held to a world-size-1 run of the same
     configuration in rank 0 (a one-rank group): every loss within rtol
     1e-5, the refines and growths the same, the pool before the refine
     per slot by the CPU tests' tolerances against JAX (strips by a count
     gate: a share of 1e-4), and after it the live slots the same, at most
     1e-3 of them holding another Gaussian and each parameter's sum over
     them within 1e-4 (a refine places near ties by statistics that the
     two layouts round apart); per-rank step ms printed;
 17. the apps (gsplat_tpu_torch/compression/, lpips.py, both viewers, the
     trainer's --compression png and --lpips-weights, the profiling and
     compress-eval scripts), with the launch counts set to 0 before 17a-d
     and read after (emit, the gather and the binned forward launched, and
     the training kernels in 17c): (a) PngCompression of garden grid5
     (2,794,625 splats with seeded degree-3 SH, cropped to 1,671^2) with
     the K-means at 65,536 clusters on the card, twice: the same arrays
     both times, each PNG field within half its quantization step of the
     quantized array, bytes and the compress, K-means and decompress
     seconds; shN's round-trip MSE over one centroid's at most
     APPS_KMEANS_LIMIT, the codebook with shuffled labels above it, and
     the card's K-means of 4,096 rows within 1.25x of the CPU's MSE; camera 0 at 1920x1080 (binned) rendered from the original and
     the round trip, their PSNR above APPS_PSNR_FLOOR; (b) LPIPS alex and
     vgg at 1920x1080 from random weights written as an .npz and read back
     by load_lpips_params: lpips(x, x) == 0, a 256x256 crop's value within
     rtol 1e-4 of the port's CPU value, each call timed; (c)
     simple_trainer.main on phase 13's COLMAP scene (kept for this phase)
     from its 1,000,000 points with --compression png
     --lpips-weights, 2 steps, one eval and save:
     compression_2/report.json and val_step2.json with "lpips", the
     compressed eval's launches; (d) simple_viewer (8 frames of 1920x1080 on the
     interpolated path,
     read back) and interactive_viewer on 127.0.0.1 in a thread (one GET a
     mode, each decoded frame equal to Viewer.frame's, on 17c's
     checkpoint); (e) scripts/torch_profiling.py --scene-grid 5
     --resolutions 1080p (its auto backend launching the tiled forward) and
     scripts/torch_compress_eval.py on 17c's checkpoint (four CSV lines),
     each a subprocess whose nonzero exit fails the phase;
 18. the `kernels` line (the eleven path kernels, the grid's two gradient
     kernels and the eighteen micro-benchmark kernels; emit, the gather and the
     reduce also with their times and bounds at the 2DGS train shapes, emit
     and the gather also at the fixture surfels, the four forwards with
     their SASS instructions per pair; the five training kernels also with
     their launches in phase 12 and in phase 13's 3DGS and 2DGS runs and
     their largest error against the plain version on phase 13's inputs,
     the grid's gradients their phase 13 launches and errors, the seven
     kernels of phase 15 their launches there, the training kernels their
     launches in phase 16, every kernel its launches in phase 17), the
     card's name and power limit, then the result line.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
FWD_MAX_ABS = 2e-4
FWD_MEAN_ABS = 1e-6
BWD_RTOL, BWD_ATOL = 1e-3, 1e-4  # atol relative to the row's max |plain|
REDUCE_TOL = 1e-6
# 2DGS forward kernel vs plain: values off by more than FWD2_TOL x scale
# (scale = max(1, the output's max |plain|)) at most a share FWD2_FLIPS of
# them, none by more than FWD2_MAX x scale; the median (a selection output)
# off by more than 1e-5 x scale at most a share MED_FLIPS of its pixels
FWD2_TOL, FWD2_FLIPS, FWD2_MAX = 2e-4, 1e-5, 1e-2
MED_FLIPS = 1e-3
# 2DGS backward kernel vs plain, per row: slots off by more than BWD2_RTOL x
# |plain| + BWD2_ATOL x the row's max |plain| (the repo's 2DGS gradient
# gates) at most a share BWD2_FLIPS of them, none by more than BWD2_MAX x
# the row's max. The M rows sum px v_hu + py v_hv over a tile, and for an
# edge-on surfel (cross product near 0) those terms are many times their
# sum, so another summation order moves a few slots further
BWD2_RTOL, BWD2_ATOL, BWD2_FLIPS, BWD2_MAX = 1e-3, 1e-3, 1e-4, 1e-2
TILE_SUBSET = 256  # tiles of the main shapes' kernel-vs-plain checks
MAIN_TILE = 16
MAIN_GRID = 5
MAIN_W, MAIN_H = 1920, 1080
# grid1's height cut so that its last tile row holds 5 pixel rows at tile 8
# and 16: a partial column the 2DGS forward's P pixels a thread do not divide
RAGGED_H = 405
TRAIN_STEPS = 12
SEED = 0
# 2DGS oracle semantics (rasterize_to_indices_in_range_2dgs + accumulate_2dgs)
# against the binned 2DGS kernel (phase 11): the FWD2_* gates, where every
# value past FWD2_TOL x scale must be explained by a float64 witness at its
# pixel: the pairs whose f32 alpha (the oracle's cross product or the
# kernel's arithmetic) lies more than FWD2_TOL from the float64 alpha of the
# same f32 inputs, with the float64 alpha itself moving at most FWD2_TOL
# when M moves by half an f32 ulp (WITNESS_PERTURB draws), and the float64
# composite with only those pairs' alphas taken from each side reproducing
# that side within FWD2_TOL x scale. An unexplained value fails the phase
WITNESS_PERTURB = 8
WITNESS_CHUNK = 64  # pixels a float64 evaluation over all N surfels
MCMC_CAP_MAX = 3_000_000  # phase 12's pool: the 2,794,625 points grow into it
INDEX_WINDOW = 1024  # depth ranks a rasterize_to_indices_in_range window (phase 11)
# phase 13: the COLMAP trainer
COLMAP_VIEWS = 10  # views 0 and 8 validate (test_every 8)
COLMAP_POINTS = 1_000_000
COLMAP_STEPS = 24
COLMAP_2DGS_STEPS = 8
FIT_STEPS = 300
# the grid's gradient kernels against their plain versions, of each
# value's sum of |terms|: a cell sums ~4 x 10^4 products at 1080p in
# another order (the plain version's index_add_), and the path's
# cotangents cancel (a cell's sum ~1e-5 of its terms)
GRID_GRAD_TOL = 1e-4


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps):
    """Mean ms per call over `reps` calls, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(torch, fn):
    """(result of one call of `fn`, its ms by CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_time_by_kernel(torch, fn):
    """Kernel times on the card over one call of `fn`, from torch.profiler:
    {kernel name: ms}, summed over launches (empty if the profiler saw no
    device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        # user annotations (record_function ranges such as the optimizer's
        # step) also appear on the device timeline; they span kernels
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def host_waits(torch, fn):
    """The host's waits on the card over one call of `fn`, from
    torch.profiler's CPU events: {op: (calls, self CPU ms)} for the runtime
    calls that block the host (stream and device synchronisation, blocking
    copies, the caching allocator's cudaMalloc and cudaFree) and the ops
    that read a device value on the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    keys = ("Synchronize", "cudaMemcpy", "cudaMalloc", "cudaFree", "_local_scalar_dense", "aten::item",
            "aten::equal")
    return {e.key: (e.count, e.self_cpu_time_total / 1e3) for e in prof.key_averages()
            if any(k in e.key for k in keys)}


def log_profile(what, kern, total_ms):
    """Device busy time (kernels on one stream do not overlap, so their sum)
    and idle share against the unprofiled time `total_ms`."""
    if not kern:
        log(f"profiled {what}: the profiler saw no device events; busy time not measured")
        return
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    log(f"profiled {what}: {len(kern)} kernel names, device busy {busy:.3f} ms, "
        f"idle share {1.0 - busy / total_ms:.3f} of {total_ms:.3f} ms; top: "
        + "; ".join(f"{name[:48]} {ms:.3f}" for name, ms in top))


def splat_arrays(grid, sh_degree, seed):
    """The garden fixture as a trained checkpoint would hold it (the JAX
    trainer's `splat/` layout): log-scales, logit-opacities, sh0 from the
    colours and seeded higher-order SH."""
    from gsplat_tpu_torch import load_test_data

    means, quats, scales, opac, colors, viewmats, Ks, W, H = load_test_data(scene_grid=grid)
    n = means.shape[0]
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2 - 1
    arrays = {
        "splat/means": means,
        "splat/quats": quats,
        "splat/scales": np.log(scales),
        "splat/opacities": np.log(opac / np.clip(1.0 - opac, 1e-6, None)),
        "splat/sh0": colors[:, None, :],
        "splat/shN": (0.1 * rng.standard_normal((n, k, 3))).astype(np.float32),
        "live": np.ones(n, bool),
    }
    return arrays, viewmats, Ks, W, H


def render_args(torch, splats):
    """The JAX trainer's render transform (Runner.render)."""
    return (
        splats["means"], splats["quats"], torch.exp(splats["scales"]),
        torch.sigmoid(splats["opacities"]),
        torch.cat([splats["sh0"], splats["shN"]], dim=1),
    )


def shade(rendering, torch, splats, live, viewmats, Ks, W, H, sh_degree):
    means, quats, scales, opac, colors = render_args(torch, splats)
    return rendering.project_and_shade(
        means, quats, scales, opac, colors, viewmats, Ks, W, H,
        sh_degree=sh_degree, masks=live,
    )


def emit_plan(binning, s, ts, W, H, capacity):
    tw, th = -(-W // ts), -(-H // ts)
    return binning.plan_emit(
        s.mean_x, s.mean_y, *s.conics, s.opacities, s.colors, s.radii,
        s.depths, ts, tw, th, capacity,
    )


def compare_emit(torch, binning, plan, slab, T):
    """Emit kernel vs plain on one plan (keys and gids equal), then the
    sort and the gather kernel vs its plain version on the sorted keys
    (gids and entry rows equal). Returns (the kernels' sorted stream, max
    abs difference of its entries from the plain gather's)."""
    raw_k = binning._emit_cuda(plan)
    raw_p = binning._emit_plain(plan)
    for a, b, what in zip(raw_k, raw_p, ("keys", "gids")):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"emit kernel {what} differ from plain at {bad} places")
    bk = binning.sort_entries(raw_k, plan.packed, plan.nf, T, slab, binning.segment_starts(plan))
    gp = binning._gather_plain(plan.packed, plan.nf, bk.dst, raw_k[1], bk.n_isects)
    for a, b, what in zip((bk.gids, bk.entries), gp, ("gids", "entries")):
        if not torch.equal(a, b):
            raise AssertionError(f"gather kernel {what} differ from plain at {int((a != b).sum())} places")
    err = float((bk.entries - gp[1]).abs().max()) if bk.entries.numel() else 0.0
    return bk, err


def gather_args(torch, plan, bk):
    """The gather's inputs for a stream sorted with its order (perm, the
    emitted gids, n_isects), and the valid row ids of index_select."""
    perm = bk.dst
    gids = torch.empty_like(bk.gids)
    gids[perm] = bk.gids  # the emitted order: gids_s[k] = gids[perm[k]]
    ids = torch.where(torch.arange(bk.gids.shape[0], device=perm.device) < bk.n_isects, bk.gids, 0)
    return (plan.packed, plan.nf, perm, gids, bk.n_isects), ids


def binning_fields(torch, binning, plan, bk, reps, what):
    """Emit and the gather alone on one plan and its sorted stream: {kernel
    name: its ms, bound_ms and, for the gather, library_ms}, logged."""
    gargs, ids = gather_args(torch, plan, bk)
    emit_ms = cuda_ms(torch, lambda: binning._emit_cuda(plan), reps)
    gather_ms = cuda_ms(torch, lambda: binning._gather_cuda(*gargs), reps)
    # one PyTorch call for the same rows: index_select and its transpose
    lib_ms = cuda_ms(torch, lambda: torch.index_select(plan.packed, 0, ids)[:, :plan.nf].t().contiguous(), reps)
    e_bytes, live_ids = emit_bytes(plan)
    g_bytes, n_rows = gather_bytes(torch, plan, bk)
    log(f"emit and gather, {what}: {live_ids} of {plan.counts.shape[0]} ids live, {plan.n_emit} entries, "
        f"{int(bk.n_isects)} kept, {plan.nf} payload rows; emit {emit_ms:.3f} ms, bound {e_bytes} bytes "
        f"{e_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms; gather {gather_ms:.3f} ms, bound {g_bytes} bytes "
        f"({n_rows} distinct rows) {g_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms; index_select + transpose "
        f"{lib_ms:.3f} ms")
    return {
        "emit": {"ms": emit_ms, "bound_ms": e_bytes / PEAK_BYTES_PER_S * 1e3},
        "emit_gather": {"ms": gather_ms, "bound_ms": g_bytes / PEAK_BYTES_PER_S * 1e3, "library_ms": lib_ms},
    }


def compare_fwd(torch, rb, bk, C, W, H, ts, entries=None, bg=None):
    """Forward kernel vs plain on one stream (its entries, or `entries` in
    their place), the background `bg` composited onto both. Returns (max abs, mean abs, share of pixels with equal
    `last`, count of values off by > 1e-5, evaluated pairs, the kernel's
    (image, T, last))."""
    entries = bk.entries if entries is None else entries
    args = (entries, bk.offs, bk.cnts, C, W, H, ts)
    img_k, T_k, last_k = rb._fwd_cuda(*args)
    if bg is not None:  # composited after the kernel, as the path does
        img_k = img_k + T_k[..., None] * bg[:, None, None, :]
    img_p, T_p, last_p, pairs = rb._fwd_plain(*args, bg)
    return gate_fwd(torch, (img_k, T_k, last_k), (img_p, T_p, last_p), pairs)


def gate_fwd(torch, ko, po, pairs):
    """FWD_MAX_ABS / FWD_MEAN_ABS on the (image, T) of a forward kernel's
    outputs `ko` against its plain version's `po`; returns as compare_fwd."""
    (img_k, T_k, last_k), (img_p, T_p, last_p) = ko, po
    d = torch.cat([(img_k - img_p).abs().reshape(-1), (T_k - T_p).abs().reshape(-1)])
    max_abs, mean_abs = float(d.max()), float(d.mean())
    n_off = int((d > 1e-5).sum())
    if not (torch.isfinite(img_k).all() and torch.isfinite(T_k).all()):
        raise AssertionError("forward kernel output is not finite")
    if max_abs > FWD_MAX_ABS or mean_abs > FWD_MEAN_ABS:
        raise AssertionError(
            f"forward kernel vs plain: max abs {max_abs:.3e} (limit {FWD_MAX_ABS}), "
            f"mean abs {mean_abs:.3e} (limit {FWD_MEAN_ABS}), {n_off} values off by > 1e-5"
        )
    same_last = float((last_k == last_p).float().mean())
    return max_abs, mean_abs, same_last, n_off, pairs, (img_k, T_k, last_k)


def cotangents(torch, gen, T_out, D):
    """Seeded cotangents of the image [C,H,W,D] and of T_final [C,H,W]."""
    v_img = torch.randn(T_out.shape + (D,), generator=gen, device=T_out.device)
    v_T = torch.randn(T_out.shape, generator=gen, device=T_out.device)
    return v_img, v_T


def compare_bwd(torch, rb, bk, T_out, last, v_img, v_T, C, W, H, ts, absgrad, entries=None, plain=None):
    """Backward kernel vs plain on one stream. Each row within BWD_RTOL of
    |plain| plus BWD_ATOL x the row's max |plain|, and the same bits from
    two launches. Returns (kernel rows, plain rows, max abs error, per-row
    max abs errors, plain's pair counts). `plain` is a precomputed result
    of `_bwd_plain` on the same inputs."""
    entries = bk.entries if entries is None else entries
    args = (entries, bk.offs, bk.cnts, T_out, last, v_img, v_T, C, W, H, ts, absgrad)
    rows_k = same_twice(torch, "backward kernel", lambda: rb._bwd_cuda(*args))
    rows_p, pairs = rb._bwd_plain(*args) if plain is None else plain
    return gate_bwd(torch, rows_k, rows_p, pairs)


def gate_bwd(torch, rows_k, rows_p, pairs):
    """BWD_RTOL / BWD_ATOL on each row of a backward kernel's slot rows
    against its plain version's; returns as compare_bwd."""
    if not torch.isfinite(rows_k).all():
        raise AssertionError("backward kernel rows are not finite")
    errs = []
    for r in range(rows_p.shape[0]):
        diff = (rows_k[r] - rows_p[r]).abs()
        scale = float(rows_p[r].abs().max())
        bad = diff > BWD_RTOL * rows_p[r].abs() + BWD_ATOL * scale
        if bool(bad.any()):
            raise AssertionError(
                f"backward kernel row {r} vs plain: {int(bad.sum())} slots off, max abs "
                f"{float(diff.max()):.3e} against row max {scale:.3e}"
            )
        errs.append(float(diff.max()))
    return rows_k, rows_p, max(errs), errs, pairs


def same_twice(torch, what, fn):
    """fn() run twice; raises unless the two results are the same bits.
    Returns the first."""
    a = fn()
    if not torch.equal(a, fn()):
        raise AssertionError(f"{what}: two launches on the same inputs differ")
    return a


def compare_reduce(torch, rb, rows, gids, n_out, order=None):
    """Reduce kernel vs index_add_ (its plain version), on the stream's own
    gid order `order` (Binned.order / Isect.order) where given and on the
    gids' sort (gid_order, the route of a caller without a stream order);
    each the same bits from two launches. Returns (max abs error, the row
    scales)."""
    want = rb._reduce_plain(rows, gids, n_out)
    scale = rb._reduce_plain(rows.abs(), gids, n_out).amax(dim=1)  # per-row largest sum of |values|
    errs = []
    for how, o in (("stream order", order), ("gid sort", rb.gid_order(gids, n_out))):
        if o is None:
            continue
        got = same_twice(torch, f"reduce kernel ({how})", lambda: rb._reduce_cuda(rows, *o, n_out))
        diff = (got - want).abs()
        bad = diff > REDUCE_TOL * scale[:, None]
        if bool(bad.any()):
            raise AssertionError(
                f"reduce kernel ({how}) vs index_add_: {int(bad.sum())} values off, max abs {float(diff.max()):.3e}"
            )
        errs.append(float(diff.max()) if diff.numel() else 0.0)
    return max(errs), scale


def reduce_at(torch, rb, rows, gids, n_out, order, reps, what):
    """The gid reduce at a training path's shapes: the kernel on the
    stream's own gid order `order` (the path's call, no sort), the same
    kernel through a gid sort (reduce_by_gid without an order) and
    index_add_, each time beside the bytes bound (each live slot's R values
    and a 4-byte gid read once, [R, n_out] written once), and the kernel
    against index_add_ as compare_reduce holds it. Returns (kernel ms,
    index_add_ ms, bound ms, max abs error)."""
    ms = cuda_ms(torch, lambda: rb._reduce_cuda(rows, *order, n_out), reps)
    sort_ms = cuda_ms(torch, lambda: rb.reduce_by_gid(rows, gids, n_out), reps)
    lib_ms = cuda_ms(torch, lambda: rb._reduce_plain(rows, gids, n_out), reps)
    err, _ = compare_reduce(torch, rb, rows, gids, n_out, order)
    R = rows.shape[0]
    n_live = int((gids < n_out).sum())
    red_bytes = n_live * (R * 4 + 4) + R * n_out * 4
    bound = red_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"reduce at the {what} ({n_live} slots of {R} rows into {n_out} ids): on the stream's gid order "
        f"{ms:.3f} ms, through a gid sort {sort_ms:.3f} ms, index_add_ {lib_ms:.3f} ms; {red_bytes} bytes, "
        f"bound {bound:.3f} ms; vs index_add_ max abs {err:.3e}")
    return ms, lib_ms, bound, err


def reduce_synthetic(torch, rb, M, n_out, R, reps):
    """The reduce path against index_add_ on seeded rows [R, M] at the train
    shapes' sizes, for three gid layouts: uniform over the n_out Gaussians;
    the same with one Gaussian owning 20,000 of the slots (a large splat);
    and with Gaussians 1-100 owning 200-1,199 slots each, so that medium
    and long segments meet inside the kernel's chunks. Each is checked as
    compare_reduce checks it."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = torch.randn((R, M), generator=gen, device=dev)
    uniform = torch.randint(0, n_out, (M,), generator=gen, device=dev)
    shuffled = torch.randperm(M, generator=gen, device=dev)
    splat = uniform.clone()
    splat[shuffled[:20000]] = 0
    ids = torch.arange(1, 101, device=dev)
    many = uniform.clone()
    owners = ids.repeat_interleave(200 + (ids * 37) % 1000)
    many[shuffled[: owners.shape[0]]] = owners
    layouts = (("uniform gids", uniform), ("one splat over 20000 slots", splat),
               (f"100 splats over {owners.shape[0]} slots", many))
    for what, gids in layouts:
        order = rb.gid_order(gids, n_out)
        k_ms = cuda_ms(torch, lambda: rb._reduce_cuda(rows, *order, n_out), reps)
        p_ms = cuda_ms(torch, lambda: rb.reduce_by_gid(rows, gids, n_out), reps)
        lib_ms = cuda_ms(torch, lambda: rb._reduce_plain(rows, gids, n_out), reps)
        err, _ = compare_reduce(torch, rb, rows, gids, n_out, order)
        log(f"reduce, synthetic {what} (M {M}, n_out {n_out}, R {R}): kernel {k_ms:.3f} ms, "
            f"gid sort + kernel {p_ms:.3f} ms, index_add_ {lib_ms:.3f} ms; max abs {err:.3e}")


def shade_2dgs(rendering, torch, splats, live, viewmats, Ks, W, H, sh_degree, render_mode):
    means, quats, scales, opac, colors = render_args(torch, splats)
    return rendering.project_and_shade_2dgs(
        means, quats, scales, opac, colors, viewmats, Ks, W, H,
        sh_degree=sh_degree, masks=live, render_mode=render_mode,
    )


def emit_plan_2dgs(binning, r2, s, ts, W, H, capacity):
    tw, th = -(-W // ts), -(-H // ts)
    mx, my = s.means2d[..., 0], s.means2d[..., 1]
    Ms = s.ray_transforms.reshape(s.ray_transforms.shape[:2] + (9,))
    return binning.plan_emit(
        mx, my, None, None, None, None, None, s.radii, s.depths, ts, tw, th, capacity,
        cull=False, payload_rows=r2.surfel_payload(mx, my, Ms, s.opacities, s.colors, s.normals),
    )


def subset_counts(torch, cnts, n_keep, seed):
    """Per-tile counts with all but `n_keep` seeded tiles (among those with
    entries) set to 0: the kernel-vs-plain checks at the main shapes, where
    the whole-frame plain version is slow."""
    gen = torch.Generator(device=cnts.device).manual_seed(seed)
    busy = torch.nonzero(cnts > 0)[:, 0]
    keep = busy[torch.randperm(busy.shape[0], generator=gen, device=busy.device)[:n_keep]]
    out = torch.zeros_like(cnts)
    out[keep] = cnts[keep]
    return out


def tile_subset(torch, bk, n_keep, seed):
    """The binned stream with the counts of all but `n_keep` seeded tiles
    set to 0 (subset_counts)."""
    return bk._replace(cnts=subset_counts(torch, bk.cnts, n_keep, seed))


def _flip_gate(torch, name, got, want, what):
    """FWD2_TOL / FWD2_FLIPS / FWD2_MAX on one output. Returns its max abs."""
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    d = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: kernel {name} is not finite")
    off = float((d > FWD2_TOL * scale).float().mean()) if d.numel() else 0.0
    mx = float(d.max()) if d.numel() else 0.0
    if off > FWD2_FLIPS or mx > FWD2_MAX * scale:
        raise AssertionError(f"{what}: {name} share off by > {FWD2_TOL} x {scale:.3g}: {off:.3e} "
                             f"(limit {FWD2_FLIPS}), max abs {mx:.3e} (limit {FWD2_MAX} x scale)")
    return mx


def compare_fwd2(torch, r2, bk, C, W, H, ts, what, plain=None):
    """2DGS forward kernel vs plain on one stream. Returns ({output: max abs},
    median share off, share of pixels with equal `last`, plain's evaluated
    pairs, the kernel's (features, T, last, distortion, median))."""
    args = (bk.entries, bk.offs, bk.cnts, C, W, H, ts)
    ko = r2._fwd2_cuda(*args)
    po = r2._fwd2_plain(*args) if plain is None else plain
    return gate_fwd2(torch, ko, po, what)


def gate_fwd2(torch, ko, po, what):
    """The FWD2_* and MED_FLIPS gates on a 2DGS forward kernel's outputs
    `ko` against its plain version's `po`; returns as compare_fwd2."""
    errs = {}
    for i, name in ((0, "features"), (1, "T"), (3, "distortion")):
        errs[name] = _flip_gate(torch, name, ko[i], po[i], what)
    scale = max(1.0, float(po[4].abs().max())) if po[4].numel() else 1.0
    med_off = float(((ko[4] - po[4]).abs() > 1e-5 * scale).float().mean()) if po[4].numel() else 0.0
    if med_off > MED_FLIPS:
        raise AssertionError(f"{what}: median differs at a share {med_off:.3e} of pixels (limit {MED_FLIPS})")
    same_last = float((ko[2] == po[2]).float().mean()) if po[2].numel() else 1.0
    return errs, med_off, same_last, po[5], ko


def cotangents_2dgs(torch, gen, T_out, L):
    """Seeded cotangents of the features [C,H,W,L], T_final and the
    distortion [C,H,W]."""
    v_feat = torch.randn(T_out.shape + (L,), generator=gen, device=T_out.device)
    v_T = torch.randn(T_out.shape, generator=gen, device=T_out.device)
    v_dist = torch.randn(T_out.shape, generator=gen, device=T_out.device)
    return v_feat, v_T, v_dist


def compare_bwd2(torch, r2, bk, ko, cot, D, C, W, H, ts, what, plain=None):
    """2DGS backward kernel vs plain on one stream and the kernel forward's
    outputs `ko`, each row held to the BWD2_* gates. Returns (kernel rows, max abs error, per-row max abs
    errors, plain's pair counts, the values past the per-slot tolerance)."""
    feat, T_k, last_k = ko[0], ko[1], ko[2]
    args = (bk.entries, bk.offs, bk.cnts, T_k, last_k, feat[..., D - 1].contiguous(), *cot, C, W, H, ts)
    rows_k = r2._bwd2_cuda(*args)
    rows_p, pairs = r2._bwd2_plain(*args) if plain is None else plain
    return gate_bwd2(torch, rows_k, rows_p, pairs, what)


def gate_bwd2(torch, rows_k, rows_p, pairs, what):
    """The BWD2_* gates on each row of a 2DGS backward kernel's slot rows
    against its plain version's; returns as compare_bwd2."""
    if not torch.isfinite(rows_k).all():
        raise AssertionError(f"{what}: 2DGS backward kernel rows are not finite")
    errs = []
    n_past = 0
    for r in range(rows_p.shape[0]):
        diff = (rows_k[r] - rows_p[r]).abs()
        scale = float(rows_p[r].abs().max()) if rows_p.shape[1] else 0.0
        n_bad = int((diff > BWD2_RTOL * rows_p[r].abs() + BWD2_ATOL * scale).sum())
        if n_bad > BWD2_FLIPS * diff.numel() or bool((diff > BWD2_MAX * scale).any()):
            raise AssertionError(
                f"{what}: 2DGS backward row {r} vs plain: {n_bad} of {diff.numel()} slots off, max abs "
                f"{float(diff.max()):.3e} against row max {scale:.3e}"
            )
        errs.append(float(diff.max()) if diff.numel() else 0.0)
        n_past += n_bad
    return rows_k, max(errs), errs, pairs, n_past


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card only", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from gsplat_tpu_torch import _backend

    t0 = time.perf_counter()
    _backend.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(n + '.cu' for n in _backend.KERNELS)})")
    for name, text in _backend.BUILD_LOG.items():
        for kernel, regs, spill in ptxas_report(text):
            log(f"  ptxas {name} {kernel}: {regs}; {spill}")


def ptxas_report(text):
    """[(kernel, its 'Used N registers, ...' line, its spill line)] of each
    entry function in an nvcc -Xptxas -v log, the names demangled by c++filt
    where the host has it."""
    rows, fn, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn is not None:
            rows.append((fn, line.split(":", 1)[-1].strip(), spill))
    return [(n, regs, sp) for n, (_, regs, sp) in zip(demangle([r[0] for r in rows]), rows)]


def demangle(names):
    """C++ symbol names without their parameter lists (c++filt -p), or as
    given where the host has no c++filt."""
    try:
        out = subprocess.run(["c++filt", "-p"], input="\n".join(names), capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)
    return out if len(out) == len(names) else list(names)


def _sass(so):
    """{demangled kernel: ([(address, instruction)], {label: address})} of
    the shared library `so` (cuobjdump beside nvcc)."""
    from gsplat_tpu_torch import _backend

    cuobjdump = os.path.join(os.path.dirname(_backend._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True, check=True).stdout
    funcs, fn, pending = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn, pending = m.group(1), []
            funcs[fn] = ([], {})
            continue
        if fn is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?);", line)
        if m:
            addr = int(m.group(1), 16)
            funcs[fn][0].append((addr, m.group(2)))
            funcs[fn][1].update({lb: addr for lb in pending})
            pending = []
    return dict(zip(demangle(list(funcs)), funcs.values()))


def _loop_bodies(ins, labels):
    """The instructions of each loop (a backward branch and what it jumps
    over) of one kernel's SASS."""
    for i, (addr, op) in enumerate(ins):
        m = re.search(r"\bBRA\b[^`]*?(?:0x([0-9a-f]+)|`\(\s*(\.L_x_\d+)\s*\))", op)
        if not m:
            continue
        target = int(m.group(1), 16) if m.group(1) else labels.get(m.group(2), addr + 1)
        if target <= addr:
            yield [o for a, o in ins[:i + 1] if a >= target]


def sass_loops(so, pattern, ex2=None):
    """{demangled kernel: the instructions of the innermost loop of its SASS
    that holds an MUFU.EX2 (an expf)} for each kernel of the shared library
    `so` whose name contains `pattern` (cuobjdump beside nvcc); with `ex2`
    (a function of the kernel's name) the loop must hold exactly ex2(name)
    of them. A static count of the loop's body: the compositing loop over
    staged entries."""
    counts = {}
    for name, (ins, labels) in _sass(so).items():
        if pattern not in name:
            continue
        best = None
        want = ex2(name) if ex2 is not None else None
        for body in _loop_bodies(ins, labels):
            n_ex2 = sum("MUFU.EX2" in o for o in body)
            if n_ex2 and (want is None or n_ex2 == want) and (best is None or len(body) < best):
                best = len(body)
        counts[name] = best
    return counts


def repeat_loops(so, ops):
    """{demangled kernel: [(loop length, count of its op) for each loop
    holding one]} of the shared library `so`, `ops` {kernel name part: SASS
    opcode} (FFMA, HMMA): shows that a micro-benchmark's repeats stay loops
    of the work on the card."""
    def opcode(ins):  # past a predicate such as @P0
        parts = ins.split()
        return parts[1] if len(parts) > 1 and parts[0].startswith("@") else (parts[0] if parts else "")

    out = {}
    for name, (ins, labels) in _sass(so).items():
        op = next((o for part, o in ops.items() if part in name), None)
        if op is not None:
            counts = ((len(b), sum(opcode(i).startswith(op) for i in b)) for b in _loop_bodies(ins, labels))
            out[name] = sorted(c for c in counts if c[1])
    return out


# SASS opcodes by the kind of issue slot they take (the first match wins):
# MUFU (the SFU), the packed half / bf16 pipe, conversions, f32, integer
# and moves (uniform datapath included), branches, memory
SASS_KINDS = (("MUFU", ("MUFU",)), ("HFMA2", ("HADD2", "HMUL2", "HFMA2", "HMNMX2", "HSETP2", "HSET2")),
              ("conversion", ("F2F", "I2F", "F2I", "F2FP", "I2FP", "FRND")),
              ("FP32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "FSWZADD")),
              ("integer", ("IADD", "IMAD", "ISETP", "IMNMX", "IABS", "LOP", "SHF", "LEA", "SEL", "PRMT", "MOV",
                           "U", "S2R", "S2UR", "CS2R", "P2R", "R2P", "PLOP3", "VIADD", "VIMNMX", "FLO", "POPC")),
              ("branch", ("BRA", "BSSY", "BSYNC", "EXIT", "WARPSYNC", "BAR", "RET", "CALL", "BREAK", "NOP")),
              ("memory", ("LD", "ST", "RED", "ATOM")))


def sass_mix(so, pattern):
    """{demangled kernel: {kind: instructions a term, "loop": the loop's
    instructions, "ex2": its MUFU.EX2}} for each kernel of the shared
    library `so` whose name contains `pattern`: the innermost SASS loop
    holding an MUFU.EX2 (`sass_loops`' loop), its instructions counted by
    `SASS_KINDS` and divided by its MUFU.EX2 (one exponential a term),
    "slots" all of them a term. A static count: each instruction once."""
    def opcode(ins):
        parts = ins.split()
        return parts[1] if len(parts) > 1 and parts[0].startswith("@") else (parts[0] if parts else "")

    out = {}
    for name, (ins, labels) in _sass(so).items():
        if pattern not in name:
            continue
        loops = [b for b in _loop_bodies(ins, labels) if any("MUFU.EX2" in o for o in b)]
        if not loops:
            out[name] = None
            continue
        body = min(loops, key=len)
        n_ex2 = sum("MUFU.EX2" in o for o in body)
        counts = {kind: 0 for kind, _ in SASS_KINDS}
        counts["other"] = 0
        for o in body:
            op = opcode(o)
            kind = next((k for k, prefixes in SASS_KINDS if op.startswith(prefixes)), "other")
            counts[kind] += 1
        mix = {k: round(v / n_ex2, 3) for k, v in counts.items()}
        mix.update(slots=round(len(body) / n_ex2, 3), loop=len(body), ex2=n_ex2)
        out[name] = mix
    return out


def fwd2_sass_per_pair(so, L, ts):
    """(kernel, loop instructions, P, instructions per (pixel, entry) pair)
    of the fwd_2dgs instantiation in `so` that L channels at tile size ts
    launch: its entry loop's SASS count over its P pixels a thread (a kernel
    without the TS and P arguments is one pixel a thread)."""
    lmax = 4 if L <= 4 else 8 if L <= 8 else 16 if L <= 16 else 35
    for name, n in sass_loops(so, "fwd_2dgs").items():
        m = re.search(r"fwd_2dgs<raster::\w+<\d+>, (\d+)(?:, (\d+), (\d+))?>", name)
        if m and int(m.group(1)) == lmax and (m.group(2) is None or int(m.group(2)) == ts):
            P = int(m.group(3)) if m.group(3) else 1
            return name, n, P, (n / P if n else None)
    return None, None, None, None


def emit_bytes(plan):
    """(bytes the emit kernel must move, live ids): a live id's start,
    rectangle and depth read (and its six cull values with the cull), each
    entry's key and gid written; an id that emits nothing costs nothing."""
    CN = plan.counts.shape[0]
    live_ids = int((plan.counts > 0).sum())
    return live_ids * (8 + 3 * 4 + 4 + (6 * 4 if plan.cull else 0)) + plan.n_emit * (8 + 4), live_ids


def gather_bytes(torch, plan, bk):
    """(bytes the gather must move, distinct rows): per slot the sort's
    permutation (8) and an emitted gid (4) read, the sorted gid (4) and nf
    values written; each distinct row that a kept slot names read once."""
    n = int(bk.n_isects)
    rows = int(torch.unique(bk.gids[:n]).numel()) if n else 0
    M = bk.gids.shape[0]
    return M * (8 + 4 + 4 + 4 * plan.nf) + rows * plan.nf * 4 + 8, rows


def fwd3_sass_per_pair(so, D, ts):
    """(kernel, loop instructions, P, instructions per (pixel, entry) pair)
    of the fwd_3dgs instantiation in `so` that D channels at tile size ts
    launch: its compositing loop (the loop holding its P pixels' expf, not
    the warp-reach loop's) over its P pixels a thread."""
    dmax = 4 if D <= 4 else 8 if D <= 8 else 16 if D <= 16 else 32
    for name, n in sass_loops(so, "fwd_3dgs", ex2=_fwd3_pixels).items():
        m = re.search(r"fwd_3dgs<raster::\w+<\d+>, (\d+), (\d+), (\d+)>", name)
        if m and int(m.group(1)) == dmax and int(m.group(2)) == ts:
            P = int(m.group(3))
            return name, n, P, (n / P if n else None)
    return None, None, None, None


def _fwd3_pixels(name):
    m = re.search(r"fwd_3dgs<raster::\w+<\d+>, \d+, \d+, (\d+)>", name)
    return int(m.group(1)) if m else None


def forward_sass_report(_backend, name, per_pair_fn, ms, pairs, *args):
    """Log the SASS instructions per pair of the forward that `name`
    launched (per_pair_fn(so, *args): fwd2_sass_per_pair or
    fwd3_sass_per_pair) beside the issue slots per evaluated pair that its
    `ms` allowed; returns the former."""
    kernel, n, P, per_pair = per_pair_fn(_backend._library_path(name), *args)
    if per_pair is None:
        raise AssertionError(f"{name}: no entry loop found in the SASS of {kernel}")
    # 132 SMs x 4 schedulers x 32 lanes a cycle at the largest SM clock
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True).stdout.split()[0])
    slots = ms * 1e-3 * 132 * 128 * mhz * 1e6 / max(pairs, 1)
    log(f"{name} {kernel}: {n} SASS instructions in the entry loop for {P} pixels, {per_pair:.1f} a pair; "
        f"{ms:.3f} ms allowed {slots:.1f} thread-instruction slots an evaluated pair at {mhz:.0f} MHz")
    return per_pair


def phase_kernel_vs_plain():
    import torch
    from gsplat_tpu_torch import rendering, splats_from_numpy
    from gsplat_tpu_torch.ops import binning, rasterize_binned as rb

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    arrays, viewmats, Ks, W, H = splat_arrays(1, 3, SEED)
    splats, live = splats_from_numpy(arrays, device=dev)
    vm = torch.as_tensor(viewmats, device=dev)
    K = torch.as_tensor(Ks, device=dev)
    C = vm.shape[0]
    N = splats["means"].shape[0]
    with torch.no_grad():
        for ts in (16, 32):
            for deg in (0, 3):
                s = shade(rendering, torch, splats, live, vm, K, W, H, deg)
                plan, slab = emit_plan(binning, s, ts, W, H, capacity=1 << 30)
                T = C * (-(-W // ts)) * (-(-H // ts))
                bk, _ = compare_emit(torch, binning, plan, slab, T)
                mx, mean, same_last, n_off, _, (_, T_k, last_k) = compare_fwd(torch, rb, bk, C, W, H, ts)
                log(f"kernel vs plain grid1 {W}x{H} C={C} ts={ts} sh={deg}: "
                    f"n_isects {int(bk.n_isects)}, emit equal, fwd max abs {mx:.3e} "
                    f"mean abs {mean:.3e} ({n_off} values > 1e-5), last equal at {same_last:.6f} of pixels")
                absgrad = ts == 16 and deg == 3
                v_img, v_T = cotangents(torch, gen, T_k, 3)
                rows_k, _, bmx, errs, _ = compare_bwd(torch, rb, bk, T_k, last_k, v_img, v_T, C, W, H, ts, absgrad)
                rmx, _ = compare_reduce(torch, rb, rows_k, bk.gids, C * N, bk.order)
                log(f"  bwd kernel vs plain{' (with absgrad rows)' if absgrad else ''}: max abs per row "
                    + " ".join(f"{e:.2e}" for e in errs) + f"; reduce vs index_add_ max abs {rmx:.3e}")
                if deg == 3:
                    # wider channel counts (the kernels' 8-, 16- and 32-wide
                    # instantiations) on this stream: random channel rows and
                    # a random background; the background's term of v_T is
                    # what autograd would hand the backward; the absgrad rows
                    # at ts 16, none at ts 32
                    M = bk.entries.shape[1]
                    for D in (8, 16, 32):
                        ent = torch.cat([bk.entries[:6], torch.rand((D, M), generator=gen, device=dev)])
                        bg = torch.rand((C, D), generator=gen, device=dev)
                        mx, mean, same_last, n_off, _, (_, T_d, last_d) = compare_fwd(
                            torch, rb, bk, C, W, H, ts, ent, bg)
                        v_img, v_T = cotangents(torch, gen, T_d, D)
                        v_T = v_T + (v_img * bg[:, None, None, :]).sum(dim=-1)
                        rows_d, _, bmx, _, _ = compare_bwd(
                            torch, rb, bk, T_d, last_d, v_img, v_T, C, W, H, ts, ts == 16, entries=ent)
                        rmx, _ = compare_reduce(torch, rb, rows_d, bk.gids, C * N, bk.order)
                        log(f"kernel vs plain grid1 ts={ts} D={D} with background: fwd max abs {mx:.3e} "
                            f"mean abs {mean:.3e} ({n_off} values > 1e-5), last equal at {same_last:.6f} "
                            f"of pixels; bwd{' (absgrad rows)' if ts == 16 else ''} max abs {bmx:.3e}; "
                            f"reduce ({rows_d.shape[0]} rows) max abs {rmx:.3e}")

        # emit and the gather at a truncated capacity (half the slab: whole
        # emit blocks dropped) and on an empty stream (no radius), ts 16
        T = C * (-(-W // 16)) * (-(-H // 16))
        full, need = emit_plan(binning, s, 16, W, H, capacity=1 << 30)
        plan, slab = emit_plan(binning, s, 16, W, H, capacity=need // 2)
        bk, _ = compare_emit(torch, binning, plan, slab, T)
        if not 0 < plan.n_emit < full.n_emit:
            raise AssertionError(f"capacity {need // 2} emitted {plan.n_emit} of {full.n_emit} entries")
        empty, slab_e = emit_plan(binning, s._replace(radii=torch.zeros_like(s.radii)), 16, W, H, capacity=1 << 30)
        be, _ = compare_emit(torch, binning, empty, slab_e, T)
        if empty.n_emit or be.entries.shape != (empty.nf, 0) or int(be.cnts.sum()):
            raise AssertionError(f"empty stream: {empty.n_emit} emitted, entries {tuple(be.entries.shape)}")
        log(f"emit and gather vs plain grid1 ts=16: truncated capacity {need // 2} ({plan.n_emit} of "
            f"{full.n_emit} entries emitted, {int(bk.n_isects)} kept) equal; empty stream equal")

        # binned (kernels) vs oracle on a small subsample, as the repo's
        # golden test cuts the garden: every 15th Gaussian, cameras / 4
        sub = {k: v[::15] for k, v in splats.items()}
        f = 4
        Ks4 = K.clone()
        Ks4[:, :2, :] /= f
        args = render_args(torch, sub)
        bg = torch.full((C, 3), 0.2, device=dev)
        out = {}
        for backend in ("binned", "oracle"):
            out[backend] = rendering.rasterization(
                *args, vm, Ks4, W // f, H // f, sh_degree=3, backgrounds=bg,
                backend=backend, isect_capacity=1 << 20,
            )
        d_img = float((out["binned"][0] - out["oracle"][0]).abs().max())
        d_a = float((out["binned"][1] - out["oracle"][1]).abs().max())
        if max(d_img, d_a) > FWD_MAX_ABS:
            raise AssertionError(f"binned vs oracle: image {d_img:.3e}, alpha {d_a:.3e}")
        log(f"binned vs oracle ({sub['means'].shape[0]} Gaussians, {W // f}x{H // f}, C={C}): "
            f"max abs image {d_img:.3e} alpha {d_a:.3e}")

    # gradients, binned (backward + reduce kernels) against the oracle's
    # autograd, cameras / 8 so the oracle's [C, pixels, N] tensors fit
    f = 8
    Ks8 = K.clone()
    Ks8[:, :2, :] /= f
    wr = torch.randn((C, H // f, W // f, 3), generator=gen, device=dev)
    wa = torch.randn((C, H // f, W // f, 1), generator=gen, device=dev)
    grads = {}
    for backend in ("binned", "oracle"):
        leaves = {k: v.clone().requires_grad_(True) for k, v in sub.items()}
        carrier = torch.zeros((C, sub["means"].shape[0], 2), device=dev, requires_grad=True)
        r, a, _ = rendering.rasterization(
            *render_args(torch, leaves), vm, Ks8, W // f, H // f, sh_degree=3,
            backgrounds=bg, backend=backend, isect_capacity=1 << 20, means2d_carrier=carrier,
        )
        ((r * wr).sum() + (a * wa).sum()).backward()
        grads[backend] = {k: v.grad for k, v in leaves.items()}
        grads[backend]["means2d"] = carrier.grad
    worst = []
    for k, want in grads["oracle"].items():
        got = grads["binned"][k]
        scale = max(float(want.abs().max()), 1e-3)
        diff = (got - want).abs()
        if not bool(torch.isfinite(got).all()) or bool((diff > BWD_RTOL * want.abs() + BWD_ATOL * scale).any()):
            raise AssertionError(f"binned vs oracle gradient of {k}: max abs {float(diff.max()):.3e}, scale {scale:.3e}")
        worst.append(f"{k} {float(diff.max()) / scale:.2e}")
    log(f"binned vs oracle gradients ({W // f}x{H // f}, C={C}), max abs / max |oracle|: " + ", ".join(worst))


def check_2dgs_binned(torch, gen, splats, live, vm, K, W, H, ts, deg, mode):
    """Emit, the binned 2DGS forward and backward against their plain
    versions on one grid1 stream at W x H, with a background's term of v_T."""
    from gsplat_tpu_torch import rendering
    from gsplat_tpu_torch.ops import binning, rasterize_2dgs_binned as r2

    C = vm.shape[0]
    s = shade_2dgs(rendering, torch, splats, live, vm, K, W, H, deg, mode)
    D = s.colors.shape[-1]
    plan, slab = emit_plan_2dgs(binning, r2, s, ts, W, H, capacity=1 << 30)
    T = C * (-(-W // ts)) * (-(-H // ts))
    bk, _ = compare_emit(torch, binning, plan, slab, T)
    what = f"2DGS grid1 ts={ts} sh={deg} D={D}"
    errs, med_off, same_last, _, ko = compare_fwd2(torch, r2, bk, C, W, H, ts, what)
    # a background enters through T's cotangent (the caller composites it),
    # as autograd would hand it over
    bg = torch.rand((C, D), generator=gen, device=vm.device)
    cot = cotangents_2dgs(torch, gen, ko[1], D + 3)
    cot = (cot[0], cot[1] + (cot[0][..., :D] * bg[:, None, None, :]).sum(dim=-1), cot[2])
    rows_k, bmx, berrs, _, n_past = compare_bwd2(torch, r2, bk, ko, cot, D, C, W, H, ts, what)
    log(f"kernel vs plain {what} {W}x{H} C={C}: n_isects {int(bk.n_isects)}, emit equal, fwd max abs "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f", median off at {med_off:.2e} of pixels, last equal at {same_last:.6f}; "
        f"bwd max abs per row " + " ".join(f"{e:.2e}" for e in berrs))
    log(f"  {what}: bwd values past the per-slot tolerance {n_past} of {rows_k.numel()}; "
        f"forward last equal at {same_last:.6f} of pixels")


def phase_kernel_vs_plain_2dgs():
    """The 2DGS kernels against their plain versions at grid1 (as
    phase_kernel_vs_plain), and binned 2DGS against the 2DGS oracle on a
    small subsample."""
    import torch
    from gsplat_tpu_torch import rendering, splats_from_numpy

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    arrays, viewmats, Ks, W, H = splat_arrays(1, 3, SEED)
    splats, live = splats_from_numpy(arrays, device=dev)
    vm = torch.as_tensor(viewmats, device=dev)
    K = torch.as_tensor(Ks, device=dev)
    C = vm.shape[0]
    with torch.no_grad():
        for ts in (16, 32):
            for deg in (0, 3):
                for mode in ("RGB", "RGB+ED"):
                    check_2dgs_binned(torch, gen, splats, live, vm, K, W, H, ts, deg, mode)
        # a partial last tile row that P does not divide (H % 16 = 5): the
        # forward's P pixels of a column, some past the image edge
        for ts in (8, 16):
            for mode in ("RGB", "RGB+ED"):
                check_2dgs_binned(torch, gen, splats, live, vm, K, W, RAGGED_H, ts, 3, mode)

    # binned (kernels) against the oracle on a small subsample: every 30th
    # Gaussian, cameras / 8, so the oracle's [C, pixels, N, 3] tensors fit
    sub = {k: v[::30] for k, v in splats.items()}
    f = 8
    Ks8 = K.clone()
    Ks8[:, :2, :] /= f
    w8, h8 = W // f, H // f
    bg = torch.full((C, 3), 0.2, device=dev)
    cot = [torch.randn(shape, generator=gen, device=dev) for shape in
           ((C, h8, w8, 4), (C, h8, w8, 1), (C, h8, w8, 3), (C, h8, w8, 1))]
    outs, grads = {}, {}
    for backend in ("binned", "oracle"):
        leaves = {k: v.clone().requires_grad_(True) for k, v in sub.items()}
        carrier = torch.zeros((C, sub["means"].shape[0], 2), device=dev, requires_grad=True)
        o = rendering.rasterization_2dgs(
            *render_args(torch, leaves), vm, Ks8, w8, h8, sh_degree=3, backgrounds=bg,
            render_mode="RGB+D", distloss=True, backend=backend, isect_capacity=1 << 20,
            densify_carrier=carrier,
        )
        outs[backend] = [x.detach() for x in (o[0], o[1], o[2], o[4], o[5])]
        sum(((x * w).sum() for x, w in zip((o[0], o[1], o[2], o[4]), cot))).backward()
        grads[backend] = {k: v.grad for k, v in leaves.items()}
        grads[backend]["means2d"] = carrier.grad
    d_out = []
    for name, got, want in zip(("colors", "alphas", "normals", "distortion", "median"),
                               outs["binned"], outs["oracle"]):
        d = (got - want).abs()
        # the oracle sums in another order: count-based gates, as the repo's
        # own 2DGS tests hold a backend to the oracle
        if float(d.max()) > 1e-2 or float((d > 2e-4).float().mean()) > 1e-3:
            raise AssertionError(f"binned 2DGS vs oracle {name}: max abs {float(d.max()):.3e}, "
                                 f"share > 2e-4 {float((d > 2e-4).float().mean()):.3e}")
        d_out.append(f"{name} {float(d.max()):.2e}")
    # the repo's gate for a 2DGS backend's gradients against the oracle's
    # (tests/test_rasterize_2dgs_tiled.py's _mostly_close): 99.5% of values
    # within 2e-3 x scale, none off by more than 0.05 x scale
    worst = []
    for k, want in grads["oracle"].items():
        got = grads["binned"][k]
        scale = max(float(want.abs().max()), 1.0)
        diff = (got - want).abs()
        close = float((diff <= 2e-3 * scale).float().mean())
        if not bool(torch.isfinite(got).all()) or close < 0.995 or float(diff.max()) > 0.05 * scale:
            raise AssertionError(f"binned 2DGS vs oracle gradient of {k}: max abs {float(diff.max()):.3e}, "
                                 f"scale {scale:.3e}, share within 2e-3 x scale {close:.4f}")
        worst.append(f"{k} {float(diff.max()) / scale:.2e}")
    log(f"binned 2DGS vs oracle ({sub['means'].shape[0]} Gaussians, {w8}x{h8}, C={C}, RGB+D), max abs: "
        + ", ".join(d_out) + "; gradients, max abs / max |oracle|: " + ", ".join(worst))


def tiled_stream(torch, rt, isect_tiles, s, ts, W, H, capacity):
    """The tiled backend's inputs for a 3DGS `Shaded`: (packed rows, ids,
    offs, cnts, the Isect record)."""
    isect = isect_tiles((s.mean_x, s.mean_y), s.radii, s.depths, ts, -(-W // ts), -(-H // ts), capacity)
    packed = rt.pack_rows([s.mean_x, s.mean_y, *s.conics, s.opacities, *s.colors.unbind(-1)])
    return (packed, isect.flatten_ids, *rt.stream_ranges(isect), isect)


def tiled_stream_2dgs(torch, rt, r2, isect_tiles, s, ts, W, H, capacity):
    """The tiled backend's inputs for a `Shaded2DGS`, as tiled_stream."""
    mx, my = s.means2d[..., 0], s.means2d[..., 1]
    isect = isect_tiles((mx, my), s.radii, s.depths, ts, -(-W // ts), -(-H // ts), capacity)
    Ms = s.ray_transforms.reshape(s.ray_transforms.shape[:2] + (9,))
    packed = rt.pack_rows(r2.surfel_payload(mx, my, Ms, s.opacities, s.colors, s.normals))
    return (packed, isect.flatten_ids, *rt.stream_ranges(isect), isect)


def compare_tiled_fwd(torch, rt, st, D, C, W, H, ts, bg=None, plain=None):
    """Tiled forward kernel vs plain on one stream `st` (tiled_stream), the
    background `bg` composited onto both as the caller does. Returns as
    compare_fwd."""
    args = (st[0], D, st[1], st[2], st[3], C, W, H, ts)
    ko = list(rt._tiled_fwd_cuda(*args))
    po = list(rt._tiled_fwd_plain(*args) if plain is None else plain)
    if bg is not None:
        for o in (ko, po):
            o[0] = o[0] + o[1][..., None] * bg[:, None, None, :]
    return gate_fwd(torch, ko, po[:3], po[3])


def compare_tiled_bwd(torch, rt, st, D, T_out, last, v_img, v_T, C, W, H, ts, absgrad, plain=None):
    """Tiled backward kernel vs plain on one stream; returns as compare_bwd."""
    args = (st[0], D, st[1], st[2], st[3], T_out, last, v_img, v_T, C, W, H, ts, absgrad)
    rows_k = same_twice(torch, "tiled backward kernel", lambda: rt._tiled_bwd_cuda(*args))
    rows_p, pairs = rt._tiled_bwd_plain(*args) if plain is None else plain
    return gate_bwd(torch, rows_k, rows_p, pairs)


def compare_tiled_fwd2(torch, r2t, st, L, C, W, H, ts, what, plain=None):
    """Tiled 2DGS forward kernel vs plain; returns as compare_fwd2."""
    args = (st[0], L, st[1], st[2], st[3], C, W, H, ts)
    ko = r2t._tiled2_fwd_cuda(*args)
    po = r2t._tiled2_fwd_plain(*args) if plain is None else plain
    return gate_fwd2(torch, ko, po, what)


def compare_tiled_bwd2(torch, r2t, st, ko, cot, D, C, W, H, ts, what, plain=None):
    """Tiled 2DGS backward kernel vs plain on the kernel forward's outputs
    `ko`; returns as compare_bwd2."""
    args = (st[0], D + 3, st[1], st[2], st[3], ko[1], ko[2], ko[0][..., D - 1].contiguous(), *cot,
            C, W, H, ts)
    rows_k = r2t._tiled2_bwd_cuda(*args)
    rows_p, pairs = r2t._tiled2_bwd_plain(*args) if plain is None else plain
    return gate_bwd2(torch, rows_k, rows_p, pairs, what)


def check_2dgs_tiled(torch, gen, splats, live, vm, K, W, H, ts, deg, mode):
    """The tiled 2DGS forward and backward against their plain versions on
    one grid1 stream at W x H, as check_2dgs_binned."""
    from gsplat_tpu_torch import rendering
    from gsplat_tpu_torch.ops import rasterize_2dgs_binned as r2, rasterize_2dgs_tiled as r2t
    from gsplat_tpu_torch.ops import rasterize_tiled as rt
    from gsplat_tpu_torch.ops.isect import isect_tiles

    C = vm.shape[0]
    s2 = shade_2dgs(rendering, torch, splats, live, vm, K, W, H, deg, mode)
    D = s2.colors.shape[-1]
    st2 = tiled_stream_2dgs(torch, rt, r2, isect_tiles, s2, ts, W, H, 1 << 30)
    what = f"tiled 2DGS grid1 ts={ts} sh={deg} D={D}"
    ferrs, med_off, same_last, _, ko = compare_tiled_fwd2(torch, r2t, st2, D + 3, C, W, H, ts, what)
    bg = torch.rand((C, D), generator=gen, device=vm.device)
    cot = cotangents_2dgs(torch, gen, ko[1], D + 3)
    cot = (cot[0], cot[1] + (cot[0][..., :D] * bg[:, None, None, :]).sum(dim=-1), cot[2])
    rows2, _, berrs, _, n_past = compare_tiled_bwd2(torch, r2t, st2, ko, cot, D, C, W, H, ts, what)
    log(f"kernel vs plain {what} {W}x{H}: stream {st2[1].shape[0]} entries, fwd max abs "
        + ", ".join(f"{k} {v:.3e}" for k, v in ferrs.items())
        + f", median off at {med_off:.2e}, last equal at {same_last:.6f}; bwd max abs per row "
        + " ".join(f"{e:.2e}" for e in berrs))
    log(f"  {what}: bwd values past the per-slot tolerance {n_past} of {rows2.numel()}; "
        f"forward last equal at {same_last:.6f} of pixels")


def phase_kernel_vs_plain_tiled():
    """The four tiled kernels against their plain versions at grid1 (as
    phase_kernel_vs_plain): 3DGS forward and backward at ts 16 and 32, sh 0
    and 3, with the absgrad rows at ts 16, and at D = 8, 16, 32 with a
    background; the 2DGS pair on the same grid (RGB and RGB+ED) by the 2DGS
    gates; the reduce on the tiled slots (the stream's order and the gid
    sort); an empty stream."""
    import torch
    from gsplat_tpu_torch import _backend, rendering, splats_from_numpy
    from gsplat_tpu_torch.ops import rasterize_2dgs_binned as r2, rasterize_2dgs_tiled as r2t
    from gsplat_tpu_torch.ops import rasterize_binned as rb, rasterize_tiled as rt
    from gsplat_tpu_torch.ops.isect import isect_tiles

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    arrays, viewmats, Ks, W, H = splat_arrays(1, 3, SEED)
    splats, live = splats_from_numpy(arrays, device=dev)
    vm = torch.as_tensor(viewmats, device=dev)
    K = torch.as_tensor(Ks, device=dev)
    C = vm.shape[0]
    N = splats["means"].shape[0]
    cap = 1 << 30
    with torch.no_grad():
        for ts in (16, 32):
            for deg in (0, 3):
                s = shade(rendering, torch, splats, live, vm, K, W, H, deg)
                st = tiled_stream(torch, rt, isect_tiles, s, ts, W, H, cap)
                mx, mean, same_last, n_off, _, (_, T_k, last_k) = compare_tiled_fwd(torch, rt, st, 3, C, W, H, ts)
                absgrad = ts == 16 and deg == 3
                v_img, v_T = cotangents(torch, gen, T_k, 3)
                rows_k, _, bmx, errs, _ = compare_tiled_bwd(
                    torch, rt, st, 3, T_k, last_k, v_img, v_T, C, W, H, ts, absgrad)
                rmx, _ = compare_reduce(torch, rb, rows_k, st[1], C * N, st[4].order)
                log(f"tiled kernel vs plain grid1 {W}x{H} C={C} ts={ts} sh={deg}: stream {st[1].shape[0]} "
                    f"entries, fwd max abs {mx:.3e} mean abs {mean:.3e} ({n_off} values > 1e-5), last equal "
                    f"at {same_last:.6f} of pixels; bwd{' (with absgrad rows)' if absgrad else ''} max abs per "
                    "row " + " ".join(f"{e:.2e}" for e in errs) + f"; reduce vs index_add_ max abs {rmx:.3e}")
                if deg == 3:
                    M = st[1].shape[0]
                    for D in (8, 16, 32):
                        cols = torch.rand((C, N, D), generator=gen, device=dev)
                        std = (rt.pack_rows([s.mean_x, s.mean_y, *s.conics, s.opacities, *cols.unbind(-1)]),
                               *st[1:])
                        bg = torch.rand((C, D), generator=gen, device=dev)
                        mx, mean, same_last, n_off, _, (_, T_d, last_d) = compare_tiled_fwd(
                            torch, rt, std, D, C, W, H, ts, bg)
                        v_img, v_T = cotangents(torch, gen, T_d, D)
                        v_T = v_T + (v_img * bg[:, None, None, :]).sum(dim=-1)
                        rows_d, _, bmx, _, _ = compare_tiled_bwd(
                            torch, rt, std, D, T_d, last_d, v_img, v_T, C, W, H, ts, ts == 16)
                        rmx, _ = compare_reduce(torch, rb, rows_d, st[1], C * N, st[4].order)
                        log(f"tiled kernel vs plain grid1 ts={ts} D={D} with background ({M} entries): fwd max "
                            f"abs {mx:.3e} mean abs {mean:.3e} ({n_off} values > 1e-5), last equal at "
                            f"{same_last:.6f}; bwd{' (absgrad rows)' if ts == 16 else ''} max abs {bmx:.3e}; "
                            f"reduce ({rows_d.shape[0]} rows) max abs {rmx:.3e}")
                for mode in ("RGB", "RGB+ED"):
                    check_2dgs_tiled(torch, gen, splats, live, vm, K, W, H, ts, deg, mode)
        # a partial last tile row that P does not divide, as for the binned
        for ts in (8, 16):
            for mode in ("RGB", "RGB+ED"):
                check_2dgs_tiled(torch, gen, splats, live, vm, K, W, RAGGED_H, ts, 3, mode)

        # an empty stream (every radius 0): nothing launched, the background
        s = shade(rendering, torch, splats, torch.zeros_like(live), vm, K, W, H, 3)
        st = tiled_stream(torch, rt, isect_tiles, s, 16, W, H, cap)
        s2 = shade_2dgs(rendering, torch, splats, torch.zeros_like(live), vm, K, W, H, 3, "RGB+ED")
        st2 = tiled_stream_2dgs(torch, rt, r2, isect_tiles, s2, 16, W, H, cap)
        before = _backend.launch_counts()
        img, T_e, last_e = rt._tiled_fwd_cuda(st[0], 3, st[1], st[2], st[3], C, W, H, 16)
        rows = rt._tiled_bwd_cuda(st[0], 3, st[1], st[2], st[3], T_e, last_e, img, T_e, C, W, H, 16)
        o2 = r2t._tiled2_fwd_cuda(st2[0], 7, st2[1], st2[2], st2[3], C, W, H, 16)
        bg = torch.full((C, 3), 0.25, device=dev)
        r, a, meta = rendering.rasterization(*render_args(torch, splats), vm, K, W, H, sh_degree=3, masks=torch.zeros_like(live),
                                             backgrounds=bg, backend="tiled", isect_capacity=cap)
        if _backend.launch_counts() != before:
            raise AssertionError("an empty tiled stream launched a kernel")
        if st[1].shape[0] or st2[1].shape[0] or rows.shape[1] or int(meta["n_isects"]):
            raise AssertionError("the all-culled scene has a non-empty stream")
        if not (bool((r == 0.25).all()) and not a.any() and not img.any() and bool((T_e == 1).all())
                and not o2[0].any() and bool((o2[2] == -1).all())):
            raise AssertionError("an empty tiled stream gave other than the background")
        log("tiled empty stream (every radius 0): no kernel launched; rasterization(backend='tiled') "
            "gives the background, alpha 0")


def phase_serving(smi):
    import torch
    from gsplat_tpu_torch import _backend, rasterization, rendering, splats_from_numpy
    from gsplat_tpu_torch.ops import binning, rasterize_binned as rb
    from gsplat_tpu_torch.ops.projection import fully_fused_projection_soa

    dev = torch.device("cuda")
    deg = 3
    arrays, viewmats, Ks, W0, _ = splat_arrays(MAIN_GRID, deg, SEED)
    Ks = Ks.copy()
    Ks[:, :2, :] *= MAIN_W / W0
    W, H, ts = MAIN_W, MAIN_H, MAIN_TILE
    splats, live = splats_from_numpy(arrays, device=dev)
    N = splats["means"].shape[0]
    vms = [torch.as_tensor(viewmats[i : i + 1], device=dev) for i in range(len(viewmats))]
    Kss = [torch.as_tensor(Ks[i : i + 1], device=dev) for i in range(len(Ks))]

    def frame(i, capacity, tile=ts):
        return rasterization(
            *render_args(torch, splats), vms[i], Kss[i], W, H, sh_degree=deg,
            masks=live, tile_size=tile, backend="binned", isect_capacity=capacity,
        )

    with torch.no_grad():
        # capacity from a first call's slab_required, over all cameras
        capacity = max(frame(i, 512)[2]["slab_required"] for i in range(len(vms))) + 1024
        torch.cuda.synchronize()

        _backend.reset_launch_counts()
        frames, frames_dev = [], []
        for rep in range(2):
            for i in range(len(vms)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                img, alpha, meta = frame(i, capacity)
                end.record()
                torch.cuda.synchronize()
                frames.append((time.perf_counter() - t0) * 1e3)
                frames_dev.append(start.elapsed_time(end))
                if not (torch.isfinite(img).all() and torch.isfinite(alpha).all()):
                    raise AssertionError(f"camera {i}: non-finite output")
                if tuple(img.shape) != (1, H, W, 3) or tuple(alpha.shape) != (1, H, W, 1):
                    raise AssertionError(f"camera {i}: shapes {tuple(img.shape)} {tuple(alpha.shape)}")
                if meta["slab_required"] > capacity:
                    raise AssertionError(f"camera {i}: truncated ({meta['slab_required']} > {capacity})")
                if rep == 0:
                    log(f"frame cam {i}: n_isects {int(meta['n_isects'])}, slab_required "
                        f"{meta['slab_required']}, alpha mean {float(alpha.mean()):.4f}, "
                        f"image mean {float(img.mean()):.4f}, finite")
        launches = _backend.launch_counts()
        log(f"serving path: N={N}, {W}x{H}, ts={ts}, sh_degree={deg}, capacity {capacity}, "
            f"{len(frames)} frames, ms/frame host {', '.join(f'{t:.2f}' for t in frames)}; "
            f"CUDA events {', '.join(f'{t:.2f}' for t in frames_dev)}")
        log(f"launches in the serving path: {launches}")
        for name in ("emit", "emit_gather", "rasterize_fwd"):
            if launches[name] == 0:
                raise AssertionError(f"kernel {name} was not launched on the serving path")

        # stage times (CUDA events), camera 0, same inputs as the frames
        s = shade(rendering, torch, splats, live, vms[0], Kss[0], W, H, deg)
        plan, slab = emit_plan(binning, s, ts, W, H, capacity)
        T = (-(-W // ts)) * (-(-H // ts))
        ops = binning._emit_cuda(plan)
        bk = binning.sort_entries(ops, plan.packed, plan.nf, T, slab, binning.segment_starts(plan))
        gargs, _ = gather_args(torch, plan, bk)
        reps = 10
        args0 = render_args(torch, splats)
        stage = {
            "projection+SH": cuda_ms(torch, lambda: shade(rendering, torch, splats, live, vms[0], Kss[0], W, H, deg), reps),
            "of it: render transform (exp, sigmoid, cat)": cuda_ms(torch, lambda: render_args(torch, splats), reps),
            "of it: projection": cuda_ms(torch, lambda: fully_fused_projection_soa(*args0[:3], vms[0], Kss[0], W, H), reps),
            "emit (plan + kernel)": cuda_ms(torch, lambda: binning._emit_cuda(emit_plan(binning, s, ts, W, H, capacity)[0]), reps),
            "sort": cuda_ms(torch, lambda: binning.sort_entries(ops, plan.packed, plan.nf, T, slab), reps),
            "of it: gather": cuda_ms(torch, lambda: binning._gather_cuda(*gargs), reps),
            "forward kernel": cuda_ms(torch, lambda: rb._fwd_cuda(bk.entries, bk.offs, bk.cnts, 1, W, H, ts), reps),
            "frame": cuda_ms(torch, lambda: frame(0, capacity), reps),
        }
        log("stage ms (CUDA events, camera 0): " + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()))
        log_profile("frame (camera 0)", device_time_by_kernel(torch, lambda: frame(0, capacity)), stage["frame"])

        # the tile size, chosen on the card: frame time per tile size
        sweep = []
        for tile in (16, 32):
            cap = frame(0, 512, tile)[2]["slab_required"] + 1024
            sweep.append(f"ts={tile} {cuda_ms(torch, lambda: frame(0, cap, tile), 5):.3f}")
        log("tile-size sweep, frame ms (CUDA events, camera 0): " + ", ".join(sweep))

        # emit, gather and forward against their plain versions at these shapes
        _, emit_err = compare_emit(torch, binning, plan, slab, T)
        mx, mean, same_last, n_off, _, _ = compare_fwd(torch, rb, bk, 1, W, H, ts)
        log(f"serving shapes {W}x{H}: emit and gather kernels equal to plain (max abs {emit_err:.3e}); forward kernel "
            f"max abs {mx:.3e}, mean abs {mean:.3e} ({n_off} values > 1e-5), last equal at {same_last:.6f} of pixels")


def train_scene(torch, rasterization, dev, grid=MAIN_GRID, W=MAIN_W, H=MAIN_H):
    """Views and initial points for the training path: the fixture's own
    splats (garden ``scene_grid=grid``) rendered at W x H (1920x1080) from
    its 3 cameras are the targets; its means and colours are the initial
    points (as a COLMAP parser gives them), the scene scale the cameras'
    spread, as the JAX Parser sets it."""
    from gsplat_tpu_torch import load_test_data

    means, quats, scales, opac, colors, viewmats, Ks, W0, _ = load_test_data(scene_grid=grid)
    Ks = Ks.copy()
    Ks[:, :2, :] *= W / W0
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    gt = (t(means), t(quats), t(scales), t(opac), t(colors))
    views = []
    with torch.no_grad():
        for i in range(len(viewmats)):
            vm, K = t(viewmats[i : i + 1]), t(Ks[i : i + 1])
            cap = rasterization(*gt, vm, K, W, H, backend="binned", isect_capacity=512,
                                tile_size=MAIN_TILE)[2]["slab_required"] + 1024
            img, _, _ = rasterization(*gt, vm, K, W, H, backend="binned",
                                      isect_capacity=cap, tile_size=MAIN_TILE)
            views.append({"image": img[0].clamp(0.0, 1.0), "camtoworld": torch.linalg.inv(vm[0]),
                          "K": K[0], "image_id": i})
    camtoworlds = np.linalg.inv(viewmats)
    locs = camtoworlds[:, :3, 3]
    scene_scale = float(np.max(np.linalg.norm(locs - locs.mean(axis=0), axis=1)))
    rgb = np.clip(np.round(colors * 255.0), 0, 255).astype(np.uint8)
    return views, means, rgb, scene_scale


def phase_train(smi):
    import torch
    from gsplat_tpu_torch import _backend, rasterization, rendering
    from gsplat_tpu_torch.ops import binning, rasterize_binned as rb
    from gsplat_tpu_torch.simple_trainer import Config, Runner

    dev = torch.device("cuda")
    W, H, ts = MAIN_W, MAIN_H, MAIN_TILE
    t0 = time.perf_counter()
    views, points, rgb, scene_scale = train_scene(torch, rasterization, dev)
    cfg = Config(
        max_steps=TRAIN_STEPS, sh_degree=3, sh_degree_interval=1, refine_start_iter=3,
        refine_every=5, tile_size=ts, backend="binned", pool_headroom=1.5, seed=SEED,
    )
    t1 = time.perf_counter()
    runner = Runner(cfg, views, points, rgb, scene_scale, device=dev)
    runner.probe_isect_capacity()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    cap = runner.live.shape[0]
    log(f"training path: {points.shape[0]} points, pool {cap} slots, scene scale {scene_scale:.4f}, "
        f"isect capacity {runner.isect_capacity}; targets {t1 - t0:.1f} s, init (kNN, probe) {t2 - t1:.1f} s")

    _backend.reset_launch_counts()
    losses, step_ms, step_dev, refined_at = [], [], [], []
    for step in range(TRAIN_STEPS):
        before = _backend.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        out = runner.train_step(step)
        end.record()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - h0) * 1e3)
        step_dev.append(start.elapsed_time(end))
        loss = float(out["loss"])
        after = _backend.launch_counts()
        per_step = {k: after[k] - before[k] for k in after}
        if not np.isfinite(loss):
            raise AssertionError(f"step {step}: loss {loss}")
        missing = [k for k in ("emit", "emit_gather", "rasterize_fwd", "rasterize_bwd", "gid_reduce")
                   if per_step[k] == 0]
        if missing:
            raise AssertionError(f"step {step}: kernels {missing} were not launched")
        losses.append((out["image_ids"][0], loss))
        if out["refined"]:
            refined_at.append(step)
        log(f"step {step}: view {out['image_ids'][0]} loss {loss:.6f} live {int(runner.live.sum())}"
            f"{' (refined)' if out['refined'] else ''} slab_required {out['slab_required']}, "
            f"host {step_ms[-1]:.2f} ms, CUDA events {step_dev[-1]:.2f} ms; launches {per_step}")
    launches = _backend.launch_counts()
    log(f"launches in the training path ({TRAIN_STEPS} steps): {launches}")
    for name, p in runner.params.items():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"parameter {name} is not finite after training")
    view0 = [loss for v, loss in losses if v == 0]
    if len(view0) < 2 or not view0[-1] < view0[0]:
        raise AssertionError(f"view 0's loss did not fall: {view0}")
    log(f"all parameters finite; view 0 loss {view0[0]:.6f} -> {view0[-1]:.6f} over {len(view0)} visits")

    # bench.py's measure on the port: rasterization fwd+bwd, loss =
    # sum(render) + sum(alpha), grads w.r.t. the five inputs, grid5 1080p
    from gsplat_tpu_torch import load_test_data

    means, quats, scales, opac, colors, viewmats, Ks, W0, _ = load_test_data(scene_grid=MAIN_GRID)
    Ks = Ks.copy()
    Ks[:, :2, :] *= W / W0
    leaves = [torch.as_tensor(a, device=dev).requires_grad_(True) for a in (means, quats, scales, opac, colors)]
    vm, K = torch.as_tensor(viewmats[:1], device=dev), torch.as_tensor(Ks[:1], device=dev)
    with torch.no_grad():
        bcap = rasterization(*leaves, vm, K, W, H, backend="binned", isect_capacity=512,
                             tile_size=ts)[2]["slab_required"] + 1024

    def fwd_bwd():
        for x in leaves:
            x.grad = None
        r, a, _ = rasterization(*leaves, vm, K, W, H, backend="binned", isect_capacity=bcap, tile_size=ts)
        (r.sum() + a.sum()).backward()

    bench_ms = cuda_ms(torch, fwd_bwd, 5)
    log(f"bench.py measure on the port (garden grid5 {W}x{H}, ts={ts}, C=1, rasterization fwd+bwd): "
        f"{bench_ms:.3f} ms, {W * H / (bench_ms / 1e3):.4e} px/s")

    # one profiled train step; the train step at tile 16 and 32
    # (step indices 13, 14 and 16 refine nothing; sh_degree stays 3)
    step_time = cuda_ms(torch, lambda: runner.train_step(13), 3)
    log_profile("train step", device_time_by_kernel(torch, lambda: runner.train_step(14)), step_time)
    sweep = [f"ts=16 {step_time:.3f}"]
    runner.cfg.tile_size = 32
    runner.probe_isect_capacity()
    sweep.append(f"ts=32 {cuda_ms(torch, lambda: runner.train_step(16), 3):.3f}")
    runner.cfg.tile_size = ts
    runner.probe_isect_capacity()
    log("train step ms by tile size (CUDA events, after the 12 steps): " + ", ".join(sweep))

    steady = float(np.median([ms for s, ms in enumerate(step_dev) if s not in refined_at]))
    log(f"steady train step {steady:.3f} ms (median of the non-refining steps, CUDA events)")
    return kernel_table(runner, launches), (views, points, rgb, scene_scale), steady


def kernel_table(runner, launches):
    """Each kernel alone against its plain version at the train path's
    shapes (view 0, the trained splats). Returns the kernels' entries of
    the `kernels` line."""
    import torch
    from gsplat_tpu_torch import _backend, rendering
    from gsplat_tpu_torch.ops import binning, rasterize_binned as rb

    dev = torch.device("cuda")
    W, H, ts = MAIN_W, MAIN_H, MAIN_TILE
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    view = runner.trainset[0]
    vm = torch.linalg.inv(view["camtoworld"])[None]
    K = view["K"][None]
    reps = 10
    with torch.no_grad():
        s = shade(rendering, torch, runner.params, runner.live, vm, K, W, H, runner.cfg.sh_degree)
        plan, slab = emit_plan(binning, s, ts, W, H, runner.isect_capacity)
        T = (-(-W // ts)) * (-(-H // ts))
        emit_plain_ms = cuda_ms(torch, lambda: binning._emit_plain(plan), 2)
        bk, emit_err = compare_emit(torch, binning, plan, slab, T)
        bfields = binning_fields(torch, binning, plan, bk, reps, f"train shapes {W}x{H}")
        gargs, _ = gather_args(torch, plan, bk)
        gather_plain_ms = cuda_ms(torch, lambda: binning._gather_plain(*gargs), 2)
        fwd_ms = cuda_ms(torch, lambda: rb._fwd_cuda(bk.entries, bk.offs, bk.cnts, 1, W, H, ts), reps)
        fwd_plain_ms = cuda_ms(torch, lambda: rb._fwd_plain(bk.entries, bk.offs, bk.cnts, 1, W, H, ts), 1)
        fmx, fmean, same_last, n_off, fwd_pairs, (_, T_k, last_k) = compare_fwd(torch, rb, bk, 1, W, H, ts)
        D = bk.entries.shape[0] - 6
        v_img, v_T = cotangents(torch, gen, T_k, D)
        bargs = (bk.entries, bk.offs, bk.cnts, T_k, last_k, v_img, v_T, 1, W, H, ts, False)
        bwd_ms = cuda_ms(torch, lambda: rb._bwd_cuda(*bargs), reps)
        plain, bwd_plain_ms = timed_once(torch, lambda: rb._bwd_plain(*bargs))
        rows_k, _, bmx, berrs, (n_eval, n_acc) = compare_bwd(torch, rb, bk, T_k, last_k, v_img, v_T, 1, W, H, ts,
                                                             False, plain=plain)
        CN = plan.counts.shape[0]
        # the plain version is index_add_, also the one PyTorch call that
        # computes the same function: timed once, reported as both
        red_ms, red_plain_ms, red_bound, rmx = reduce_at(
            torch, rb, rows_k, bk.gids, CN, bk.order, reps, f"train shapes {W}x{H}")
    log(f"train shapes {W}x{H} (view 0, trained splats, {CN} slots): emit and gather equal (max abs {emit_err:.3e}); "
        f"fwd max abs {fmx:.3e} mean abs {fmean:.3e} ({n_off} > 1e-5), last equal at {same_last:.6f}; "
        f"bwd max abs per row " + " ".join(f"{e:.2e}" for e in berrs)
        + f"; reduce vs index_add_ max abs {rmx:.3e}")
    reduce_synthetic(torch, rb, int(bk.n_isects), CN, rows_k.shape[0], reps)

    # bounds: bytes each input read once and each output written once, over
    # HBM rate; operations this run's data needs over the f32 peak
    NF = plan.nf
    M = plan.n_emit
    n_isects = int(bk.n_isects)
    e_bytes, live_ids = emit_bytes(plan)
    pix = H * W
    fwd_bytes = n_isects * NF * 4 + 2 * T * 4 + pix * (4 * D + 4 + 4)
    # 18 per evaluated and 2D + 4 more per accepted pair (csrc/raster.cuh);
    # the backward accepts the forward's pairs, so its count is the forward's
    fwd_ops = 18 * fwd_pairs + (2 * D + 4) * n_acc
    fwd_bound = max(fwd_bytes / PEAK_BYTES_PER_S, fwd_ops / PEAK_F32_FLOPS) * 1e3
    R = rows_k.shape[0]
    # backward: stream, offsets, per-pixel T, last, v_img, v_T read once;
    # rows [R, M] written once. Flops as counted in csrc/raster.cuh (bwd_3dgs)
    bwd_bytes = n_isects * NF * 4 + 2 * T * 4 + pix * (4 + 4 + 4 * D + 4) + R * M * 4
    bwd_ops = 16 * n_eval + (28 + 3 * D) * n_acc
    bwd_bound_b, bwd_bound_o = bwd_bytes / PEAK_BYTES_PER_S * 1e3, bwd_ops / PEAK_F32_FLOPS * 1e3
    # reduce (reduce_at): the function needs the R rows and a 4-byte gid of
    # each of the n_isects slots read once and [R, CN] written once; the
    # stream order and the scratch are this design's own and not counted
    log(f"emit: {live_ids} of {CN} ids live, {M} entries, {e_bytes} bytes; forward: {n_isects} entries, "
        f"{fwd_pairs} evaluated pairs, {fwd_ops} flops, {fwd_bytes} bytes; backward: {n_eval} evaluated and "
        f"{n_acc} accepted pairs, {bwd_ops} flops, {bwd_bytes} bytes")
    sass = forward_sass_report(_backend, "rasterize_fwd", fwd3_sass_per_pair, fwd_ms, fwd_pairs, D, ts)
    kernels = [
        {
            "name": "emit", "route": "cuda", "source": "gsplat_tpu_torch/csrc/emit.cu",
            "replaces": "gsplat_tpu/ops/binning.py:74", "launches": launches["emit"],
            "max_abs_err": 0.0, "ms": bfields["emit"]["ms"], "plain_ms": emit_plain_ms,
            "bound_ms": bfields["emit"]["bound_ms"], "bound_by": "bytes", "library_ms": None,
        },
        {
            "name": "emit_gather", "route": "cuda", "source": "gsplat_tpu_torch/csrc/emit_gather.cu",
            "replaces": "gsplat_tpu/ops/binning.py:74", "launches": launches["emit_gather"],
            "max_abs_err": emit_err, "ms": bfields["emit_gather"]["ms"], "plain_ms": gather_plain_ms,
            "bound_ms": bfields["emit_gather"]["bound_ms"], "bound_by": "bytes",
            "library_ms": bfields["emit_gather"]["library_ms"],
        },
        {
            "name": "rasterize_fwd", "route": "cuda", "source": "gsplat_tpu_torch/csrc/rasterize_fwd.cu",
            "replaces": "gsplat_tpu/ops/rasterize_binned.py:61", "launches": launches["rasterize_fwd"],
            "max_abs_err": fmx, "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound,
            "bound_by": "operations" if fwd_ops / PEAK_F32_FLOPS >= fwd_bytes / PEAK_BYTES_PER_S else "bytes",
            "library_ms": None, "sass_per_pair": sass,
        },
        {
            "name": "rasterize_bwd", "route": "cuda", "source": "gsplat_tpu_torch/csrc/rasterize_bwd.cu",
            "replaces": "gsplat_tpu/ops/rasterize_binned.py:299", "launches": launches["rasterize_bwd"],
            "max_abs_err": bmx, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
            "bound_ms": max(bwd_bound_b, bwd_bound_o),
            "bound_by": "operations" if bwd_bound_o >= bwd_bound_b else "bytes", "library_ms": None,
        },
        {
            "name": "gid_reduce", "route": "cuda", "source": "gsplat_tpu_torch/csrc/gid_reduce.cu",
            "replaces": "gsplat_tpu/ops/rasterize_binned.py:571", "launches": launches["gid_reduce"],
            "max_abs_err": rmx, "ms": red_ms, "plain_ms": red_plain_ms, "bound_ms": red_bound,
            "bound_by": "bytes", "library_ms": red_plain_ms,
        },
    ]
    return kernels


def phase_serving_2dgs(trained):
    """2DGS serving: rasterization_2dgs(backend="binned", RGB+ED) under
    no_grad at the serving phase's shapes, on two scenes: the serving
    phase's splats as surfels (a few thousand frame-sized surfels next to
    the near plane saturate every pixel within a few entries: a long stream
    and little compositing) and the 2DGS training phase's surfels after its
    steps (`trained` = (params, live) of its Runner2DGS: each pixel
    composites many surfels). Launch counts over both scenes' frames; for
    each scene frame and stage times, the peak device memory of a frame,
    one profiled frame, the stream's size and the forward kernel against
    its plain version on a seeded subset of tiles. Returns emit's and the
    gather's fields on the fixture surfels, by kernel name."""
    import torch
    from gsplat_tpu_torch import _backend, rasterization_2dgs, rendering, splats_from_numpy
    from gsplat_tpu_torch.ops import binning, rasterize_2dgs_binned as r2
    from gsplat_tpu_torch.ops.projection_2dgs import fully_fused_projection_2dgs

    dev = torch.device("cuda")
    deg, mode = 3, "RGB+ED"
    arrays, viewmats, Ks, W0, _ = splat_arrays(MAIN_GRID, deg, SEED)
    Ks = Ks.copy()
    Ks[:, :2, :] *= MAIN_W / W0
    W, H, ts = MAIN_W, MAIN_H, MAIN_TILE
    T = (-(-W // ts)) * (-(-H // ts))
    scenes = {"fixture splats": splats_from_numpy(arrays, device=dev), "trained surfels": trained}
    vms = [torch.as_tensor(viewmats[i : i + 1], device=dev) for i in range(len(viewmats))]
    Kss = [torch.as_tensor(Ks[i : i + 1], device=dev) for i in range(len(Ks))]

    def frame(name, i, capacity):
        splats, live = scenes[name]
        return rasterization_2dgs(
            *render_args(torch, splats), vms[i], Kss[i], W, H, sh_degree=deg, masks=live,
            tile_size=ts, backend="binned", isect_capacity=capacity, render_mode=mode,
        )

    with torch.no_grad():
        caps = {name: max(frame(name, i, 512)[6]["slab_required"] for i in range(len(vms))) + 1024
                for name in scenes}
        torch.cuda.synchronize()
        _backend.reset_launch_counts()
        for name, capacity in caps.items():
            frames, frames_dev = [], []
            for i in range(len(vms)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                out = frame(name, i, capacity)
                end.record()
                torch.cuda.synchronize()
                frames.append((time.perf_counter() - t0) * 1e3)
                frames_dev.append(start.elapsed_time(end))
                img, alpha, nrm, nfd, dist, med, meta = out
                shapes = [tuple(x.shape) for x in (img, alpha, nrm, nfd, dist, med)]
                want = [(1, H, W, 4), (1, H, W, 1), (1, H, W, 3), (1, H, W, 3), (1, H, W, 1), (1, H, W, 1)]
                if shapes != want:
                    raise AssertionError(f"2DGS {name} camera {i}: shapes {shapes}")
                if not all(bool(torch.isfinite(x).all()) for x in (img, alpha, nrm, nfd, dist, med)):
                    raise AssertionError(f"2DGS {name} camera {i}: non-finite output")
                if meta["slab_required"] > capacity:
                    raise AssertionError(f"2DGS {name} camera {i}: truncated ({meta['slab_required']} > {capacity})")
                log(f"2DGS frame, {name}, cam {i}: n_isects {int(meta['n_isects'])}, slab_required "
                    f"{meta['slab_required']}, alpha mean {float(alpha.mean()):.4f}, image mean "
                    f"{float(img[..., :3].mean()):.4f}, median depth mean {float(med.mean()):.4f}, finite")
            log(f"2DGS serving path, {name}: N={int(scenes[name][1].sum())}, {W}x{H}, ts={ts}, "
                f"sh_degree={deg}, {mode}, capacity {capacity}, {len(frames)} frames, ms/frame host "
                f"{', '.join(f'{t:.2f}' for t in frames)}; CUDA events {', '.join(f'{t:.2f}' for t in frames_dev)}")
        launches = _backend.launch_counts()
        log(f"launches in the 2DGS serving path (both scenes): {launches}")
        extra = {k: v for k, v in launches.items() if (v > 0) != (k in ("emit", "emit_gather", "rasterize_2dgs_fwd"))}
        if extra:
            raise AssertionError(f"2DGS serving launched other than emit, the gather and the 2DGS forward: {extra}")

        fields = {}

        for name, capacity in caps.items():
            # stage times (CUDA events), camera 0, same inputs as the frames
            splats, live = scenes[name]
            s = shade_2dgs(rendering, torch, splats, live, vms[0], Kss[0], W, H, deg, mode)
            plan, slab = emit_plan_2dgs(binning, r2, s, ts, W, H, capacity)
            ops = binning._emit_cuda(plan)
            bk = binning.sort_entries(ops, plan.packed, plan.nf, T, slab, binning.segment_starts(plan))
            gargs, _ = gather_args(torch, plan, bk)
            reps = 5
            args0 = render_args(torch, splats)
            stage = {
                "projection+SH": cuda_ms(torch, lambda: shade_2dgs(rendering, torch, splats, live, vms[0], Kss[0],
                                                                   W, H, deg, mode), reps),
                "of it: projection": cuda_ms(torch, lambda: fully_fused_projection_2dgs(*args0[:3], vms[0], Kss[0],
                                                                                        W, H), reps),
                "emit (plan + kernel)": cuda_ms(torch, lambda: binning._emit_cuda(
                    emit_plan_2dgs(binning, r2, s, ts, W, H, capacity)[0]), reps),
                "of it: emit kernel": cuda_ms(torch, lambda: binning._emit_cuda(plan), reps),
                "sort": cuda_ms(torch, lambda: binning.sort_entries(ops, plan.packed, plan.nf, T, slab), reps),
                "of it: gather": cuda_ms(torch, lambda: binning._gather_cuda(*gargs), reps),
                "forward kernel": cuda_ms(torch, lambda: r2._fwd2_cuda(bk.entries, bk.offs, bk.cnts, 1, W, H, ts),
                                          reps),
                "frame": cuda_ms(torch, lambda: frame(name, 0, capacity), reps),
            }
            log(f"2DGS stage ms (CUDA events, {name}, camera 0): "
                + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()))
            log_profile(f"2DGS frame ({name}, camera 0)",
                        device_time_by_kernel(torch, lambda: frame(name, 0, capacity)), stage["frame"])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            frame(name, 0, capacity)
            torch.cuda.synchronize()
            log(f"2DGS frame ({name}, camera 0): peak device memory {torch.cuda.max_memory_allocated()} bytes "
                f"({torch.cuda.max_memory_allocated() - base} above the {base} held before the frame)")
            if name == "fixture splats":
                # emit and the gather alone on the fixture's near-plane surfels
                fields = {k: {f + "_fixture_surfels": v for f, v in kf.items()} for k, kf in binning_fields(
                    torch, binning, plan, bk, reps, f"2DGS serving, {name}, camera 0").items()}
            live_ids = int((plan.counts > 0).sum())
            NF = plan.nf
            # surfels whose rectangle spans at least half the frame, and the
            # share of the stream they own
            big = plan.counts >= T // 2
            log(f"2DGS stream, {name}, camera 0: {live_ids} live ids, {int(bk.n_isects)} entries ({plan.n_emit} "
                f"emitted), largest rectangle {int(plan.counts.max())} tiles of {T}, {NF} payload rows; emit writes "
                f"{plan.n_emit * (8 + 4)} bytes, the gather {plan.n_emit * (4 + 4 * NF)}; {int(big.sum())} ids "
                f"with rectangles of >= {T // 2} tiles "
                f"emit {int(plan.counts[big].sum())} entries, median depth "
                f"{float(plan.depth[big].median()) if bool(big.any()) else float('nan'):.4f}")
            sub = tile_subset(torch, bk, TILE_SUBSET, SEED)
            errs, med_off, same_last, pairs, _ = compare_fwd2(torch, r2, sub, 1, W, H, ts, f"2DGS serving, {name}")
            log(f"2DGS serving shapes, {name}, {TILE_SUBSET} seeded tiles ({int(sub.cnts.sum())} entries, "
                f"{int(pairs)} evaluated pairs, ~{int(pairs) / (TILE_SUBSET * ts * ts):.1f} a pixel): forward kernel "
                f"vs plain max abs " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f", median off at {med_off:.2e}, last equal at {same_last:.6f}")
    return fields


def phase_train_2dgs(scene):
    """2DGS training: Runner2DGS on the training phase's points and views,
    12 steps of one view with both geometry losses from step 0. Returns
    kernel_table_2dgs's (the reduce's, emit's and the gather's fields at
    these shapes, by kernel name; the 2DGS kernels' entries) and the
    runner."""
    import torch
    from gsplat_tpu_torch.simple_trainer_2dgs import Runner2DGS

    runner, launches = train_runner(
        torch, Runner2DGS, scene, "binned",
        ("emit", "emit_gather", "rasterize_2dgs_fwd", "rasterize_2dgs_bwd", "gid_reduce"),
        "2DGS", normal_start=0, dist_start=0,
    )
    return kernel_table_2dgs(runner, launches), runner


def kernel_table_2dgs(runner, launches):
    """The 2DGS kernels alone against their plain versions at the 2DGS
    train path's shapes (view 0, the trained splats): the whole frame (the
    plain versions timed once) and a seeded subset of tiles; the gid reduce
    and the emit and gather kernels at these shapes. Returns ({kernel name:
    its fields at these shapes} for the reduce's, emit's and the gather's
    entries of the `kernels` line, the 2DGS kernels' entries, the
    forward's with its SASS instructions per pair)."""
    import torch
    from gsplat_tpu_torch import _backend, rendering
    from gsplat_tpu_torch.ops import binning, rasterize_2dgs_binned as r2, rasterize_binned as rb

    dev = torch.device("cuda")
    W, H, ts = MAIN_W, MAIN_H, runner.cfg.tile_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    view = runner.trainset[0]
    vm = torch.linalg.inv(view["camtoworld"])[None]
    K = view["K"][None]
    reps = 5
    what = f"2DGS train shapes {W}x{H}"
    with torch.no_grad():
        s = shade_2dgs(rendering, torch, runner.params, runner.live, vm, K, W, H, runner.cfg.sh_degree, "RGB+ED")
        D = s.colors.shape[-1]
        L = D + 3
        plan, slab = emit_plan_2dgs(binning, r2, s, ts, W, H, runner.isect_capacity)
        T = (-(-W // ts)) * (-(-H // ts))
        # emit and the gather alone at these shapes (row 1 at the 2DGS payload)
        bk, _ = compare_emit(torch, binning, plan, slab, T)
        bfields = binning_fields(torch, binning, plan, bk, reps, what)
        fargs = (bk.entries, bk.offs, bk.cnts, 1, W, H, ts)
        fwd_ms = cuda_ms(torch, lambda: r2._fwd2_cuda(*fargs), reps)
        plain_f, fwd_plain_ms = timed_once(torch, lambda: r2._fwd2_plain(*fargs))
        ferrs, med_off, same_last, fwd_pairs, ko = compare_fwd2(torch, r2, bk, 1, W, H, ts, what, plain=plain_f)
        del plain_f
        cot = cotangents_2dgs(torch, gen, ko[1], L)
        bargs = (bk.entries, bk.offs, bk.cnts, ko[1], ko[2], ko[0][..., D - 1].contiguous(), *cot, 1, W, H, ts)
        bwd_ms = cuda_ms(torch, lambda: r2._bwd2_cuda(*bargs), reps)
        plain_b, bwd_plain_ms = timed_once(torch, lambda: r2._bwd2_plain(*bargs))
        rows_k, bmx, berrs, (n_eval, n_acc), n_past = compare_bwd2(torch, r2, bk, ko, cot, D, 1, W, H, ts, what,
                                                                    plain=plain_b)
        del plain_b
        # both kernels also on a seeded subset of tiles, the other tiles'
        # counts zeroed for both
        sub = tile_subset(torch, bk, TILE_SUBSET, SEED + 1)
        serrs, _, _, _, ko_s = compare_fwd2(torch, r2, sub, 1, W, H, ts, what + " tile subset")
        _, sbmx, _, _, s_past = compare_bwd2(torch, r2, sub, ko_s, cot, D, 1, W, H, ts, what + " tile subset")
        # the gid reduce at these shapes: the [12 + L, M] slot rows summed
        # per Gaussian, as kernel_table times it at the 3DGS shapes
        CN = plan.counts.shape[0]
        red_ms, red_plain_ms, red_bound, rmx = reduce_at(torch, rb, rows_k, bk.gids, CN, bk.order, reps, what)
    log(f"{what} (view 0, trained splats, {int(bk.n_isects)} entries): 2DGS forward vs plain max abs "
        + ", ".join(f"{k} {v:.3e}" for k, v in ferrs.items())
        + f", median off at {med_off:.2e}, last equal at {same_last:.6f}; backward max abs per row "
        + " ".join(f"{e:.2e}" for e in berrs)
        + f"; on {TILE_SUBSET} seeded tiles: forward max abs {max(serrs.values()):.3e}, backward {sbmx:.3e}")
    log(f"  {what}: bwd values past the per-slot tolerance {n_past} of {rows_k.numel()} (on the seeded "
        f"tiles {s_past}); forward last equal at {same_last:.6f} of pixels")

    NF = bk.entries.shape[0]
    n_isects = int(bk.n_isects)
    pix = H * W
    # counted from csrc/raster.cuh (fwd_2dgs, bwd_2dgs), a division and an expf
    # one operation each: the forward 41 per evaluated pair (sigma, alpha,
    # tests) and 2L + 13 per accepted one; the backward 41 per pair at or
    # before the pixel's `last` and 5L + 87 per accepted one (the chain, the
    # cross-product VJP, one add into the slot's sum per row)
    fwd_ops = 41 * fwd_pairs + (2 * L + 13) * n_acc
    fwd_bytes = n_isects * NF * 4 + 2 * T * 4 + pix * 4 * (L + 4)
    bwd_ops = 41 * n_eval + (5 * L + 87) * n_acc
    bwd_bytes = n_isects * NF * 4 + 2 * T * 4 + pix * 4 * (L + 5) + (r2.NFIX + L) * rows_k.shape[1] * 4
    fb = (fwd_bytes / PEAK_BYTES_PER_S * 1e3, fwd_ops / PEAK_F32_FLOPS * 1e3)
    bb = (bwd_bytes / PEAK_BYTES_PER_S * 1e3, bwd_ops / PEAK_F32_FLOPS * 1e3)
    log(f"2DGS forward: {fwd_pairs} evaluated and {n_acc} accepted pairs, {fwd_ops} operations, {fwd_bytes} bytes; "
        f"backward: {n_eval} evaluated pairs, {bwd_ops} operations, {bwd_bytes} bytes; kernel ms fwd {fwd_ms:.3f} "
        f"bwd {bwd_ms:.3f}, plain ms fwd {fwd_plain_ms:.1f} bwd {bwd_plain_ms:.1f}")
    sass = forward_sass_report(_backend, "rasterize_2dgs_fwd", fwd2_sass_per_pair, fwd_ms, fwd_pairs, L, ts)
    shared = {
        "gid_reduce": {"ms_2dgs": red_ms, "plain_ms_2dgs": red_plain_ms, "bound_ms_2dgs": red_bound,
                       "library_ms_2dgs": red_plain_ms, "max_abs_err_2dgs": rmx},
        **{k: {f + "_2dgs": v for f, v in fields.items()} for k, fields in bfields.items()},
    }
    return shared, [
        {
            "name": "rasterize_2dgs_fwd", "route": "cuda", "source": "gsplat_tpu_torch/csrc/rasterize_2dgs_fwd.cu",
            "replaces": "gsplat_tpu/ops/rasterize_2dgs_binned.py:107", "launches": launches["rasterize_2dgs_fwd"],
            "max_abs_err": max(ferrs.values()), "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": max(fb),
            "bound_by": "operations" if fb[1] >= fb[0] else "bytes", "library_ms": None, "sass_per_pair": sass,
        },
        {
            "name": "rasterize_2dgs_bwd", "route": "cuda", "source": "gsplat_tpu_torch/csrc/rasterize_2dgs_bwd.cu",
            "replaces": "gsplat_tpu/ops/rasterize_2dgs_binned.py:292", "launches": launches["rasterize_2dgs_bwd"],
            "max_abs_err": bmx, "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": max(bb),
            "bound_by": "operations" if bb[1] >= bb[0] else "bytes", "library_ms": None,
        },
    ]


def phase_serving_tiled():
    """Tiled serving: what a caller that passes no isect_capacity gets.
    rasterization(backend="auto") at the serving phase's shapes resolves
    to the tiled backend (C N W H far above the oracle's limit); 3 frames
    (one per camera) under no_grad, launch counts, the stream's length
    beside the binned stream's, stage and frame times, one profiled frame,
    and the forward kernel against its plain version on seeded tiles."""
    import torch
    from gsplat_tpu_torch import _backend, rasterization, rendering, splats_from_numpy
    from gsplat_tpu_torch.ops import rasterize_tiled as rt
    from gsplat_tpu_torch.ops.isect import isect_tiles

    dev = torch.device("cuda")
    deg = 3
    arrays, viewmats, Ks, W0, _ = splat_arrays(MAIN_GRID, deg, SEED)
    Ks = Ks.copy()
    Ks[:, :2, :] *= MAIN_W / W0
    W, H, ts = MAIN_W, MAIN_H, MAIN_TILE
    splats, live = splats_from_numpy(arrays, device=dev)
    N = splats["means"].shape[0]
    vms = [torch.as_tensor(viewmats[i : i + 1], device=dev) for i in range(len(viewmats))]
    Kss = [torch.as_tensor(Ks[i : i + 1], device=dev) for i in range(len(Ks))]

    def frame(i):
        return rasterization(*render_args(torch, splats), vms[i], Kss[i], W, H, sh_degree=deg, masks=live,
                             tile_size=ts)

    with torch.no_grad():
        _backend.reset_launch_counts()
        frames, frames_dev, n_tiled = [], [], []
        for i in range(len(vms)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            img, alpha, meta = frame(i)
            end.record()
            torch.cuda.synchronize()
            frames.append((time.perf_counter() - t0) * 1e3)
            frames_dev.append(start.elapsed_time(end))
            if "slab_required" in meta or "n_isects" not in meta:
                raise AssertionError(f"camera {i}: backend='auto' did not resolve to tiled (meta {sorted(meta)})")
            if meta["isect_capacity"] != max(1 << 20, 16 * N) or int(meta["n_isects"]) > meta["isect_capacity"]:
                raise AssertionError(f"camera {i}: capacity {meta['isect_capacity']}, n_isects {int(meta['n_isects'])}")
            if not (torch.isfinite(img).all() and torch.isfinite(alpha).all()):
                raise AssertionError(f"tiled camera {i}: non-finite output")
            if tuple(img.shape) != (1, H, W, 3) or tuple(alpha.shape) != (1, H, W, 1):
                raise AssertionError(f"tiled camera {i}: shapes {tuple(img.shape)} {tuple(alpha.shape)}")
            n_tiled.append(int(meta["n_isects"]))
        launches = _backend.launch_counts()
        log(f"launches in the tiled serving path (backend='auto', no capacity): {launches}")
        extra = {k: v for k, v in launches.items() if (v > 0) != (k == "rasterize_tiled_fwd")}
        if extra or launches["rasterize_tiled_fwd"] != len(vms):
            raise AssertionError(f"tiled serving launched other than one tiled forward a frame: {launches}")
        # the binned stream at the same cameras, for its length
        n_binned = []
        for i in range(len(vms)):
            cap = rasterization(*render_args(torch, splats), vms[i], Kss[i], W, H, sh_degree=deg, masks=live,
                                tile_size=ts, backend="binned", isect_capacity=512)[2]["slab_required"] + 1024
            n_binned.append(int(rasterization(*render_args(torch, splats), vms[i], Kss[i], W, H, sh_degree=deg,
                                              masks=live, tile_size=ts, backend="binned",
                                              isect_capacity=cap)[2]["n_isects"]))
        log(f"tiled serving path: N={N}, {W}x{H}, ts={ts}, sh_degree={deg}, capacity {meta['isect_capacity']}, "
            f"{len(frames)} frames, ms/frame host {', '.join(f'{t:.2f}' for t in frames)}; CUDA events "
            f"{', '.join(f'{t:.2f}' for t in frames_dev)}; stream entries tiled {n_tiled}, binned (culled) "
            f"{n_binned}")

        s = shade(rendering, torch, splats, live, vms[0], Kss[0], W, H, deg)
        cap = meta["isect_capacity"]
        st = tiled_stream(torch, rt, isect_tiles, s, ts, W, H, cap)
        reps = 10
        stage = {
            "projection+SH": cuda_ms(torch, lambda: shade(rendering, torch, splats, live, vms[0], Kss[0], W, H, deg),
                                     reps),
            "isect": cuda_ms(torch, lambda: isect_tiles((s.mean_x, s.mean_y), s.radii, s.depths, ts,
                                                        -(-W // ts), -(-H // ts), cap), reps),
            "pack": cuda_ms(torch, lambda: rt.pack_rows([s.mean_x, s.mean_y, *s.conics, s.opacities,
                                                         *s.colors.unbind(-1)]), reps),
            "forward kernel": cuda_ms(torch, lambda: rt._tiled_fwd_cuda(st[0], 3, st[1], st[2], st[3], 1, W, H, ts),
                                      reps),
            "frame": cuda_ms(torch, lambda: frame(0), reps),
        }
        log("tiled stage ms (CUDA events, camera 0): " + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()))
        log_profile("tiled frame (camera 0)", device_time_by_kernel(torch, lambda: frame(0)), stage["frame"])
        sub = (*st[:3], subset_counts(torch, st[3], TILE_SUBSET, SEED))
        mx, mean, same_last, n_off, pairs, _ = compare_tiled_fwd(torch, rt, sub, 3, 1, W, H, ts)
        log(f"tiled serving shapes, {TILE_SUBSET} seeded tiles ({int(sub[3].sum())} entries, {pairs} evaluated "
            f"pairs): forward kernel max abs {mx:.3e}, mean abs {mean:.3e} ({n_off} values > 1e-5), last equal "
            f"at {same_last:.6f} of pixels")


def phase_serving_tiled_2dgs(trained):
    """Tiled 2DGS serving: rasterization_2dgs(backend="tiled", RGB+ED) under
    no_grad on the 2DGS training phase's surfels (`trained` = (params,
    live)), 3 frames, with the tiled serving phase's prints and checks."""
    import torch
    from gsplat_tpu_torch import _backend, rasterization_2dgs, rendering
    from gsplat_tpu_torch.ops import rasterize_2dgs_binned as r2, rasterize_2dgs_tiled as r2t
    from gsplat_tpu_torch.ops import rasterize_tiled as rt
    from gsplat_tpu_torch.ops.isect import isect_tiles, suggest_capacity

    dev = torch.device("cuda")
    deg, mode = 3, "RGB+ED"
    _, viewmats, Ks, W0, _ = splat_arrays(MAIN_GRID, deg, SEED)
    Ks = Ks.copy()
    Ks[:, :2, :] *= MAIN_W / W0
    W, H, ts = MAIN_W, MAIN_H, MAIN_TILE
    splats, live = trained
    vms = [torch.as_tensor(viewmats[i : i + 1], device=dev) for i in range(len(viewmats))]
    Kss = [torch.as_tensor(Ks[i : i + 1], device=dev) for i in range(len(Ks))]

    def frame(i, capacity, backend="tiled"):
        return rasterization_2dgs(*render_args(torch, splats), vms[i], Kss[i], W, H, sh_degree=deg, masks=live,
                                  tile_size=ts, backend=backend, isect_capacity=capacity, render_mode=mode)

    with torch.no_grad():
        capacity = suggest_capacity(max(int(frame(i, 4096)[6]["n_isects"]) for i in range(len(vms))))
        torch.cuda.synchronize()
        _backend.reset_launch_counts()
        frames, frames_dev, n_tiled = [], [], []
        for i in range(len(vms)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = frame(i, capacity)
            end.record()
            torch.cuda.synchronize()
            frames.append((time.perf_counter() - t0) * 1e3)
            frames_dev.append(start.elapsed_time(end))
            img, alpha, nrm, nfd, dist, med, meta = out
            shapes = [tuple(x.shape) for x in (img, alpha, nrm, nfd, dist, med)]
            want = [(1, H, W, 4), (1, H, W, 1), (1, H, W, 3), (1, H, W, 3), (1, H, W, 1), (1, H, W, 1)]
            if shapes != want or "slab_required" in meta or int(meta["n_isects"]) > capacity:
                raise AssertionError(f"tiled 2DGS camera {i}: shapes {shapes}, meta {sorted(meta)}")
            if not all(bool(torch.isfinite(x).all()) for x in (img, alpha, nrm, nfd, dist, med)):
                raise AssertionError(f"tiled 2DGS camera {i}: non-finite output")
            n_tiled.append(int(meta["n_isects"]))
        launches = _backend.launch_counts()
        log(f"launches in the tiled 2DGS serving path: {launches}")
        extra = {k: v for k, v in launches.items() if (v > 0) != (k == "rasterize_2dgs_tiled_fwd")}
        if extra or launches["rasterize_2dgs_tiled_fwd"] != len(vms):
            raise AssertionError(f"tiled 2DGS serving launched other than one tiled 2DGS forward a frame: {launches}")
        n_binned = [int(frame(i, capacity, "binned")[6]["n_isects"]) for i in range(len(vms))]
        log(f"tiled 2DGS serving path, trained surfels: N={int(live.sum())}, {W}x{H}, ts={ts}, sh_degree={deg}, "
            f"{mode}, capacity {capacity}, {len(frames)} frames, ms/frame host {', '.join(f'{t:.2f}' for t in frames)}; "
            f"CUDA events {', '.join(f'{t:.2f}' for t in frames_dev)}; stream entries tiled {n_tiled}, binned "
            f"{n_binned}")

        s = shade_2dgs(rendering, torch, splats, live, vms[0], Kss[0], W, H, deg, mode)
        st = tiled_stream_2dgs(torch, rt, r2, isect_tiles, s, ts, W, H, capacity)
        mx, my = s.means2d[..., 0], s.means2d[..., 1]
        Ms = s.ray_transforms.reshape(s.ray_transforms.shape[:2] + (9,))
        reps = 5
        stage = {
            "projection+SH": cuda_ms(torch, lambda: shade_2dgs(rendering, torch, splats, live, vms[0], Kss[0], W, H,
                                                               deg, mode), reps),
            "isect": cuda_ms(torch, lambda: isect_tiles((mx, my), s.radii, s.depths, ts, -(-W // ts), -(-H // ts),
                                                        capacity), reps),
            "pack": cuda_ms(torch, lambda: rt.pack_rows(r2.surfel_payload(mx, my, Ms, s.opacities, s.colors,
                                                                          s.normals)), reps),
            "forward kernel": cuda_ms(torch, lambda: r2t._tiled2_fwd_cuda(st[0], 7, st[1], st[2], st[3], 1, W, H, ts),
                                      reps),
            "frame": cuda_ms(torch, lambda: frame(0, capacity), reps),
        }
        log("tiled 2DGS stage ms (CUDA events, trained surfels, camera 0): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()))
        log_profile("tiled 2DGS frame (trained surfels, camera 0)", device_time_by_kernel(torch, lambda: frame(0, capacity)),
                    stage["frame"])
        sub = (*st[:3], subset_counts(torch, st[3], TILE_SUBSET, SEED))
        errs, med_off, same_last, pairs, _ = compare_tiled_fwd2(torch, r2t, sub, 7, 1, W, H, ts, "tiled 2DGS serving")
        log(f"tiled 2DGS serving shapes, {TILE_SUBSET} seeded tiles ({int(sub[3].sum())} entries, {int(pairs)} "
            f"evaluated pairs, ~{int(pairs) / (TILE_SUBSET * ts * ts):.1f} a pixel): forward kernel vs plain max abs "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f", median off at {med_off:.2e}, last equal at "
            f"{same_last:.6f}")


def train_runner(torch, runner_cls, scene, backend, kernels, what, **kw):
    """TRAIN_STEPS steps of `runner_cls` on `backend` on the training
    phase's scene, each launching `kernels` and no other kernel; finite
    parameters, view 0's loss falling, the steady step time and one
    profiled step. Returns (runner, launch counts)."""
    from gsplat_tpu_torch import _backend
    from gsplat_tpu_torch.simple_trainer import Config

    views, points, rgb, scene_scale = scene
    cfg = Config(
        max_steps=TRAIN_STEPS, sh_degree=3, sh_degree_interval=1, refine_start_iter=3,
        refine_every=5, tile_size=MAIN_TILE, backend=backend, pool_headroom=1.5, seed=SEED,
    )
    t1 = time.perf_counter()
    runner = runner_cls(cfg, views, points, rgb, scene_scale, device=torch.device("cuda"), **kw)
    runner.probe_isect_capacity()
    torch.cuda.synchronize()
    log(f"{what} training path: {points.shape[0]} points, pool {runner.live.shape[0]} slots, isect capacity "
        f"{runner.isect_capacity} (from the probe); init {time.perf_counter() - t1:.1f} s")
    _backend.reset_launch_counts()
    losses = []
    for step in range(TRAIN_STEPS):
        before = _backend.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        out = runner.train_step(step)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3
        loss = float(out["loss"])
        after = _backend.launch_counts()
        per_step = {k: after[k] - before[k] for k in after}
        if not np.isfinite(loss):
            raise AssertionError(f"{what} step {step}: loss {loss}")
        missing = [k for k in kernels if per_step[k] == 0]
        other = [k for k, v in per_step.items() if v and k not in kernels]
        if missing or other:
            raise AssertionError(f"{what} step {step}: kernels {missing} not launched, {other} launched")
        losses.append((out["image_ids"][0], loss))
        log(f"{what} step {step}: view {out['image_ids'][0]} loss {loss:.6f} live {int(runner.live.sum())}"
            f"{' (refined)' if out['refined'] else ''} capacity needed {out['slab_required']}, "
            f"host {host_ms:.2f} ms, CUDA events {start.elapsed_time(end):.2f} ms; launches {per_step}")
    launches = _backend.launch_counts()
    log(f"launches in the {what} training path ({TRAIN_STEPS} steps): {launches}")
    for name, p in runner.params.items():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{what}: parameter {name} is not finite after training")
    view0 = [loss for v, loss in losses if v == 0]
    if len(view0) < 2 or not view0[-1] < view0[0]:
        raise AssertionError(f"{what}: view 0's loss did not fall: {view0}")
    log(f"{what}: all parameters finite; view 0 loss {view0[0]:.6f} -> {view0[-1]:.6f} over {len(view0)} visits")
    step_time = cuda_ms(torch, lambda: runner.train_step(13), 3)
    log_profile(f"{what} train step", device_time_by_kernel(torch, lambda: runner.train_step(14)), step_time)
    log(f"{what} train step ms (CUDA events, after the {TRAIN_STEPS} steps): {step_time:.3f}")
    return runner, launches


def unique_row_bytes(torch, ids, nf):
    """Bytes of the distinct packed rows a stream names, nf floats each: what
    a gathering kernel needs to read once."""
    return int(torch.unique(ids).numel()) * nf * 4 if ids.numel() else 0


def phase_train_tiled(scene):
    """Tiled 3DGS training (Runner, backend="tiled", on the training phase's
    scene) and its two kernels alone against their plain versions at the
    train shapes. Returns their entries of the `kernels` line."""
    import torch
    from gsplat_tpu_torch import _backend, rendering
    from gsplat_tpu_torch.ops import rasterize_binned as rb, rasterize_tiled as rt
    from gsplat_tpu_torch.ops.isect import isect_tiles
    from gsplat_tpu_torch.simple_trainer import Runner

    runner, launches = train_runner(
        torch, Runner, scene, "tiled", ("rasterize_tiled_fwd", "rasterize_tiled_bwd", "gid_reduce"), "tiled")
    dev = torch.device("cuda")
    W, H, ts = MAIN_W, MAIN_H, MAIN_TILE
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    view = runner.trainset[0]
    vm = torch.linalg.inv(view["camtoworld"])[None]
    K = view["K"][None]
    reps = 10
    with torch.no_grad():
        s = shade(rendering, torch, runner.params, runner.live, vm, K, W, H, runner.cfg.sh_degree)
        st = tiled_stream(torch, rt, isect_tiles, s, ts, W, H, runner.isect_capacity)
        D = 3
        fargs = (st[0], D, st[1], st[2], st[3], 1, W, H, ts)
        fwd_ms = cuda_ms(torch, lambda: rt._tiled_fwd_cuda(*fargs), reps)
        plain_f, fwd_plain_ms = timed_once(torch, lambda: rt._tiled_fwd_plain(*fargs))
        fmx, fmean, same_last, n_off, fwd_pairs, (_, T_k, last_k) = compare_tiled_fwd(
            torch, rt, st, D, 1, W, H, ts, plain=plain_f)
        v_img, v_T = cotangents(torch, gen, T_k, D)
        bargs = (st[0], D, st[1], st[2], st[3], T_k, last_k, v_img, v_T, 1, W, H, ts, False)
        bwd_ms = cuda_ms(torch, lambda: rt._tiled_bwd_cuda(*bargs), reps)
        plain_b, bwd_plain_ms = timed_once(torch, lambda: rt._tiled_bwd_plain(*bargs))
        rows_k, _, bmx, berrs, (n_eval, n_acc) = compare_tiled_bwd(
            torch, rt, st, D, T_k, last_k, v_img, v_T, 1, W, H, ts, False, plain=plain_b)
        reduce_at(torch, rb, rows_k, st[1], s.mean_x.numel(), st[4].order, reps, f"tiled train shapes {W}x{H}")
    M = st[1].shape[0]
    T = (-(-W // ts)) * (-(-H // ts))
    pix = W * H
    nf = 6 + D
    rows_b = unique_row_bytes(torch, st[1], nf)
    # forward: the ids and the distinct rows they name read once, the
    # offsets, the image, T and last written once; 18 per evaluated and
    # 2D + 4 more per accepted pair (csrc/raster.cuh), the backward's count
    fwd_bytes = M * 4 + rows_b + 2 * T * 4 + pix * (4 * D + 4 + 4)
    fwd_ops = 18 * fwd_pairs + (2 * D + 4) * n_acc
    fb = (fwd_bytes / PEAK_BYTES_PER_S * 1e3, fwd_ops / PEAK_F32_FLOPS * 1e3)
    # backward: the same reads plus T, last, v_img and v_T; the slot rows
    # written once; 16 per evaluated and 28 + 3D per accepted pair
    bwd_bytes = M * 4 + rows_b + 2 * T * 4 + pix * (4 + 4 + 4 * D + 4) + nf * M * 4
    bwd_ops = 16 * n_eval + (28 + 3 * D) * n_acc
    bb = (bwd_bytes / PEAK_BYTES_PER_S * 1e3, bwd_ops / PEAK_F32_FLOPS * 1e3)
    log(f"tiled train shapes {W}x{H} (view 0, trained splats, {M} entries, {int(torch.unique(st[1]).numel())} "
        f"distinct rows): fwd max abs {fmx:.3e} mean abs {fmean:.3e} ({n_off} > 1e-5), last equal at "
        f"{same_last:.6f}; bwd max abs per row " + " ".join(f"{e:.2e}" for e in berrs))
    log(f"tiled forward: {fwd_pairs} evaluated pairs, {fwd_ops} flops, {fwd_bytes} bytes; backward: {n_eval} "
        f"evaluated and {n_acc} accepted pairs, {bwd_ops} flops, {bwd_bytes} bytes; kernel ms fwd {fwd_ms:.3f} "
        f"bwd {bwd_ms:.3f}, plain ms fwd {fwd_plain_ms:.1f} bwd {bwd_plain_ms:.1f}")
    sass = forward_sass_report(_backend, "rasterize_tiled_fwd", fwd3_sass_per_pair, fwd_ms, fwd_pairs, D, ts)
    return [
        {
            "name": "rasterize_tiled_fwd", "route": "cuda", "source": "gsplat_tpu_torch/csrc/rasterize_tiled_fwd.cu",
            "replaces": "gsplat_tpu/ops/rasterize_tiled.py:127", "launches": launches["rasterize_tiled_fwd"],
            "max_abs_err": fmx, "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": max(fb),
            "bound_by": "operations" if fb[1] >= fb[0] else "bytes", "library_ms": None, "sass_per_pair": sass,
        },
        {
            "name": "rasterize_tiled_bwd", "route": "cuda", "source": "gsplat_tpu_torch/csrc/rasterize_tiled_bwd.cu",
            "replaces": "gsplat_tpu/ops/rasterize_tiled.py:238", "launches": launches["rasterize_tiled_bwd"],
            "max_abs_err": bmx, "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": max(bb),
            "bound_by": "operations" if bb[1] >= bb[0] else "bytes", "library_ms": None,
        },
    ]


def phase_train_tiled_2dgs(scene):
    """Tiled 2DGS training (Runner2DGS, backend="tiled", both geometry
    losses from step 0) and its two kernels alone against their plain
    versions at the train shapes: the whole frame and seeded tiles. Returns
    their entries of the `kernels` line."""
    import torch
    from gsplat_tpu_torch import _backend, rendering
    from gsplat_tpu_torch.ops import rasterize_2dgs_binned as r2, rasterize_2dgs_tiled as r2t
    from gsplat_tpu_torch.ops import rasterize_binned as rb, rasterize_tiled as rt
    from gsplat_tpu_torch.ops.isect import isect_tiles
    from gsplat_tpu_torch.simple_trainer_2dgs import Runner2DGS

    runner, launches = train_runner(
        torch, Runner2DGS, scene, "tiled", ("rasterize_2dgs_tiled_fwd", "rasterize_2dgs_tiled_bwd", "gid_reduce"),
        "tiled 2DGS", normal_start=0, dist_start=0,
    )
    dev = torch.device("cuda")
    W, H, ts = MAIN_W, MAIN_H, MAIN_TILE
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    view = runner.trainset[0]
    vm = torch.linalg.inv(view["camtoworld"])[None]
    K = view["K"][None]
    reps = 5
    what = f"tiled 2DGS train shapes {W}x{H}"
    with torch.no_grad():
        s = shade_2dgs(rendering, torch, runner.params, runner.live, vm, K, W, H, runner.cfg.sh_degree, "RGB+ED")
        D = s.colors.shape[-1]
        L = D + 3
        st = tiled_stream_2dgs(torch, rt, r2, isect_tiles, s, ts, W, H, runner.isect_capacity)
        fargs = (st[0], L, st[1], st[2], st[3], 1, W, H, ts)
        fwd_ms = cuda_ms(torch, lambda: r2t._tiled2_fwd_cuda(*fargs), reps)
        plain_f, fwd_plain_ms = timed_once(torch, lambda: r2t._tiled2_fwd_plain(*fargs))
        ferrs, med_off, same_last, fwd_pairs, ko = compare_tiled_fwd2(torch, r2t, st, L, 1, W, H, ts, what,
                                                                      plain=plain_f)
        del plain_f
        cot = cotangents_2dgs(torch, gen, ko[1], L)
        bargs = (st[0], L, st[1], st[2], st[3], ko[1], ko[2], ko[0][..., D - 1].contiguous(), *cot, 1, W, H, ts)
        bwd_ms = cuda_ms(torch, lambda: r2t._tiled2_bwd_cuda(*bargs), reps)
        plain_b, bwd_plain_ms = timed_once(torch, lambda: r2t._tiled2_bwd_plain(*bargs))
        rows_k, bmx, berrs, (n_eval, n_acc), n_past = compare_tiled_bwd2(
            torch, r2t, st, ko, cot, D, 1, W, H, ts, what, plain=plain_b)
        del plain_b
        sub = (*st[:3], subset_counts(torch, st[3], TILE_SUBSET, SEED + 1))
        serrs, _, _, _, ko_s = compare_tiled_fwd2(torch, r2t, sub, L, 1, W, H, ts, what + " tile subset")
        _, sbmx, _, _, s_past = compare_tiled_bwd2(torch, r2t, sub, ko_s, cot, D, 1, W, H, ts,
                                                   what + " tile subset")
        reduce_at(torch, rb, rows_k, st[1], s.opacities.numel(), st[4].order, reps, what)
    M = st[1].shape[0]
    T = (-(-W // ts)) * (-(-H // ts))
    pix = W * H
    nf = r2.NFIX + L
    rows_b = unique_row_bytes(torch, st[1], nf)
    log(f"{what} (view 0, trained surfels, {M} entries): forward vs plain max abs "
        + ", ".join(f"{k} {v:.3e}" for k, v in ferrs.items())
        + f", median off at {med_off:.2e}, last equal at {same_last:.6f}; backward max abs per row "
        + " ".join(f"{e:.2e}" for e in berrs)
        + f"; on {TILE_SUBSET} seeded tiles: forward max abs {max(serrs.values()):.3e}, backward {sbmx:.3e}")
    log(f"  {what}: bwd values past the per-slot tolerance {n_past} of {rows_k.numel()} (on the seeded "
        f"tiles {s_past}); forward last equal at {same_last:.6f} of pixels")
    # counted from csrc/raster.cuh, the binned 2DGS pair's kernels: 41 per
    # evaluated pair and 2L + 13 per accepted one forward; 41 per pair at
    # or before `last` and 5L + 87 per accepted one backward
    fwd_ops = 41 * fwd_pairs + (2 * L + 13) * n_acc
    fwd_bytes = M * 4 + rows_b + 2 * T * 4 + pix * 4 * (L + 4)
    bwd_ops = 41 * n_eval + (5 * L + 87) * n_acc
    bwd_bytes = M * 4 + rows_b + 2 * T * 4 + pix * 4 * (L + 5) + nf * M * 4
    fb = (fwd_bytes / PEAK_BYTES_PER_S * 1e3, fwd_ops / PEAK_F32_FLOPS * 1e3)
    bb = (bwd_bytes / PEAK_BYTES_PER_S * 1e3, bwd_ops / PEAK_F32_FLOPS * 1e3)
    sass = forward_sass_report(_backend, "rasterize_2dgs_tiled_fwd", fwd2_sass_per_pair, fwd_ms, fwd_pairs, L, ts)
    log(f"tiled 2DGS forward: {fwd_pairs} evaluated and {n_acc} accepted pairs, {fwd_ops} operations, {fwd_bytes} "
        f"bytes; backward: {n_eval} evaluated pairs, {bwd_ops} operations, {bwd_bytes} bytes; kernel ms fwd "
        f"{fwd_ms:.3f} bwd {bwd_ms:.3f}, plain ms fwd {fwd_plain_ms:.1f} bwd {bwd_plain_ms:.1f}")
    entries = [
        {
            "name": "rasterize_2dgs_tiled_fwd", "route": "cuda",
            "source": "gsplat_tpu_torch/csrc/rasterize_2dgs_tiled_fwd.cu",
            "replaces": "gsplat_tpu/ops/rasterize_2dgs_tiled.py:83", "launches": launches["rasterize_2dgs_tiled_fwd"],
            "max_abs_err": max(ferrs.values()), "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": max(fb),
            "bound_by": "operations" if fb[1] >= fb[0] else "bytes", "library_ms": None, "sass_per_pair": sass,
        },
        {
            "name": "rasterize_2dgs_tiled_bwd", "route": "cuda",
            "source": "gsplat_tpu_torch/csrc/rasterize_2dgs_tiled_bwd.cu",
            "replaces": "gsplat_tpu/ops/rasterize_2dgs_tiled.py:207", "launches": launches["rasterize_2dgs_tiled_bwd"],
            "max_abs_err": bmx, "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": max(bb),
            "bound_by": "operations" if bb[1] >= bb[0] else "bytes", "library_ms": None,
        },
    ]
    return entries, runner


def _packed_matches_dense(torch, packed, dense, n_rows, what):
    """A packed projection's buffer against the dense projection: nnz the
    dense valid count, the live slots in camera-major, Gaussian-minor order,
    each float output equal bit for bit to the dense entry at (camera,
    gaussian), the slots past nnz padded (ids -1, radii 0). `dense` is
    (radii, output...) [C, N, ...] and `packed` (camera_ids, gaussian_ids,
    radii, output..., nnz), each with `n_rows` float outputs. Returns nnz."""
    cam, gau, radii, nnz = packed[0], packed[1], packed[2], packed[-1]
    n_valid = int((dense[0] > 0).sum())
    if int(nnz) != n_valid:
        raise AssertionError(f"{what}: nnz {int(nnz)} against {n_valid} valid dense entries")
    live = min(n_valid, cam.shape[0])
    c, g = cam[:live].long(), gau[:live].long()
    flat = c * dense[0].shape[1] + g
    if live > 1 and not bool((flat[1:] > flat[:-1]).all()):
        raise AssertionError(f"{what}: live slots not in camera-major, Gaussian-minor order")
    if not torch.equal(radii[:live], dense[0][c, g]) or not bool((radii[:live] > 0).all()):
        raise AssertionError(f"{what}: radii differ from the dense projection's")
    for i in range(n_rows):
        if not torch.equal(packed[3 + i][:live], dense[1 + i][c, g]):
            raise AssertionError(f"{what}: output {3 + i} differs from the dense projection's bits")
    pad = slice(live, None)
    if not (bool((cam[pad] == -1).all()) and bool((gau[pad] == -1).all()) and bool((radii[pad] == 0).all())):
        raise AssertionError(f"{what}: slots past nnz are not padding")
    return n_valid


def _window_pairs(torch, indices_fn, N, R, C, W, H, feats, *args):
    """rasterize_to_indices_in_range(_2dgs) chained over depth-rank windows
    of R, the termination stream passed on. Returns the contributing pairs
    as (gaussian, pixel, camera) lists grouped by ray, depth-ordered, and
    the windows' own composite of each [C, N, k] of `feats` and of alpha
    ([C, H, W, k] each): the oracle's compositing, window by window."""
    dev = args[0].device
    T = torch.ones((C, H, W), device=dev)
    gids, pids, cids = [], [], []
    comp = [torch.zeros((C, H * W, f.shape[-1]), device=dev) for f in feats]
    alpha_acc = torch.zeros((C, H * W), device=dev)
    for start in range(0, N, R):
        contrib, alpha, sel, new_T = indices_fn(start, min(start + R, N), T, *args, W, H, MAIN_TILE)
        c, p, r = torch.nonzero(contrib, as_tuple=True)
        gids.append(sel[c, r])
        pids.append(p)
        cids.append(c)
        T_incl = torch.cumprod(torch.where(contrib, 1.0 - alpha, 1.0), dim=-1)
        T_excl = T.reshape(C, -1, 1) * torch.cat([torch.ones_like(T_incl[..., :1]), T_incl[..., :-1]], dim=-1)
        w = torch.where(contrib, alpha * T_excl, 0.0)
        del contrib, alpha, T_incl, T_excl
        for acc, f in zip(comp, feats):
            acc += torch.bmm(w, torch.gather(f, 1, sel[..., None].expand(-1, -1, f.shape[-1])))
        alpha_acc += w.sum(dim=-1)
        T = new_T.reshape(C, H, W)
    gids, pids, cids = (torch.cat(x) for x in (gids, pids, cids))
    order = torch.sort(cids * (H * W) + pids, stable=True).indices
    comp = [x.reshape(C, H, W, -1) for x in comp] + [alpha_acc.reshape(C, H, W, 1)]
    return (gids[order], pids[order], cids[order]), comp


def _fwd_gate(torch, got, want, what):
    """FWD_MAX_ABS / FWD_MEAN_ABS over the pairs of outputs. Returns (max
    abs, mean abs)."""
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"{what}: shape {tuple(a.shape)} against {tuple(b.shape)}")
    d = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(got, want)])
    mx, mean = float(d.max()), float(d.mean())
    if not all(bool(torch.isfinite(a).all()) for a in got) or mx > FWD_MAX_ABS or mean > FWD_MEAN_ABS:
        raise AssertionError(f"{what}: max abs {mx:.3e} (limit {FWD_MAX_ABS}), mean abs {mean:.3e} "
                             f"(limit {FWD_MEAN_ABS})")
    return mx, mean


def _composite(torch, valid, alpha, feats):
    """The oracle's compositing of pairs [C, P, N] in depth order, in the
    dtype of `alpha`: each of `feats` [C, N, k] and the alpha, [C, P, k]."""
    from gsplat_tpu_torch.ops.rasterize_ref import TRANSMITTANCE_EPS

    one_m = torch.where(valid, 1.0 - alpha, 1.0)
    T_incl = torch.cumprod(one_m, dim=-1)
    accept = valid & (T_incl > TRANSMITTANCE_EPS)
    T_excl = torch.cat([torch.ones_like(T_incl[..., :1]), T_incl[..., :-1]], dim=-1)
    vis = torch.where(accept, T_excl * alpha, 0.0)
    final_T = torch.prod(torch.where(accept, one_m, 1.0), dim=-1)
    return [torch.bmm(vis, f.to(alpha.dtype)) for f in feats] + [(1.0 - final_T)[..., None]]


def _sigma_oracle(m2s, M9, px, py):
    """The oracle's f32 sigma (`surfel_sigma`'s cross product) [C, P, N]."""
    from gsplat_tpu_torch.ops.rasterize_2dgs_ref import surfel_sigma

    return surfel_sigma(m2s, M9.reshape(M9.shape[:-1] + (3, 3)), px, py)


def _sigma_kernel(m2s, M9, px, py):
    """The binned 2DGS kernel's f32 sigma (`_sigma`, its plain version's
    arithmetic) [C, P, N]."""
    from gsplat_tpu_torch.ops.rasterize_2dgs_binned import _sigma

    rows = [r[:, None, :] for r in (m2s[..., 0], m2s[..., 1], *M9.unbind(-1))]
    return _sigma(rows, px[None, :, None], py[None, :, None])[0]


def _shift_frame(torch, m2s, M9, y_off):
    """Surfels in the frame of a strip starting at row `y_off`, in their own
    dtype, as distributed.py shifts them: mean_y - y_off, M[1] - y_off M[2]."""
    if not y_off:
        return m2s, M9
    m2s = torch.cat([m2s[..., :1], m2s[..., 1:] - float(y_off)], dim=-1)
    M9 = torch.cat([M9[..., :3], M9[..., 3:6] - y_off * M9[..., 6:9], M9[..., 6:]], dim=-1)
    return m2s, M9


def _witness_2dgs(torch, pix, m2, Ms, opc, feats, radii, depths, W, ts, gen, sides=None, row0=0,
                  chunk=WITNESS_CHUNK):
    """The float64 witness at pixels `pix` (flat ids of an image of width W
    whose first row is the frame's row `row0`; camera 0) over all N surfels
    in depth order. Each pair's alpha three ways from the same f32 inputs:
    the two f32 evaluations of `sides` and float64. A side is (sigma
    function, y_off): its surfels and pixels shifted into the frame of a
    strip starting at row y_off (`_shift_frame`), and its sigma by
    `_sigma_oracle` or `_sigma_kernel`; by default the oracle's and the
    kernel's in the image frame. The unstable pairs are those where either
    f32 alpha (or its 1/255 acceptance) differs by more than FWD2_TOL from
    the float64 alpha of the same f32 inputs (lost to arithmetic), and, for
    a shifted side, those whose float64 alpha of the f32-shifted inputs
    differs by more than FWD2_TOL from that of the shift made in float64
    (sensitive to rounding the strip frame's inputs to f32). Returns the
    composites [P, k] of `feats` and alpha with float64 alphas everywhere
    (`truth`) and with the unstable pairs' alphas taken from each side
    (`hat0`, `hat1`), whether each pixel holds an unstable pair [P], each
    surfel's count of unstable pairs [N] (depth order), the depth order
    `sel` [N], the largest move of the float64 alpha of a pair lost
    to arithmetic when M moves by half an f32 ulp, the largest move of a
    float64 alpha when a side's frame shift is made in float64, and the
    number of pairs sensitive to the rounding."""
    from gsplat_tpu_torch.ops.rasterize_2dgs_ref import surfel_sigma
    from gsplat_tpu_torch.ops.rasterize_ref import ALPHA_MAX, depth_rank_window, valid_pairs

    sides = sides or ((_sigma_oracle, 0), (_sigma_kernel, 0))
    C, N = m2.shape[:2]
    sel, (m2s, M9, ops, rad, *fs) = depth_rank_window(depths, 0, N, m2, Ms.reshape(C, N, 9), opc, radii, *feats)
    M3 = M9.reshape(C, N, 3, 3)
    out = {k: [] for k in ("truth", "hat0", "hat1", "pix_any")}
    surf_count = torch.zeros(N, dtype=torch.int64, device=m2.device)
    cond = shift = 0.0
    n_rep = 0
    for part in pix.split(chunk):
        col, row = part % W, part // W + row0
        px = col.float() + 0.5

        def alpha_of(sig, op, m2f, y_off):
            a = torch.clamp_max(op[:, None, :] * torch.exp(-sig), ALPHA_MAX)
            return a, valid_pairs(a, sig, rad, m2f, col.int() // ts, (row - y_off).int() // ts, ts)

        py = row.float() + 0.5
        a64, v64 = alpha_of(surfel_sigma(m2s.double(), M3.double(), px.double(), py.double()), ops.double(), m2s, 0)
        unstable = torch.zeros_like(v64)
        rep = torch.zeros_like(v64)
        side_alphas = []

        def apart(a, v, a_ref, v_ref):
            return (v != v_ref) | ((v | v_ref) & ((a.double() - a_ref).abs() > FWD2_TOL))

        for fn, y_off in sides:
            m2f, M9f = _shift_frame(torch, m2s, M9, y_off)
            py_f = (row - y_off).double() + 0.5
            a, v = alpha_of(fn(m2f, M9f, px, py_f.float()), ops, m2f, y_off)
            a_ref, v_ref = a64, v64
            if y_off:
                # the shift in float64 must be exact math (the image frame's
                # alphas); the f32 shifted inputs' own float64 alphas are
                # the side's reference, and where they leave the exact ones
                # the pair is sensitive to rounding its inputs to f32
                m2d, M9d = _shift_frame(torch, m2s.double(), M9.double(), y_off)
                ad, vd = alpha_of(surfel_sigma(m2d, M9d.reshape(C, N, 3, 3), px.double(), py_f), ops.double(),
                                  m2d, y_off)
                moved = (torch.where(vd, ad, 0.0) - torch.where(v64, a64, 0.0)).abs()
                shift = max(shift, float(moved.max()))
                a_ref, v_ref = alpha_of(surfel_sigma(m2f.double(), M9f.double().reshape(C, N, 3, 3), px.double(),
                                                     py_f), ops.double(), m2f, y_off)
                rep |= apart(a_ref, v_ref, ad, vd)
            unstable |= apart(a, v, a_ref, v_ref)
            side_alphas.append((a, v))
        unstable |= rep
        n_rep += int(rep.sum())
        out["truth"].append(_composite(torch, v64, a64, fs))
        for key, (a, v) in zip(("hat0", "hat1"), side_alphas):
            out[key].append(_composite(torch, torch.where(unstable, v, v64), torch.where(unstable, a.double(), a64), fs))
        out["pix_any"].append(unstable[0].any(dim=-1))
        surf_count += unstable[0].sum(dim=0)
        # the half-ulp test decides the pairs lost to arithmetic; a pair
        # sensitive to its inputs' rounding moves under it by definition
        c, p, n = torch.nonzero(unstable & ~rep, as_tuple=True)
        if n.numel():
            Mu, mu = M3[c, n].double(), m2s[c, n].double()
            for _ in range(WITNESS_PERTURB):
                step = (torch.rand(Mu.shape, generator=gen, device=Mu.device, dtype=torch.float64) * 2 - 1) * 2.0**-24
                sig = surfel_sigma(mu[None], (Mu * (1 + step))[None], px[p].double(), py[p].double())
                # surfel_sigma pairs every pixel with every surfel: take the diagonal
                sig = sig[0].diagonal()
                a = torch.clamp_max(ops[c, n].double() * torch.exp(-sig), ALPHA_MAX)
                cond = max(cond, float((a - a64[c, p, n]).abs().max()))
    joined = {k: [torch.cat(x, dim=1)[0] for x in zip(*v)] for k, v in out.items() if k != "pix_any"}
    return joined, torch.cat(out["pix_any"]), surf_count, sel[0], cond, shift, n_rep


def _attribute_2dgs(torch, names, got, want, geo, W, ts, what, labels=("accumulate", "the kernel"), **witness):
    """The FWD2_* gates between `got` and `want` (by default accumulate_2dgs
    and the binned 2DGS kernel), each a tuple of [1, H, W, k] outputs in
    `names` order, where every value past FWD2_TOL x scale must be
    explained by the float64 witness at its pixel (`_witness_2dgs`, given
    `witness`: the sides, the first row's place). Returns the printed
    summary."""
    flags, scales, flat = [], [], []
    for a, b in zip(got, want):
        d = (a - b).abs().reshape(-1, a.shape[-1])
        scale = max(1.0, float(b.abs().max()))
        flags.append((d > FWD2_TOL * scale).any(dim=-1))
        scales.append(scale)
        flat.append((float((d > FWD2_TOL * scale).float().mean()), float(d.max())))
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: {names[len(flags) - 1]} not finite")
    pix = torch.nonzero(torch.stack(flags).any(dim=0))[:, 0]
    summary = ", ".join(f"{n} share past {FWD2_TOL} x scale {f:.3e}, max abs {m:.3e}" for n, (f, m) in zip(names, flat))
    if pix.numel() == 0:
        return f"{summary}; nothing to attribute"
    gen = torch.Generator(device=got[0].device).manual_seed(SEED)
    hats, pix_any, surf_count, sel, cond, shift, n_rep = _witness_2dgs(torch, pix, *geo, W, ts, gen, **witness)
    missing = int((~pix_any).sum())
    if missing:
        raise AssertionError(f"{what}: {missing} of {pix.numel()} pixels past the FWD2 tolerance hold no pair "
                             f"whose f32 alpha the float64 witness finds lost")
    if cond > FWD2_TOL:
        raise AssertionError(f"{what}: the float64 alpha of an unstable pair moves by {cond:.3e} under half-ulp "
                             f"moves of M: the witness cannot decide")
    if shift > STRIP_SHIFT_TOL:
        raise AssertionError(f"{what}: the strip frame's float64 alpha differs from the image frame's by {shift:.3e} "
                             f"(limit {STRIP_SHIFT_TOL}): the shift is not exact math")
    errs = []
    for i, (n, a, b, scale) in enumerate(zip(names, got, want, scales)):
        a, b = a.reshape(-1, a.shape[-1])[pix].double(), b.reshape(-1, b.shape[-1])[pix].double()
        res_a = float((a - hats["hat0"][i]).abs().max())
        res_b = float((b - hats["hat1"][i]).abs().max())
        if res_a > FWD2_TOL * scale or res_b > FWD2_TOL * scale:
            raise AssertionError(f"{what}: {n} at the flagged pixels not reproduced by the float64 composite with "
                                 f"only the unstable pairs' alphas taken from each side: {labels[0]} off by "
                                 f"{res_a:.3e}, {labels[1]} off by {res_b:.3e} (limit {FWD2_TOL} x {scale:.3g})")
        errs.append(f"{n} {labels[0]} {float((a - hats['truth'][i]).abs().max()):.3e} {labels[1]} "
                    f"{float((b - hats['truth'][i]).abs().max()):.3e} (reproduced within {max(res_a, res_b):.1e})")
    n_idx = torch.nonzero(surf_count)[:, 0]
    m2, depths = geo[0][0], geo[-1][0]
    surfels = ", ".join(f"{int(g)} (depth {float(depths[g]):.6g}, mean2d ({float(m2[g, 0]):.7g}, {float(m2[g, 1]):.7g}), "
                        f"{int(surf_count[k])} pixels)" for k, g in zip(n_idx[:8].tolist(), sel[n_idx[:8]].tolist()))
    if n_idx.numel() > 8:
        surfels += f" and {n_idx.numel() - 8} more"
    rows, cols = pix // W + witness.get("row0", 0), pix % W
    return (f"{summary}; {pix.numel()} pixels past the tolerance (x {int(cols.min())}-{int(cols.max())}, "
            f"y {int(rows.min())}-{int(rows.max())}), each explained by the float64 witness: "
            f"{int(surf_count.sum())} unstable pairs ({n_rep} of them sensitive to rounding the strip frame's "
            f"inputs to f32, the rest lost to f32 arithmetic) of the surfels {surfels}; the float64 alpha of a pair "
            f"lost to arithmetic moves at most {cond:.3e} under half-ulp moves of M, an exact alpha at most "
            f"{shift:.3e} under the frame shift; max abs against the float64 composite there: " + ", ".join(errs))


def phase_op_api():
    """The rest of the op API on the card: the packed projections at the
    serving shapes against the dense ones, and rasterize_to_indices_in_range
    (3DGS and 2DGS) chained over depth-rank windows, then accumulate over
    the pairs, against the binned forward kernels at grid1."""
    import torch
    from gsplat_tpu_torch import (
        accumulate, accumulate_2dgs, fully_fused_projection, fully_fused_projection_2dgs,
        fully_fused_projection_2dgs_packed, fully_fused_projection_packed, load_test_data,
        rasterize_to_indices_in_range, rasterize_to_indices_in_range_2dgs,
    )
    from gsplat_tpu_torch.ops.rasterize import rasterize_to_pixels, rasterize_to_pixels_2dgs

    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    means, quats, scales, opac, colors, viewmats, Ks, W0, _ = load_test_data(scene_grid=MAIN_GRID)
    Ks = Ks.copy()
    Ks[:, :2, :] *= MAIN_W / W0
    W, H = MAIN_W, MAIN_H
    args = (t(means), t(quats), t(scales), t(viewmats[:1]), t(Ks[:1]), W, H)
    N = means.shape[0]
    reps = 5
    with torch.no_grad():
        for kind, dense_fn, packed_fn, kw, n_rows in (
            ("3DGS", fully_fused_projection, fully_fused_projection_packed, dict(calc_compensations=True), 4),
            ("2DGS", fully_fused_projection_2dgs, fully_fused_projection_2dgs_packed, {}, 4),
        ):
            dense = dense_fn(*args, **kw)
            full = packed_fn(*args, N, **kw)
            nnz = _packed_matches_dense(torch, full, dense, n_rows, f"{kind} packed projection, capacity C*N")
            half = packed_fn(*args, nnz // 2, **kw)
            _packed_matches_dense(torch, half, dense, n_rows, f"{kind} packed projection, capacity nnz/2")
            for a, b in zip(half[:-1], full[:-1]):
                if a is not None and not torch.equal(a, b[: nnz // 2]):
                    raise AssertionError(f"{kind} packed projection: truncation kept other than the lowest flat indices")
            packed_ms = cuda_ms(torch, lambda: packed_fn(*args, N, **kw), reps)
            dense_ms = cuda_ms(torch, lambda: dense_fn(*args, **kw), reps)
            log(f"{kind} packed projection, garden grid{MAIN_GRID} {W}x{H}, C=1, N={N}: nnz {nnz}; live slots equal "
                f"the dense projection bit for bit at capacity C*N and nnz/2 (truncation keeps the lowest flat "
                f"indices); packed {packed_ms:.3f} ms, dense {dense_ms:.3f} ms (CUDA events, mean of {reps})")

        # indices in depth-rank windows, then accumulate, against the forward kernels at grid1
        means, quats, scales, opac, colors, viewmats, Ks, W, H = load_test_data(scene_grid=1)
        N, C, R, ts = means.shape[0], 1, INDEX_WINDOW, MAIN_TILE
        geo = (t(means), t(quats), t(scales), t(viewmats[:1]), t(Ks[:1]), W, H)
        opc, cols = t(opac)[None], t(colors)[None]

        radii, means2d, depths, conics, _ = fully_fused_projection(*geo)
        ((gids, pids, cids), chain), idx_ms = timed_once(torch, lambda: _window_pairs(
            torch, rasterize_to_indices_in_range, N, R, C, W, H, [cols], means2d, conics, opc, radii, depths))
        acc, acc_ms = timed_once(torch, lambda: accumulate(means2d, conics, opc, cols, gids, pids, cids, W, H))
        cap = rasterize_to_pixels(means2d, conics, cols, opc, radii, depths, W, H, ts, 512,
                                  backend="binned")[2]["slab_required"] + 1024
        (img_k, alpha_k, _), fwd_ms = timed_once(torch, lambda: rasterize_to_pixels(
            means2d, conics, cols, opc, radii, depths, W, H, ts, cap, backend="binned"))
        what = "3DGS indices + accumulate"
        cmx, cmean = _fwd_gate(torch, acc, chain, f"{what} vs the windows' own composite")
        mx, mean = _fwd_gate(torch, acc, (img_k, alpha_k), f"{what} vs the binned forward kernel")
        log(f"3DGS indices in range (windows of {R}) + accumulate, garden grid1 {W}x{H}, N={N}: "
            f"{gids.shape[0]} pairs; indices (and the windows' composite) {idx_ms:.1f} ms, accumulate "
            f"{acc_ms:.1f} ms, binned render {fwd_ms:.3f} ms; image and alpha vs the binned forward kernel max abs "
            f"{mx:.3e}, mean abs {mean:.3e}; vs the windows' composite max abs {cmx:.3e}, mean abs {cmean:.3e}")

        radii, means2d, depths, Ms, normals = fully_fused_projection_2dgs(*geo)
        ((gids, pids, cids), chain), idx_ms = timed_once(torch, lambda: _window_pairs(
            torch, rasterize_to_indices_in_range_2dgs, N, R, C, W, H, [cols, normals],
            means2d, Ms, opc, radii, depths))
        acc, acc_ms = timed_once(torch, lambda: accumulate_2dgs(
            means2d, Ms, opc, cols, normals, gids, pids, cids, W, H))
        cap = rasterize_to_pixels_2dgs(means2d, Ms, cols, normals, opc, radii, depths, W, H, ts, 512,
                                       backend="binned")[5]["slab_required"] + 1024
        ko, fwd_ms = timed_once(torch, lambda: rasterize_to_pixels_2dgs(
            means2d, Ms, cols, normals, opc, radii, depths, W, H, ts, cap, backend="binned"))
        what = "2DGS indices + accumulate_2dgs"
        acc = (acc[0], acc[2], acc[1])  # colors, normals, alpha: the windows' composite order
        names = ("colors", "normals", "alpha")
        errs = {n: _flip_gate(torch, n, a, b, f"{what} vs the windows' own composite")
                for n, a, b in zip(names, acc, chain)}
        kern = _attribute_2dgs(torch, names, acc, (ko[0], ko[2], ko[1]),
                               (means2d, Ms, opc, [cols, normals], radii, depths), W, ts,
                               f"{what} vs the binned 2DGS forward kernel")
        log(f"2DGS indices in range (windows of {R}) + accumulate_2dgs, garden grid1 {W}x{H}, N={N}: "
            f"{gids.shape[0]} pairs; indices (and the windows' composite) {idx_ms:.1f} ms, accumulate "
            f"{acc_ms:.1f} ms, binned render {fwd_ms:.3f} ms; vs the windows' composite max abs "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; vs the binned 2DGS forward kernel (FWD2 gates, float64 witness): {kern}")


def _relocation_f64(torch, op, ratios, binoms):
    """Eq. 9 in float64 on the card: (new opacity, the scale's factor)."""
    n_max = binoms.shape[0]
    op = op.double()
    new = 1.0 - torch.pow(1.0 - op, 1.0 / ratios.double())
    k = torch.arange(n_max, dtype=torch.float64, device=op.device)
    sign = 1.0 - 2.0 * (k % 2)
    term = sign / torch.sqrt(k + 1.0) * new[:, None] ** (k[None, :] + 1.0)
    denom = torch.cumsum(term @ binoms.double().T, dim=1)
    return new, op / denom.gather(1, (ratios.long() - 1)[:, None])[:, 0]


def phase_train_mcmc(scene, default_steady_ms):
    """MCMC training: Runner(strategy_name="mcmc") on the training phase's
    scene, the reference's MCMC preset, 12 steps refining at 5 and 10; then
    relocate and compute_relocation alone on the final pool, and
    compute_relocation against float64. Returns the five training kernels'
    launches over the 12 steps."""
    import torch
    from gsplat_tpu_torch import _backend, compute_relocation, make_binoms
    from gsplat_tpu_torch.simple_trainer import Config, Runner
    from gsplat_tpu_torch.strategy import ops

    dev = torch.device("cuda")
    views, points, rgb, scene_scale = scene
    n0 = points.shape[0]
    cfg = Config(
        strategy_name="mcmc", cap_max=MCMC_CAP_MAX, max_steps=TRAIN_STEPS, sh_degree=3, sh_degree_interval=1,
        refine_start_iter=0, refine_every=5, tile_size=MAIN_TILE, backend="binned", seed=SEED,
        init_opa=0.5, init_scale=0.1, opacity_reg=0.01, scale_reg=0.01,
    )
    t1 = time.perf_counter()
    runner = Runner(cfg, views, points, rgb, scene_scale, device=dev)
    runner.probe_isect_capacity()
    torch.cuda.synchronize()
    cap = runner.live.shape[0]
    if cap != -(-MCMC_CAP_MAX // 4096) * 4096 or int(runner.live.sum()) != n0:
        raise AssertionError(f"MCMC pool {cap} slots with {int(runner.live.sum())} live")
    log(f"MCMC training path: {n0} points in a {cap}-slot pool (cap_max {MCMC_CAP_MAX}), init_opa 0.5, init_scale "
        f"0.1, opacity_reg 0.01, scale_reg 0.01, isect capacity {runner.isect_capacity}; init "
        f"{time.perf_counter() - t1:.1f} s")
    kernels = ("emit", "emit_gather", "rasterize_fwd", "rasterize_bwd", "gid_reduce")
    # the JAX package's growth: int(1.05 * n_live) in float32, capped
    want_live = {5: min(MCMC_CAP_MAX, int(np.float32(1.05) * np.float32(n0)))}
    want_live[10] = min(MCMC_CAP_MAX, int(np.float32(1.05) * np.float32(want_live[5])))
    _backend.reset_launch_counts()
    losses, step_ms, refined_at = [], [], []
    for step in range(TRAIN_STEPS):
        before = _backend.launch_counts()
        live_before = runner.live.clone()
        dead_means = runner.params["means"].detach()[~live_before].clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = runner.train_step(step)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        loss = float(out["loss"])
        after = _backend.launch_counts()
        per_step = {k: after[k] - before[k] for k in after}
        if not np.isfinite(loss):
            raise AssertionError(f"MCMC step {step}: loss {loss}")
        missing = [k for k in kernels if per_step[k] == 0]
        other = [k for k, v in per_step.items() if v and k not in kernels]
        if missing or other:
            raise AssertionError(f"MCMC step {step}: kernels {missing} not launched, {other} launched")
        n_live = int(runner.live.sum())
        if out["refined"]:
            refined_at.append(step)
            activated = runner.live & ~live_before
            for name, opt in runner.optimizers.items():
                st_ = opt.state[runner.params[name]]
                if bool(st_["exp_avg"][activated].any()) or bool(st_["exp_avg_sq"][activated].any()):
                    raise AssertionError(f"MCMC step {step}: {name}'s Adam moments not zero at the activated slots")
            if n_live != want_live[step]:
                raise AssertionError(f"MCMC step {step}: live {n_live}, want {want_live[step]}")
        elif not torch.equal(runner.params["means"].detach()[~live_before], dead_means):
            raise AssertionError(f"MCMC step {step}: the means of free slots moved")
        losses.append((out["image_ids"][0], loss))
        log(f"MCMC step {step}: view {out['image_ids'][0]} loss {loss:.6f} live {n_live}"
            f"{' (refined)' if out['refined'] else ''}, CUDA events {step_ms[-1]:.2f} ms; launches {per_step}")
    launches = _backend.launch_counts()
    if refined_at != [5, 10]:
        raise AssertionError(f"MCMC refined at {refined_at}, want [5, 10]")
    for name, p in runner.params.items():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"MCMC: parameter {name} is not finite after training")
    view0 = [loss for v, loss in losses if v == 0]
    if len(view0) < 2 or not view0[-1] < view0[0]:
        raise AssertionError(f"MCMC: view 0's loss did not fall: {view0}")
    steady = float(np.median([ms for s, ms in enumerate(step_ms) if s not in refined_at]))
    log(f"launches in the MCMC training path ({TRAIN_STEPS} steps): {launches}")
    log(f"MCMC: live {n0} -> {want_live[5]} (step 5) -> {want_live[10]} (step 10), the Adam moments zero at "
        f"the activated slots, free slots' means unmoved, all parameters finite; view 0 loss {view0[0]:.6f} -> "
        f"{view0[-1]:.6f}; steady step {steady:.3f} ms (median of the non-refining steps; the default "
        f"strategy's {default_steady_ms:.3f}), refine steps +{step_ms[5] - steady:.3f} / "
        f"+{step_ms[10] - steady:.3f} ms")

    # relocate and compute_relocation alone, on a clone of the final pool
    strat = runner.strategy
    binoms = runner.strategy_state["binoms"]
    with torch.no_grad():
        params = {k: v.detach().clone() for k, v in runner.params.items()}
        live = runner.live.clone()
        gen = torch.Generator(device=dev).manual_seed(SEED + 12)
        idx = torch.nonzero(live)[:, 0]
        pick = idx[torch.randperm(idx.shape[0], generator=gen, device=dev)[: idx.shape[0] // 100]]
        params["opacities"][pick] = float(np.log(0.001 / 0.999))
        # the noise at the first step's learning rate moves live means only
        # (the gate opens below opacity ~0.01: the slots just set to 0.001)
        noisy = dict(params, means=params["means"].clone())
        ops.inject_noise_to_position(noisy, live, cfg.means_lr * runner.scene_scale * strat.noise_lr, gen)
        moved_rows = (noisy["means"] != params["means"]).any(dim=1)
        moved = int(moved_rows.sum())
        if bool((moved_rows & ~live).any()) or moved == 0:
            raise AssertionError(f"noise: a free slot's mean moved, or no live mean moved ({moved})")
        del noisy
        dead = live & (torch.sigmoid(params["opacities"]) <= strat.min_opacity)
        n_dead, n_live = int(dead.sum()), int(live.sum())
        counts, reloc_ms = timed_once(torch, lambda: ops.relocate(
            params, live, dead, binoms, None, strat.min_opacity, gen))
        if int(counts.sum()) != n_dead or int(live.sum()) != n_live:
            raise AssertionError(f"relocate: {int(counts.sum())} draws for {n_dead} dead, live {n_live} -> "
                                 f"{int(live.sum())}")
        if bool((torch.sigmoid(params["opacities"])[live] <= strat.min_opacity).any()):
            raise AssertionError("relocate left a live slot at or below min_opacity")
        op_sig, sc = torch.sigmoid(params["opacities"]), torch.exp(params["scales"])
        comp_ms = cuda_ms(torch, lambda: compute_relocation(op_sig, sc, counts + 1, binoms), 5)
        log(f"relocate on the final pool ({cap} slots, {n_live} live, a seeded 1% set to opacity 0.001: {n_dead} "
            f"dead): one call {reloc_ms:.3f} ms (CUDA events; sampling, Eq. 9 and the moves); draws {n_dead}, "
            f"live unchanged, no live slot at or below {strat.min_opacity}; compute_relocation over the pool "
            f"{comp_ms:.3f} ms (mean of 5); before it, the noise at step 0's rate moved {moved} live means "
            f"and no free one")

        # compute_relocation against float64, ratios 1-51, with TF32 asked for around the call
        rng = np.random.default_rng(SEED)
        ops_ = np.concatenate([[0.005, 0.05, 0.5, 0.9, 0.99, 0.999, 0.99999, 0.9999999],
                               rng.uniform(0.005, 0.999, 56)]).astype(np.float32)
        op_t = torch.as_tensor(np.repeat(ops_, 51), device=dev)
        ratios = torch.as_tensor(np.tile(np.arange(1, 52), ops_.size).astype(np.int32), device=dev)
        ones = torch.ones((op_t.shape[0], 3), device=dev)
        want_op, want_f = _relocation_f64(torch, op_t, ratios, binoms)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            new_op, new_sc = compute_relocation(op_t, ones, ratios, binoms)
            tf32_after = torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        cpu_op, cpu_sc = (x.to(dev) for x in compute_relocation(op_t.cpu(), ones.cpu(), ratios.cpu(), binoms.cpu()))

        def rel_err(o, sc):
            return torch.maximum((o.double() - want_op).abs() / want_op, (sc[:, 0].double() - want_f).abs() / want_f)

        e_card, e_cpu = rel_err(new_op, new_sc), rel_err(cpu_op, cpu_sc)
        bands = []
        for lo, hi in ((1, 10), (11, 25), (26, 51)):
            band = (ratios >= lo) & (ratios <= hi)
            a, b = float(e_card[band].max()), float(e_cpu[band].max())
            bands.append(f"ratios {lo}-{hi}: card {a:.3e}, CPU {b:.3e}")
            if a > b + 2.5e-4:
                raise AssertionError(f"compute_relocation on the card vs float64, {bands[-1]} (limit CPU + 2.5e-4)")
        if not tf32_after:
            raise AssertionError("compute_relocation did not restore the caller's TF32 setting")
        log("compute_relocation vs float64 (max relative error of opacity and scale; TF32 allowed by the "
            "caller, off for the product): " + "; ".join(bands))
    return launches


def _record_steps(torch, _backend, runner_cls, record):
    """Wrap runner_cls.train_step and _grow_pool: per step its launches,
    CUDA-event and host ms, loss, depth term, image ids and live count;
    per growth the old and new capacity and whether each optimizer's state
    at the old slots came through unchanged. Returns the restore
    function."""
    train_step, grow_pool = runner_cls.train_step, runner_cls._grow_pool

    def step(self, i):
        before = _backend.launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        out = train_step(self, i)
        end.record()
        torch.cuda.synchronize()
        after = _backend.launch_counts()
        record["steps"].append({
            "step": i, "ms": start.elapsed_time(end), "host_ms": (time.perf_counter() - h0) * 1e3,
            "loss": float(out["loss"]), "depth": None if out["depth"] is None else float(out["depth"]),
            "view": out["image_ids"][0], "live": int(self.live.sum()), "refined": out["refined"],
            "grew": out["pool_grew"], "launches": {k: after[k] - before[k] for k in after},
        })
        return out

    def grow(self, new_cap):
        cap = self.live.shape[0]
        old = {k: {n: v.clone() for n, v in opt.state[self.params[k]].items() if torch.is_tensor(v)}
               for k, opt in self.optimizers.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        grow_pool(self, new_cap)
        end.record()
        torch.cuda.synchronize()
        same = all(torch.equal(v, self.optimizers[k].state[self.params[k]][n][:cap])
                   for k, st_ in old.items() for n, v in st_.items())
        fresh = all(not self.optimizers[k].state[self.params[k]][n][cap:].any() for k, st_ in old.items() for n in st_)
        record["growths"].append({"old": cap, "new": new_cap, "moments_kept": same, "new_slots_zero": fresh,
                                  "ms": start.elapsed_time(end)})

    runner_cls.train_step, runner_cls._grow_pool = step, grow

    def restore():
        runner_cls.train_step, runner_cls._grow_pool = train_step, grow_pool

    return restore


def _colmap_view(torch, runner):
    """The first train view of a COLMAP runner as its last step saw it: the
    pose module's camera, the step's colours (the appearance module's
    per-camera colours where it is on) and SH degree. Returns (colours,
    sh_degree for the render, viewmats [1,4,4], Ks [1,3,3], W, H)."""
    cfg = runner.cfg
    view = runner.trainset[0]
    pixels, c2w, K = runner._as_batch([view])
    ids = torch.tensor([int(view["image_id"])], device=runner.device)
    if "pose" in runner.aux:
        c2w = runner.aux["pose"](c2w, ids)
    sh_degree = min((cfg.max_steps - 1) // cfg.sh_degree_interval, cfg.sh_degree)
    colors, sh = runner._colors(c2w, ids, sh_degree)
    return colors, sh, torch.linalg.inv(c2w), K, pixels.shape[2], pixels.shape[1]


def check_colmap_kernels(runner, what):
    """The 3DGS path's kernels against their plain versions on a COLMAP
    runner's own inputs: its first train view rendered as its step renders
    it (_colmap_view; RGB+ED where the depth loss is on), over the whole
    pool and at its intersection budget. Emit and the gather equal, the
    forward by the FWD_* gates, the backward (seeded cotangents) by the
    BWD_* gates and the same bits twice, the reduce against index_add_ on
    the stream's order and through a gid sort (compare_reduce). Returns
    {kernel name: max abs error}."""
    import torch
    from gsplat_tpu_torch import rendering
    from gsplat_tpu_torch.ops import binning, rasterize_binned as rb

    cfg = runner.cfg
    ts = cfg.tile_size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    with torch.no_grad():
        colors, sh, vm, K, W, H = _colmap_view(torch, runner)
        p = runner.params
        s = rendering.project_and_shade(
            p["means"], p["quats"], torch.exp(p["scales"]), torch.sigmoid(p["opacities"]), colors, vm, K, W, H,
            near_plane=cfg.near_plane, far_plane=cfg.far_plane, sh_degree=sh,
            render_mode="RGB+ED" if cfg.depth_loss else "RGB",
            rasterize_mode="antialiased" if cfg.antialiased else "classic", camera_model=cfg.camera_model,
            masks=runner.live,
        )
        plan, slab = emit_plan(binning, s, ts, W, H, runner.isect_capacity)
        bk, emit_err = compare_emit(torch, binning, plan, slab, (-(-W // ts)) * (-(-H // ts)))
        fmx, fmean, same_last, n_off, _, (_, T_k, last_k) = compare_fwd(torch, rb, bk, 1, W, H, ts)
        D = bk.entries.shape[0] - 6
        v_img, v_T = cotangents(torch, gen, T_k, D)
        rows_k, _, bmx, berrs, _ = compare_bwd(torch, rb, bk, T_k, last_k, v_img, v_T, 1, W, H, ts, cfg.absgrad)
        CN = plan.counts.shape[0]
        rmx, _ = compare_reduce(torch, rb, rows_k, bk.gids, CN, bk.order)
    log(f"{what}: kernels vs plain on the path's inputs (first train view, D = {D}, "
        f"{'per-camera colours' if sh is None else f'SH degree {sh}'}, {int(runner.live.sum())} live of {CN} "
        f"slots, {int(bk.n_isects)} entries of a {runner.isect_capacity} budget): emit and gather equal; fwd max "
        f"abs {fmx:.3e} mean abs {fmean:.3e} ({n_off} > 1e-5), last equal at {same_last:.6f}; bwd max abs per "
        f"row " + " ".join(f"{e:.2e}" for e in berrs) + f"; reduce vs index_add_ max abs {rmx:.3e}")
    return {"emit": 0.0, "emit_gather": emit_err, "rasterize_fwd": fmx, "rasterize_bwd": bmx, "gid_reduce": rmx}


def check_colmap_kernels_2dgs(runner, what):
    """check_colmap_kernels for a COLMAP Runner2DGS: its first train view
    through the surfel projection (RGB+ED, as its step renders), emit and
    the gather equal, the 2DGS forward by the FWD2_* gates, the 2DGS
    backward (seeded cotangents) by the BWD2_* gates, the reduce against
    index_add_. Returns {kernel name: max abs error}."""
    import torch
    from gsplat_tpu_torch import rendering
    from gsplat_tpu_torch.ops import binning, rasterize_2dgs_binned as r2, rasterize_binned as rb

    cfg = runner.cfg
    ts = cfg.tile_size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    with torch.no_grad():
        colors, sh, vm, K, W, H = _colmap_view(torch, runner)
        p = runner.params
        s = rendering.project_and_shade_2dgs(
            p["means"], p["quats"], torch.exp(p["scales"]), torch.sigmoid(p["opacities"]), colors, vm, K, W, H,
            near_plane=cfg.near_plane, far_plane=cfg.far_plane, sh_degree=sh, render_mode="RGB+ED",
            masks=runner.live,
        )
        D = s.colors.shape[-1]
        plan, slab = emit_plan_2dgs(binning, r2, s, ts, W, H, runner.isect_capacity)
        bk, emit_err = compare_emit(torch, binning, plan, slab, (-(-W // ts)) * (-(-H // ts)))
        ferrs, med_off, same_last, _, ko = compare_fwd2(torch, r2, bk, 1, W, H, ts, what)
        cot = cotangents_2dgs(torch, gen, ko[1], D + 3)
        rows_k, bmx, berrs, _, n_past = compare_bwd2(torch, r2, bk, ko, cot, D, 1, W, H, ts, what)
        CN = plan.counts.shape[0]
        rmx, _ = compare_reduce(torch, rb, rows_k, bk.gids, CN, bk.order)
    log(f"{what}: kernels vs plain on the path's inputs (first train view, RGB+ED, {int(runner.live.sum())} live "
        f"of {CN} slots, {int(bk.n_isects)} entries of a {runner.isect_capacity} budget): emit and gather equal; "
        f"2DGS forward max abs " + ", ".join(f"{k} {v:.3e}" for k, v in ferrs.items())
        + f", median off at {med_off:.2e}, last equal at {same_last:.6f}; backward max abs per row "
        + " ".join(f"{e:.2e}" for e in berrs) + f" ({n_past} values past the per-slot tolerance); reduce vs "
        f"index_add_ max abs {rmx:.3e}")
    return {"emit": 0.0, "emit_gather": emit_err, "rasterize_2dgs_fwd": max(ferrs.values()),
            "rasterize_2dgs_bwd": bmx, "gid_reduce": rmx}


def check_grid_grad(torch, bilagrid, inputs, what):
    """csrc/bilagrid_bwd.cu's two kernels on `inputs` (the gathered grids g
    [B, Z, Y, X, 12], the cotangent v [B, H, W, 12], gray [B, H, W], the
    grids' shape): the same bits from two launches, and within
    GRID_GRAD_TOL x each value's sum of |terms| of their plain versions.
    Returns the grids' and the luminance's max abs errors."""
    from gsplat_tpu_torch.microbench import compare

    g, v, gray, shape = inputs["g"].detach(), inputs["v"], inputs["gray"], inputs["shape"]
    # each value's sum of |terms|: the cell's |weight| |v| (the plain
    # version on |v|), and per pixel (Z - 1) x 2 max|g| x sum |v|
    scales = (bilagrid._grid_grad_plain(v.abs(), gray, shape),
              v.abs().sum(-1) * (2 * (shape[1] - 1) * float(g.abs().max())))
    errs = []
    for name, kern, plain, scale in (("the grids' gradient", lambda: bilagrid._grid_grad_cuda(v, gray, shape),
                                      lambda: bilagrid._grid_grad_plain(v, gray, shape), scales[0]),
                                     ("the luminance's gradient", lambda: bilagrid._lum_grad_cuda(g, gray, v),
                                      lambda: bilagrid._lum_grad(g, gray, v), scales[1])):
        a, b = kern(), kern()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs between two launches at {int((a != b).sum())} values")
        errs.append(compare(f"{what}: {name}", a, plain(), GRID_GRAD_TOL, scale=scale))
        log(f"{what}: {name} kernel on its inputs ({tuple(v.shape)} cotangent, grids {shape}): the same bits from "
            f"two launches, max abs {errs[-1]:.3e} against the plain version (of max |plain| "
            f"{float(b.abs().max()):.3e})")
    return tuple(errs)


def phase_colmap(smi, default_steady_ms):
    """The COLMAP trainer end to end: a synthetic scene written by
    datasets/synth.py (the training path's 2,794,625 splats at 1920x1080,
    10 views, 1,000,000 initial points with their observations), then
    simple_trainer.main with every aux module, the depth loss, pool growth,
    checkpoints and the fly-through; a resumed run; the 2DGS command line;
    image fitting. Returns the launches of the 3DGS and 2DGS runs."""
    import shutil

    import torch
    from gsplat_tpu_torch import _backend, bilagrid, image_fitting, load_test_data
    from gsplat_tpu_torch import simple_trainer as st
    from gsplat_tpu_torch import simple_trainer_2dgs as st2
    from gsplat_tpu_torch.datasets import Parser, image_io, synth

    root = colmap_root()
    shutil.rmtree(root, ignore_errors=True)
    data, res, res2, rt_dir, res_2dgs = (os.path.join(root, d) for d in ("scene", "r", "r_resumed", "r_rt", "r_2dgs"))
    means, quats, scales, opac, colors, *_ = load_test_data(scene_grid=MAIN_GRID)
    splats = {"means": means, "quats": quats, "scales": scales, "opacities": opac, "colors": colors}
    info = synth.write_scene(data, splats, COLMAP_VIEWS, MAIN_W, MAIN_H, COLMAP_POINTS, seed=SEED, device="cuda",
                             tile_size=MAIN_TILE)
    t0 = time.perf_counter()
    parser = Parser(data, normalize=True, test_every=8)
    parse_s = time.perf_counter() - t0
    log(f"COLMAP scene: {len(means)} splats rendered at {MAIN_W}x{MAIN_H} from {COLMAP_VIEWS} views "
        f"({info['render_s']:.2f} s), {parser.points.shape[0]} points with {info['observations']} observations; "
        f"written {info['write_s']:.2f} s, {info['bytes']} bytes on disk; Parser read {parse_s:.2f} s "
        f"(card: {smi})")
    del parser

    half = COLMAP_STEPS // 2
    ckpt = os.path.join(res, f"ckpt_{half}.npz")

    def colmap_argv(result_dir, *extra):
        return ["default", "--data-dir", data, "--data-factor", "1", "--result-dir", result_dir, "--max-steps",
                str(COLMAP_STEPS), "--eval-steps", str(COLMAP_STEPS), "--save-steps", str(half), str(COLMAP_STEPS),
                "--refine-start-iter", "4", "--refine-every", "8", "--pool-headroom", "1.0", "--depth-loss",
                "--pose-opt", "--app-opt", "--use-bilateral-grid", "--white-bkgd", "--tile-size", str(MAIN_TILE),
                "--seed", str(SEED), *extra]

    kernels = ("emit", "emit_gather", "rasterize_fwd", "rasterize_bwd", "gid_reduce", "bilagrid_bwd",
               "bilagrid_lum_bwd")
    record = {"steps": [], "growths": []}
    restore = _record_steps(torch, _backend, st.Runner, record)
    # the grid's gradients' inputs as the last step hands them to its kernels
    grid_grad, lum_grad, grid_inputs = bilagrid.grid_grad, bilagrid.lum_grad, {}

    def recording_grid_grad(v, gray, shape):
        grid_inputs.update(v=v, gray=gray, shape=tuple(shape))
        return grid_grad(v, gray, shape)

    def recording_lum_grad(g, gray, v):
        grid_inputs.update(g=g)
        return lum_grad(g, gray, v)

    bilagrid.grid_grad, bilagrid.lum_grad = recording_grid_grad, recording_lum_grad
    try:
        _backend.reset_launch_counts()
        t0 = time.perf_counter()
        runner = st.main(colmap_argv(res, "--render-traj"))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _backend.launch_counts()
        bilagrid.grid_grad, bilagrid.lum_grad = grid_grad, lum_grad
        first = record
        record = {"steps": [], "growths": []}
        restore()
        # where a steady step's time goes: the host's view load (PNG
        # decode, the depth points' projection), one profiled step
        load_ms = [timed_once(torch, lambda: runner.trainset[i])[1] for i in range(3)]
        step_ms = cuda_ms(torch, lambda: runner.train_step(COLMAP_STEPS), 2)
        kern = device_time_by_kernel(torch, lambda: runner.train_step(COLMAP_STEPS + 1))
        errs = check_colmap_kernels(runner, "COLMAP trainer")
        errs["bilagrid_bwd"], errs["bilagrid_lum_bwd"] = check_grid_grad(torch, bilagrid, grid_inputs,
                                                                          "COLMAP trainer's last step")
        # the first train frame as Up-, Paeth- and Average-filtered PNGs
        # (encoders such as libpng choose Paeth and Average rows for
        # photographs), each read back by the port's reader on the host
        frame = image_io.read_png(runner.parser.image_paths[1])
        png_ms = {}
        for ft, name in ((2, "Up"), (4, "Paeth"), (3, "Average")):
            path = os.path.join(root, f"frame_{name}.png")
            image_io.write_png(path, frame, filter_type=ft)
            h0 = time.perf_counter()
            got = image_io.read_png(path)
            png_ms[name] = (time.perf_counter() - h0) * 1e3
            if not np.array_equal(got, frame):
                raise AssertionError(f"the {name}-filtered frame does not read back")
        restore = _record_steps(torch, _backend, st.Runner, record)
        # the checkpoint's arrays: save -> load -> save
        rt = st.Runner.from_colmap(st.parse_config(colmap_argv(rt_dir)))
        rt.load(ckpt)
        rt.save(half)
        del rt
        t1 = time.perf_counter()
        resumed = st.main(colmap_argv(res2, "--resume", ckpt))
        resumed_s = time.perf_counter() - t1
        second = record
    finally:
        restore()
        bilagrid.grid_grad, bilagrid.lum_grad = grid_grad, lum_grad

    steps = first["steps"]
    for s in steps:
        missing = [k for k in kernels if s["launches"][k] == 0]
        if missing:
            raise AssertionError(f"COLMAP step {s['step']}: kernels {missing} were not launched")
        if not (s["depth"] is not None and np.isfinite(s["depth"]) and s["depth"] > 0):
            raise AssertionError(f"COLMAP step {s['step']}: depth term {s['depth']}")
        if not np.isfinite(s["loss"]):
            raise AssertionError(f"COLMAP step {s['step']}: loss {s['loss']}")
        log(f"COLMAP step {s['step']}: view {s['view']} loss {s['loss']:.6f} depth {s['depth']:.6f} live {s['live']}"
            f"{' (refined)' if s['refined'] else ''}{' (pool grew)' if s['grew'] else ''}, CUDA events "
            f"{s['ms']:.2f} ms, host {s['host_ms']:.2f} ms")
    if not first["growths"] or not all(g["moments_kept"] and g["new_slots_zero"] for g in first["growths"]):
        raise AssertionError(f"pool growth: {first['growths']}")
    for name, p in list(runner.params.items()) + [(f"{m}.{n}", p) for m, mod in runner.aux.items()
                                                   for n, p in mod.named_parameters()]:
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"COLMAP: parameter {name} is not finite after training")
    view = min(s["view"] for s in steps)
    visits = [s["loss"] for s in steps if s["view"] == view]
    if len(visits) < 2 or not visits[-1] < visits[0]:
        raise AssertionError(f"COLMAP: view {view}'s loss did not fall: {visits}")
    want_files = ["cfg.json", "stats.jsonl", f"val_step{COLMAP_STEPS}.json", f"ckpt_{half}.npz",
                  f"ckpt_{COLMAP_STEPS}.npz", f"splats_{COLMAP_STEPS}.ply"]
    missing = [f for f in want_files if not os.path.exists(os.path.join(res, f))]
    traj = os.listdir(os.path.join(res, "videos")) if os.path.isdir(os.path.join(res, "videos")) else []
    if missing or not traj:
        raise AssertionError(f"COLMAP results missing {missing}, fly-through {traj}")
    val = json.load(open(os.path.join(res, f"val_step{COLMAP_STEPS}.json")))
    grow_steps = [s for s in steps if s["grew"]]
    grow_ms = ", ".join(f"{s['ms']:.2f} ms, of it the growth {g['ms']:.2f}" for s, g in zip(grow_steps, first["growths"]))
    steady = float(np.median([s["ms"] for s in steps if not (s["grew"] or s["refined"] or s["step"] == 0)]))
    log(f"launches in the COLMAP training path ({COLMAP_STEPS} steps): {launches}")
    log(f"COLMAP trainer (main, {run_s:.1f} s): pool growths "
        + "; ".join(f"{g['old']} -> {g['new']} slots (moments at the old slots kept, new slots zero)"
                    for g in first["growths"])
        + f" at steps {[s['step'] for s in grow_steps]} ({grow_ms}); "
        f"view {view} loss {visits[0]:.6f} -> {visits[-1]:.6f}; every parameter and aux parameter finite; "
        f"val PSNR {val['psnr']:.3f} SSIM {val['ssim']:.4f} at {val['num_GS']} splats; files {want_files} and "
        f"videos/{traj[0]}; steady step with pose, appearance, grid and depth {steady:.3f} ms (median, CUDA "
        f"events; phase 5's default step {default_steady_ms:.3f} ms; card: {smi})")

    log(f"a train view's load (PNG decode, depth points) {np.mean(load_ms):.2f} ms on the host (mean of 3); "
        f"read_png of a {frame.shape[1]}x{frame.shape[0]} frame on the host: "
        + ", ".join(f"{k}-filtered {v:.2f} ms" for k, v in png_ms.items()) + f" (card: {smi})")
    log_profile("COLMAP train step (all aux modules)", kern, step_ms)

    # the checkpoint round trip and the resumed run
    a, b = np.load(ckpt), np.load(os.path.join(rt_dir, f"ckpt_{half}.npz"))
    if sorted(a.files) != sorted(b.files) or not all(np.array_equal(a[k], b[k]) for k in a.files):
        raise AssertionError("checkpoint arrays differ after save -> load -> save")
    by_step = {s["step"]: s for s in steps}
    rel, lives = [], []
    for s in second["steps"]:
        w = by_step[s["step"]]
        rel.append(abs(s["loss"] - w["loss"]) / abs(w["loss"]))
        lives.append((s["live"], w["live"]))
    if [s["step"] for s in second["steps"]] != list(range(half, COLMAP_STEPS)):
        raise AssertionError(f"resumed steps {[s['step'] for s in second['steps']]}")
    if max(rel) > 1e-3 or any(x != y for x, y in lives):
        raise AssertionError(f"resumed run: loss rel diffs {rel}, live (resumed, uninterrupted) {lives}")
    log(f"checkpoint ckpt_{half}.npz: {len(a.files)} arrays the same bits after save -> load -> save; resumed run "
        f"({resumed_s:.1f} s) steps {half}-{COLMAP_STEPS - 1} (refines at "
        f"{[s['step'] for s in second['steps'] if s['refined']]}): largest loss difference {max(rel):.3e} relative "
        f"to the uninterrupted run, live counts equal ({lives[-1][0]})")
    del runner, resumed

    # the 2DGS command line
    kernels_2dgs = ("emit", "rasterize_2dgs_fwd", "rasterize_2dgs_bwd", "gid_reduce")
    record = {"steps": [], "growths": []}
    restore = _record_steps(torch, _backend, st.Runner, record)
    try:
        _backend.reset_launch_counts()
        runner2 = st2.main(["--data-dir", data, "--data-factor", "1", "--result-dir", res_2dgs, "--max-steps",
                            str(COLMAP_2DGS_STEPS), "--eval-steps", str(COLMAP_2DGS_STEPS), "--save-steps",
                            "--white-bkgd", "--seed", str(SEED)])
        launches_2dgs = _backend.launch_counts()
    finally:
        restore()
    for s in record["steps"]:
        missing = [k for k in kernels_2dgs if s["launches"][k] == 0]
        if missing or not np.isfinite(s["loss"]):
            raise AssertionError(f"2DGS COLMAP step {s['step']}: kernels {missing} not launched, loss {s['loss']}")
    for name, p in runner2.params.items():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"2DGS COLMAP: parameter {name} is not finite")
    errs_2dgs = check_colmap_kernels_2dgs(runner2, "2DGS command line")
    val2 = json.load(open(os.path.join(res_2dgs, f"val_step{COLMAP_2DGS_STEPS}.json")))
    steady2 = float(np.median([s["ms"] for s in record["steps"][1:]]))
    log(f"2DGS command line ({COLMAP_2DGS_STEPS} steps, launches {launches_2dgs}): steady step {steady2:.3f} ms "
        f"(median after step 0, CUDA events), val PSNR {val2['psnr']:.3f} at {val2['num_GS']} surfels (card: {smi})")
    del runner2

    # image fitting at its defaults, FIT_STEPS steps, binned on the card
    fit = image_fitting.main(["--max-steps", str(FIT_STEPS)])
    if not fit["psnr"] > fit["psnr0"]:
        raise AssertionError(f"image fitting: PSNR {fit['psnr0']:.3f} -> {fit['psnr']:.3f}")
    log(f"image fitting (256x256, 2000 points, binned): {FIT_STEPS} steps in {fit['seconds']:.2f} s, "
        f"{fit['steps_per_s']:.1f} steps/s, PSNR {fit['psnr0']:.3f} -> {fit['psnr']:.3f} (card: {smi})")
    for d in os.listdir(root):  # the scene stays for phase 17
        if d != "scene":
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    return launches, launches_2dgs, errs, errs_2dgs


# phase 14: the micro-benchmarks (gsplat_tpu_torch/microbench/, which
# scripts/torch_exp_*.py drive) and the TPU kernels they replace
MB_MODULES = ("vpu_calib", "primitives", "kernel_shapes", "fwd_breakdown")
MB_RUNS = 7
MB_REPLACES = {
    "fma_chain": "scripts/exp_vpu_calib.py:18",
    "sgemm": "scripts/exp_vpu_calib.py:29",
    "tf32_mma": "scripts/exp_vpu_calib.py:29",
    "gather_rows": "scripts/exp_r2_batch2.py:18",
    "gather_window": "scripts/exp_r2_primitives.py:79",
    "gather_cols": "scripts/exp_r2_primitives.py:155",
    "inner_math_f32": "scripts/exp_r2_primitives.py:189",
    "inner_math_bf16": "scripts/exp_r2_primitives.py:189",
    **{f"slice_{v}": "scripts/exp_mxu_kernel_shapes.py:43"
       for v in ("vpu_sigma", "mxu_sigma", "moments", "vpu_reduce5", "scan", "fwd_mix")},
    **{f"fwd_breakdown_L{i}": "scripts/exp_fwd_breakdown.py:67" for i in range(4)},
}
# e1's take_along_axis kernels (one block) run through these two
MB_ALSO_REPLACES = {"gather_rows": "scripts/exp_r2_primitives.py:57",
                    "gather_window": "scripts/exp_r2_primitives.py:52"}


# the grid kernels' edge shapes (B, H, W, Z, Y, X): two images, a small odd
# image, one narrower and shorter than the grid, Z = 16 and 32 (the first
# version took Z <= 16), one node along an axis, 1080p at B = 2 and at Z = 32
GRID_EDGE_SHAPES = ((2, 23, 37, 8, 16, 16), (1, 23, 37, 16, 16, 16), (1, 23, 37, 32, 16, 16),
                    (1, 5, 7, 8, 16, 16), (2, 23, 37, 4, 1, 16), (1, 37, 23, 3, 16, 1),
                    (2, 1080, 1920, 8, 16, 16), (1, 1080, 1920, 32, 16, 16))


def grid_inputs(torch, B, H, W, Z, Y, X, seed):
    """The grid kernels' inputs at a shape: grids of random affines about
    the identity, a cotangent, and the luminance of random colours with the
    first and last rows (8 at most) black and white (on the bottom and top
    node)."""
    from gsplat_tpu_torch import bilagrid

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, Z, Y, X, 12)
    ident = bilagrid.BilateralGrid(1, X, Y, Z, device="cuda").grids.detach()
    grids = torch.randn(shape, device="cuda", generator=g) * 0.2 + ident
    rgb = torch.rand(B, H, W, 3, device="cuda", generator=g)
    e = min(8, max(1, H // 8))
    rgb[:, :e] = 0.0
    rgb[:, -e:] = 1.0
    gray = torch.clamp((rgb * torch.tensor(bilagrid.RGB2GRAY, device="cuda")).sum(-1), 0.0, 1.0)
    v = torch.randn(B, H, W, 12, device="cuda", generator=g)
    return {"g": grids, "v": v, "gray": gray, "shape": shape, "rgb": rgb}


def check_grid_edges(torch):
    """check_grid_grad at each of GRID_EDGE_SHAPES. Returns the largest
    errors (the grids', the luminance's)."""
    from gsplat_tpu_torch import bilagrid

    errs = [check_grid_grad(torch, bilagrid, grid_inputs(torch, *shape, SEED + 22 + i), "edge B{} {}x{}, grids "
                            "Z{} Y{} X{}".format(shape[0], shape[2], shape[1], *shape[3:]))
            for i, shape in enumerate(GRID_EDGE_SHAPES)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def grid_grad_at_1080p(torch, smi):
    """The bilateral grid's two gradient kernels at 1920x1080 (16 x 16 x 8
    grids, luminance rows on the bottom and top node included): the same
    bits twice and against their plain versions (check_grid_grad), also at
    GRID_EDGE_SHAPES, timed beside grid_sample's backward for the grids
    alone and for the coordinates alone (output masks [True, False] and
    [False, True]) and the slice's whole backward through the port's
    Function beside grid_sample's autograd. Returns their `kernels` entries
    (launches filled from phase 13)."""
    from gsplat_tpu_torch import bilagrid
    from gsplat_tpu_torch.microbench import bound_ms, median_ms

    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    B, H, W = 1, MAIN_H, MAIN_W
    x = grid_inputs(torch, B, H, W, 8, 16, 16, SEED + 21)
    grids, v, gray, shape, rgb = x["g"], x["v"], x["gray"], x["shape"], x["rgb"]
    err, lum_err = check_grid_grad(torch, bilagrid, x, f"{W}x{H}")
    edge_err, edge_lum_err = check_grid_edges(torch)
    err, lum_err = max(err, edge_err), max(lum_err, edge_lum_err)
    ms = median_ms(lambda: bilagrid._grid_grad_cuda(v, gray, shape), MB_RUNS)
    plain_ms = median_ms(lambda: bilagrid._grid_grad_plain(v, gray, shape), 3, warmup=1)
    lum_ms = median_ms(lambda: bilagrid._lum_grad_cuda(grids, gray, v), MB_RUNS)
    lum_plain_ms = median_ms(lambda: bilagrid._lum_grad(grids, gray, v), 3, warmup=1)
    g5, coords, go = grids.permute(0, 4, 1, 2, 3), bilagrid._coords(gray), v.permute(0, 3, 1, 2)[:, :, None]
    lib_ms = median_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(go, g5, coords, 0, 1, True, [True, False]),
                       MB_RUNS)
    # the coordinates' gradient alone: grid_sample's per-pixel backward
    lum_lib_ms = median_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(go, g5, coords, 0, 1, True,
                                                                           [False, True]), MB_RUNS)
    # the slice's whole backward: the port's Function against grid_sample's autograd
    x = rgb.clone().requires_grad_(True)
    gp = grids.clone().requires_grad_(True)
    cot = torch.randn(B, H, W, 3, device="cuda", generator=g)

    def port():
        torch.autograd.grad(bilagrid.slice_grid(gp, torch.zeros(1, dtype=torch.int64, device="cuda"), x), (gp, x), cot)

    def autograd_grid_sample():
        gr = torch.clamp((x * torch.tensor(bilagrid.RGB2GRAY, device="cuda")).sum(-1), 0.0, 1.0)
        a = torch.nn.functional.grid_sample(gp.permute(0, 4, 1, 2, 3), bilagrid._coords(gr), mode="bilinear",
                                            padding_mode="border", align_corners=True)
        A = a[:, :, 0].permute(0, 2, 3, 1).reshape(B, H, W, 3, 4)
        torch.autograd.grad((A[..., :3] * x[..., None, :]).sum(-1) + A[..., 3], (gp, x), cot)

    port_ms, old_ms = median_ms(port, MB_RUNS), median_ms(autograd_grid_sample, MB_RUNS)
    # bytes: v and gray read, the grids' gradient (the luminance's) written;
    # operations: 8 corners x 12 multiply-adds a pixel (the luminance's: 8
    # x 12 interpolation multiply-adds and 12 for the dot)
    nbytes = 4 * (v.numel() + gray.numel() + grids.numel())
    bound, by = bound_ms(nbytes=nbytes, flops=2 * 96 * B * H * W)
    lum_bytes = 4 * (v.numel() + 2 * gray.numel() + grids.numel())
    lum_bound, lum_by = bound_ms(nbytes=lum_bytes, flops=2 * 108 * B * H * W)
    log(f"bilagrid_bwd at {W}x{H}: {ms:.4f} ms, bound {bound:.4f} ms ({by}, {nbytes} bytes); plain "
        f"{plain_ms:.3f} ms; grid_sample's backward for the grids {lib_ms:.4f} ms; bilagrid_lum_bwd {lum_ms:.4f} "
        f"ms, bound {lum_bound:.4f} ms ({lum_by}), plain {lum_plain_ms:.3f} ms, grid_sample's backward for the "
        f"coordinates {lum_lib_ms:.4f} ms; the slice's forward and backward {port_ms:.3f} ms through the port's "
        f"Function against {old_ms:.3f} ms through grid_sample's autograd (card: {smi})")
    entry = {"route": "cuda", "source": "gsplat_tpu_torch/csrc/bilagrid_bwd.cu",
             "replaces": "none: gsplat_tpu/bilagrid.py:31 (_trilerp) is plain JAX", "launches": None}
    return [{"name": "bilagrid_bwd", **entry, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": by, "library_ms": lib_ms},
            {"name": "bilagrid_lum_bwd", **entry, "max_abs_err": lum_err, "ms": lum_ms, "plain_ms": lum_plain_ms,
             "bound_ms": lum_bound, "bound_by": lum_by, "library_ms": lum_lib_ms}]


def phase_microbench(smi):
    """Phase 14: each micro-benchmark kernel against its plain version at a
    small size and at its TPU script's, each gate shown to reject a wrong
    result (gsplat_tpu_torch/microbench/*.py::check; the slice kernels also
    at their edge shapes and tiles, two launches to the same bits; the
    gathers and the inner math at theirs), the inner math's SASS a term, the
    grid gradient at 1080p (grid_grad_at_1080p), then the micro-benchmarks'
    own path: launch counts set to 0, every module's timing run at its
    script's sizes (::measure), the counts read (each kernel launched); the
    calibration rates beside the data sheet's figures. Returns the kernels'
    `kernels` entries."""
    import importlib

    import torch
    from gsplat_tpu_torch import _backend
    from gsplat_tpu_torch.microbench import PEAK_BYTES_PER_S, PEAK_EX2_PER_S, format_errors, report_line
    from gsplat_tpu_torch.microbench import fwd_breakdown

    # the repeats of rows 11-12 as loops of the work in SASS (tf32_mma's
    # product: wgmma, HGMMA in SASS), each kernel's work in one
    ops = {"fma_chain": "FFMA", "sgemm": "FFMA", "tf32_mma": "HGMMA"}
    calib_loops = repeat_loops(_backend._library_path("mb_calib"), ops)
    for name, loops in calib_loops.items():
        log(f"SASS loops of {name} (instructions, of them its FFMA / HGMMA): {loops}")
    bare = [part for part in ops if not any(loops for name, loops in calib_loops.items() if part in name)]
    if bare:
        raise AssertionError(f"no SASS loop of {bare} holds its {[ops[p] for p in bare]}")
    # row 19's pixel loop, its instructions a term (an exponential) by kind
    inner_mix = sass_mix(_backend._library_path("mb_inner_math"), "inner_")
    for name, mix in inner_mix.items():
        log(f"SASS of {name}'s pixel loop, instructions a term: {mix}")
    if len(inner_mix) != 2 or not all(inner_mix.values()):
        raise AssertionError(f"mb_inner_math: no pixel loop with an MUFU.EX2 in {inner_mix}")
    mods = [importlib.import_module(f"gsplat_tpu_torch.microbench.{n}") for n in MB_MODULES]
    errs = {}
    for mod in mods:
        for small in (True, False):
            e = mod.check(small)
            log(f"{mod.__name__} kernels against plain ({'small' if small else 'the script'}'s size): "
                f"{format_errors(e)}")
            if not small:
                errs.update(e)
    _, offs, cnts, *_ = fwd_breakdown.stream(*fwd_breakdown.PRODUCTION)
    log("fwd_breakdown's edge tiles at 1080p, held to plain above: " + ", ".join(
        f"tile {t} ({int(cnts[t])} entries from {int(offs[t])})" for t in fwd_breakdown.edge_tiles(offs, cnts).tolist()))
    grid_entries = grid_grad_at_1080p(torch, smi)

    _backend.reset_launch_counts()
    rows, fwd_info = [], None
    for mod in mods:
        out = mod.measure(MB_RUNS)
        if isinstance(out, tuple):
            out, fwd_info = out
        rows += out
    torch.cuda.synchronize()
    launches = _backend.launch_counts()
    for r in rows:
        log(report_line(r, smi))
    missing = [r["name"] for r in rows if launches[r["name"]] == 0]
    if missing:
        raise AssertionError(f"micro-benchmark kernels not launched: {missing}")
    log(f"{fwd_breakdown.describe(fwd_info)} (card: {smi})")
    by = {r["name"]: r for r in rows}

    def product(name):  # its rate and share of its bound, beside torch.bmm's
        r = by[name]
        return (f"{r['rate']:.4g} flop/s against {r['peak']:.4g}, {r['bound_ms'] / r['ms']:.3f} of its bound "
                f"(torch.bmm {r['rate'] * r['ms'] / r['library_ms']:.4g}, {r['bound_ms'] / r['library_ms']:.3f})")

    log("calibration (measured against the data sheet's figures the bounds use): "
        f"f32 multiply-adds {by['fma_chain']['rate']:.4g}/s against {by['fma_chain']['peak']:.4g}; f32 matmul "
        f"(FFMA) {product('sgemm')}; TF32 wgmma {product('tf32_mma')}; gather bytes "
        f"{by['gather_rows']['rate']:.4g}/s against {PEAK_BYTES_PER_S:.4g}; exponentials "
        f"{by['inner_math_f32']['rate']:.4g}/s against the SFU's {PEAK_EX2_PER_S:.4g} (card: {smi})")
    fwd_breakdown.stream.cache_clear()  # its binned streams
    sources = {k: src for src, ks in _backend.SOURCE_KERNELS.items() for k in ks}
    kernels = []
    for r in rows:
        entry = {"name": r["name"], "route": "cuda", "source": f"gsplat_tpu_torch/csrc/{sources[r['name']]}.cu",
                 "replaces": MB_REPLACES[r["name"]], "launches": launches[r["name"]],
                 "max_abs_err": errs[r["name"]], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        # the split of a call (primitives.measure: the gathers and the inner
        # math): the card's ms a launch and the host's us a call, the
        # kernel's and, for a gather, torch.gather's
        entry.update({k: r[k] for k in ("device_ms", "host_us", "library_device_ms", "library_host_us") if k in r})
        if r["name"] in MB_ALSO_REPLACES:
            entry["also_replaces"] = MB_ALSO_REPLACES[r["name"]]
            entry.update({k: v for k, v in r.items() if k.startswith("e1_")})
        kernels.append(entry)
    return kernels + grid_entries


# phase 15: multi-GPU rendering (gsplat_tpu_torch/distributed.py). The
# kernels its path launches, and those the two-rank runs launch
DIST_KERNELS = ("emit", "emit_gather", "rasterize_fwd", "rasterize_bwd", "gid_reduce", "rasterize_tiled_fwd",
                "rasterize_2dgs_fwd")
DIST_RANK_KERNELS = ("emit", "emit_gather", "rasterize_fwd", "rasterize_bwd", "gid_reduce", "rasterize_2dgs_fwd")
# a 2DGS strip against the single-device frame: the strip's kernel outputs
# (before the expected-depth division and the normals' rotation) against the
# single-device kernel's rows by the FWD2_* tolerance, every value past it
# explained by the float64 witness (`_witness_2dgs` with the strip's frame
# as one side). The strip evaluates its surfels in its own pixel frame
# (M[1] - y_off * M[2], as JAX does), where the f32 sigma of a near-plane
# surfel cancels otherwise (ROADMAP Queue 3 item 4). Its normals from depth
# are held to depth_to_normal of the strips' assembled depth
WITNESS_STRIP_CHUNK = 16  # pixels a float64 evaluation over the 2.8M surfels of grid5
# the float64 alpha of the strip frame's inputs (shifted in float64) against
# the image frame's, at the attributed pixels: the shift itself is exact math
STRIP_SHIFT_TOL = 1e-6
NFD_TOL = 1e-5
DIST_RANKS = 2


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_scene(torch, dev, grid, W, H, n_ranks, sh_degree=3):
    """Garden `grid` as phase 4 serves it, N padded to a multiple of
    `n_ranks` with masked slots: (render args, live, viewmats [C,4,4], Ks
    [C,3,3])."""
    from gsplat_tpu_torch import splats_from_numpy

    arrays, viewmats, Ks, W0, _ = splat_arrays(grid, sh_degree, SEED)
    Ks = Ks.copy()
    Ks[:, :2, :] *= W / W0
    pad = (-arrays["splat/means"].shape[0]) % n_ranks
    if pad:
        for k, v in arrays.items():
            fill = np.zeros((pad,) + v.shape[1:], v.dtype)  # live False
            if k == "splat/quats":
                fill[:, 0] = 1.0
            arrays[k] = np.concatenate([v, fill])
    splats, live = splats_from_numpy(arrays, device=dev)
    return list(render_args(torch, splats)), live, torch.as_tensor(viewmats, device=dev), torch.as_tensor(Ks, device=dev)


def gate_grads(torch, got, want, names, what):
    """BWD_RTOL / BWD_ATOL on each gradient against the reference's,
    BWD_ATOL relative to its largest |value|. Returns the largest error."""
    errs = []
    for g, w, name in zip(got, want, names):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: gradient of {name} not finite")
        d = (g - w).abs()
        scale = float(w.abs().max())
        bad = d > BWD_RTOL * w.abs() + BWD_ATOL * scale
        if bool(bad.any()):
            raise AssertionError(f"{what}: gradient of {name}: {int(bad.sum())} of {bad.numel()} values off, "
                                 f"max abs {float(d.max()):.3e} against its max {scale:.3e}")
        errs.append(float(d.max()))
    return max(errs)


def gate_2dgs(torch, got, want, what):
    """A 2DGS block against the single-device one: colours (expected depth
    included), alphas, normals, normals from depth and distortion by the
    FWD2 gates, the median by MED_FLIPS. Returns {output: max abs}."""
    errs = {}
    for i, name in ((0, "render"), (1, "alphas"), (2, "normals"), (3, "normals_from_depth"), (4, "distort")):
        if want[i] is not None:
            errs[name] = _flip_gate(torch, name, got[i], want[i], what)
    scale = max(1.0, float(want[5].abs().max())) if want[5].numel() else 1.0
    med_off = float(((got[5] - want[5]).abs() > 1e-5 * scale).float().mean()) if want[5].numel() else 0.0
    if med_off > MED_FLIPS:
        raise AssertionError(f"{what}: median differs at a share {med_off:.3e} of pixels (limit {MED_FLIPS})")
    errs["median share off"] = med_off
    return errs


def diff_stats(torch, got, want):
    """Per 2DGS output: max abs and the share of values off by > 5e-4 and by
    > 2e-4 x max(1, max |want|)."""
    out = {}
    for i, name in enumerate(("render", "alphas", "normals", "normals_from_depth", "distort", "median")):
        if want[i] is None or not want[i].numel():
            continue
        d = (got[i] - want[i]).abs()
        scale = max(1.0, float(want[i].abs().max()))
        out[f"{name} max"] = float(d.max())
        out[f"{name} >5e-4"] = float((d > 5e-4).float().mean())
        out[f"{name} >2e-4s"] = float((d > 2e-4 * scale).float().mean())
    return out


def same_bits(torch, a, b):
    return all((x is None and y is None) or (x.shape == y.shape and torch.equal(x, y)) for x, y in zip(a, b))


def _loss_weights(torch, dev, C, H, W, X):
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    return torch.randn((C, H, W, X), generator=gen, device=dev)


def _render3(rasterization, args, live, vm, K, W, H, cap, backend="binned", **kw):
    return rasterization(*args, vm, K, W, H, sh_degree=3, masks=live, tile_size=MAIN_TILE, backend=backend,
                         isect_capacity=cap, **kw)


def _render2(rasterization_2dgs, args, live, vm, K, W, H, cap, **kw):
    return rasterization_2dgs(*args, vm, K, W, H, sh_degree=3, masks=live, tile_size=MAIN_TILE, backend="binned",
                              isect_capacity=cap, render_mode="RGB+ED", **kw)


def _grads3(torch, rasterization, args, live, vm, K, W, H, cap, w, block=lambda x: x, **kw):
    """Gradients w.r.t. the render args of sum(render * w) + sum(alphas),
    each summed over `block` of the outputs, with the outputs detached."""
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    img, alpha, meta = _render3(rasterization, leaves, live, vm, K, W, H, cap, **kw)
    ((img * block(w)).sum() + alpha.sum()).backward()
    return [p.grad for p in leaves], img.detach(), alpha.detach(), meta


def phase_distributed_world1(smi, dev=None, grid=MAIN_GRID, W=MAIN_W, H=MAIN_H, pg_backend="nccl"):
    """15a: an in-process process group of world size 1 (NCCL on the card):
    rasterization(distributed=True) binned and tiled, rasterization_2dgs
    (distributed=True, RGB+ED) binned, and one 3DGS binned forward and
    backward, each against the single-device call on the same inputs.
    Returns the launch counts of the distributed calls."""
    import torch
    import torch.distributed as dist
    from gsplat_tpu_torch import _backend, rasterization, rasterization_2dgs

    dev = torch.device("cuda") if dev is None else dev
    args, live, vms, Kss = dist_scene(torch, dev, grid, W, H, 1)
    vm, K = vms[:1], Kss[:1]
    names = ("means", "quats", "scales", "opacities", "colors")
    with torch.no_grad():
        cap = _render3(rasterization, args, live, vm, K, W, H, 512)[2]["slab_required"] + 1024
        cap_t = int(_render3(rasterization, args, live, vm, K, W, H, 1 << 20, backend="tiled")[2]["n_isects"]) + 4096
        cap2 = _render2(rasterization_2dgs, args, live, vm, K, W, H, 512)[6]["slab_required"] + 1024
    w = _loss_weights(torch, dev, 1, H, W, 3)
    dist.init_process_group(pg_backend, init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        _backend.reset_launch_counts()
        with torch.no_grad():
            d3 = _render3(rasterization, args, live, vm, K, W, H, cap, distributed=True)
            d3t = _render3(rasterization, args, live, vm, K, W, H, cap_t, backend="tiled", distributed=True)
            d2 = _render2(rasterization_2dgs, args, live, vm, K, W, H, cap2, distributed=True)
        g_d, img_g, alpha_g, _ = _grads3(torch, rasterization, args, live, vm, K, W, H, cap, w, distributed=True)
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        launches = _backend.launch_counts()
        log(f"launches in the world-size-1 distributed path: {launches}")
        for name in DIST_KERNELS:
            if launches[name] == 0:
                raise AssertionError(f"kernel {name} was not launched on the distributed path")
        with torch.no_grad():
            s3 = _render3(rasterization, args, live, vm, K, W, H, cap)
            s3t = _render3(rasterization, args, live, vm, K, W, H, cap_t, backend="tiled")
            s2 = _render2(rasterization_2dgs, args, live, vm, K, W, H, cap2)
        g_s, img_s, alpha_s, _ = _grads3(torch, rasterization, args, live, vm, K, W, H, cap, w)
        for what, d, s in (("3DGS binned", d3, s3), ("3DGS tiled", d3t, s3t), ("3DGS binned fwd+bwd", (img_g, alpha_g), (img_s, alpha_s))):
            e = [_fwd_gate(torch, [d[i]], [s[i]], f"world size 1, {what}, {k}") for i, k in enumerate(("render", "alphas"))]
            log(f"world size 1, {what} against rasterization(): same bits {same_bits(torch, d[:2], s[:2])}, "
                f"render max abs {e[0][0]:.3e} mean {e[0][1]:.3e}, alphas max abs {e[1][0]:.3e}")
        e2 = gate_2dgs(torch, d2[:6], s2[:6], "world size 1, 2DGS binned RGB+ED")
        log(f"world size 1, 2DGS binned RGB+ED against rasterization_2dgs(): same bits {same_bits(torch, d2[:6], s2[:6])}, "
            + ", ".join(f"{k} {v:.3e}" for k, v in e2.items()))
        ge = gate_grads(torch, g_d, g_s, names, "world size 1, 3DGS binned backward")
        log(f"world size 1, 3DGS binned gradients against rasterization()'s: same bits {same_bits(torch, g_d, g_s)}, "
            f"max abs {ge:.3e}; meta: n_isects {d3[2]['n_isects'].tolist()}, slab_required {int(d3[2]['slab_required'])}, "
            f"a2a_bytes_per_device {d3[2]['a2a_bytes_per_device']}")
        if dev.type == "cuda":
            with torch.no_grad():
                ms_d = cuda_ms(torch, lambda: _render3(rasterization, args, live, vm, K, W, H, cap, distributed=True), 5)
                ms_s = cuda_ms(torch, lambda: _render3(rasterization, args, live, vm, K, W, H, cap), 5)
            log(f"world size 1 ({pg_backend}), 3DGS binned frame {W}x{H} (CUDA events, mean of 5): distributed "
                f"{ms_d:.3f} ms, rasterization() {ms_s:.3f} ms, the exchange and its bookkeeping {ms_d - ms_s:.3f} ms "
                f"({smi})")
            with torch.no_grad():
                kd = device_time_by_kernel(torch, lambda: _render3(rasterization, args, live, vm, K, W, H, cap,
                                                                   distributed=True))
                ks = device_time_by_kernel(torch, lambda: _render3(rasterization, args, live, vm, K, W, H, cap))
            log_profile("world size 1, distributed frame", kd, ms_d)
            log_profile("world size 1, rasterization() frame", ks, ms_s)
            extra = sorted(((k, v - ks.get(k, 0.0)) for k, v in kd.items()), key=lambda kv: -kv[1])[:6]
            log("world size 1, device time the distributed frame adds, by kernel: "
                + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in extra))
            with torch.no_grad():
                for what, fn in (("distributed", lambda: _render3(rasterization, args, live, vm, K, W, H, cap,
                                                                  distributed=True)),
                                 ("rasterization()", lambda: _render3(rasterization, args, live, vm, K, W, H, cap))):
                    waits = host_waits(torch, fn)
                    log(f"world size 1, {what} frame: the host's waits on the card (calls, self CPU ms): "
                        + "; ".join(f"{k} {c} {ms:.3f}" for k, (c, ms) in sorted(waits.items()))
                        + f"; device memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
                        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    finally:
        dist.destroy_process_group()
    return launches


def _rank_rows(rank, C, n, H, ts=MAIN_TILE):
    """(y0, y1, strip_h) of rank `rank`'s strip (n % C == 0), by the
    distributed module's own layout."""
    from gsplat_tpu_torch.distributed import strip_layout, strip_rows

    G, _, strip_h = strip_layout(C, n, H, ts)
    return strip_rows(rank % G, strip_h, H) + (strip_h,)


def _rank_block(x, rank, C, n, H, ts=MAIN_TILE):
    """Rank `rank`'s block of a [C, H, ...] single-device output (whole
    cameras, or its strip's rows)."""
    if C % n == 0:
        k = C // n
        return x[rank * k:(rank + 1) * k]
    y0, y1, _ = _rank_rows(rank, C, n, H, ts)
    return x[rank // (n // C): rank // (n // C) + 1, y0:y1]


def strip_normals_check(torch, dist, d2, vm, K, rank, n, H):
    """A strip's normals from depth (C=1) against depth_to_normal of the
    strips' depth, gathered from every rank and assembled: the rows at the
    strip's edges read the neighbouring strip's depth. Returns max abs."""
    from gsplat_tpu_torch.utils import depth_to_normal

    depth = d2[0][..., -1:]
    _, _, strip_h = _rank_rows(rank, 1, n, H)
    buf = depth.new_zeros((1, strip_h) + tuple(depth.shape[2:]))
    buf[:, :depth.shape[1]] = depth
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf)
    full = torch.cat([p[:, :_rank_rows(r, 1, n, H)[1] - _rank_rows(r, 1, n, H)[0]] for r, p in enumerate(parts)],
                     dim=1)
    want = _rank_block(depth_to_normal(full, torch.linalg.inv(vm), K), rank, 1, n, H)
    err = float((d2[3] - want).abs().max())
    if not err <= NFD_TOL:
        raise AssertionError(f"rank {rank}: strip normals from depth off the assembled depth's by {err:.3e} "
                             f"(limit {NFD_TOL})")
    return err


def strip_check_2dgs(torch, args, live, vm, K, W, H, cap, rank, n, d2, want):
    """Rank `rank`'s 2DGS strip of one camera (`d2`, RGB+ED) against the
    single-device frame (`want`, the rank's block). The strip is rebuilt
    here from the single-device projection, its surfels shifted into the
    strip's frame by `_shift_frame` (distributed.py's arithmetic), and its
    kernel outputs post-processed must be the distributed block bit for bit
    (normals from depth apart: they read the neighbours' depth). Its kernel
    outputs (colours, accumulated depth, normals, alpha) are then held to
    the single-device kernel's rows by the FWD2_* tolerance with every value
    past it explained by the float64 witness (the strip's frame as one
    side), and its median by MED_FLIPS. Returns the printed summary."""
    from gsplat_tpu_torch.rendering import postprocess_2dgs, project_and_shade_2dgs, rasterize_shaded_2dgs

    what = f"rank {rank}, strips C=1, 2DGS"
    y0, y1, strip_h = _rank_rows(rank, 1, n, H)
    y_off = (rank % n) * strip_h
    with torch.no_grad():
        s = project_and_shade_2dgs(*args, vm, K, W, H, sh_degree=3, masks=live, render_mode="RGB+ED")

        def raster(m2, M, h):
            return rasterize_shaded_2dgs("binned", m2, M, s.colors, s.normals, s.opacities, s.radii, s.depths, W, h,
                                         MAIN_TILE, cap)[:5]

        full = [o[:, y0:y1] for o in raster(s.means2d, s.ray_transforms, H)]
        m2f, M9f = _shift_frame(torch, s.means2d, s.ray_transforms.reshape(s.radii.shape + (9,)), y_off)
        strip = [o[:, : y1 - y0] for o in raster(m2f, M9f.reshape(M9f.shape[:-1] + (3, 3)), strip_h)]
        post = postprocess_2dgs(*strip, vm, K, "RGB+ED", "expected", False, normals_fn=lambda d: None)
    for i, name in ((0, "render"), (1, "alphas"), (2, "normals"), (4, "distort"), (5, "median")):
        if not torch.equal(post[i], d2[i]):
            raise AssertionError(f"{what}: the strip rebuilt from the single-device projection is not the "
                                 f"distributed block ({name})")
    names = ("colours", "depth", "normals", "alpha")
    split = lambda o: (o[0][..., :3], o[0][..., 3:], o[2], o[1])  # noqa: E731
    geo = (s.means2d, s.ray_transforms, s.opacities, [s.colors[..., :3], s.colors[..., 3:], s.normals], s.radii,
           s.depths)
    summary = _attribute_2dgs(torch, names, split(strip), split(full), geo, W, MAIN_TILE, what,
                              labels=("the strip", "one device"), sides=((_sigma_kernel, y_off), (_sigma_kernel, 0)),
                              row0=y0, chunk=WITNESS_STRIP_CHUNK)
    scale = max(1.0, float(want[5].abs().max())) if want[5].numel() else 1.0
    med_off = float(((d2[5] - want[5]).abs() > 1e-5 * scale).float().mean()) if want[5].numel() else 0.0
    if med_off > MED_FLIPS:
        raise AssertionError(f"{what}: median differs at a share {med_off:.3e} of pixels (limit {MED_FLIPS})")
    return f"the distributed block is the rebuilt strip bit for bit; kernel outputs vs one device: {summary}; " \
           f"median share off {med_off:.3e}"


def _dist_rank(rank, port, out_path, grid, W, H, dev_name):
    """One of DIST_RANKS gloo ranks on one card (15b): the cases of
    phase_distributed_ranks, each rank's block against its block of the
    single-device call. Writes its numbers to `out_path` (JSON)."""
    import torch
    import torch.distributed as dist
    from gsplat_tpu_torch import _backend, rasterization, rasterization_2dgs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev_name)
    n = DIST_RANKS
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    out = {"rank": rank, "cases": []}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=n, rank=rank)
    try:
        args, live, vms, Kss = dist_scene(torch, dev, grid, W, H, n)
        N = args[0].shape[0]
        rows = slice(rank * (N // n), (rank + 1) * (N // n))
        mine = [a[rows] for a in args]
        live_r = live[rows]
        names = ("means", "quats", "scales", "opacities", "colors")
        launches = {k: 0 for k in DIST_RANK_KERNELS}

        def timed(fn):
            """fn()'s result and ms on the host's clock after one warm-up
            call, its launches added to `launches`."""
            fn()
            sync()
            _backend.reset_launch_counts()
            t0 = time.perf_counter()
            r = fn()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            for k in launches:
                launches[k] += _backend.launch_counts()[k]
            return r, ms

        for C in (1, 2):
            vm, K = vms[:C], Kss[:C]
            layout = "strips" if C < n else "whole cameras"
            w = _loss_weights(torch, dev, C, H, W, 3)
            with torch.no_grad():  # the budget of all C cameras: enough for a rank's share
                cap = _render3(rasterization, args, live, vm, K, W, H, 512)[2]["slab_required"] + 1024
                cap2 = _render2(rasterization_2dgs, args, live, vm, K, W, H, 512)[6]["slab_required"] + 1024
            blk = lambda x: _rank_block(x, rank, C, n, H)  # noqa: E731
            # 3DGS binned forward and backward
            (g_d, img_d, alpha_d, meta), ms = timed(lambda: _grads3(
                torch, rasterization, mine, live_r, vm, K, W, H, cap, w, block=blk, distributed=True))
            g_s, img_s, alpha_s, _ = _grads3(torch, rasterization, args, live, vm, K, W, H, cap, w)
            e = [_fwd_gate(torch, [a], [blk(b)], f"rank {rank}, {layout} C={C}, 3DGS {k}")
                 for a, b, k in ((img_d, img_s, "render"), (alpha_d, alpha_s, "alphas"))]
            ge = gate_grads(torch, g_d, [g[rows] for g in g_s], names, f"rank {rank}, {layout} C={C}, 3DGS backward")
            out["cases"].append({"case": f"{layout} C={C} 3DGS binned fwd+bwd", "ms": ms, "render_max_abs": e[0][0],
                                 "render_mean_abs": e[0][1], "alphas_max_abs": e[1][0], "grad_max_abs": ge,
                                 "same_bits": same_bits(torch, [img_d, alpha_d], [blk(img_s), blk(alpha_s)]),
                                 "n_isects": meta["n_isects"].tolist(), "slab_required": int(meta["slab_required"]),
                                 "a2a_bytes_per_device": meta["a2a_bytes_per_device"]})
            # 2DGS binned forward
            with torch.no_grad():
                d2, ms = timed(lambda: _render2(rasterization_2dgs, mine, live_r, vm, K, W, H, cap2, distributed=True))
                s2 = _render2(rasterization_2dgs, args, live, vm, K, W, H, cap2)
            ref2 = [None if x is None else blk(x) for x in s2[:6]]
            case = {"case": f"{layout} C={C} 2DGS binned RGB+ED fwd", "ms": ms, **diff_stats(torch, d2[:6], ref2),
                    "same_bits": same_bits(torch, d2[:6], ref2)}
            out["cases"].append(case)
            try:
                if C < n:
                    case["normals_from_depth vs assembled depth"] = strip_normals_check(torch, dist, d2, vm, K, rank,
                                                                                        n, H)
                    case["witness"] = strip_check_2dgs(torch, args, live, vm, K, W, H, cap2, rank, n, d2, ref2)
                    if cuda:  # the witness's float64 blocks, cached, would crowd the other rank on the card
                        torch.cuda.empty_cache()
                else:
                    gate_2dgs(torch, d2[:6], ref2, f"rank {rank}, {layout} C={C}, 2DGS")
            except AssertionError as e:  # reported with every case's numbers, then raised
                case["failed"] = str(e)
        # the packed exchange, whole cameras, at pack_capacity = pack_required
        vm, K = vms[:2], Kss[:2]
        with torch.no_grad():
            need = int(_render3(rasterization, mine, live_r, vm, K, W, H, cap, distributed=True, packed=True,
                                pack_capacity=1)[2]["pack_required"])
            (img_p, alpha_p, meta_p), ms = timed(lambda: _render3(
                rasterization, mine, live_r, vm, K, W, H, cap, distributed=True, packed=True, pack_capacity=need))
            img_s, alpha_s, _ = _render3(rasterization, args, live, vm, K, W, H, cap)
        blk = lambda x: _rank_block(x, rank, 2, n, H)  # noqa: E731
        e = [_fwd_gate(torch, [a], [blk(b)], f"rank {rank}, packed C=2, 3DGS {k}")
             for a, b, k in ((img_p, img_s, "render"), (alpha_p, alpha_s, "alphas"))]
        if int(meta_p["pack_required"]) != need:
            raise AssertionError(f"rank {rank}: pack_required {meta_p['pack_required']} != {need}")
        out["cases"].append({"case": "packed C=2 3DGS binned fwd", "ms": ms, "pack_capacity": need,
                             "pack_rows_of": N // n, "render_max_abs": e[0][0], "render_mean_abs": e[0][1],
                             "alphas_max_abs": e[1][0],
                             "same_bits": same_bits(torch, [img_p, alpha_p], [blk(img_s), blk(alpha_s)])})
        out["launches"] = launches
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase_distributed_ranks(smi, grid=MAIN_GRID, W=MAIN_W, H=MAIN_H, dev_name="cuda:0"):
    """15b: DIST_RANKS ranks on one card over gloo, spawned here: C=1 as
    strips and C=2 as whole cameras, each 3DGS binned forward and backward
    and 2DGS binned forward, and the packed exchange at pack_capacity =
    pack_required; each rank's block (and its gradient rows) against the
    single-device call. Returns the ranks' summed launch counts."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_dist")
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"rank{r}.json") for r in range(DIST_RANKS)]
    for p in paths + [p + ".err" for p in paths]:
        if os.path.exists(p):
            os.remove(p)
    port = free_port()
    t0 = time.perf_counter()
    try:
        mp.start_processes(_dist_rank_entry, args=(port, paths, grid, W, H, dev_name), nprocs=DIST_RANKS,
                           join=True, start_method="spawn")
    except Exception:
        for r, p in enumerate(paths):
            if os.path.exists(p + ".err"):
                with open(p + ".err") as f:
                    log(f"rank {r} failed:\n{f.read()}")
        raise
    wall = time.perf_counter() - t0
    ranks = []
    for p in paths:
        with open(p) as f:
            ranks.append(json.load(f))
    for r in ranks:
        for c in r["cases"]:
            log(f"two gloo ranks on one card, rank {r['rank']}, {c['case']}: "
                + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in c.items() if k != "case"))
    log(f"two gloo ranks on one card: gloo's all_to_all_single took the CUDA tensors (it stages them through host "
        f"memory); the two ranks share the card, so these times say "
        f"nothing of scaling across cards ({smi}); phase wall time {wall:.1f} s")
    failed = [f"rank {r['rank']}: {c['failed']}" for r in ranks for c in r["cases"] if "failed" in c]
    if failed:
        raise AssertionError("; ".join(failed))
    launches = {k: sum(r["launches"][k] for r in ranks) for k in DIST_RANK_KERNELS}
    log(f"launches in the two ranks' distributed calls: {launches}")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was not launched by the two ranks")
    return launches


def _dist_rank_entry(rank, port, paths, grid, W, H, dev_name):
    try:
        _dist_rank(rank, port, paths[rank], grid, W, H, dev_name)
    except BaseException:  # kept for the parent, which reports every rank's
        import traceback

        with open(paths[rank] + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def phase_distributed(smi):
    """Phase 15: 15a then 15b. Returns {kernel: launches in this phase}."""
    launches = phase_distributed_world1(smi)
    for k, v in phase_distributed_ranks(smi).items():
        launches[k] += v
    return launches


# phase 16: multi-GPU training (simple_trainer{,_2dgs} with distributed=True)
TRAIN_KERNELS_3DGS = ("emit", "emit_gather", "rasterize_fwd", "rasterize_bwd", "gid_reduce")
TRAIN_KERNELS_2DGS = ("emit", "emit_gather", "rasterize_2dgs_fwd", "rasterize_2dgs_bwd", "gid_reduce")
DIST_TRAIN_STEPS_2DGS = 6  # 16a's 2DGS depth: a refine at step 5
DIST_TRAIN_GRID = 1  # 16b's scene
DIST_TRAIN_STEPS = 3  # 16b: a refine at step 2
# the CPU tests' tolerances for the port's ranks against its one device
# (tests/test_torch_trainer_colmap.py's, which
# tests/test_torch_trainer_distributed.py holds its ranks to and these
# to): parameters rtol 1e-4 and atol PARAM_ATOL x the learning rate,
# moments and statistics rtol 1e-4 and atol MOMENT_ATOL x the array's
# largest |value|
PARAM_ATOL, MOMENT_ATOL = 1e-4, 1e-6


def train_config(**kw):
    """Phase 5's training configuration."""
    from gsplat_tpu_torch.simple_trainer import Config

    return Config(**{**dict(max_steps=TRAIN_STEPS, sh_degree=3, sh_degree_interval=1, refine_start_iter=3,
                            refine_every=5, tile_size=MAIN_TILE, backend="binned", pool_headroom=1.5, seed=SEED),
                     **kw})


def pool_clone(runner):
    """The runner's whole pool (gathered to rank 0 where distributed; every
    rank calls it), cloned: {name: tensor}, None on the other ranks."""
    whole = runner._gather_pool()
    return None if runner.rank else {k: v.detach().clone() for k, v in whole.items()}


def compare_after_refine(torch, got, want, lrs, what):
    """Two whole pools after a refine. A refine places its candidates in
    the order of their statistics (and MCMC draws its targets from their
    opacities), and on the card those differ in their last bits between
    layouts (the reduce sums another stream in another order), so near
    ties swap slots or targets: the live slots must agree, at most 1e-3 of
    them may hold another Gaussian (a slot off past `compare_pool`'s
    tolerance in any parameter), and each parameter's sum over the live
    slots must lie within 1e-4 of its sum of magnitudes. Returns the
    share of slots off."""
    live = want["live"]
    if not torch.equal(got["live"], live):
        raise AssertionError(f"{what}: the live slots differ at {int((got['live'] != live).sum())} slots")
    off = torch.zeros_like(live)
    for k, w in want.items():
        if not k.startswith("splat/"):
            continue
        lr = next(v for p, v in lrs.items() if k.startswith(p))
        g = got[k]
        bad = ((g - w).abs() > 1e-4 * w.abs() + PARAM_ATOL * lr).reshape(w.shape[0], -1).any(dim=1)
        off |= bad & live
        x, y = g[live].double(), w[live].double()
        err = float(((x.sum(0) - y.sum(0)).abs() / y.abs().sum(0).clamp_min(1e-30)).max())
        if err > 1e-4:
            raise AssertionError(f"{what}: {k} summed over the live slots is off by {err:.3e} of its magnitude")
    share = float(off.sum()) / max(float(live.sum()), 1.0)
    if share > 1e-3:
        raise AssertionError(f"{what}: {int(off.sum())} of {int(live.sum())} live slots hold another Gaussian")
    return share


def pool_lrs(runner):
    """{pool key prefix: learning rate} (the means' at count 0)."""
    lrs = {}
    for k, opt in runner.optimizers.items():
        lr = opt.param_groups[0]["lr"]
        lrs[f"splat/{k}"] = runner.cfg.means_lr * runner.scene_scale if callable(lr) else lr
    return lrs


def compare_pool(torch, got, want, lrs, what, share=0.0):
    """Two whole pools: the same names and shapes, live and the step
    counts equal; splats by PARAM_ATOL x their learning rate, moments and
    statistics by MOMENT_ATOL x their largest |value|; with ``share``, at
    most that share of an array's values past it, none by more than 2 x
    the learning rate or 1e-2 x the largest |value| (the repo's count
    gates). Returns (the same bits, the largest error over its
    tolerance's atol)."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: pools hold {sorted(got)} and {sorted(want)}")
    same, worst = True, 0.0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape:
            raise AssertionError(f"{what}: {k} has shape {tuple(g.shape)}, the reference {tuple(w.shape)}")
        if torch.equal(g, w):
            continue
        same = False
        if w.dtype == torch.bool:
            raise AssertionError(f"{what}: {k} differs at {int((g != w).sum())} slots")
        if k.startswith("splat/"):
            lr = next(v for p, v in lrs.items() if k.startswith(p))
            atol, cap = PARAM_ATOL * lr, 2 * lr
        else:
            scale = max(float(w.abs().max()), 1e-12)
            atol, cap = MOMENT_ATOL * scale, 1e-2 * scale
        d = (g - w).abs()
        bad = d > 1e-4 * w.abs() + atol
        if float(bad.float().mean()) > share or (bool(bad.any()) and float(d.max()) > cap):
            raise AssertionError(f"{what}: {k}: {int(bad.sum())} of {bad.numel()} values off, max abs "
                                 f"{float(d.max()):.3e} (atol {atol:.3e}, share allowed {share})")
        worst = max(worst, float(d.max()) / atol)
    return same, worst


def _timed(torch, dev, fn):
    """(fn(), its ms: CUDA events on the card, the host's clock on the
    CPU)."""
    if dev.type != "cuda":
        h0 = time.perf_counter()
        return fn(), (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    r = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return r, start.elapsed_time(end)


def run_train(torch, runner, steps, record=None, start=0):
    """Steps `start` to `steps - 1`: per step the loss, ms (`_timed`) and
    the host's ms, and whether it refined or grew the pool; with `record`
    (a dict), a refine's pool gather and scatter, timed alike, go into
    record["gather"] / record["scatter"]."""
    out = {"losses": [], "ms": [], "host_ms": [], "refined": [], "grew": []}
    dev = runner.device
    restore = []
    if record is not None:
        for name in ("_gather_pool", "_scatter_pool"):
            real = getattr(runner, name)

            def timed(*a, _real=real, _key=name.strip("_").split("_")[0], **k):
                r, ms = _timed(torch, dev, lambda: _real(*a, **k))
                record.setdefault(_key, []).append(ms)
                return r

            setattr(runner, name, timed)
            restore.append(name)
    try:
        for step in range(start, steps):
            h0 = time.perf_counter()
            o, ms = _timed(torch, dev, lambda: runner.train_step(step))
            out["host_ms"].append((time.perf_counter() - h0) * 1e3)
            out["ms"].append(ms)
            out["losses"].append(float(o["loss"]))
            out["refined"].append(bool(o["refined"]))
            out["grew"].append(bool(o["pool_grew"]))
    finally:
        for name in restore:
            delattr(runner, name)
    return out


def phase_train_distributed_world1(smi, scene, default_steady_ms, dev=None, pg_backend="nccl"):
    """16a: world size 1 under NCCL at phase 5's full width (`scene`,
    phase 5's). Returns ({kernel: launches in the distributed runs},
    summary)."""
    import torch
    import torch.distributed as dist
    from gsplat_tpu_torch import _backend
    from gsplat_tpu_torch.simple_trainer import Runner
    from gsplat_tpu_torch.simple_trainer_2dgs import Runner2DGS

    dev = torch.device("cuda") if dev is None else dev
    cuda = dev.type == "cuda"
    views, points, rgb, scene_scale = scene
    launches = {}
    summary = {}
    dist.init_process_group(pg_backend, init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        for what, cls, steps, kw, kernels in (
            ("3DGS", Runner, TRAIN_STEPS, {}, TRAIN_KERNELS_3DGS),
            ("2DGS", Runner2DGS, DIST_TRAIN_STEPS_2DGS, dict(normal_start=0, dist_start=0), TRAIN_KERNELS_2DGS),
        ):
            t0 = time.perf_counter()
            single = cls(train_config(), views, points, rgb, scene_scale, device=dev, **kw)
            single.probe_isect_capacity()
            ref = run_train(torch, single, steps)
            want = pool_clone(single)
            kern_single, single_ms = {}, float("nan")
            if cuda:  # the same profiled steps on one device, after the pool's clone
                single_ms = cuda_ms(torch, lambda: single.train_step(steps + 1), 3)
                kern_single = device_time_by_kernel(torch, lambda: single.train_step(steps + 2))
            del single
            if cuda:
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            runner = cls(train_config(distributed=True), views, points, rgb, scene_scale, device=dev, **kw)
            runner.probe_isect_capacity()
            _timed(torch, dev, lambda: None)  # the card idle before the counts start
            _backend.reset_launch_counts()
            record = {}
            got = run_train(torch, runner, steps, record)
            counts = _backend.launch_counts()
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            missing = [k for k in kernels if counts[k] == 0]
            if missing:
                raise AssertionError(f"16a {what}: kernels {missing} were not launched on the distributed path")
            if got["losses"] != ref["losses"]:
                raise AssertionError(f"16a {what}: losses {got['losses']} against one device's {ref['losses']}")
            if got["refined"] != ref["refined"] or not any(got["refined"]):
                raise AssertionError(f"16a {what}: refines {got['refined']} against {ref['refined']}")
            same, worst = compare_pool(torch, pool_clone(runner), want, pool_lrs(runner), f"16a {what}")
            if not same:
                raise AssertionError(f"16a {what}: the pool is within the tolerance ({worst:.3e} of its atol) "
                                     "but not the single-device bits")
            steady = [ms for s, ms in enumerate(got["ms"]) if not got["refined"][s]]
            steady_ref = [ms for s, ms in enumerate(ref["ms"]) if not ref["refined"][s]]
            pool_bytes = sum(v.numel() * v.element_size() for v in runner._pool_tensors().values())
            step_ms, kern = float("nan"), {}
            if cuda:
                step_ms = cuda_ms(torch, lambda: runner.train_step(steps + 1), 3)
                kern = device_time_by_kernel(torch, lambda: runner.train_step(steps + 2))
                log_profile(f"16a {what} distributed train step", kern, step_ms)
                log_profile(f"16a {what} single-device train step", kern_single, single_ms)
                extra = sorted(((k, v - kern_single.get(k, 0.0)) for k, v in kern.items()), key=lambda kv: -kv[1])
                log(f"16a {what}: device time the distributed step adds, by kernel: "
                    + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in extra[:8]))
            busy = sum(kern.values()) if kern else float("nan")
            summary[what] = {
                "median_ms": float(np.median(steady)), "median_ms_single": float(np.median(steady_ref)),
                "profiled_ms": step_ms, "idle_share": 1.0 - busy / step_ms, "profiled_ms_single": single_ms,
                "idle_share_single": 1.0 - sum(kern_single.values()) / single_ms if kern_single else float("nan"),
                "gather_ms": record.get("gather", []), "scatter_ms": record.get("scatter", []),
                "pool_bytes": pool_bytes, "slots": runner.pool_size,
            }
            log(f"16a {what}, world size 1 ({pg_backend}), {runner.pool_size} slots, {steps} steps: every loss and the pool "
                f"after the last step (splats, Adam moments, live, the strategy's statistics) are the single-device "
                f"runner's bits; launches {({k: v for k, v in counts.items() if v})}; median step (non-refining "
                f"steps) distributed "
                f"{summary[what]['median_ms']:.3f} ms, single device {summary[what]['median_ms_single']:.3f} ms"
                + (f", phase 5's {default_steady_ms:.3f} ms" if what == "3DGS" else "")
                + f"; profiled step {step_ms:.3f} ms, idle share {summary[what]['idle_share']:.3f} (one device "
                f"{single_ms:.3f} ms, {summary[what]['idle_share_single']:.3f}); refine steps "
                f"{[round(m, 3) for s, m in enumerate(got['ms']) if got['refined'][s]]} ms against one device's "
                f"{[round(m, 3) for s, m in enumerate(ref['ms']) if ref['refined'][s]]}; a refine's gather "
                f"{[round(m, 3) for m in record.get('gather', [])]} ms and scatter "
                f"{[round(m, 3) for m in record.get('scatter', [])]} ms of the {pool_bytes / 1e9:.3f} GB pool; "
                f"{time.perf_counter() - t1:.1f} s distributed, {t1 - t0:.1f} s single ({smi})")
            del runner
            if cuda:
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return launches, summary


DIST_TRAIN_RANK_KERNELS = TRAIN_KERNELS_3DGS + TRAIN_KERNELS_2DGS[2:4] + ("bilagrid_bwd", "bilagrid_lum_bwd")
DIST_TRAIN_CASES = {
    # name: (runner, config, kwargs)
    "3DGS C=2, bilateral grid, two growths": ("3dgs", dict(batch_size=2, use_bilateral_grid=True,
                                                           pool_grow_at=0.5, grow_grad2d=1e-9), {}),
    "3DGS C=1 strips": ("3dgs", dict(batch_size=1, grow_grad2d=1e-9, pool_headroom=3.0), {}),
    "3DGS packed C=2": ("3dgs", dict(batch_size=2, packed=True), {}),
    "2DGS C=2": ("2dgs", dict(batch_size=2), dict(normal_start=0, dist_start=0)),
    "MCMC C=2": ("3dgs", dict(batch_size=2, strategy_name="mcmc"), {}),
}


def _dist_train_rank(rank, port, out_path, dev_name, grid, size, only=None):
    """One of DIST_RANKS gloo ranks on one card (16b): every case of
    DIST_TRAIN_CASES at DIST_RANKS ranks, then on rank 0 the same case in
    a one-rank group; rank 0 compares. Writes its numbers to `out_path`."""
    import torch
    import torch.distributed as dist
    from gsplat_tpu_torch import _backend, rasterization
    from gsplat_tpu_torch.simple_trainer import Runner
    from gsplat_tpu_torch.simple_trainer_2dgs import Runner2DGS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev_name)
    out = {"rank": rank, "cases": []}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=DIST_RANKS, rank=rank)
    try:
        one = dist.new_group([0])
        views, points, rgb, scene_scale = train_scene(torch, rasterization, dev, grid, *size)
        launches = {}
        for name, (kind, cfg_kw, kw) in DIST_TRAIN_CASES.items():
            if only and only not in name:
                continue
            cls = Runner if kind == "3dgs" else Runner2DGS
            cfg_kw = dict(refine_start_iter=1, refine_every=2, max_steps=DIST_TRAIN_STEPS, **cfg_kw)
            if cfg_kw.get("strategy_name") == "mcmc":
                cfg_kw["cap_max"] = int(points.shape[0] * 1.2)

            def make(group, _cls=cls, _cfg=cfg_kw, _kw=kw):
                r = _cls(train_config(distributed=True, **_cfg), views, points, rgb, scene_scale, device=dev,
                         group=group, **_kw)
                if r.cfg.packed:  # no truncation: both world sizes hold every visible row
                    r.pack_capacity = r.live.shape[0]
                # kNN scales are isotropic, so the rotations' true gradient is
                # 0 and Adam steps on rounding noise, which strips round
                # apart: an anisotropic start, as the CPU tests take (the
                # rank's rows of one seeded draw)
                gen = torch.Generator(device=dev).manual_seed(SEED + 11)
                noise = torch.randn((r.pool_size, 3), generator=gen, device=dev) * 0.3
                with torch.no_grad():
                    r.params["scales"] += r._own_rows(noise)
                r.probe_isect_capacity()
                return r

            def run(r):
                """The steps before the refine, the pool then, the refine's
                step, the pool after it."""
                a = run_train(torch, r, DIST_TRAIN_STEPS - 1)
                before = pool_clone(r)
                b = run_train(torch, r, DIST_TRAIN_STEPS, start=DIST_TRAIN_STEPS - 1)
                return {k: a[k] + b[k] for k in a}, before, pool_clone(r)

            runner = make(None)
            _timed(torch, dev, lambda: None)
            _backend.reset_launch_counts()
            got, before, whole = run(runner)
            for k, v in _backend.launch_counts().items():
                launches[k] = launches.get(k, 0) + v
            lrs = pool_lrs(runner)
            case = {"case": name, "step_ms": got["ms"], "host_ms": got["host_ms"], "refined": got["refined"],
                    "grew": got["grew"], "slots": runner.pool_size, "n_live": runner.n_live()}
            del runner
            if rank == 0:
                ref_runner = make(one)
                ref, want_before, want = run(ref_runner)
                del ref_runner
                try:
                    if got["refined"] != ref["refined"] or not any(got["refined"]):
                        raise AssertionError(f"refines {got['refined']} against world size 1's {ref['refined']}")
                    if got["grew"] != ref["grew"]:
                        raise AssertionError(f"growths {got['grew']} against world size 1's {ref['grew']}")
                    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
                    if loss_err > 1e-5:
                        raise AssertionError(f"losses {got['losses']} against world size 1's {ref['losses']}")
                    # strips: the repo's count gate (a gradient that cancels
                    # over the strips' rows rounds apart in a few slots, and
                    # Adam's lr x g / (|g| + eps) turns the rounding of a
                    # gradient near eps into a share of the learning rate)
                    same, worst = compare_pool(torch, before, want_before, lrs, name + ", before the refine",
                                               share=1e-4 if "strips" in name else 0.0)
                    case["slots_off_after_refine"] = compare_after_refine(torch, whole, want, lrs, name)
                    case.update(same_bits=same, worst_over_atol=worst, loss_rel_err=loss_err,
                                world1_step_ms=ref["ms"])
                except AssertionError as e:  # reported with every case's numbers, then raised
                    case["failed"] = str(e)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            dist.barrier()
            out["cases"].append(case)
        out["launches"] = launches
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def _dist_train_rank_entry(rank, port, paths, dev_name, grid, size, only):
    try:
        _dist_train_rank(rank, port, paths[rank], dev_name, grid, size, only)
    except BaseException:  # kept for the parent, which reports every rank's
        import traceback

        with open(paths[rank] + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def phase_train_distributed_ranks(smi, dev_name="cuda:0", grid=DIST_TRAIN_GRID, size=(MAIN_W, MAIN_H), only=None):
    """16b: DIST_RANKS gloo ranks on one card, spawned here (``only``: the
    cases whose name holds it). Returns the ranks' summed launch counts."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_dist_train")
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"rank{r}.json") for r in range(DIST_RANKS)]
    for p in paths + [p + ".err" for p in paths]:
        if os.path.exists(p):
            os.remove(p)
    t0 = time.perf_counter()
    try:
        mp.start_processes(_dist_train_rank_entry, args=(free_port(), paths, dev_name, grid, size, only),
                           nprocs=DIST_RANKS, join=True, start_method="spawn")
    except Exception:
        for r, p in enumerate(paths):
            if os.path.exists(p + ".err"):
                with open(p + ".err") as f:
                    log(f"rank {r} failed:\n{f.read()}")
        raise
    wall = time.perf_counter() - t0
    ranks = []
    for p in paths:
        with open(p) as f:
            ranks.append(json.load(f))
    for i, case in enumerate(ranks[0]["cases"]):
        per_rank = "; ".join(f"rank {r['rank']} step ms {[round(m, 1) for m in r['cases'][i]['step_ms']]}"
                             for r in ranks)
        log(f"16b two gloo ranks, {case['case']}: {case['slots']} slots, {case['n_live']} live after "
            f"{DIST_TRAIN_STEPS} steps, refined {case['refined']}, grew {case['grew']}; against world size 1: "
            + (f"FAILED {case['failed']}" if "failed" in case else
               f"before the refine same bits {case['same_bits']}, worst error {case['worst_over_atol']:.3e} of its "
               f"atol; after it a share {case['slots_off_after_refine']:.3e} of the live slots holds another "
               f"Gaussian; losses within {case['loss_rel_err']:.3e}; world size 1 step ms "
               f"{[round(m, 1) for m in case['world1_step_ms']]}")
            + f"; {per_rank}")
    log(f"16b: the two ranks share the card and gloo stages their collectives through host memory, so these "
        f"times say nothing of scaling across cards ({smi}); phase wall time {wall:.1f} s")
    failed = [f"{c['case']}: {c['failed']}" for c in ranks[0]["cases"] if "failed" in c]
    if failed:
        raise AssertionError("; ".join(failed))
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    missing = [k for k in DIST_TRAIN_RANK_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"16b: kernels {missing} were not launched by the two ranks")
    log(f"16b launches in the two ranks' training: {launches}")
    return launches


def phase_train_distributed(smi, scene, default_steady_ms):
    """Phase 16: 16a then 16b. Returns {kernel: launches in this phase}."""
    launches, _ = phase_train_distributed_world1(smi, scene, default_steady_ms)
    for k, v in phase_train_distributed_ranks(smi).items():
        launches[k] = launches.get(k, 0) + v
    return launches


# phase 17: the apps (compression, LPIPS, the trainer's --compression png and
# --lpips-weights, both viewers, the profiling and compress-eval scripts)
APPS_PSNR_FLOOR = 20.0  # dB, the full-count round trip's render against the original (PERF.md §6 PR 19)
APPS_LPIPS_RTOL = 1e-4  # the card's LPIPS against the port's CPU value on a 256x256 crop
APPS_LPIPS_CROP = 256
# shN's K-means round-trip MSE over that of one centroid (the column
# means): at most 1.25 x the 0.6121 of the full count on the card (PERF.md
# §6 PR 19), where the same codebook with shuffled labels reads ~1.4
APPS_KMEANS_LIMIT = 0.765
APPS_KMEANS_SUB = (4096, 64)  # rows and clusters of the card's K-means against the CPU's
APPS_KMEANS_RATIO = 1.25  # its MSE over the CPU's: the CPU test's bound against scikit-learn
APPS_TRAIN_STEPS = 2
APPS_VIEWER_FRAMES = 8
APPS_KERNELS = ("emit", "emit_gather", "rasterize_fwd")  # every render of the phase
APPS_TRAIN_KERNELS = APPS_KERNELS + ("rasterize_bwd", "gid_reduce")


def colmap_root():
    """Phase 13's directory; it keeps its scene (``scene/``) for phase 17,
    which removes the directory."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_colmap")


def _quantization_check(torch, prepared, back, what):
    """Each PNG field of the round trip within half a quantization step
    (8 bits; the means 16 bits, in the log space they are stored in) of
    the array that was quantized, channel by channel. Returns the largest
    error over its step, by field."""
    from gsplat_tpu_torch.utils import log_transform

    out = {}
    for name, levels in (("means", 2**16 - 1), ("scales", 255), ("quats", 255), ("opacities", 255), ("sh0", 255)):
        want = prepared[name].reshape(prepared[name].shape[0], -1).astype(np.float64)
        got = back[name]
        if name == "means":
            got = log_transform(torch.from_numpy(got)).numpy()
        got = got.reshape(got.shape[0], -1).astype(np.float64)
        span = np.maximum(want.max(0) - want.min(0), 1e-12)
        # half a step, and the float32 rounding of the quantization and of
        # the decoded value (a few ulps of the range and of the value)
        err = float((np.abs(got - want) / (0.5 * span / levels + 1e-6 * (span + np.abs(want)))).max())
        out[name] = err
        if not err <= 1.0:
            raise AssertionError(f"{what}: {name} off by {err:.3f} x its bound (half a step) after the round trip")
    return out


def _kmeans_check(torch, dev, want, got, npz, kmeans):
    """17a's gate on the K-means of the full count: shN's round-trip MSE
    (``got`` decoded against ``want``) over one centroid's at most
    APPS_KMEANS_LIMIT, where the control, the same codebook (``npz``) with
    its labels shuffled, must exceed it; then ``kmeans`` on APPS_KMEANS_SUB
    rows spread over the scene, on ``dev`` within APPS_KMEANS_RATIO of the
    CPU's MSE. Returns the readings."""
    def mse(a, b):
        return float(((a - b) ** 2).mean())

    x = torch.as_tensor(want.reshape(want.shape[0], -1), device=dev)
    one = mse(x, x.mean(0, keepdim=True))
    out = {"kmeans": mse(x, torch.as_tensor(got.reshape(got.shape[0], -1), device=dev)) / one}
    with np.load(npz) as z:
        c = torch.as_tensor(z["centroids"].astype(np.float32), device=dev)
        labels = torch.as_tensor(z["labels"].astype(np.int64), device=dev)
    perm = torch.randperm(labels.shape[0], generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    out["shuffled"] = mse(x, c[labels[perm]]) / one
    del c, labels, perm
    n, k = APPS_KMEANS_SUB
    sub = x[:: x.shape[0] // n][:n]
    for name, d in (("sub_card", dev), ("sub_cpu", torch.device("cpu"))):
        cs, ls = kmeans(sub.to(d), k)
        out[name] = mse(sub.to(d), cs[ls])
    if not (out["kmeans"] <= APPS_KMEANS_LIMIT < out["shuffled"]
            and out["sub_card"] <= APPS_KMEANS_RATIO * out["sub_cpu"]):
        raise AssertionError(f"17a K-means: {out} (limit {APPS_KMEANS_LIMIT}, the card's subsample MSE at most "
                             f"{APPS_KMEANS_RATIO} x the CPU's)")
    return out


def _psnr(torch, a, b):
    mse = float(((a.clamp(0, 1) - b.clamp(0, 1)) ** 2).mean())
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_apps_compression(smi, dev, out_dir):
    """17a: PngCompression of the garden grid5 scene at full count (K-means
    at 65,536 clusters on the card), twice; the round trip rendered at
    1920x1080 against the original. Returns the round trip's PSNR."""
    import torch
    from gsplat_tpu_torch import splats_from_numpy
    from gsplat_tpu_torch.compression import PngCompression, png_compression
    from gsplat_tpu_torch.simple_viewer import SplatRenderer

    arrays, viewmats, Ks, W0, _ = splat_arrays(MAIN_GRID, 3, SEED)
    Ks = Ks.copy()
    Ks[:, :2, :] *= MAIN_W / W0
    fields = {k[len("splat/"):]: v for k, v in arrays.items() if k.startswith("splat/")}
    N = fields["means"].shape[0]
    km_s = []
    kmeans = png_compression.kmeans

    def timed_kmeans(*a, **kw):
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = kmeans(*a, **kw)
        _sync(torch, dev)
        km_s.append(time.perf_counter() - t0)
        return out

    png_compression.kmeans = timed_kmeans
    try:
        runs = []
        for run in range(2):
            cdir = os.path.join(out_dir, f"compression_{run}")
            comp = PngCompression(device=str(dev))
            t0 = time.perf_counter()
            prepared = comp.compress(cdir, fields)
            t1 = time.perf_counter()
            back = comp.decompress(cdir)
            t2 = time.perf_counter()
            size = sum(os.path.getsize(os.path.join(cdir, f)) for f in os.listdir(cdir))
            runs.append((back, size, t1 - t0, t2 - t1, {f: os.path.getsize(os.path.join(cdir, f))
                                                         for f in sorted(os.listdir(cdir))}))
    finally:
        png_compression.kmeans = kmeans
    (back, size, comp_s, dec_s, files), (back2, size2, comp2_s, dec2_s, _) = runs
    if sorted(back) != sorted(back2) or not all(np.array_equal(back[k], back2[k]) for k in back):
        raise AssertionError("decompress(compress(x)) differs between two runs")
    side = int(N**0.5)
    n = side * side
    if back["means"].shape[0] != n or back["shN"].shape != (n, 15, 3):
        raise AssertionError(f"round trip shapes {[(k, v.shape) for k, v in back.items()]}, expected {n} splats")
    quant = _quantization_check(torch, prepared, back, "17a")
    shn_mse = float(((back["shN"] - prepared["shN"]) ** 2).mean())
    km = _kmeans_check(torch, dev, prepared["shN"], back["shN"], os.path.join(out_dir, "compression_0", "shN.npz"),
                       kmeans)
    log(f"17a compression of {N} splats (cropped to {side}^2 = {n}): {size} bytes ({size / N:.2f} B a splat; "
        f"{', '.join(f'{f} {b}' for f, b in files.items())}), compress {comp_s:.2f} s and {comp2_s:.2f} s "
        f"(of it the K-means at {min(65536, n)} clusters on the card {km_s[0]:.2f} s and {km_s[1]:.2f} s), "
        f"decompress {dec_s:.2f} s and {dec2_s:.2f} s; the two runs the same arrays ({size2} bytes); each PNG "
        f"field within half its quantization step (largest error over it: "
        f"{', '.join(f'{k} {v:.3f}' for k, v in quant.items())}); shN's K-means MSE {shn_mse:.4e} against its "
        f"variance {float(prepared['shN'].var()):.4e}; over one centroid's MSE {km['kmeans']:.4f} (limit "
        f"{APPS_KMEANS_LIMIT}; the codebook with shuffled labels {km['shuffled']:.4f}); K-means of "
        f"{APPS_KMEANS_SUB[0]} rows at {APPS_KMEANS_SUB[1]} clusters, MSE on the card {km['sub_card']:.4e} against "
        f"the CPU's {km['sub_cpu']:.4e} (at most {APPS_KMEANS_RATIO}x) (card: {smi})")

    def render(f, live=None):
        splats, _ = splats_from_numpy(f, device=dev)
        return SplatRenderer(splats, live, 3)(
            torch.as_tensor(viewmats[:1], device=dev), torch.as_tensor(Ks[:1], device=dev), MAIN_W, MAIN_H)

    with torch.no_grad():
        img0, _, meta0 = render(fields)
        img1, _, meta1 = render(back)
    if not (torch.isfinite(img0).all() and torch.isfinite(img1).all()):
        raise AssertionError("17a: a render is not finite")
    psnr = _psnr(torch, img1, img0)
    log(f"17a camera 0 at {MAIN_W}x{MAIN_H} (binned): the round trip's render against the original's PSNR "
        f"{psnr:.3f} dB (floor {APPS_PSNR_FLOOR}), n_isects {int(meta0['n_isects'])} and {int(meta1['n_isects'])} "
        f"(card: {smi})")
    if not psnr > APPS_PSNR_FLOOR:
        raise AssertionError(f"17a: round-trip PSNR {psnr:.3f} dB under its floor {APPS_PSNR_FLOOR}")
    return psnr


def lpips_weights(net_type, path):
    """Random LPIPS weights (`init_random_params`, seed SEED) written to
    ``path`` as the .npz `load_lpips_params` reads."""
    from gsplat_tpu_torch import lpips

    p = lpips.init_random_params(net_type, SEED, device="cpu")
    arrays = {f"conv{i}_{k}": t.numpy() for i, wb in enumerate(p["convs"]) for k, t in zip("wb", wb)}
    arrays.update({f"lin{i}_w": w.numpy() for i, w in enumerate(p["lins"])})
    np.savez(path, **arrays)
    return path


def phase_apps_lpips(smi, dev, out_dir):
    """17b: LPIPS alex and vgg at 1920x1080 on the card from random weights
    read back through load_lpips_params: lpips(x, x) == 0, the card's
    value against the port's CPU value on a 256x256 crop, each call timed.
    Returns {net: npz path}."""
    import torch
    from gsplat_tpu_torch import lpips

    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((1, MAIN_H, MAIN_W, 3), generator=gen, device=dev)
    y = (x + 0.1 * torch.randn((1, MAIN_H, MAIN_W, 3), generator=gen, device=dev)).clamp(0, 1)
    paths = {}
    for net in ("alex", "vgg"):
        paths[net] = lpips_weights(net, os.path.join(out_dir, f"lpips_{net}.npz"))
        params = lpips.load_lpips_params(paths[net], net, device=dev)
        norm = net == "alex"
        same = float(lpips.lpips(params, x, x, net, norm))
        val = float(lpips.lpips(params, x, y, net, norm))
        ms = cuda_ms(torch, lambda: lpips.lpips(params, x, y, net, norm), 3)
        c = APPS_LPIPS_CROP
        crop = float(lpips.lpips(params, x[:, :c, :c], y[:, :c, :c], net, norm))
        cpu = float(lpips.lpips(lpips.load_lpips_params(paths[net], net, device="cpu"), x[:, :c, :c].cpu(),
                                y[:, :c, :c].cpu(), net, norm))
        rel = abs(crop - cpu) / abs(cpu)
        log(f"17b LPIPS {net} at {MAIN_W}x{MAIN_H}: lpips(x, x) {same}, lpips(x, y) {val:.6f}, {ms:.3f} ms a call "
            f"(CUDA events, cuDNN TF32 off); {c}x{c} crop card {crop:.8f} against CPU {cpu:.8f} (relative "
            f"{rel:.3e}, rtol {APPS_LPIPS_RTOL}) (card: {smi})")
        if same != 0.0 or not np.isfinite(val) or not val > 0 or not rel <= APPS_LPIPS_RTOL:
            raise AssertionError(f"17b LPIPS {net}: lpips(x, x) {same}, lpips(x, y) {val}, crop {crop} vs CPU {cpu}")
    return paths


def phase_apps_trainer(smi, dev, data, out_dir, weights):
    """17c: simple_trainer.main on phase 13's COLMAP scene with
    --compression png and --lpips-weights, one eval and save step; the
    compressed eval's launches counted. Returns (its checkpoint, those
    launches)."""
    import torch
    from gsplat_tpu_torch import _backend
    from gsplat_tpu_torch import simple_trainer as st

    res = os.path.join(out_dir, "r")
    step = APPS_TRAIN_STEPS
    seen = {}
    run_compression = st.Runner.run_compression

    def counted(self, s):
        _sync(torch, dev)
        before = _backend.launch_counts()
        t0 = time.perf_counter()
        out = run_compression(self, s)
        _sync(torch, dev)
        seen["s"] = time.perf_counter() - t0
        seen["launches"] = {k: v - before[k] for k, v in _backend.launch_counts().items()}
        return out

    st.Runner.run_compression = counted
    try:
        t0 = time.perf_counter()
        st.main(["default", "--data-dir", data, "--data-factor", "1", "--result-dir", res, "--max-steps", str(step),
                 "--eval-steps", str(step), "--save-steps", str(step), "--white-bkgd", "--tile-size", str(MAIN_TILE),
                 "--seed", str(SEED), "--compression", "png", "--lpips-weights", weights], device=dev)
        run_s = time.perf_counter() - t0
    finally:
        st.Runner.run_compression = run_compression
    report = json.load(open(os.path.join(res, f"compression_{step}", "report.json")))
    val = json.load(open(os.path.join(res, f"val_step{step}.json")))
    launches = seen["launches"]
    missing = [k for k in APPS_KERNELS if launches[k] == 0]
    if missing or "lpips" not in val or "lpips" not in report or not np.isfinite(report["psnr"]):
        raise AssertionError(f"17c: kernels {missing} not launched by the compressed eval; report {report}; val {val}")
    log(f"17c simple_trainer.main --compression png --lpips-weights ({step} steps, {run_s:.1f} s): "
        f"compression_{step}/report.json {report} ({seen['s']:.2f} s: compress, round trip, eval); val_step{step}.json "
        f"{val}; launches of the compressed eval {({k: v for k, v in launches.items() if v})} (card: {smi})")
    return os.path.join(res, f"ckpt_{step}.npz"), launches


def phase_apps_viewers(smi, dev, out_dir, ckpt):
    """17d: simple_viewer (8 frames of the fixture grid5 at 1920x1080, read
    back) and interactive_viewer (the checkpoint, served on 127.0.0.1 in a
    thread; one GET a mode, each decoded frame equal to Viewer.frame's)."""
    import threading
    import urllib.request

    from gsplat_tpu_torch import interactive_viewer, simple_viewer
    from gsplat_tpu_torch.datasets.image_io import decode_png, read_png

    frames_dir = os.path.join(out_dir, "frames")
    t0 = time.perf_counter()
    # the interpolated path through the fixture's 3 cameras: n_frames // 7
    # poses a pair of them (the JAX viewer's), so 28 asks for 8 frames
    simple_viewer.main(["--scene-grid", str(MAIN_GRID), "--n-frames", str(7 * APPS_VIEWER_FRAMES // 2),
                        "--width", str(MAIN_W), "--height", str(MAIN_H), "--output-dir", frames_dir], device=dev)
    view_s = time.perf_counter() - t0
    names = sorted(f for f in os.listdir(frames_dir) if f.endswith(".png"))
    imgs = [read_png(os.path.join(frames_dir, f)) for f in names]
    if len(imgs) != APPS_VIEWER_FRAMES or any(i.shape != (MAIN_H, MAIN_W, 3) for i in imgs):
        raise AssertionError(f"17d simple_viewer: {names}, shapes {[i.shape for i in imgs]}")
    if not all(i.std() > 0 for i in imgs):
        raise AssertionError("17d simple_viewer: a frame is flat")

    args = interactive_viewer.parse_args(["--ckpt", ckpt, "--width", str(MAIN_W), "--height", str(MAIN_H)])
    viewer = interactive_viewer.build_viewer(args, dev)
    httpd = interactive_viewer.serve(viewer, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    got_ms = {}
    try:
        port = httpd.server_address[1]
        pan = np.zeros(3)
        for mode in interactive_viewer.MODES:
            url = f"http://127.0.0.1:{port}/render?az=0.8&el=0.4&r={viewer.r0}&tx=0&ty=0&tz=0&mode={mode}"
            h0 = time.perf_counter()
            with urllib.request.urlopen(url, timeout=120) as resp:
                body = resp.read()
            got_ms[mode] = (time.perf_counter() - h0) * 1e3
            img = decode_png(body)
            want = viewer.frame(0.8, 0.4, viewer.r0, pan, mode)
            if img.shape != (MAIN_H, MAIN_W, 3) or not np.array_equal(img, want):
                raise AssertionError(f"17d interactive viewer: the {mode} frame served differs from Viewer.frame's")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    log(f"17d simple_viewer: {len(imgs)} frames of {MAIN_W}x{MAIN_H} in {view_s:.2f} s, read back; "
        f"interactive viewer on 127.0.0.1 ({MAIN_W}x{MAIN_H}, the 17c checkpoint, binned budget "
        f"{viewer.render.capacity}): each mode's GET equal to Viewer.frame's, "
        f"{', '.join(f'{k} {v:.1f} ms' for k, v in got_ms.items())} a request (card: {smi})")


def phase_apps_scripts(smi, dev, data, ckpt, out_dir):
    """17e: scripts/torch_profiling.py and scripts/torch_compress_eval.py as
    subprocesses (a nonzero exit fails the phase)."""
    root = os.path.dirname(os.path.abspath(__file__))
    csv_path = os.path.join(out_dir, "compression.csv")
    cpu = ["--cpu"] if dev.type == "cpu" else []
    cmds = {
        "torch_profiling": ["--scene-grid", str(MAIN_GRID), "--resolutions", f"{MAIN_W}x{MAIN_H}", *cpu],
        "torch_compress_eval": ["--ckpt", ckpt, "--data-dir", data, "--out-csv", csv_path, *cpu],
    }
    outs = {}
    for name, argv in cmds.items():
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.join(root, "scripts", f"{name}.py"), *argv], cwd=root,
                           capture_output=True, text=True)
        outs[name] = p.stdout
        if p.returncode != 0:
            raise AssertionError(f"17e scripts/{name}.py exited {p.returncode}:\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        log(f"17e scripts/{name}.py ({time.perf_counter() - t0:.1f} s): "
            + " | ".join(line for line in p.stdout.splitlines()[-4:] if line.strip()) + f" (card: {smi})")
    rows = [line for line in open(csv_path).read().splitlines() if line and not line.startswith("#")]
    if len(rows) != 4 or (dev.type == "cuda" and "rasterize_tiled_fwd" not in outs["torch_profiling"]):
        raise AssertionError(f"17e: the CSV's rows {rows}; the profiling's auto backend did not launch the tiled "
                             "forward")


def phase_apps(smi, data, dev=None):
    """Phase 17: the apps on the card (17a-e; ``dev`` the CPU only to
    rehearse it). The launch counts are set to 0 before and read after (the
    scripts' subprocesses count their own). Returns {kernel: launches in
    this phase}."""
    import shutil

    import torch
    from gsplat_tpu_torch import _backend

    dev = torch.device("cuda") if dev is None else dev
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_apps")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        _backend.reset_launch_counts()
        phase_apps_compression(smi, dev, out_dir)
        weights = phase_apps_lpips(smi, dev, out_dir)
        ckpt, compressed_eval = phase_apps_trainer(smi, dev, data, out_dir, weights["alex"])
        phase_apps_viewers(smi, dev, out_dir, ckpt)
        _sync(torch, dev)
        launches = _backend.launch_counts()
        if dev.type == "cuda":
            torch.cuda.empty_cache()  # the scripts' processes share the card
        phase_apps_scripts(smi, dev, data, ckpt, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.rmtree(colmap_root(), ignore_errors=True)
    missing = [k for k in APPS_TRAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"phase 17: kernels {missing} were not launched")
    log(f"launches in the apps path (17a-d): {launches}; of them the compressed eval's {compressed_eval}")
    return launches


def main():
    smi = phase_device()
    import torch

    t0 = time.perf_counter()
    phase_build()
    phase_kernel_vs_plain()
    phase_kernel_vs_plain_2dgs()
    phase_kernel_vs_plain_tiled()
    t1 = time.perf_counter()
    phase_serving(smi)
    t2 = time.perf_counter()
    kernels, scene, default_steady_ms = phase_train(smi)
    t3 = time.perf_counter()
    (shared_2dgs, kernels_2dgs), runner_2dgs = phase_train_2dgs(scene)
    for k in kernels:
        k.update(shared_2dgs.get(k["name"], {}))
    kernels += kernels_2dgs
    t4 = time.perf_counter()
    fixture_fields = phase_serving_2dgs((runner_2dgs.params, runner_2dgs.live))
    for k in kernels:
        k.update(fixture_fields.get(k["name"], {}))
    del runner_2dgs
    t5 = time.perf_counter()
    phase_serving_tiled()
    kernels += phase_train_tiled(scene)
    kernels_tiled_2dgs, runner_tiled_2dgs = phase_train_tiled_2dgs(scene)
    kernels += kernels_tiled_2dgs
    phase_serving_tiled_2dgs((runner_tiled_2dgs.params, runner_tiled_2dgs.live))
    t6 = time.perf_counter()
    phase_op_api()
    t7 = time.perf_counter()
    mcmc_launches = phase_train_mcmc(scene, default_steady_ms)
    for k in kernels:
        if k["name"] in mcmc_launches and k["name"] in ("emit", "emit_gather", "rasterize_fwd", "rasterize_bwd",
                                                        "gid_reduce"):
            k["launches_mcmc"] = mcmc_launches[k["name"]]
    t8 = time.perf_counter()
    colmap_launches, colmap_launches_2dgs, colmap_errs, colmap_errs_2dgs = phase_colmap(smi, default_steady_ms)
    for k in kernels:
        if k["name"] in colmap_errs:
            k["launches_colmap"] = colmap_launches[k["name"]]
            k["max_abs_err_colmap"] = colmap_errs[k["name"]]
        if k["name"] in colmap_errs_2dgs:
            k["launches_colmap_2dgs"] = colmap_launches_2dgs[k["name"]]
            k["max_abs_err_colmap_2dgs"] = colmap_errs_2dgs[k["name"]]
    t9 = time.perf_counter()
    mb = phase_microbench(smi)
    for k in mb:
        if k["name"] in ("bilagrid_bwd", "bilagrid_lum_bwd"):  # their main path is phase 13's
            k["launches"] = colmap_launches[k["name"]]
            k["max_abs_err_colmap"] = colmap_errs[k["name"]]
    kernels += mb
    t10 = time.perf_counter()
    dist_launches = phase_distributed(smi)
    for k in kernels:
        if k["name"] in DIST_KERNELS:
            k["launches_distributed"] = dist_launches[k["name"]]
    t11 = time.perf_counter()
    train_dist_launches = phase_train_distributed(smi, scene, default_steady_ms)
    for k in kernels:
        if train_dist_launches.get(k["name"], 0):
            k["launches_distributed_training"] = train_dist_launches[k["name"]]
    t12 = time.perf_counter()
    apps_launches = phase_apps(smi, os.path.join(colmap_root(), "scene"))
    for k in kernels:
        k["launches_apps"] = apps_launches.get(k["name"], 0)
    t13 = time.perf_counter()
    log(f"phase wall times: build + kernel vs plain {t1 - t0:.1f} s, serving {t2 - t1:.1f} s, "
        f"training {t3 - t2:.1f} s, 2DGS training {t4 - t3:.1f} s, 2DGS serving {t5 - t4:.1f} s, "
        f"tiled serving and training {t6 - t5:.1f} s, op API {t7 - t6:.1f} s, MCMC training {t8 - t7:.1f} s, "
        f"COLMAP trainer {t9 - t8:.1f} s, micro-benchmarks {t10 - t9:.1f} s, multi-GPU rendering {t11 - t10:.1f} s, "
        f"multi-GPU training {t12 - t11:.1f} s, apps {t13 - t12:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {smi}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
