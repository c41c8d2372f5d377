#!/bin/bash
# Three alternating pairs (P C, C P, P C) of chip_smoke.py's serving,
# training and 2DGS serving phases (4-10: the binned 3DGS frame, Runner,
# Runner2DGS and its trained surfels served binned, the tiled 3DGS frame,
# both trainers with backend="tiled", and the tiled trained surfels served
# tiled) on a checkout of another tree (P, for example the parent commit
# unpacked with `git archive` into build/parent) and on this one (C), on
# one CUDA card, each run also printing the peak device memory of one
# binned 2DGS frame (RGB+ED, camera 0) of the fixture surfels and of the
# trained surfels; each run's log goes to chiprun_out/pair<N>_<P|C>.log and
# its frame, stage and step times, bench.py's measure, the reduce lines,
# the peak memory and view 0's losses to stdout.
#
#     bash scripts/torch_train_ab.sh build/parent
set -u
parent=${1:?usage: torch_train_ab.sh PARENT_DIR}
here=$(cd "$(dirname "$0")/.." && pwd)
mkdir -p "$here/chiprun_out"
smoke() {
  (cd "$1" && python3 -c "
import time, torch, chip_smoke as c
from gsplat_tpu_torch import rasterization_2dgs, splats_from_numpy

def peak_2dgs(name, splats, live):
    arrays, vms, Ks, W0, _ = c.splat_arrays(c.MAIN_GRID, 3, c.SEED)
    Ks = Ks.copy()
    Ks[:, :2, :] *= c.MAIN_W / W0
    vm, K = torch.as_tensor(vms[:1], device='cuda'), torch.as_tensor(Ks[:1], device='cuda')
    f = lambda cap: rasterization_2dgs(*c.render_args(torch, splats), vm, K, c.MAIN_W, c.MAIN_H, sh_degree=3,
                                       masks=live, tile_size=c.MAIN_TILE, backend='binned', isect_capacity=cap,
                                       render_mode='RGB+ED')
    with torch.no_grad():
        cap = f(512)[6]['slab_required'] + 1024
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        f(cap)
        torch.cuda.synchronize()
    print('binned 2DGS frame peak memory,', name + ':', torch.cuda.max_memory_allocated() - base,
          'bytes above the', base, 'held before it', flush=True)

smi = c.phase_device(); c.phase_build()
t0 = time.perf_counter()
c.phase_serving(smi)
k, scene = c.phase_train(smi)
_, r = c.phase_train_2dgs(scene)
c.phase_serving_2dgs((r.params, r.live))
peak_2dgs('trained surfels', r.params, r.live)
del r
arrays = c.splat_arrays(c.MAIN_GRID, 3, c.SEED)[0]
peak_2dgs('fixture surfels', *splats_from_numpy(arrays, device='cuda'))
c.phase_serving_tiled()
c.phase_train_tiled(scene)
_, r = c.phase_train_tiled_2dgs(scene)
c.phase_serving_tiled_2dgs((r.params, r.live))
print('phases 4-10 done in', round(time.perf_counter() - t0, 1), 's')
")
}
for pair in 1 2 3; do
  if [ "$pair" = 2 ]; then order="C P"; else order="P C"; fi
  for t in $order; do
    if [ "$t" = P ]; then dir=$parent; else dir=$here; fi
    log="$here/chiprun_out/pair${pair}_$t.log"
    smoke "$dir" > "$log" 2>&1
    echo "pair $pair tree $t rc $?"
    grep -E "serving path|stage ms|train step ms|bench.py measure|reduce at the|reduce path|view 0 loss|peak memory|phases 4-10|Error" "$log" | cut -c1-300
  done
done
