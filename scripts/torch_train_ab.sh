#!/bin/bash
# Three alternating pairs (P C, C P, P C) of chip_smoke.py's training and
# 2DGS serving phases (5, 6, 7, 9 and 10: Runner, Runner2DGS and its
# trained surfels served binned, both trainers with backend="tiled", and
# the tiled trained surfels served tiled) on a checkout of another tree (P,
# for example the parent commit unpacked with `git archive` into
# build/parent) and on this one (C), on one CUDA card; each run's log goes
# to chiprun_out/pair<N>_<P|C>.log and its step times, bench.py's measure,
# the reduce lines, the 2DGS frame and stage times and view 0's losses to
# stdout.
#
#     bash scripts/torch_train_ab.sh build/parent
set -u
parent=${1:?usage: torch_train_ab.sh PARENT_DIR}
here=$(cd "$(dirname "$0")/.." && pwd)
mkdir -p "$here/chiprun_out"
smoke() {
  (cd "$1" && python3 -c "
import time, chip_smoke as c
smi = c.phase_device(); c.phase_build()
t0 = time.perf_counter()
k, scene = c.phase_train(smi)
_, r = c.phase_train_2dgs(scene)
c.phase_serving_2dgs((r.params, r.live))
del r
c.phase_train_tiled(scene)
_, r = c.phase_train_tiled_2dgs(scene)
c.phase_serving_tiled_2dgs((r.params, r.live))
print('phases 5, 6, 7, 9, 10 done in', round(time.perf_counter() - t0, 1), 's')
")
}
for pair in 1 2 3; do
  if [ "$pair" = 2 ]; then order="C P"; else order="P C"; fi
  for t in $order; do
    if [ "$t" = P ]; then dir=$parent; else dir=$here; fi
    log="$here/chiprun_out/pair${pair}_$t.log"
    smoke "$dir" > "$log" 2>&1
    echo "pair $pair tree $t rc $?"
    grep -E "train step ms|bench.py measure|reduce at the|reduce path|view 0 loss|2DGS serving path|2DGS stage ms|phases 5, 6, 7|Error" "$log" | cut -c1-260
  done
done
