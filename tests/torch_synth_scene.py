"""A tiny synthetic COLMAP scene for the port's dataset and trainer tests,
written once per process by gsplat_tpu_torch.datasets.synth on the CPU:
2,000 of the garden fixture's splats as the ground truth, 6 views of
64x48 on a circle (view 0 is the validation view at test_every 8), 300
initial points with each view's observations."""

import functools
import tempfile

import numpy as np

N_SPLATS, N_VIEWS, W, H, N_POINTS = 2000, 6, 64, 48, 300


@functools.lru_cache(maxsize=None)
def scene_dir() -> str:
    from gsplat_tpu_torch import load_test_data
    from gsplat_tpu_torch.datasets import synth

    means, quats, scales, opac, colors, *_ = load_test_data()
    sub = np.random.default_rng(0).choice(len(means), N_SPLATS, replace=False)
    splats = dict(means=means[sub], quats=quats[sub], scales=scales[sub], opacities=opac[sub], colors=colors[sub])
    out = tempfile.mkdtemp(prefix="synth_scene_")
    synth.write_scene(out, splats, N_VIEWS, W, H, N_POINTS, seed=3, device="cpu")
    return out

