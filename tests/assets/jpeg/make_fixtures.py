"""Write the JPEG fixtures of this directory with PIL, each beside its PIL
decoding (``np.asarray(Image.open(f).convert("RGB"))``) as a PNG written by
gsplat_tpu_torch.datasets.image_io.write_png.

    python tests/assets/jpeg/make_fixtures.py [NAME ...]

With names, only those fixtures are written. The 1920x1080 fixtures are
the port's CPU render of the garden fixture's camera 0 (binned backend,
plain versions; ~25 s); the progressive one has no PNG of its own: its
PIL decoding is the baseline file's (the same quantized coefficients),
which this script checks. same_png.json names each fixture held to
another's PNG (the one place its readers look it up). README.md lists
the files.
"""

import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from gsplat_tpu_torch.datasets.image_io import write_png  # noqa: E402


def pattern(h, w, seed):
    """Smooth bands plus seeded noise, RGB uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 7.0) * 60 + np.cos(yy / 5.0) * 50 + 120)[..., None] + np.arange(3) * 30
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def garden_1080p():
    import torch

    from gsplat_tpu_torch import load_test_data, rasterization

    means, quats, scales, opac, colors, viewmats, Ks, W, _ = load_test_data()
    K = Ks[:1].copy()
    K[:, :2] *= 1920 / W
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    args = [t(a) for a in (means, quats, scales, opac, colors, viewmats[:1], K)]
    with torch.no_grad():
        need = rasterization(*args, 1920, 1080, backend="binned", isect_capacity=512)[2]["slab_required"]
        img = rasterization(*args, 1920, 1080, backend="binned", isect_capacity=int(need) + 1024)[0]
    return (img[0].clamp(0, 1) * 255).to(torch.uint8).numpy()


def fixtures():
    """name -> (image or the function that makes it, PIL save options)."""
    grey = pattern(31, 45, 4)[..., 0]
    # 16-bit quantization tables (values past 255) make PIL write SOF1
    coarse = [list(range(1, 65)), [min(300 + 7 * i, 900) for i in range(64)]]
    return {
        "q75_444_97x61": (pattern(61, 97, 0), dict(quality=75, subsampling=0)),
        "q50_422_restart_97x61": (pattern(61, 97, 1), dict(quality=50, subsampling=1, restart_marker_blocks=3)),
        "q95_420_33x17": (pattern(17, 33, 2), dict(quality=95, subsampling=2)),
        "grey_q75_45x31": (grey, dict(quality=75)),
        "sof1_16bit_tables_47x33": (pattern(33, 47, 3), dict(qtables=coarse)),
        "rgb_adobe_q90_17x9": (pattern(9, 17, 5), dict(quality=90, keep_rgb=True)),
        "garden_1080p_q85": (garden_1080p, dict(quality=85)),
        "prog_q80_420_restart_97x61": (pattern(61, 97, 6),
                                       dict(quality=80, subsampling=2, restart_marker_blocks=4, progressive=True)),
        "prog_grey_q75_45x31": (pattern(31, 45, 7)[..., 0], dict(quality=75, progressive=True)),
        "garden_1080p_q85_progressive": (garden_1080p, dict(quality=85, progressive=True)),
    }


# a fixture held to another's PNG
with open(os.path.join(HERE, "same_png.json")) as f:
    SAME_PNG = json.load(f)


def main(names=None):
    render = {}
    for name, (img, opts) in fixtures().items():
        if names and name not in names:
            continue
        if callable(img):  # the render, made once
            if img not in render:
                render[img] = img()
            img = render[img]
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", **opts)
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        if name in SAME_PNG:
            from gsplat_tpu_torch.datasets.image_io import read_png

            other = os.path.join(HERE, SAME_PNG[name] + ".png")
            if not np.array_equal(read_png(other), want):
                raise SystemExit(f"{name}: PIL's decoding differs from {other}")
        else:
            write_png(os.path.join(HERE, name + ".png"), want)
        with open(os.path.join(HERE, name + ".jpg"), "wb") as f:
            f.write(buf.getvalue())
        print(name, img.shape, len(buf.getvalue()), "bytes")


if __name__ == "__main__":
    main(sys.argv[1:])
