"""The compression round trip of a trained checkpoint, as a CSV of
{variant, n_gaussians, bytes, psnr, ssim} (port of scripts/compress_eval.py).

From a checkpoint of the port's trainer (or the JAX trainer's), the live
splats (rendered at the SH degree the checkpoint holds) are compressed
with `PngCompression` in three layouts: unsorted,
the serpentine sort (the default) and the serpentine sort with
`plas_refine`. Each is decompressed into the pool and evaluated on the
scene's validation views (`Runner.eval_round_trip`). The CSV ends with the
uncompressed evaluation as a comment line. Runs on the card unless
``--cpu`` asks for the CPU.

    python scripts/torch_compress_eval.py --ckpt results/garden/ckpt_7000.npz \\
        --data-dir data/garden --out-csv results/garden/compression.csv
"""

import argparse
import csv
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from gsplat_tpu_torch import simple_trainer  # noqa: E402
from gsplat_tpu_torch.compression import PngCompression  # noqa: E402

VARIANTS = [
    ("unsorted", dict(use_sort=False)),
    ("serpentine", dict(use_sort=True)),
    ("serpentine+plas", dict(use_sort=True, plas=True)),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--out-csv", required=True)
    ap.add_argument("--data-factor", type=int, default=1)
    ap.add_argument("--white-bkgd", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    result_dir = os.path.join(os.path.dirname(os.path.abspath(args.ckpt)), "compress_eval")
    with np.load(args.ckpt) as ckpt:  # the SH degree the checkpoint carries
        n_sh = 1 + next((ckpt[k].shape[1] for k in ("splat/shN", "shN") if k in ckpt.files), 0)
    cfg = simple_trainer.Config(data_dir=args.data_dir, data_factor=args.data_factor, result_dir=result_dir,
                                white_bkgd=args.white_bkgd, test_every=8,
                                sh_degree=int(round(n_sh**0.5)) - 1)
    runner = simple_trainer.Runner.from_colmap(cfg, device=device)
    step = runner.load(args.ckpt)
    n_gs = runner.n_live()

    def keep_val_json(name):
        # eval() writes val_step{step}.json: keep each evaluation's own
        src = os.path.join(result_dir, f"val_step{step}.json")
        if os.path.exists(src):
            os.replace(src, os.path.join(result_dir, f"val_step{step}_{name}.json"))

    base = runner.eval(step)
    keep_val_json("uncompressed")
    rows = []
    for name, kw in VARIANTS:
        cdir = os.path.join(result_dir, f"compression_{name}")
        size, stats = runner.eval_round_trip(PngCompression(device=device, **kw), cdir, step)
        keep_val_json(name)
        rows.append({"variant": name, "n_gaussians": stats["num_GS"], "bytes": size,
                     "psnr": round(float(stats["psnr"]), 4), "ssim": round(float(stats["ssim"]), 4)})
        print(name, rows[-1], flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out_csv)), exist_ok=True)
    with open(args.out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["variant", "n_gaussians", "bytes", "psnr", "ssim"])
        w.writeheader()
        w.writerows(rows)
        f.write(f"# uncompressed: n_gaussians={n_gs} psnr={float(base['psnr']):.4f}\n")
    print("wrote", args.out_csv)
    return rows


if __name__ == "__main__":
    main()
