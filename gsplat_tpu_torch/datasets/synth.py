"""Synthetic COLMAP scenes from splats (port of
scripts/make_synth_dataset.py).

`write_scene` renders ground-truth images of given splats with the port's
``rasterization`` (the binned backend: its kernels on the card, their
plain versions on the CPU) over a white background, from cameras on a
circle around the splats looking at their centre, and writes a COLMAP
binary model (``sparse/0/{cameras,images,points3D}.bin``, one PINHOLE
camera) and the images as PNGs (``images/view_###.png``). The initial
points are a seeded sample of the splats' means and colours. Unlike the
JAX script, each image also lists its 2D observations: the initial points
in front of it that project inside the frame (and each point its track),
so that a trainer's depth loss has points to read.

    python -m gsplat_tpu_torch.datasets.synth --out DIR --n-views 16 \
        --width 324 --height 210 --n-points 40000

By default the ground truth is the fixture's splats as they are (all of
them, or a sorted seeded sample of ``--gt-splats``). ``--jax-scene``
builds the JAX script's scene instead (`jax_scene`): a seeded, unsorted
sample of ``--gt-splats`` (default 120,000) of the fixture's means and
colours, isotropic scales from the mean of the 2nd-4th nearest-neighbour
distances clipped to [5e-3, 0.05], identity quaternions and opacity 0.9;
the cameras from those float32 points; the initial points drawn by the same
generator after the sample, in its order. Camera poses, intrinsics, splats,
points and colours are then the JAX script's; the images are this
package's render of them (the JAX script's is its oracle's).

``--fisheye`` writes the JAX script's OPENCV_FISHEYE scene: each view is
rendered with ``camera_model="fisheye"`` (the ideal equidistant frame),
then warped into the distorted capture frame, which the `Parser`'s
theta-polynomial remap inverts back: the capture pixel at distorted
radius rho_d samples the ideal image at the rho that solves rho (1 + k1
rho^2 + ... + k4 rho^8) = rho_d (12 Newton steps in float64), through
`image_io.remap_bilinear` with the edge repeated (cv2's
``BORDER_REPLICATE`` in the JAX script). cameras.bin holds model 5 with
k = (0.06, 0.012, 0, 0). The observations stay the pinhole projections of
the points.
"""

from __future__ import annotations

import argparse
import os
import struct
import time
from typing import Dict, Optional

import numpy as np
import torch

from .colmap_io import POINT2D_RECORD, POINT_RECORD
from .image_io import remap_bilinear, write_png

FISHEYE_K = (0.06, 0.012, 0.0, 0.0)  # the JAX script's k1..k4


def fisheye_capture_maps(W: int, H: int, f: float, k=FISHEYE_K):
    """(mapx, mapy) float32 [H, W]: where each pixel of the distorted
    capture frame samples the ideal equidistant render
    (scripts/make_synth_dataset.py:134-155)."""
    k1, k2, k3, k4 = k
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64), indexing="xy")
    xd = (uu - W // 2) / f
    yd = (vv - H // 2) / f
    rho_d = np.sqrt(xd**2 + yd**2)
    rho = rho_d.copy()
    for _ in range(12):
        poly = rho * (1 + k1 * rho**2 + k2 * rho**4 + k3 * rho**6 + k4 * rho**8)
        dpoly = 1 + 3 * k1 * rho**2 + 5 * k2 * rho**4 + 7 * k3 * rho**6 + 9 * k4 * rho**8
        rho = rho - (poly - rho_d) / dpoly
    radial = np.where(rho_d > 1e-9, rho / np.clip(rho_d, 1e-9, None), 1.0)
    return (f * xd * radial + W / 2).astype(np.float32), (f * yd * radial + H / 2).astype(np.float32)


def look_at(eye, target, up=np.array([0.0, 0.0, 1.0])):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def rotmat_to_qvec(R):
    K = (
        np.array(
            [
                [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
                [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
                [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
                 R[0, 0] + R[1, 1] + R[2, 2]],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def _scatter_rows(buf: np.ndarray, offsets: np.ndarray, rows: np.ndarray, chunk: int = 1 << 18) -> None:
    """buf[offsets[i] : offsets[i] + rows.shape[1]] = rows[i], in chunks."""
    width = np.arange(rows.shape[1])
    for s in range(0, len(offsets), chunk):
        buf[offsets[s : s + chunk, None] + width] = rows[s : s + chunk]


def _points3d_bin(xyz, rgb, obs_image, obs_point, obs_index) -> bytes:
    """points3D.bin: each point's record, then its track of (image id,
    point2D index) pairs in image order."""
    n = len(xyz)
    counts = np.bincount(obs_point, minlength=n)
    rec_len = POINT_RECORD.itemsize + 8 * counts
    offs = 8 + np.concatenate([[0], np.cumsum(rec_len)[:-1]]).astype(np.int64)
    buf = np.zeros(8 + int(rec_len.sum()), np.uint8)
    buf[:8] = np.frombuffer(struct.pack("<Q", n), np.uint8)
    head = np.zeros(n, POINT_RECORD)
    head["id"] = np.arange(1, n + 1)
    head["xyz"] = xyz
    head["rgb"] = rgb
    head["err"] = 0.5
    head["track_len"] = counts
    _scatter_rows(buf, offs, head.view(np.uint8).reshape(n, POINT_RECORD.itemsize))
    order = np.lexsort((obs_image, obs_point))
    track = np.zeros(len(order), [("image_id", "<i4"), ("point2d_idx", "<i4")])
    track["image_id"] = obs_image[order]
    track["point2d_idx"] = obs_index[order]
    pt = obs_point[order]
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = offs[pt] + POINT_RECORD.itemsize + 8 * (np.arange(len(order)) - first[pt])
    _scatter_rows(buf, pos, track.view(np.uint8).reshape(-1, 8))
    return buf.tobytes()


def circle_cameras(pts: np.ndarray, n_views: int, W: int, H: int):
    """(K [3, 3], world-to-camera [n_views, 4, 4]), float64: `n_views`
    cameras on a circle around `pts` looking at their mean, the JAX script's
    (its centre and radius in the dtype of `pts`)."""
    center = pts.mean(axis=0)
    radius = 1.2 * np.percentile(np.linalg.norm(pts - center, axis=1), 90)
    f = 0.85 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float64)
    c2ws = []
    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        eye = center + radius * np.array([np.cos(th), np.sin(th), 0.45 + 0.15 * np.sin(3 * th)])
        c2ws.append(look_at(eye, center))
    return K, np.linalg.inv(np.stack(c2ws))


def jax_scene(means: np.ndarray, colors: np.ndarray, gt_splats: int, n_points: int, seed: int):
    """The JAX script's ground truth and initial points
    (scripts/make_synth_dataset.py:86-96, :196) from the fixture's `means`
    and `colors`: (splats, keep), `keep` the rows of the splats that are
    the initial points, in the generator's order."""
    from ..modules import knn_distances

    rng = np.random.default_rng(seed)
    sub = rng.choice(len(means), size=min(len(means), gt_splats), replace=False)
    pts, cols = means[sub], colors[sub]
    d = knn_distances(pts, k=4)[:, 1:].mean(axis=1)
    splats = {
        "means": pts,
        "quats": np.tile(np.array([1, 0, 0, 0], np.float32), (len(pts), 1)),
        "scales": np.tile(np.clip(d, 5e-3, 0.05)[:, None], (1, 3)).astype(np.float32),
        "opacities": np.full((len(pts),), 0.9, np.float32),
        "colors": cols,
    }
    keep = rng.choice(len(pts), size=min(n_points, len(pts)), replace=False)
    return splats, keep


def write_scene(
    out: str,
    splats: Dict[str, np.ndarray],
    n_views: int,
    width: int,
    height: int,
    n_points: int,
    seed: int = 3,
    device="cuda",
    tile_size: int = 16,
    keep: Optional[np.ndarray] = None,
    cameras=None,
    fisheye: bool = False,
) -> Dict:
    """Render `splats` (means [N,3], quats [N,4], scales [N,3] and
    opacities [N] activated, colors [N,3] in [0, 1]) from `n_views` cameras
    at width x height and write the COLMAP scene to `out`, with a seeded
    `n_points` of the means and colours as its points (or the rows `keep`,
    in that order). The cameras are `circle_cameras` of the float64 means,
    or `cameras` = (K, world-to-camera) where given; with `fisheye` an
    OPENCV_FISHEYE camera (the module's docstring). Returns {"render_s",
    "write_s", "bytes", "observations"}."""
    from .._backend import resolve_device
    from ..rendering import rasterization

    device = resolve_device(device)
    means = np.asarray(splats["means"], np.float64)
    W, H = width, height
    K, w2cs = circle_cameras(means, n_views, W, H) if cameras is None else cameras
    f = K[0, 0]

    img_dir = os.path.join(out, "images")
    sp = os.path.join(out, "sparse", "0")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(sp, exist_ok=True)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    gt = [t(splats[k]) for k in ("means", "quats", "scales", "opacities", "colors")]
    Kt = t(K)[None]
    bg = torch.ones((1, 3), device=device)
    model = "fisheye" if fisheye else "pinhole"
    names, frames = [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(n_views):
            vm = t(w2cs[i])[None]
            need = rasterization(*gt, vm, Kt, W, H, backend="binned", isect_capacity=512,
                                 tile_size=tile_size, camera_model=model)[2]["slab_required"]
            img = rasterization(*gt, vm, Kt, W, H, backgrounds=bg, backend="binned",
                                isect_capacity=int(need) + 1024, tile_size=tile_size, camera_model=model)[0]
            frames.append((img[0].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
            names.append(f"view_{i:03d}.png")
    if fisheye:
        mapx, mapy = fisheye_capture_maps(W, H, f)
        frames = [remap_bilinear(fr, mapx, mapy, border="replicate") for fr in frames]
    render_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    nbytes = sum(write_png(os.path.join(img_dir, n), fr) for n, fr in zip(names, frames))

    if keep is None:
        rng = np.random.default_rng(seed)
        keep = np.sort(rng.choice(len(means), size=min(n_points, len(means)), replace=False))
    xyz = means[keep]
    rgb = (np.asarray(splats["colors"])[keep] * 255).astype(np.uint8)
    obs = []  # per image: (point rows, xy)
    for i in range(n_views):
        pc = xyz @ w2cs[i, :3, :3].T + w2cs[i, :3, 3]
        uv = pc @ K.T
        uv = uv[:, :2] / np.clip(uv[:, 2:3], 1e-9, None)
        sel = (pc[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
        obs.append((np.nonzero(sel)[0], uv[sel]))

    with open(os.path.join(sp, "cameras.bin"), "wb") as fo:
        fo.write(struct.pack("<Q", 1))
        if fisheye:
            fo.write(struct.pack("<iiQQ", 1, 5, W, H))  # OPENCV_FISHEYE
            fo.write(struct.pack("<8d", f, f, W / 2, H / 2, *FISHEYE_K))
        else:
            fo.write(struct.pack("<iiQQ", 1, 1, W, H))  # PINHOLE
            fo.write(struct.pack("<4d", f, f, W / 2, H / 2))
    with open(os.path.join(sp, "images.bin"), "wb") as fo:
        fo.write(struct.pack("<Q", n_views))
        for i in range(n_views):
            rows, xy = obs[i]
            fo.write(struct.pack("<i", i + 1))
            fo.write(struct.pack("<7d", *rotmat_to_qvec(w2cs[i, :3, :3]), *w2cs[i, :3, 3]))
            fo.write(struct.pack("<i", 1))
            fo.write(names[i].encode() + b"\x00")
            fo.write(struct.pack("<Q", len(rows)))
            rec = np.zeros(len(rows), POINT2D_RECORD)
            rec["xy"] = xy
            rec["id3"] = rows + 1
            fo.write(rec.tobytes())
    obs_image = np.concatenate([np.full(len(r), i + 1, np.int64) for i, (r, _) in enumerate(obs)])
    obs_point = np.concatenate([r for r, _ in obs])
    obs_index = np.concatenate([np.arange(len(r)) for r, _ in obs])
    with open(os.path.join(sp, "points3D.bin"), "wb") as fo:
        fo.write(_points3d_bin(xyz, rgb, obs_image, obs_point, obs_index))
    nbytes += sum(os.path.getsize(os.path.join(sp, n)) for n in os.listdir(sp))
    return {"render_s": render_s, "write_s": time.perf_counter() - t0, "bytes": nbytes,
            "observations": int(len(obs_point))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-views", type=int, default=16)
    ap.add_argument("--width", type=int, default=324)
    ap.add_argument("--height", type=int, default=210)
    ap.add_argument("--n-points", type=int, default=40000)
    ap.add_argument("--scene-grid", type=int, default=1,
                    help="the garden fixture tiled scene_grid x scene_grid: its splats are the ground truth")
    ap.add_argument("--gt-splats", type=int, default=None,
                    help="a seeded sample of this many of the fixture's splats as the ground truth (default: all; "
                         "with --jax-scene 120000)")
    ap.add_argument("--jax-scene", action="store_true",
                    help="the ground truth, cameras and points of scripts/make_synth_dataset.py (its pinhole path)")
    ap.add_argument("--fisheye", action="store_true",
                    help="an OPENCV_FISHEYE scene: the views rendered with camera_model='fisheye' and warped into "
                         "the distorted capture frame")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the kernels' plain versions")
    args = ap.parse_args(argv)
    from .._helper import load_test_data

    means, quats, scales, opac, colors, _, _, _, _ = load_test_data(scene_grid=args.scene_grid)
    keep = cameras = None
    if args.jax_scene:
        gt = 120_000 if args.gt_splats is None else args.gt_splats
        splats, keep = jax_scene(means, colors, gt, args.n_points, args.seed)
        cameras = circle_cameras(splats["means"], args.n_views, args.width, args.height)
    else:
        if 0 < (args.gt_splats or 0) < len(means):
            sub = np.sort(np.random.default_rng(args.seed).choice(len(means), args.gt_splats, replace=False))
            means, quats, scales, opac, colors = (a[sub] for a in (means, quats, scales, opac, colors))
        splats = {"means": means, "quats": quats, "scales": scales, "opacities": opac, "colors": colors}
    n = len(splats["means"])
    info = write_scene(args.out, splats, args.n_views, args.width, args.height, args.n_points,
                       seed=args.seed, device=args.device, keep=keep, cameras=cameras, fisheye=args.fisheye)
    print(f"wrote a synthetic COLMAP scene of {n} splats to {args.out}: {args.n_views} views at "
          f"{args.width}x{args.height}, {min(args.n_points, n)} points, {info['observations']} "
          f"observations, {info['bytes']} bytes; render {info['render_s']:.2f} s, write {info['write_s']:.2f} s")
    if args.jax_scene:
        info["splats"], info["keep"] = splats, keep
    return info


if __name__ == "__main__":
    main()
