"""The port's PNG compression (gsplat_tpu_torch/compression/) against the
JAX package's (gsplat_tpu/compression/), on the CPU at fixture scale.

- sort_splats gives JAX's permutation at N = 1,000 (cropped to 31^2, as
  compress crops) and 1,024, with and without PLAS, and JAX's Morton order
  where N is no square.
- The files: for the same splats, meta.json and the pixels of every PNG
  (read with PIL) equal JAX's. The one difference between the pipelines is
  the log transform of the means: XLA's log1p and torch's differ in the
  last bits on about a fifth of the values (torch's within an ulp of
  float64, XLA's within 2), which can move a 16-bit level, or a Morton
  cell, by one. So the pixel test gives
  both packages the same transform (the port's module takes JAX's), and a
  second test holds the untouched pipelines to the same rows of every
  8-bit field and the means within one 16-bit step.
- Each package's decompress of the other's directory equals its decompress
  of its own, bit for bit (all fields but shN, whose K-means differs by
  design), and the two packages decode one directory alike (the means to
  XLA's expm1, within 4 ulps).
- The K-means (torch: greedy k-means++ seeding, Lloyd's passes) at 16 and 64 clusters over 4,096 rows has a
  round-trip MSE at most 1.25x scikit-learn's MiniBatchKMeans with JAX's
  settings on the same rows; with k = N it is exact up to float16.
- Empty fields and fields with no codec of their own (npz) pass through.
"""

import functools
import json
import os
import tempfile

import numpy as np
import pytest
import torch
from PIL import Image

import gsplat_tpu.compression.png_compression as jpc
from gsplat_tpu.compression import PngCompression as JaxPng
from gsplat_tpu.compression.sort import sort_splats as jax_sort
from gsplat_tpu.utils import inverse_log_transform as jax_ilog
from gsplat_tpu.utils import log_transform as jax_log
from gsplat_tpu_torch import PngCompression
from gsplat_tpu_torch.compression import png_compression as tpc
from gsplat_tpu_torch.compression.sort import sort_splats
from gsplat_tpu_torch.utils import inverse_log_transform, log_transform

from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

PNG_FIELDS = ("means_l", "means_u", "scales", "quats", "opacities", "sh0")


@functools.lru_cache(maxsize=None)
def _splats(n, shn=True):
    """n of the garden fixture's splats in the trainer's layout, with seeded
    degree-3 SH rest bands (or none)."""
    from gsplat_tpu_torch import load_test_data

    means, quats, scales, opac, colors, *_ = load_test_data()
    sub = np.random.default_rng(1).choice(len(means), n, replace=False)
    rng = np.random.default_rng(2)
    op = np.clip(opac[sub], 1e-4, 1 - 1e-4)
    out = {
        "means": means[sub], "scales": np.log(scales[sub]), "quats": quats[sub],
        "opacities": np.log(op / (1 - op)).astype(np.float32), "sh0": colors[sub][:, None, :],
        "shN": (0.1 * rng.standard_normal((n, 15 if shn else 0, 3))).astype(np.float32),
    }
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def _jax_log(x):
    return torch.from_numpy(np.array(jax_log(x.numpy())))


@functools.lru_cache(maxsize=None)
def _dirs(n):
    """(JAX's directory, the port's, the port's with JAX's log transform) of
    _splats(n), written once per process."""
    tmp = tempfile.mkdtemp(prefix="compression_")
    d_jax, d_port, d_same = (os.path.join(tmp, f"{w}_{n}") for w in ("jax", "port", "same"))
    JaxPng().compress(d_jax, dict(_splats(n)))
    PngCompression(device="cpu").compress(d_port, dict(_splats(n)))
    real = tpc.log_transform
    tpc.log_transform = _jax_log
    try:
        PngCompression(device="cpu").compress(d_same, dict(_splats(n)))
    finally:
        tpc.log_transform = real
    return d_jax, d_port, d_same


@pytest.fixture
def dirs():
    return _dirs(1000)


def _png(d, name):
    return np.asarray(Image.open(os.path.join(d, f"{name}.png")))


@pytest.mark.parametrize("plas", [False, True])
@pytest.mark.parametrize("n", [1000, 1024])
def test_sort_splats_gives_jax_permutation(n, plas):
    sp = {k: v for k, v in _splats(n).items() if k != "shN"}
    s = int(n**0.5)
    keep = np.argsort(sp["opacities"])[n - s * s:]
    sp = {k: v[keep] for k, v in sp.items()}
    got, want = sort_splats(dict(sp), n_sidelen=s, plas=plas), jax_sort(dict(sp), n_sidelen=s, plas=plas)
    for k in sp:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got, want = sort_splats(dict(_splats(n))), jax_sort(dict(_splats(n)))  # no grid: the Morton order alone
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_transforms_lie_within_an_ulp_of_float64():
    """The port's log transform and its inverse lie within an ulp of a
    float64 evaluation rounded to float32; XLA's within 2 and 4 (so the
    packages' transforms differ in the last bits)."""
    x = _splats(1000)["means"].copy()
    x64 = x.astype(np.float64)
    want = (np.sign(x64) * np.log1p(np.abs(x64))).astype(np.float32)
    got = log_transform(torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    np.testing.assert_array_max_ulp(np.asarray(jax_log(x)), want, maxulp=2)
    y64 = got.astype(np.float64)
    want = (np.sign(y64) * np.expm1(np.abs(y64))).astype(np.float32)
    np.testing.assert_array_max_ulp(inverse_log_transform(torch.from_numpy(got)).numpy(), want, maxulp=1)
    np.testing.assert_array_max_ulp(np.asarray(jax_ilog(got)), want, maxulp=4)


def test_files_equal_jax_for_the_same_transform(dirs):
    d_jax, _, d_same = dirs
    assert sorted(os.listdir(d_same)) == sorted(os.listdir(d_jax))
    meta = json.load(open(os.path.join(d_same, "meta.json")))
    assert meta == json.load(open(os.path.join(d_jax, "meta.json")))
    assert meta["means"]["shape"] == [961, 3] and meta["shN"]["n_clusters"] == 961
    for name in PNG_FIELDS:
        got, want = _png(d_same, name), _png(d_jax, name)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_files_hold_jax_rows_with_the_port_transform(dirs):
    """The untouched pipelines: every 8-bit field holds the same rows (a
    splat's pixels), and each splat's means lie within one 16-bit step of
    JAX's, matched by its 8-bit rows."""
    d_jax, d_port, _ = dirs
    mj, mp = (json.load(open(os.path.join(d, "meta.json"))) for d in (d_jax, d_port))
    for name in ("scales", "quats", "opacities", "sh0"):
        assert mp[name] == mj[name], name
    np.testing.assert_array_max_ulp(np.float32(mp["means"]["mins"]), np.float32(mj["means"]["mins"]), 1)
    np.testing.assert_array_max_ulp(np.float32(mp["means"]["maxs"]), np.float32(mj["means"]["maxs"]), 1)

    def rows(d):
        eight = np.concatenate([_png(d, n).reshape(961, -1) for n in ("scales", "quats", "opacities", "sh0")], 1)
        means = (_png(d, "means_u").astype(np.int64) << 8) + _png(d, "means_l")
        order = np.lexsort(eight.T[::-1])
        return eight[order], means.reshape(961, 3)[order]

    (ej, mj16), (ep, mp16) = rows(d_jax), rows(d_port)
    np.testing.assert_array_equal(ep, ej)
    assert int(np.abs(mp16 - mj16).max()) <= 1


def test_each_package_reads_the_other_directory(dirs):
    d_jax, _, d_same = dirs
    port, jax_ = PngCompression(device="cpu"), JaxPng()
    for dec in (port.decompress, jax_.decompress):
        own, other = dec(d_same), dec(d_jax)
        assert sorted(own) == sorted(other)
        for k in own:
            if k != "shN":
                np.testing.assert_array_equal(own[k], other[k], err_msg=k)
    for d in (d_jax, d_same):  # one directory, both decoders
        got, want = port.decompress(d), jax_.decompress(d)
        for k in want:
            if k == "means":  # expm1: torch's and XLA's (test_transforms_lie_within_an_ulp_of_float64)
                np.testing.assert_array_max_ulp(got[k], want[k], maxulp=4)
            else:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_round_trip_within_the_quantization(dirs):
    _, d_port, _ = dirs
    comp = PngCompression(device="cpu")
    prepared, s = comp.prepare(dict(_splats(1000)))
    back = comp.decompress(d_port)
    assert s == 31 and sorted(back) == sorted(prepared)
    for name, levels in (("scales", 255), ("quats", 255), ("opacities", 255), ("sh0", 255)):
        want = prepared[name].reshape(961, -1)
        step = (want.max(0) - want.min(0)) / levels
        assert (np.abs(back[name].reshape(961, -1) - want) <= 0.5 * step + 1e-6).all(), name
    got = log_transform(torch.from_numpy(back["means"])).numpy()
    step = (prepared["means"].max(0) - prepared["means"].min(0)) / 65535
    assert (np.abs(got - prepared["means"]) <= 0.5 * step + 1e-6).all()
    # k = N: every row its own centroid, exact up to float16
    np.testing.assert_array_equal(back["shN"], prepared["shN"].astype(np.float16).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _sklearn_mse(k):
    from sklearn.cluster import MiniBatchKMeans

    x = _kmeans_rows()
    km = MiniBatchKMeans(n_clusters=k, batch_size=4096, n_init=1, max_iter=20, random_state=0).fit(x)
    return float(((km.cluster_centers_[km.labels_] - x) ** 2).mean())


@functools.lru_cache(maxsize=None)
def _kmeans_rows():
    """4,096 rows of 45 values: 64 seeded cluster centres and noise."""
    rng = np.random.default_rng(5)
    centres = rng.standard_normal((64, 45))
    return (centres[rng.integers(0, 64, 4096)] + 0.3 * rng.standard_normal((4096, 45))).astype(np.float32)


@pytest.mark.parametrize("k", [16, 64])
def test_kmeans_round_trip_within_sklearn(k):
    x = _kmeans_rows()
    c, labels = tpc.kmeans(torch.from_numpy(x), k)
    assert c.shape == (k, 45) and labels.shape == (4096,) and int(labels.max()) < k
    mse = float(((c[labels].numpy() - x) ** 2).mean())
    assert mse <= 1.25 * _sklearn_mse(k), (mse, _sklearn_mse(k))
    c2, labels2 = tpc.kmeans(torch.from_numpy(x), k)  # the same bits on every run
    assert torch.equal(c, c2) and torch.equal(labels, labels2)


def test_kmeans_with_k_equal_n_is_exact_to_float16(tmp_path):
    x = _kmeans_rows()
    meta = tpc._compress_kmeans(str(tmp_path), "shN", x.reshape(4096, 15, 3), 64, device="cpu")
    assert meta["n_clusters"] == 4096
    data = np.load(os.path.join(tmp_path, "shN.npz"))
    assert data["centroids"].dtype == np.float16 and data["labels"].dtype == np.uint16
    back = jpc._decompress_kmeans(str(tmp_path), "shN", meta)  # JAX's reader
    np.testing.assert_array_equal(back, x.reshape(4096, 15, 3).astype(np.float16).astype(np.float32))


def test_empty_and_extra_fields_pass_through(tmp_path):
    sp = dict(_splats(1024, shn=False))
    sp["features"] = np.random.default_rng(4).standard_normal((1024, 8)).astype(np.float32)
    comp = PngCompression(device="cpu")
    comp.compress(str(tmp_path), dict(sp))
    assert "shN.npz" not in os.listdir(tmp_path) and "features.npz" in os.listdir(tmp_path)
    prepared, _ = comp.prepare(dict(sp))
    for back in (comp.decompress(str(tmp_path)), JaxPng().decompress(str(tmp_path))):
        assert back["shN"].shape == (1024, 0, 3) and back["shN"].dtype == np.float32
        np.testing.assert_array_equal(back["features"], prepared["features"])


def test_kmeans_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PngCompression().compress("unused", dict(_splats(1024)))
    assert PngCompression()._kmeans_device({"means": torch.zeros(1)}).type == "cpu"
