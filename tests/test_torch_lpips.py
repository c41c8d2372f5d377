"""The port's LPIPS (gsplat_tpu_torch/lpips.py) against the JAX package's
(gsplat_tpu/lpips.py), on the CPU.

- init_random_params draws JAX's weights exactly (alex and vgg).
- lpips matches JAX's within rtol 1e-5 for alex at 64x64 and vgg at 32x32,
  B = 2, with normalize both ways; lpips(x, x) is 0.
- convert_torch_state_dict matches JAX's on both key styles
  (net.slice{k}.{i} / lin{k}.model.1 and net.features.{i} /
  lins.{k}.model.1), and load_lpips_params reads an .npz and a torch
  checkpoint as JAX's does (None for a missing file).
No pretrained weights ship with the repository: every test draws random
ones, as the JAX package's tests do.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import lpips as jl
from gsplat_tpu_torch import lpips as tl

from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

SIZES = {"alex": 64, "vgg": 32}


def _flat(params):
    return [np.asarray(a) for w, b in params["convs"] for a in (w, b)] + [np.asarray(w) for w in params["lins"]]


@functools.lru_cache(maxsize=None)
def _images(net):
    rng = np.random.default_rng(7)
    s = SIZES[net]
    x = rng.random((2, s, s, 3)).astype(np.float32)
    y = np.clip(x + 0.2 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_lpips(net, normalize):
    x, y = _images(net)
    fn = jax.jit(functools.partial(jl.lpips, net_type=net, normalize=normalize))
    return float(fn(jl.init_random_params(net, 3), jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_init_random_params_matches_jax(net):
    got, want = _flat(tl.init_random_params(net, 3, device="cpu")), _flat(jl.init_random_params(net, 3))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax(net, normalize):
    x, y = _images(net)
    params = tl.init_random_params(net, 3, device="cpu")
    got = float(tl.lpips(params, torch.from_numpy(x), torch.from_numpy(y), net, normalize))
    want = _jax_lpips(net, normalize)
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(tl.lpips(params, torch.from_numpy(x), torch.from_numpy(x), net, normalize)) == 0.0


def _state_dict(net, style):
    """A state dict of JAX's random weights in a torch LPIPS key style."""
    p = jl.init_random_params(net, 4)
    cfg = jl._net_cfg(net)
    sd = {}
    for i, (w, b) in enumerate(p["convs"]):
        layer = 3 * i  # torchvision's feature indices, spaced as its ReLUs and pools are
        key = f"net.features.{layer}" if style == "features" else f"net.slice{i + 1}.{layer}"
        sd[key + ".weight"], sd[key + ".bias"] = np.asarray(w), np.asarray(b)
    for t in range(len(cfg["taps"])):
        key = f"lins.{t}.model.1.weight" if style == "features" else f"lin{t}.model.1.weight"
        sd[key] = np.asarray(p["lins"][t])
    return sd


@pytest.mark.parametrize("style", ["slice", "features"])
@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_convert_torch_state_dict_matches_jax(net, style):
    sd = _state_dict(net, style)
    want = _flat(jl.convert_torch_state_dict(sd, net))
    got = _flat(tl.convert_torch_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, net, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    bad = dict(sd)
    bad.pop(next(k for k in sd if k.endswith(".weight") and "lin" not in k))
    with pytest.raises(ValueError, match="convs"):
        tl.convert_torch_state_dict(bad, net, device="cpu")


def test_load_lpips_params_reads_npz_and_torch_checkpoint(tmp_path):
    p = jl.init_random_params("alex", 5)
    arrays = {f"conv{i}_{k}": np.asarray(t) for i, wb in enumerate(p["convs"]) for k, t in zip("wb", wb)}
    arrays.update({f"lin{i}_w": np.asarray(w) for i, w in enumerate(p["lins"])})
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **arrays)
    want = _flat(jl.load_lpips_params(npz, "alex"))
    for g, w in zip(_flat(tl.load_lpips_params(npz, "alex", device="cpu")), want):
        np.testing.assert_array_equal(g, w)
    pth = str(tmp_path / "w.pth")
    torch.save({k: torch.from_numpy(v) for k, v in _state_dict("alex", "slice").items()}, pth)
    want = _flat(jl.load_lpips_params(pth, "alex"))
    for g, w in zip(_flat(tl.load_lpips_params(pth, "alex", device="cpu")), want):
        np.testing.assert_array_equal(g, w)
    assert tl.load_lpips_params(str(tmp_path / "missing.npz"), device="cpu") is None
    assert tl.load_lpips_params("", device="cpu") is None
    with pytest.raises(ValueError, match="net_type"):
        tl.init_random_params("squeeze", device="cpu")
