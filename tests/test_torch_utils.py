"""Port utilities (gsplat_tpu_torch.utils) vs the JAX package's
(gsplat_tpu/utils.py): the log transforms and the projection matrix within
rtol 1e-6 (atol 1e-7), and save_ply's file equal byte for byte to the JAX
package's from the same splats, with a `live` mask and rows holding NaN
and Inf. The projection matrix goes on the card unless asked for the CPU.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gsplat_tpu import utils as jutils
from gsplat_tpu_torch import utils as tutils
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

TOL = dict(rtol=1e-6, atol=1e-7)


def test_log_transforms_match_jax():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32) * 50
    x[:3] = [0.0, -0.0, 1e-30]
    y = tutils.log_transform(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jutils.log_transform(jnp.asarray(x))), **TOL)
    z = tutils.inverse_log_transform(y)
    np.testing.assert_allclose(z.numpy(), np.asarray(jutils.inverse_log_transform(jnp.asarray(y.numpy()))), **TOL)
    np.testing.assert_allclose(z.numpy(), x, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("args", [(0.01, 100.0, 1.2, 0.9), (0.5, 20.0, 0.4, 0.3)])
def test_projection_matrix_matches_jax(args):
    got = tutils.get_projection_matrix(*args, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jutils.get_projection_matrix(*args)), **TOL)


def test_projection_matrix_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tutils.get_projection_matrix(0.01, 100.0, 1.2, 0.9)


def _splats(n=64, b=8, seed=0):
    rng = np.random.default_rng(seed)
    s = {
        "means": rng.standard_normal((n, 3)),
        "scales": rng.standard_normal((n, 3)),
        "quats": rng.standard_normal((n, 4)),
        "opacities": rng.standard_normal(n),
        "sh0": rng.standard_normal((n, 1, 3)),
        "shN": rng.standard_normal((n, b, 3)),
    }
    s = {k: v.astype(np.float32) for k, v in s.items()}
    s["means"][5, 1] = np.nan
    s["shN"][9, 2, 0] = np.inf
    s["opacities"][40] = -np.inf
    return s


@pytest.mark.parametrize("with_live", [False, True])
@pytest.mark.parametrize("with_sh", [True, False])
def test_save_ply_bytes_match_jax(tmp_path, with_live, with_sh):
    s = _splats()
    if not with_sh:
        s = {k: v for k, v in s.items() if k not in ("sh0", "shN")}
    live = None
    if with_live:
        live = np.random.default_rng(1).random(64) < 0.7
        live[[5, 9]] = True  # the non-finite rows stay in the pool
    jp, tp = tmp_path / "jax.ply", tmp_path / "torch.ply"
    n_j = jutils.save_ply({k: jnp.asarray(v) for k, v in s.items()}, str(jp),
                          None if live is None else jnp.asarray(live))
    n_t = tutils.save_ply({k: torch.from_numpy(v) for k, v in s.items()}, str(tp),
                          None if live is None else torch.from_numpy(live))
    assert n_t == n_j
    finite = np.ones(64, bool)
    for v in s.values():
        finite &= np.isfinite(v.reshape(64, -1)).all(axis=1)
    assert not finite.all() and n_t == int((finite if live is None else finite & live).sum())
    assert tp.read_bytes() == jp.read_bytes()
    assert tp.read_bytes().startswith(b"ply\nformat binary_little_endian 1.0\n")


def test_depth_to_normal_on_rows_of_a_taller_image():
    """``row0`` places a depth strip at its rows of a taller image: the
    strip's inner rows are the whole image's normals, bit for bit (what a
    distributed strip computes with one halo row from each neighbour)."""
    rng = np.random.default_rng(3)
    H, W, y0, h = 24, 20, 7, 9
    depth = torch.from_numpy((rng.random((1, H, W, 1)) * 2 + 1).astype(np.float32))
    c2w = torch.eye(4)[None]
    c2w[0, :3, 3] = torch.tensor([0.1, -0.2, 0.3])
    K = torch.tensor([[[30.0, 0, W / 2], [0, 28.0, H / 2], [0, 0, 1]]])
    full = tutils.depth_to_normal(depth, c2w, K)
    strip = tutils.depth_to_normal(depth[:, y0 - 1:y0 + h + 1], c2w, K, row0=y0 - 1)
    assert torch.equal(strip[:, 1:-1], full[:, y0:y0 + h])
    assert torch.equal(tutils.depth_to_points(depth[:, y0:y0 + h], c2w, K, row0=y0),
                       tutils.depth_to_points(depth, c2w, K)[:, y0:y0 + h])
