"""The port's image fitting (gsplat_tpu_torch.image_fitting) vs
examples/image_fitting.py.

- Five Adam steps from the same initial values (drawn by the port's
  init_params), both on the oracle at 32x24 with 150 points: the JAX step
  as the example builds it (its loss, optax.adam, jitted), the port's fit;
  the losses and parameters within rtol 1e-4 (parameters also atol 1e-4 x
  the learning rate, as tests/test_torch_trainer.py holds Adam steps).
- make_target equal to the example's, its gradient default and an image
  file (a PNG the port's writer wrote, which the example reads with PIL).
- The command line on the CPU: runs, the PSNR rises, --save-path writes
  a PNG.
"""

import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from PIL import Image

from gsplat_tpu import rasterization as jax_rasterization
from gsplat_tpu_torch import image_fitting as fit_mod
from gsplat_tpu_torch.datasets.image_io import write_png

from torch_exp_warmup import one_torch_thread, warm_exp  # noqa: F401 (one_torch_thread: an autouse fixture)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example():
    name = "jax_image_fitting_for_port_tests"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(_ROOT, "examples", "image_fitting.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def test_five_steps_match_jax():
    warm_exp()
    H, W, N, lr = 24, 32, 150, 0.01
    target = _jax_example().make_target(H, W, None)
    params0 = fit_mod.init_params(N, torch.Generator().manual_seed(0), device="cpu")

    # examples/image_fitting.py's step, from the same initial values
    fov_x = math.pi / 2.0
    focal = 0.5 * W / math.tan(0.5 * fov_x)
    viewmats = jnp.eye(4)[None].at[:, 2, 3].set(8.0)
    Ks = jnp.asarray([[[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]]], jnp.float32)
    tx = optax.adam(lr)

    def loss_fn(params):
        render, _, _ = jax_rasterization(
            params["means"], params["quats"], jnp.exp(params["scales"]), jax.nn.sigmoid(params["opacities"]),
            jax.nn.sigmoid(params["colors"]), viewmats, Ks, W, H, backend="oracle",
        )
        return jnp.mean((render[0] - jnp.asarray(target)) ** 2), render[0]

    @jax.jit
    def step(params, opt_state):
        (loss, img), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jp = {k: jnp.asarray(v.numpy()) for k, v in params0.items()}
    state = tx.init(jp)
    want_losses = []
    for _ in range(5):
        jp, state, loss = step(jp, state)
        want_losses.append(float(loss))

    out = fit_mod.fit(torch.from_numpy(target), params0, 5, lr=lr, log_every=0)
    np.testing.assert_allclose(out["losses"], want_losses, rtol=1e-4)
    assert out["losses"][-1] < out["losses"][0]
    for k, p in out["params"].items():
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), rtol=1e-4, atol=1e-4 * lr, err_msg=k)
        assert not torch.equal(p, params0[k]), k


def test_make_target_matches_jax(tmp_path):
    ex = _jax_example()
    np.testing.assert_array_equal(fit_mod.make_target(48, 64), ex.make_target(48, 64, None))
    img = (np.random.default_rng(0).random((20, 30, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "t.png")
    write_png(path, img)
    np.testing.assert_array_equal(fit_mod.make_target(0, 0, path), ex.make_target(0, 0, path))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_command_line(tmp_path):
    save = str(tmp_path / "fit.png")
    out = fit_mod.main(["--height", "24", "--width", "32", "--num-points", "100", "--max-steps", "30",
                        "--save-path", save], device="cpu")
    assert out["psnr"] > out["psnr0"] and len(out["losses"]) == 30 and out["steps_per_s"] > 0
    assert np.asarray(Image.open(save)).shape == (24, 32, 3)
