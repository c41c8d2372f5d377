"""Port SelectiveAdam (gsplat_tpu_torch.optimizers) vs the JAX package's.

Five steps on seeded numpy parameters of the trainer's shapes ([cap, 3],
[cap], [cap, 15, 3]) with seeded gradients, a per-step visibility mask and
a callable learning rate that reads the post-increment step count. The
parameters and both moments must agree within rtol 1e-6 after every step,
with atol 1e-8 (1e-6 of the ~1e-2 step: a parameter near zero takes the
step's rounding, and the JAX schedule rounds the learning rate in
float32), and invisible rows must keep their values and moments exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gsplat_tpu.optimizers import SelectiveAdam as JaxAdam
from gsplat_tpu_torch.optimizers import SelectiveAdam
from torch_exp_warmup import one_torch_thread  # noqa: F401 (an autouse fixture)

CAP = 64
SHAPES = {"means": (CAP, 3), "opacities": (CAP,), "shN": (CAP, 15, 3)}
TOL = dict(rtol=1e-6, atol=1e-8)


def _lr(count):
    return 1e-2 * 0.01 ** (count / 30)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("lr", ["callable", "float"])
def test_selective_adam_matches_jax(masked, lr):
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    lr_t = _lr if lr == "callable" else 5e-3
    lr_j = (lambda c: 1e-2 * 0.01 ** (c.astype(jnp.float32) / 30)) if lr == "callable" else 5e-3
    j_opt = {k: JaxAdam(lr_j, eps=1e-15) for k in params}
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = {k: j_opt[k].init(v) for k, v in j_params.items()}
    t_params = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    t_opt = {k: SelectiveAdam([p], lr=lr_t, eps=1e-15) for k, p in t_params.items()}
    for step in range(5):
        vis = rng.random(CAP) > 0.3 if masked else None
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        before = {k: p.detach().clone() for k, p in t_params.items()}
        moments = {k: [t.clone() for t in (t_opt[k].state[p].get("exp_avg"), t_opt[k].state[p].get("exp_avg_sq"))]
                   if step else None for k, p in t_params.items()}
        for k in params:
            upd, j_state[k] = j_opt[k].update(
                jnp.asarray(grads[k]), j_state[k], j_params[k],
                None if vis is None else jnp.asarray(vis),
            )
            j_params[k] = j_params[k] + upd
            t_params[k].grad = torch.from_numpy(grads[k])
            t_opt[k].step(None if vis is None else torch.from_numpy(vis))
            st = t_opt[k].state[t_params[k]]
            assert st["step"] == int(j_state[k].count) == step + 1
            np.testing.assert_allclose(t_params[k].detach().numpy(), np.asarray(j_params[k]), **TOL)
            np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(j_state[k].mu), **TOL)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(j_state[k].nu), **TOL)
            if vis is not None:
                hidden = torch.from_numpy(~vis)
                assert torch.equal(t_params[k].detach()[hidden], before[k][hidden])
                if moments[k] is not None:
                    assert torch.equal(st["exp_avg"][hidden], moments[k][0][hidden])
                    assert torch.equal(st["exp_avg_sq"][hidden], moments[k][1][hidden])


def test_params_without_grad_are_skipped():
    p = torch.zeros(4, 3, requires_grad=True)
    q = torch.zeros(4, requires_grad=True)
    opt = SelectiveAdam([p, q], lr=0.1)
    p.grad = torch.ones(4, 3)
    opt.step(torch.tensor([True, False, True, False]))
    assert q not in opt.state or not opt.state[q]
    assert torch.allclose(p.detach()[0], torch.full((3,), -0.1))
    assert torch.equal(p.detach()[1], torch.zeros(3))
