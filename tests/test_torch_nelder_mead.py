"""Parity of the port's Nelder-Mead and bound-penalty wrapper with JAX.

* The reference-constants quadratic of tests/test_optimizers.py:41
  (converged, x to 1e-2, f to 1e-4), with the same iteration and
  evaluation counts as the JAX package.
* A lockstep batch of three Rosenbrock simplices against JAX's vmap, lane
  by lane: iteration and evaluation counts and histories equal, x and the
  cost history to 1e-8.
* The penalty wrapper's numbers (tests/test_optimizers.py:96).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu.optimize import (make_penalized_cost as
                                            jpenalized)
from optimalcontrolmps_tpu.optimize import minimize_nelder_mead as jnm
from optimalcontrolmps_torch.optimize import (bound_penalty,
                                              make_penalized_cost,
                                              minimize_nelder_mead)

F64 = torch.float64


def test_reference_constants_match_jax():
    res = minimize_nelder_mead(lambda X: torch.sum((X - 2.0) ** 2, -1) + 1.5,
                               torch.zeros(4, dtype=F64))
    rj = jax.jit(lambda x0: jnm(lambda x: jnp.sum((x - 2.0) ** 2) + 1.5,
                                x0))(jnp.zeros(4))
    assert bool(res.converged)
    assert float(torch.abs(res.x - 2.0).max()) < 1e-2
    assert abs(float(res.f) - 1.5) < 1e-4
    assert int(res.iterations) == int(rj.iterations)
    assert int(res.n_evals) == int(rj.n_evals)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(rj.x), atol=1e-12)


def test_batch_lanes_match_vmapped_jax():
    X0 = np.random.default_rng(0).normal(0.0, 1.0, (3, 4))
    X0[0] = 0.0
    max_iter = 300

    def rosen(X):
        return torch.sum(100.0 * (X[:, 1:] - X[:, :-1] ** 2) ** 2
                         + (1.0 - X[:, :-1]) ** 2, dim=-1)

    def rosen_j(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    rt = minimize_nelder_mead(rosen, torch.as_tensor(X0), max_iter=max_iter)
    rj = jax.jit(jax.vmap(lambda x: jnm(rosen_j, x, max_iter=max_iter)))(
        jnp.asarray(X0))
    for key in ("iterations", "n_evals", "converged", "evals_history"):
        np.testing.assert_array_equal(getattr(rt, key).numpy(),
                                      np.asarray(getattr(rj, key)))
    assert rt.cost_history.shape == (3, max_iter + 1)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)
    np.testing.assert_allclose(rt.cost_history.numpy(),
                               np.asarray(rj.cost_history), atol=1e-8)
    # each lane = its own one-problem solve
    r1 = minimize_nelder_mead(rosen, torch.as_tensor(X0[1]),
                              max_iter=max_iter)
    assert torch.equal(r1.x, rt.x[1]) and int(r1.n_evals) == rt.n_evals[1]


def test_penalty_wrapper_matches_jax():
    u = torch.tensor([1.0, 50.0, 103.0], dtype=F64)
    assert abs(float(bound_penalty(u, 2.0, 100.0, 100.0))
               - 100.0 * (1.0 + 9.0)) < 1e-9
    f = make_penalized_cost(lambda x: torch.sum(x * x, -1),
                            convert_control=lambda x: 10.0 * x,
                            gamma_bound=100.0)
    fj = jpenalized(lambda x: jnp.sum(x * x),
                    convert_control=lambda x: 10.0 * x, gamma_bound=100.0)
    x = torch.tensor([[0.05], [0.3], [10.5]], dtype=F64)
    assert abs(float(f(x[0])) - (0.0025 + 100 * 2.25)) < 1e-9
    np.testing.assert_allclose(f(x).numpy(),
                               [float(fj(jnp.asarray(r))) for r in x.numpy()],
                               rtol=1e-14)


@pytest.mark.parametrize("max_iter", [1, 2])
def test_history_shapes_at_the_smallest_limits(max_iter):
    res = minimize_nelder_mead(lambda X: torch.sum(X * X, -1),
                               torch.ones(3, dtype=F64), max_iter=max_iter)
    assert res.cost_history.shape == (max_iter + 1,)
    assert torch.isfinite(res.cost_history).all()
