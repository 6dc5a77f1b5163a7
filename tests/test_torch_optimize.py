"""Parity of the port's optimizers with the JAX package.

L-BFGS (one problem and the lockstep batch) and damped Newton run in float64
on the same numpy-built problems in both packages: ill-conditioned
quadratics and a chained Rosenbrock function. The iterates must agree to
1e-10 and the iteration and evaluation counts must be equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu.optimize import lbfgs as jlbfgs
from optimalcontrolmps_tpu.optimize import newton as jnewton
from optimalcontrolmps_torch import control, sector, seeds
from optimalcontrolmps_torch.optimize import lbfgs
from optimalcontrolmps_torch.optimize import (minimize_lbfgs,
                                              minimize_lbfgs_batch,
                                              minimize_newton)


NDIM, NQUAD = 6, 5
LANES = NQUAD + 1  # five quadratics, then one Rosenbrock lane


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(42)
    A = np.empty((LANES, NDIM, NDIM))
    b = rng.normal(size=(LANES, NDIM))
    for k in range(LANES):
        Q, _ = np.linalg.qr(rng.normal(size=(NDIM, NDIM)))
        A[k] = (Q * np.logspace(0, 3, NDIM)) @ Q.T
    rosen = np.arange(LANES) == NQUAD
    x0 = rng.normal(size=(LANES, NDIM))
    x0[NQUAD] = [-1.2, 1.0, -1.2, 1.0, -1.2, 1.0]
    return A, b, rosen, x0


def _objective(xp, A, b, rosen):
    """f(x) of one lane: the quadratic 0.5 (x - b)^T A (x - b), or the
    chained Rosenbrock function. Both have f* = 0, so f stays resolvable in
    float64 down to ||g||_inf = tol."""
    def f(x):
        if rosen:
            return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                          + (1.0 - x[:-1]) ** 2)
        r = x - b
        return 0.5 * r @ (A @ r)
    return f


def _torch_fg(f):
    def fg(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            v = f(x)
            (g,) = torch.autograd.grad(v, x)
        return v.detach(), g
    return fg


def _lanes(xp, A, b, rosen):
    conv = jnp.asarray if xp is jnp else torch.as_tensor
    return [_objective(xp, conv(A[k]), conv(b[k]), bool(rosen[k]))
            for k in range(LANES)]


@pytest.mark.parametrize("k", range(LANES))
def test_lbfgs_matches_jax(problems, k):
    A, b, rosen, x0 = problems
    fj = _lanes(jnp, A, b, rosen)[k]
    rj = jax.jit(lambda x: jlbfgs.minimize_lbfgs(
        jax.value_and_grad(fj), x, max_iter=100, tol=1e-8))(jnp.asarray(x0[k]))
    rt = minimize_lbfgs(_torch_fg(_lanes(torch, A, b, rosen)[k]),
                        torch.as_tensor(x0[k]), max_iter=100, tol=1e-8)
    assert rt.converged == bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    assert rt.n_evals == int(rj.n_evals)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-10)
    assert abs(rt.f - float(rj.f)) < 1e-10


def test_lbfgs_batch_matches_jax(problems):
    A, b, rosen, x0 = problems
    lanes_j = _lanes(jnp, A, b, rosen)
    lanes_t = _lanes(torch, A, b, rosen)

    def f_j(X):
        return jnp.stack([lanes_j[k](X[k]) for k in range(LANES)])

    def fg_j(X):
        return f_j(X), jax.grad(lambda X: jnp.sum(f_j(X)))(X)

    def fg_t(X):
        with torch.enable_grad():
            X = X.detach().requires_grad_(True)
            f = torch.stack([lanes_t[k](X[k]) for k in range(LANES)])
            (g,) = torch.autograd.grad(f.sum(), X)
        return f.detach(), g

    rj = jax.jit(lambda X: jlbfgs.minimize_lbfgs_batch(
        fg_j, X, max_iter=100, tol=1e-8))(jnp.asarray(x0))
    rt = minimize_lbfgs_batch(fg_t, torch.as_tensor(x0), max_iter=100,
                              tol=1e-8)
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.n_evals.numpy(), np.asarray(rj.n_evals))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    assert rt.converged.all()
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-10)
    np.testing.assert_allclose(rt.f.numpy(), np.asarray(rj.f), atol=1e-10)


@pytest.mark.parametrize("k", [0, NQUAD])
def test_newton_matches_jax(problems, k):
    A, b, rosen, x0 = problems
    fj = _lanes(jnp, A, b, rosen)[k]
    ft = _lanes(torch, A, b, rosen)[k]

    def fgh_j(x):
        v, g = jax.value_and_grad(fj)(x)
        return v, g, jax.hessian(fj)(x)

    def fgh_t(x):
        v, g = _torch_fg(ft)(x)
        return v, g, torch.autograd.functional.hessian(ft, x)

    # Newton is a polish: the Rosenbrock lane starts inside the basin
    start = np.linspace(0.9, 1.1, NDIM) if rosen[k] else x0[k]
    rj = jax.jit(lambda x: jnewton.minimize_newton(
        fgh_j, x, tol=1e-8, max_iter=30, fun=fj))(jnp.asarray(start))
    rt = minimize_newton(fgh_t, torch.as_tensor(start), tol=1e-8,
                         max_iter=30, fun=ft)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-10)
    assert abs(rt.f - float(rj.f)) < 1e-10


def test_batched_lbfgs_matches_single_on_sector_objective():
    """Port of test_batched_lbfgs_matches_vmapped: the lockstep batch
    reproduces lane-by-lane solves on the float32 sector objective."""
    T, DT, M, GAMMA = 0.5, 0.01, 8, 1e-6
    N = int(round(T / DT)) + 1
    st = sector.make_sector_stepper(5, 4, 5, 1.0, DT, dtype=torch.complex64,
                                    device="cpu")
    psi_i = sector.sector_ground_state(5, 4, 5, 1.0, 2.5,
                                       dtype=torch.complex64, device="cpu")
    psi_f = sector.sector_ground_state(5, 4, 5, 1.0, 50.0,
                                       dtype=torch.complex64, device="cpu")
    u0 = seeds.linsigmoid_seed(2.5, 50.0, N, rng=np.random.default_rng(1))
    basis = control.chopped_sine_basis(u0, DT, T, M, dtype=torch.float32,
                                       device="cpu")
    cs = np.random.default_rng(11).uniform(-0.3, 0.3, size=(6, M))
    cs = torch.as_tensor(cs.astype(np.float32))

    def fg(c):
        return _torch_fg(lambda c: sector.cost(
            st, psi_i, psi_f, basis.convert_control(c), GAMMA))(c)

    def fg_batch(C):
        out = [fg(c) for c in C]
        return (torch.stack([o[0] for o in out]),
                torch.stack([o[1] for o in out]))

    r_b = minimize_lbfgs_batch(fg_batch, cs, max_iter=25, tol=1e-6)
    f_single = [minimize_lbfgs(fg, c, max_iter=25, tol=1e-6).f for c in cs]
    np.testing.assert_allclose(r_b.f.numpy(), np.asarray(f_single),
                               rtol=2e-4, atol=2e-6)
    J0, _ = fg_batch(cs)
    assert float(torch.max(r_b.f - J0)) < 0


# ---------------------------------------------------------------------------
# the lockstep solver's steps: eager on the CPU, graphed bodies emulated
# ---------------------------------------------------------------------------

def _batch_fg(problems, calls=None):
    A, b, rosen, x0 = problems
    lanes_t = _lanes(torch, A, b, rosen)

    def fg_t(X):
        if calls is not None:
            calls.append(1)
        with torch.enable_grad():
            X = X.detach().requires_grad_(True)
            f = torch.stack([lanes_t[k](X[k]) for k in range(LANES)])
            (g,) = torch.autograd.grad(f.sum(), X)
        return f.detach(), g
    return fg_t


def _same(a, b):
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_lbfgs_batch_capture_safe_runs_eagerly_on_cpu(problems):
    """A capture-safe objective on the CPU takes the eager steps: the same
    result as an undeclared one, nothing replayed or captured, and every
    objective call counted as an eager trial."""
    x0 = torch.as_tensor(problems[3])
    calls = []
    fg_safe = _batch_fg(problems, calls)
    fg_safe.capture_safe = True
    lbfgs.reset_counts()
    r_safe = minimize_lbfgs_batch(fg_safe, x0, max_iter=100, tol=1e-8)
    counts = (lbfgs.trials_eager, lbfgs.trials_replayed,
              lbfgs.graphs_captured)
    assert counts == (len(calls), 0, 0)
    assert len(calls) > 10
    r_plain = minimize_lbfgs_batch(_batch_fg(problems), x0, max_iter=100,
                                   tol=1e-8)
    _same(r_safe, r_plain)


def test_lbfgs_batch_ragged_searches_match_jax(problems, monkeypatch):
    """Lockstep searches that end at different trials, some at max_ls (3
    here), against the JAX package's batch solver; the searches' trial
    counts per lane are read where each iteration ends."""
    A, b, rosen, x0 = problems
    lanes_j = _lanes(jnp, A, b, rosen)

    def f_j(X):
        return jnp.stack([lanes_j[k](X[k]) for k in range(LANES)])

    def fg_j(X):
        return f_j(X), jax.grad(lambda X: jnp.sum(f_j(X)))(X)

    ks = []
    finish = lbfgs._finish

    def spy(state, d, s, *a):
        ks.append(s["k"][d["live"]])
        return finish(state, d, s, *a)

    monkeypatch.setattr(lbfgs, "_finish", spy)
    rj = jax.jit(lambda X: jlbfgs.minimize_lbfgs_batch(
        fg_j, X, max_iter=60, tol=1e-8, max_ls=3))(jnp.asarray(x0))
    rt = minimize_lbfgs_batch(_batch_fg(problems), torch.as_tensor(x0),
                              max_iter=60, tol=1e-8, max_ls=3)
    assert any(len(set(k.tolist())) > 1 for k in ks)
    assert any(bool((k == 3).any()) for k in ks)
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.n_evals.numpy(), np.asarray(rj.n_evals))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-10)
    np.testing.assert_allclose(rt.f.numpy(), np.asarray(rj.f), atol=1e-10)


class _EmulatedGraph:
    """A capture that runs nothing and a replay that runs the body again
    on the static buffers: a CUDA graph's semantics, on the CPU."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step.flags = self.step.body()

    def reset(self):
        pass


@pytest.mark.parametrize("max_ls", [20, 3])
def test_lbfgs_batch_static_buffers_match_eager(problems, monkeypatch,
                                                max_ls):
    """The graphed path's sequence (a warm-up, a capture that runs nothing,
    then replays on the static buffers) gives the eager path's result
    bitwise."""
    x0 = torch.as_tensor(problems[3])
    calls = []
    fg = _batch_fg(problems, calls)
    eager = minimize_lbfgs_batch(fg, x0, max_iter=60, tol=1e-8,
                                 max_ls=max_ls)
    n_calls = len(calls)

    def capture(step):
        step.graph = _EmulatedGraph(step)

    monkeypatch.setattr(lbfgs._Step, "_capture", capture)
    lbfgs.reset_counts()
    x_in = x0.clone()
    graphed = lbfgs._solve(fg, x_in, 60, 1e-8, 10, max_ls, 3, graphed=True)
    _same(graphed, eager)
    assert torch.equal(x_in, x0)   # the start is not a static buffer
    assert lbfgs.trials_eager == 2 and lbfgs.trials_replayed > 0
    assert lbfgs.trials_eager + lbfgs.trials_replayed == n_calls
