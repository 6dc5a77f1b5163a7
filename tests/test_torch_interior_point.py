"""Parity of the port's interior point with the JAX package's.

The same float64 problems go through both packages on the CPU:
* the three toy problems of tests/test_optimizers.py:51-93 (active box,
  active path, adaptive against monotone barrier), x to the JAX tests'
  1e-7 / 1e-6, equal iteration counts;
* the control problem of tests/test_optimizers.py:141 at its size (L=5,
  d=4, chi=30, T=0.1, M=5; its first iteration, for time: after one step
  the eigh truncation, which resolves states to ~sqrt(eps), moves H by
  ~1e-8 for a 5e-15 change of x, so the two solvers' iterates part at that
  level), with the port's MPS objective fed to both solvers, so they see
  the same f, g and H: the JAX test's checks, and the step to rounding;
* the quadratic NLP of tests/test_streaming_hessian.py: host = jit (x to
  1e-7, f to 1e-10), the chunked warm start = the unchunked solve, and the
  zero-slack iterate stays finite;
* a lockstep batch of 3 lanes against JAX's vmap, lane by lane, with a lane
  that converges at iteration 1 and must stay frozen bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu.optimize import interior_point as jip
from optimalcontrolmps_torch import control, engine, groundstate, seeds, tebd
from optimalcontrolmps_torch.optimize import interior_point as tip

torch.set_num_threads(2)
F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _box_fgh(xp):
    def fgh(x):
        eye = xp.eye(x.shape[-1], dtype=x.dtype)
        return xp.sum((x - 5.0) ** 2), 2 * (x - 5.0), 2 * eye
    return fgh


@pytest.mark.parametrize("strategy", ["monotone", "adaptive"])
def test_active_box_matches_jax(strategy):
    rj = jax.jit(lambda x0: jip.minimize_interior_point(
        _box_fgh(jnp), x0, x_lb=-3.0, x_ub=3.0, tol=1e-8,
        mu_strategy=strategy))(jnp.zeros(5))
    rt = tip.minimize_interior_point(_box_fgh(torch),
                                     torch.zeros(5, dtype=F64), x_lb=-3.0,
                                     x_ub=3.0, tol=1e-8, mu_strategy=strategy)
    assert bool(rt.converged) and bool(rj.converged)
    np.testing.assert_allclose(rt.x.numpy(), 3.0, atol=1e-7)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-12)
    assert int(rt.iterations) == int(rj.iterations)
    assert float(rt.mu) == pytest.approx(float(rj.mu), rel=1e-12)


def test_adaptive_needs_no_more_iterations_than_monotone():
    r = {s: tip.minimize_interior_point(_box_fgh(torch),
                                        torch.zeros(5, dtype=F64), x_lb=-3.0,
                                        x_ub=3.0, tol=1e-8, mu_strategy=s)
         for s in ("monotone", "adaptive")}
    np.testing.assert_allclose(r["adaptive"].x.numpy(),
                               r["monotone"].x.numpy(), atol=1e-6)
    assert int(r["adaptive"].iterations) <= int(r["monotone"].iterations)


def test_active_path_matches_jax():
    """u = u0 + B x >= 2 is active at the optimum x* = (0.5, 0.5)."""
    B = np.ones((3, 2))
    u0 = np.asarray([1.0, 1.5, 2.5])

    def fgh(xp):
        return lambda x: (xp.sum((x + 2.0) ** 2), 2 * (x + 2.0),
                          2 * xp.eye(2, dtype=x.dtype))

    rj = jax.jit(lambda x0: jip.minimize_interior_point(
        fgh(jnp), x0, B=B, u0=u0, tol=1e-8))(jnp.asarray([2.0, 2.0]))
    rt = tip.minimize_interior_point(fgh(torch), _t([2.0, 2.0]), B=B, u0=u0,
                                     tol=1e-8)
    assert bool(rt.converged)
    np.testing.assert_allclose(rt.x.numpy(), [0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-12)
    assert int(rt.iterations) == int(rj.iterations)


# ---------------------------------------------------------------------------
# the control problem of tests/test_optimizers.py:109-163
# ---------------------------------------------------------------------------

def test_control_problem_matches_jax():
    L, D, NPART, J, T, DT, M, CHI, GAMMA = 5, 4, 5, 1.0, 0.1, 1e-2, 5, 30, 1e-6
    N = int(T / DT + 1)
    st = tebd.make_stepper(L, D, J, DT, CHI, device="cpu")
    psi_i = groundstate.initialize_state(L, D, NPART, J, 2.5, CHI,
                                         device="cpu")
    psi_f = groundstate.initialize_state(L, D, NPART, J, 50.0, CHI,
                                         device="cpu")
    basis = control.chopped_sine_basis(seeds.linspace(2.5, 50.0, N), DT, T,
                                       M, device="cpu")

    memo = {}

    def fgh(c):
        # both solvers start at c = 0: the second evaluation there is a hit
        key = c.numpy().tobytes()
        if key not in memo:
            memo[key] = fgh_eval(c)
        return memo[key]

    def fgh_eval(c):
        u = basis.convert_control(c)
        g_u, aux = engine.gradient(st, psi_i, psi_f, u, GAMMA)
        ov = aux[3]
        Jv = 0.5 * (1.0 - (ov * ov.conj()).real) + engine.regularization(
            u, GAMMA, st.dt)
        H = basis.convert_hessian(engine.hessian(st, psi_i, psi_f, u, GAMMA,
                                                 aux=aux))
        return Jv, basis.convert_gradient(g_u), H

    def cheap(c):
        return engine.cost(st, psi_i, psi_f, basis.convert_control(c), GAMMA)

    def fg(c):
        Jv, g_u = engine.cost_and_gradient(st, psi_i, psi_f,
                                           basis.convert_control(c), GAMMA)
        return Jv, basis.convert_gradient(g_u)

    kw = dict(B=basis.jacobian().numpy(), u0=basis.u0.numpy(), tol=1e-5,
              max_iter=1)
    ht, hj = [], []
    rt = tip.minimize_interior_point(fgh, torch.zeros(M, dtype=F64),
                                     fun=cheap, fun_grad=fg,
                                     callback=lambda *a: ht.append(a), **kw)
    # JAX's solver on the same f, g and H; its host loop, whose early-exit
    # line search makes the trials the port's makes
    rj = jip.minimize_interior_point_host(
        lambda c: tuple(a.numpy() for a in fgh(_t(c))), jnp.zeros(M),
        fun=lambda c: float(cheap(_t(c))), callback=lambda *a: hj.append(a),
        fun_grad=lambda c: tuple(a.numpy() for a in fg(_t(c))), **kw)
    f0 = float(cheap(torch.zeros(M, dtype=F64)))
    assert float(rt.f) <= f0 + 1e-12
    u_opt = basis.convert_control(rt.x).numpy()
    assert u_opt.min() >= 2.0 - 1e-9 and u_opt.max() <= 100.0 + 1e-9
    assert int(rt.iterations) == int(rj.iterations) == 1
    # the step is taken from the same f, g, H: x_1 agrees to rounding, and
    # so do f and the KKT error of the iteration and its trial count
    np.testing.assert_allclose(np.asarray(ht), np.asarray(hj), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-12)
    assert abs(float(rt.f) - float(rj.f)) < 1e-13
    np.testing.assert_allclose(rt.z_lo.numpy(), np.asarray(rj.z_lo),
                               rtol=1e-10)


# ---------------------------------------------------------------------------
# the quadratic NLP of tests/test_streaming_hessian.py:49-63
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quad():
    n, m = 12, 5
    rng = np.random.default_rng(3)
    A = rng.normal(size=(n, n))
    Q = A @ A.T + np.eye(n)
    b = rng.normal(size=n) * 10
    B = rng.normal(size=(m, n))
    u0 = np.full(m, 51.0)
    Qt, bt = _t(Q), _t(b)

    def fgh(x):
        return 0.5 * x @ (Qt @ x) + bt @ x, Qt @ x + bt, Qt

    def fgh_batch(X):
        return (0.5 * torch.einsum("bi,ij,bj->b", X, Qt, X) + X @ bt,
                X @ Qt.T + bt, Qt.expand(X.shape[0], n, n))

    def fgh_jax(x):
        return 0.5 * x @ (jnp.asarray(Q) @ x) + jnp.asarray(b) @ x, \
            jnp.asarray(Q) @ x + jnp.asarray(b), jnp.asarray(Q)

    return dict(n=n, B=B, u0=u0, Q=Q, b=b, fgh=fgh, fgh_batch=fgh_batch,
                fgh_jax=fgh_jax)


def test_host_ip_matches_jit_ip(quad):
    x0 = torch.zeros(quad["n"], dtype=F64)
    kw = dict(B=quad["B"], u0=quad["u0"], tol=1e-8, max_iter=200)
    r1 = tip.minimize_interior_point(quad["fgh"], x0, **kw)
    r2 = tip.minimize_interior_point_host(quad["fgh"], x0, **kw)
    assert bool(r1.converged) and bool(r2.converged)
    np.testing.assert_allclose(r1.x.numpy(), r2.x.numpy(), atol=1e-7)
    assert abs(float(r1.f) - float(r2.f)) < 1e-10
    # the host loop against its JAX counterpart (the lockstep solver's is
    # test_batch_lanes_match_vmapped_jax)
    j2 = jip.minimize_interior_point_host(quad["fgh_jax"],
                                          jnp.zeros(quad["n"]), **kw)
    assert int(r2.iterations) == int(j2.iterations)
    np.testing.assert_allclose(r2.x.numpy(), np.asarray(j2.x), atol=1e-12)


def test_host_ip_callbacks_and_checkpoints(quad):
    calls, cks = [], []
    r = tip.minimize_interior_point_host(
        quad["fgh"], torch.zeros(quad["n"], dtype=F64), B=quad["B"],
        u0=quad["u0"], tol=1e-8, max_iter=4,
        callback=lambda *a: calls.append(a),
        checkpoint_cb=lambda it, sd, f, kkt: cks.append((it, sd, f, kkt)))
    assert [c[0] for c in calls] == [1, 2, 3, 4] == [c[0] for c in cks]
    np.testing.assert_array_equal(cks[-1][1]["x"], r.x.numpy())
    np.testing.assert_array_equal(cks[-1][1]["z_lo"], r.z_lo.numpy())
    assert float(cks[-1][1]["mu"]) == float(r.mu)
    assert int(r.iterations) == 4 and not bool(r.converged)


def test_chunked_dual_warmstart_matches_unchunked(quad):
    kw = dict(B=quad["B"], u0=quad["u0"], tol=1e-8)
    x0 = torch.zeros(quad["n"], dtype=F64)
    ref = tip.minimize_interior_point_host(quad["fgh"], x0, max_iter=200,
                                           **kw)
    it_total, duals, x, mu = 0, tip.cold_duals(x0, B=quad["B"],
                                               u0=quad["u0"]), x0, 0.1
    for _ in range(40):
        r = tip.minimize_interior_point_host(quad["fgh"], x, max_iter=5,
                                             duals0=duals, mu0=mu, **kw)
        x, duals = r.x, (r.z_lo, r.z_hi, r.w_lo, r.w_hi)
        mu = max(float(r.mu), 1e-9)
        it_total += int(r.iterations)
        if bool(r.converged):
            break
    assert bool(r.converged)
    assert it_total <= int(ref.iterations) + 5
    np.testing.assert_allclose(r.x.numpy(), ref.x.numpy(), atol=1e-7)
    # cold_duals is the JAX package's
    jd = jip.cold_duals(jnp.zeros(quad["n"]), B=quad["B"], u0=quad["u0"])
    for a, b in zip(tip.cold_duals(x0, B=quad["B"], u0=quad["u0"]), jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)


def test_zero_slack_iterate_stays_finite(quad):
    """An iterate exactly on a bound gives finite Newton data: the slacks
    are floored at the dtype's rounding scale."""
    n = quad["n"]
    x = torch.full((1, n), -20.0, dtype=F64)
    core = tip._make_core(x, -20.0, 20.0, quad["B"], quad["u0"], 2.0, 100.0,
                          1e-8, 0.995, 0.2, 1.5, None, 1e-3, 100.0,
                          "adaptive")
    s = core.init_state(x, None, 5.0, 0.1)
    s["x"] = x                       # defeat the interior push
    f, g, H = quad["fgh"](x[0])
    P = core.iter_prep(s, f[None], g[None], H[None])
    assert all(bool(torch.isfinite(v).all()) for v in P.values())
    assert float(P["a_p"][0]) > 0.0
    s2 = core.iter_apply(s, {**P, "found": torch.tensor([True])},
                         P["a_p"].clone())
    assert all(bool(torch.isfinite(v.double()).all()) for v in s2.values())


def test_batch_lanes_match_vmapped_jax(quad):
    """Lane b of the lockstep batch = JAX's vmapped lane b. Lane 0 starts
    at the optimum with zero multipliers and converges at iteration 1;
    it stays frozen while the others run (bitwise = its one-lane solve)."""
    n = quad["n"]
    kw = dict(B=quad["B"], u0=quad["u0"], tol=1e-8, max_iter=200,
              mu_strategy="adaptive")
    # the unconstrained optimum is interior
    x_star = np.linalg.solve(quad["Q"], -quad["b"])
    u = quad["u0"] + quad["B"] @ x_star
    assert np.abs(x_star).max() < 19.0 and u.min() > 3.0 and u.max() < 99.0
    rng = np.random.default_rng(5)
    X0 = np.stack([x_star, rng.normal(0, 2, n), np.zeros(n)])
    cold = [v.numpy() for v in tip.cold_duals(_t(X0[1:]), B=quad["B"],
                                              u0=quad["u0"])]
    duals = [np.concatenate([np.zeros((1, v.shape[1])), v]) for v in cold]

    rt = tip.minimize_interior_point(quad["fgh_batch"], _t(X0),
                                     duals0=[_t(v) for v in duals], **kw)
    rj = jax.vmap(lambda x, d: jip.minimize_interior_point(
        quad["fgh_jax"], x, duals0=d, **kw))(jnp.asarray(X0),
                                              tuple(map(jnp.asarray, duals)))
    assert rt.iterations[0] == 1 and bool(rt.converged.all())
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-10)
    np.testing.assert_allclose(rt.f.numpy(), np.asarray(rj.f), rtol=1e-12)
    np.testing.assert_allclose(rt.mu.numpy(), np.asarray(rj.mu), rtol=1e-7)
    # the converged lane is frozen bit for bit: = its own one-lane solve
    r0 = tip.minimize_interior_point(quad["fgh"], _t(X0[0]),
                                     duals0=[_t(v[0]) for v in duals], **kw)
    assert torch.equal(rt.x[0], r0.x) and torch.equal(rt.x[0], _t(x_star))
    for a, b in ((rt.mu[0], r0.mu), (rt.z_lo[0], r0.z_lo),
                 (rt.w_hi[0], r0.w_hi)):
        assert torch.equal(a, b)
    assert torch.equal(rt.z_hi[0], torch.full((n,), 1e-12, dtype=F64))
