"""The port's flagship solve (flagship.py) against the same composition in
the JAX package: bench.py's batch objective through the chain (the scan
reference on the CPU) under minimize_lbfgs_batch, then the float64 polish
(L-BFGS with the autodiff gradient, exact-Hessian Newton)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu import control as jcontrol
from optimalcontrolmps_tpu import sector as jsector
from optimalcontrolmps_tpu import seeds as jseeds
from optimalcontrolmps_tpu.engine import regularization as jreg
from optimalcontrolmps_tpu.ops import pallas_sector as jps
from optimalcontrolmps_tpu.optimize import minimize_lbfgs as jlbfgs
from optimalcontrolmps_tpu.optimize import minimize_newton as jnewton
from optimalcontrolmps_tpu.optimize.lbfgs import minimize_lbfgs_batch as jbatch
from optimalcontrolmps_tpu.optimize.penalty import bound_penalty as jpen
from optimalcontrolmps_torch import flagship

torch.set_num_threads(2)

T, M, B = 0.5, 8, 8
DT, GAMMA = flagship.DT, flagship.GAMMA
# float32 lockstep trajectories of the two packages agree while the Wolfe
# searches take the same branches; after ~10 iterations a last-bit
# difference flips a branch in some lane (measured: 2% apart at 12)
CHIP_ITERS = 6


def _jax_problem(T, M, f64):
    N = int(round(T / DT)) + 1
    cd = jnp.complex128 if f64 else jnp.complex64
    st = jsector.make_sector_stepper(5, 4, 5, 1.0, DT, dtype=cd)
    psi_i = jsector.sector_ground_state(5, 4, 5, 1.0, 2.5, dtype=np.dtype(cd))
    psi_f = jsector.sector_ground_state(5, 4, 5, 1.0, 50.0,
                                        dtype=np.dtype(cd))
    u0 = jseeds.linsigmoid_seed(2.5, 50.0, N,
                                rng=np.random.default_rng(123456789))
    basis = jcontrol.chopped_sine_basis(
        u0, DT, T, M, dtype=np.float64 if f64 else np.float32)
    return st, psi_i, psi_f, basis


def _jax_chip_phase(cs, max_iter):
    """bench.py:186-201 on the scan chain."""
    st, psi_i, psi_f, basis = _jax_problem(T, M, False)
    psi_f_conj = np.conj(np.asarray(psi_f)).astype(np.complex64)

    def batch_fg(C):
        def tot(C):
            U = jax.vmap(basis.convert_control)(C)
            ov = jps.chain_final(st, U, psi_i) @ psi_f_conj
            fid = (ov * ov.conj()).real
            extra = jax.vmap(lambda u: jreg(u, GAMMA, st.dt) + jpen(u))(U)
            J = 0.5 * (1.0 - fid) + extra
            return jnp.sum(J), J
        (_, J), G = jax.value_and_grad(tot, has_aux=True)(C)
        return J, G

    return jax.jit(lambda c: jbatch(batch_fg, c, max_iter=max_iter,
                                    tol=1e-5))(jnp.asarray(cs))


def _jax_polish(T, M, c0):
    """bench.py:75-107 (polish_main)."""
    st, psi_i, psi_f, basis = _jax_problem(T, M, True)

    def Jpen(c):
        u = basis.convert_control(c)
        return jsector.cost(st, psi_i, psi_f, u, GAMMA) + jpen(u)

    def fgh(c):
        Jv, g = jax.value_and_grad(Jpen)(c)
        H = basis.convert_hessian(jsector.hessian(
            st, psi_i, psi_f, basis.convert_control(c), GAMMA))
        return Jv, g, H

    res = jax.jit(lambda c: jlbfgs(jax.value_and_grad(Jpen), c, max_iter=200,
                                   tol=1e-8))(jnp.asarray(c0))
    nres = jax.jit(lambda c: jnewton(fgh, c, tol=1e-8, max_iter=20,
                                     fun=Jpen))(res.x)
    best = nres if float(nres.f) <= float(res.f) else res
    return res, nres, best


@pytest.fixture(scope="module")
def chip():
    cs = flagship.multistart_coeffs(B, M)
    r_j = _jax_chip_phase(cs, CHIP_ITERS)
    r_t = flagship.chip_phase(flagship.make_problem("cpu", T=T, M=M), cs,
                              max_iter=CHIP_ITERS)
    return r_j, r_t


def test_multistart_coeffs_follow_bench():
    cs = flagship.multistart_coeffs(B, M)
    rng = np.random.default_rng(7)
    assert cs.dtype == np.float32 and not cs[0].any()
    np.testing.assert_array_equal(
        cs[1:], rng.normal(0.0, 0.5, (B - 1, M)).astype(np.float32))


def test_chip_phase_matches_jax(chip):
    r_j, r_t = chip
    np.testing.assert_allclose(r_t.f.numpy(), np.asarray(r_j.f), rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_array_equal(r_t.iterations.numpy(),
                                  np.asarray(r_j.iterations))
    np.testing.assert_array_equal(r_t.n_evals.numpy(),
                                  np.asarray(r_j.n_evals))
    assert np.isfinite(r_t.f.numpy()).all()


def test_polish_matches_jax_from_chip_best(chip):
    """At T=0.5 the best lane's optimum puts the control on the bound
    u_min=2, where the quadratic penalty has no second derivative and the
    Newton polish stops short of 1e-8; both packages must stop at the same
    J* and agree on `converged`."""
    r_j, _ = chip
    k = int(np.argmin(np.asarray(r_j.f)))
    c0 = np.asarray(r_j.x)[k].astype(np.float64)
    _, _, best = _jax_polish(T, M, c0)
    out = flagship.polish(flagship.make_problem("cpu", f64=True, T=T, M=M),
                          c0)
    assert abs(out["best_cost_f64"] - float(best.f)) < 1e-10
    assert out["converged"] == bool(best.converged)


def test_polish_converges_like_jax_on_flagship():
    """The full-horizon flagship (T=2, M=10) from c=0, as
    tests/test_optimizers.py:test_flagship_converges_to_reference_opttol."""
    c0 = np.zeros(10)
    res, nres, best = _jax_polish(2.0, 10, c0)
    out = flagship.polish(flagship.make_problem("cpu", f64=True), c0)
    assert out["converged"] and bool(best.converged)
    assert out["grad_norm_f64"] < 1e-8
    assert abs(out["best_cost_f64"] - float(best.f)) < 1e-10
    assert out["lbfgs_iters"] == int(res.iterations)
    assert out["newton_iters"] == int(nres.iterations)
    assert out["best_cost_f64"] < 6e-3 and out["best_infidelity"] < 6e-3


def test_solve_flagship_entry_point():
    out = flagship.solve_flagship(B=3, device="cpu", max_iter=2)
    for key in ("best_cost_c64", "median_cost_c64", "iters_min_med_max",
                "best_cost_f64", "grad_norm_f64", "converged",
                "best_infidelity", "lbfgs_iters", "newton_iters"):
        assert key in out
    assert out["all_costs_finite"] and out["iters_min_med_max"][2] <= 2
    assert out["converged"] and out["grad_norm_f64"] < 1e-8
    assert out["best_cost_f64"] < 6e-3 and out["best_infidelity"] < 6e-3
    assert len(out["c0"]) == 10
