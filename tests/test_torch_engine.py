"""Parity of the port's MPS engine (and the sector additions) with JAX.

Goldens: the reference's CostTests physics (L=5, d=5, chi=40, T=0.1) gives
cost 0.375995 for the linear ramp 2 -> 50 and 0.370157 for GROUP
c = linspace(0, 7, 5), checked at 1e-5 (tests/test_cost_golden.py).
Parity: the same problem is built in both packages on the CPU in complex128
(L=4, d=3, chi=16 = the exact rank bound, N_t=11), with controls from numpy
seeds. Only gauge-invariant results are compared: costs, fidelities,
gradients (rel 1e-10), Hessians (1e-8 of their scale, symmetric to 1e-12).
The lowmem and full gradients agree to 1e-11 (tests/test_gradient.py:131),
and a control batch agrees with one-at-a-time calls to 1e-11.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu import control as jcontrol
from optimalcontrolmps_tpu import engine as jengine
from optimalcontrolmps_tpu import groundstate as jgs
from optimalcontrolmps_tpu import problem as jproblem
from optimalcontrolmps_tpu import sector as jsector
from optimalcontrolmps_tpu import tebd as jtebd
from optimalcontrolmps_torch import (backends, control, engine, groundstate,
                                     problem, sector, seeds, tebd)


L, D, NPART, J, CHI = 4, 3, 4, 1.0, 16
T, DT, M, GAMMA = 0.1, 0.01, 4, 1e-3
N = int(round(T / DT)) + 1


@pytest.fixture(scope="module")
def golden():
    st = tebd.make_stepper(5, 5, J, DT, 40, device="cpu")
    psi_i = groundstate.initialize_state(5, 5, 5, J, 2.0, 40, device="cpu")
    psi_f = groundstate.initialize_state(5, 5, 5, J, 50.0, 40, device="cpu")
    basis = control.chopped_sine_basis(seeds.linspace(2.0, 50.0, N), DT, T,
                                       5, device="cpu")
    return st, psi_i, psi_f, basis


@pytest.fixture(scope="module")
def prob():
    u0 = seeds.linspace(2.5, 30.0, N)
    j = (jtebd.make_stepper(L, D, J, DT, CHI),
         jgs.initialize_state(L, D, NPART, J, 2.5, CHI),
         jgs.initialize_state(L, D, NPART, J, 30.0, CHI),
         jcontrol.chopped_sine_basis(u0, DT, T, M))
    t = (tebd.make_stepper(L, D, J, DT, CHI, device="cpu"),
         groundstate.initialize_state(L, D, NPART, J, 2.5, CHI, device="cpu"),
         groundstate.initialize_state(L, D, NPART, J, 30.0, CHI,
                                      device="cpu"),
         control.chopped_sine_basis(u0, DT, T, M, device="cpu"))
    rng = np.random.default_rng(7)
    us = u0[None] + rng.normal(0.0, 2.0, (3, N))
    return j, t, us


@pytest.fixture(scope="module")
def jax_grad(prob):
    (st, pi, pf, _), _, us = prob
    g, aux = jax.jit(lambda u: jengine.gradient(st, pi, pf, u, GAMMA))(
        jnp.asarray(us[0]))
    return np.asarray(g), complex(aux[3])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_goldens(golden):
    st, psi_i, psi_f, basis = golden
    u = torch.as_tensor(seeds.linspace(2.0, 50.0, N))
    assert abs(float(engine.cost(st, psi_i, psi_f, u, 0.0))
               - 0.375995) < 1e-5
    c2 = torch.as_tensor(seeds.linspace(0.0, 7.0, 5))
    assert abs(float(engine.cost(st, psi_i, psi_f,
                                 basis.convert_control(c2), 0.0))
               - 0.370157) < 1e-5


def test_cost_and_fidelities_match_jax(prob):
    (st_j, pi_j, pf_j, _), (st, pi, pf, _), us = prob
    u = us[1]
    J_j = float(jengine.cost(st_j, pi_j, pf_j, jnp.asarray(u), GAMMA))
    F_j = np.asarray(jengine.fidelities(st_j, pi_j, pf_j, jnp.asarray(u)))
    ut = torch.as_tensor(u)
    assert abs(float(engine.cost(st, pi, pf, ut, GAMMA)) - J_j) < 1e-10
    np.testing.assert_allclose(engine.fidelities(st, pi, pf, ut).numpy(),
                               F_j, atol=1e-10)
    np.testing.assert_allclose(
        engine.fidelities_streaming(st, pi, pf, ut).numpy(), F_j, atol=1e-10)


def test_gradients_match_jax_and_each_other(prob, jax_grad):
    _, (st, pi, pf, _), us = prob
    g_j, ov_j = jax_grad
    ut = torch.as_tensor(us[0])
    g, (psi_t, xi_t, divT, ov) = engine.gradient(st, pi, pf, ut, GAMMA)
    g_low, (_, none, divT_low, _) = engine.gradient_lowmem(st, pi, pf, ut,
                                                           GAMMA)
    assert psi_t.shape == xi_t.shape == (N, L, CHI, D + 1, CHI)
    assert none is None
    assert _rel(g.numpy(), g_j) < 1e-10
    assert abs(complex(ov) - ov_j) < 1e-10
    np.testing.assert_allclose(g_low.numpy(), g.numpy(), atol=1e-11)
    np.testing.assert_allclose(divT_low.numpy(), divT.numpy(), atol=1e-11)
    J, g2 = engine.cost_and_gradient(st, pi, pf, ut, GAMMA)
    assert torch.equal(g2, g)
    assert abs(float(J) - float(engine.cost(st, pi, pf, ut, GAMMA))) < 1e-12


def test_batched_matches_single(prob):
    _, (st, pi, pf, _), us = prob
    U = torch.as_tensor(us)
    Jb = engine.cost(st, pi, pf, U, GAMMA)
    gb, (psi_b, _, _, ov_b) = engine.gradient(st, pi, pf, U, GAMMA)
    glb, _ = engine.gradient_lowmem(st, pi, pf, U, GAMMA)
    assert Jb.shape == (3,) and gb.shape == (3, N)
    assert psi_b.shape == (3, N, L, CHI, D + 1, CHI) and ov_b.shape == (3,)
    for k in range(3):
        g1, _ = engine.gradient(st, pi, pf, U[k], GAMMA)
        assert abs(float(Jb[k]) - float(engine.cost(st, pi, pf, U[k],
                                                    GAMMA))) < 1e-11
        np.testing.assert_allclose(gb[k].numpy(), g1.numpy(), atol=1e-11)
        np.testing.assert_allclose(glb[k].numpy(), g1.numpy(), atol=1e-11)


def test_hessian_matches_jax():
    """L=3, d=2, chi=3 (the rank bound), N_t=11, GRAPE Hessian."""
    L3, D3 = 3, 2
    u = seeds.linspace(2.5, 30.0, N) + np.random.default_rng(3).normal(
        0.0, 1.0, N)
    st_j = jtebd.make_stepper(L3, D3, J, DT, 3)
    pi_j = jgs.initialize_state(L3, D3, L3, J, 2.5, 3)
    pf_j = jgs.initialize_state(L3, D3, L3, J, 30.0, 3)
    H_j = np.asarray(jax.jit(lambda uu: jengine.hessian(
        st_j, pi_j, pf_j, uu, GAMMA))(jnp.asarray(u)))
    st = tebd.make_stepper(L3, D3, J, DT, 3, device="cpu")
    pi = groundstate.initialize_state(L3, D3, L3, J, 2.5, 3, device="cpu")
    pf = groundstate.initialize_state(L3, D3, L3, J, 30.0, 3, device="cpu")
    H = engine.hessian(st, pi, pf, torch.as_tensor(u), GAMMA).numpy()
    scale = np.abs(H_j).max()
    assert np.abs(H - H_j).max() < 1e-8 * scale
    assert np.abs(H - H.T).max() < 1e-12 * scale


def test_hessian_complex64_snake_eigh_matches_jax():
    """complex64, the snake sweep with eigh splits, L=3, d=2, chi=6, N_t=9
    at the adiabatic seed (the JAX dry run's MPS shapes): LAPACK's QR gave
    NaN in a gauge move and the next eigh raised until
    `householder_qr` zeroed the underflowing columns. The Hessian is
    finite and within 1e-5 of its scale of JAX's (single precision)."""
    n9 = 9
    u = seeds.adiabatic_seed(2.5, 50.0, n9).astype(np.float32)
    c64 = jnp.complex64
    st_j = jtebd.make_stepper(3, 2, J, DT, 6, dtype=c64)
    pi_j = jgs.initialize_state(3, 2, 3, J, 2.5, 6, dtype=c64)
    pf_j = jgs.initialize_state(3, 2, 3, J, 50.0, 6, dtype=c64)
    H_j = np.asarray(jax.jit(lambda uu: jengine.hessian(
        st_j, pi_j, pf_j, uu, 1e-6))(jnp.asarray(u)))
    kw = dict(dtype=torch.complex64, device="cpu")
    st = tebd.make_stepper(3, 2, J, DT, 6, **kw)
    pi = groundstate.initialize_state(3, 2, 3, J, 2.5, 6, **kw)
    pf = groundstate.initialize_state(3, 2, 3, J, 50.0, 6, **kw)
    H = engine.hessian(st, pi, pf, torch.as_tensor(u), 1e-6).numpy()
    assert np.isfinite(H).all()
    assert np.abs(H - H_j).max() < 1e-5 * np.abs(H_j).max()


def test_problem_surface_matches_jax(prob):
    (st_j, pi_j, pf_j, b_j), (st, pi, pf, b), _ = prob
    c = np.random.default_rng(11).normal(0.0, 0.5, M)
    pj = jproblem.OptimalControlProblem(pf_j, pi_j, st_j, basis=b_j,
                                        gamma=GAMMA, bfgs=True)
    pt = problem.OptimalControlProblem(pf, pi, st, basis=b, gamma=GAMMA,
                                       bfgs=True)
    Jj, gj = pj.get_cost_and_gradient(c)
    Jt, gt = pt.get_cost_and_gradient(c)
    assert abs(float(Jt) - float(Jj)) < 1e-10
    assert _rel(gt.numpy(), np.asarray(gj)) < 1e-10
    assert abs(float(pt.get_cost(c)) - float(Jj)) < 1e-10
    np.testing.assert_allclose(pt.get_control(c).numpy(),
                               np.asarray(pj.get_control(c)), atol=1e-12)
    np.testing.assert_allclose(pt.get_time_axis(), pj.get_time_axis())
    assert pt.grape().M == 0 and pt.use_bfgs()
    assert backends.engine_for(st) is engine
    assert backends.sector_fits(5, 4, 5)


@pytest.fixture(scope="module")
def sector_prob():
    st_j = jsector.make_sector_stepper(5, 4, 5, 1.0, DT)
    fields = {k: np.asarray(v) for k, v in dataclasses.asdict(st_j).items()}
    st = sector.stepper_from_numpy(fields, "cpu")
    pi = jsector.sector_ground_state(5, 4, 5, 1.0, 2.5)
    pf = jsector.sector_ground_state(5, 4, 5, 1.0, 50.0)
    u = seeds.adiabatic_seed(2.5, 50.0, N) + np.random.default_rng(5).normal(
        0.0, 0.3, N)
    return st_j, st, pi, pf, u


def test_sector_additions_match_jax(sector_prob):
    st_j, st, pi, pf, u = sector_prob
    g_j, aux_j = jsector.gradient_lowmem(st_j, jnp.asarray(pi),
                                         jnp.asarray(pf), jnp.asarray(u),
                                         GAMMA)
    pit, pft, ut = (torch.as_tensor(x) for x in (pi, pf, u))
    g, (a, b, divT, ov) = sector.gradient_lowmem(st, pit, pft, ut, GAMMA)
    assert a is None and b is None
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), atol=1e-12)
    np.testing.assert_allclose(divT.numpy(), np.asarray(aux_j[2]),
                               atol=1e-12)
    g_full, _ = sector.gradient(st, pit, pft, ut, GAMMA)
    np.testing.assert_allclose(g.numpy(), g_full.numpy(), atol=1e-11)
    np.testing.assert_allclose(
        sector.expectation_n(st, pit).numpy(),
        np.asarray(jsector.expectation_n(st_j, jnp.asarray(pi))), atol=1e-14)
    np.testing.assert_allclose(
        sector.fidelities_streaming(st, pit, pft, ut).numpy(),
        sector.fidelities(st, pit, pft, ut).numpy(), atol=0)
    J, g2 = sector.cost_and_gradient(st, pit, pft, ut, GAMMA)
    assert torch.equal(g2, g_full)


def test_constructors_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    calls = [
        lambda: tebd.make_stepper(3, 2, J, DT, 3),
        lambda: sector.make_sector_stepper(3, 2, 3, J, DT),
        lambda: sector.sector_ground_state(3, 2, 3, J, 2.5),
        lambda: control.chopped_sine_basis(np.zeros(N), DT, T, 2),
        lambda: engine.regularization_hessian(N, GAMMA, DT),
        lambda: groundstate.initialize_state(3, 2, 3, J, 2.5, 3),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
