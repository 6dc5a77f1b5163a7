"""Parity of the PyTorch port's sector engine with the JAX package.

Both packages run on the CPU in float64 on the same inputs (numpy seeds).
The port's steppers are built from the JAX stepper's fields
(`stepper_from_numpy`), and the port's own constructors are held to those
fields, so both sides compute on identical constants.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu import control as jcontrol
from optimalcontrolmps_tpu import engine as jengine
from optimalcontrolmps_tpu import groundstate as jgs
from optimalcontrolmps_tpu import sector as jsector
from optimalcontrolmps_tpu import seeds as jseeds
from optimalcontrolmps_tpu import sites as jsites
from optimalcontrolmps_tpu.ops import gates as jgates
from optimalcontrolmps_tpu.optimize import penalty as jpenalty
from optimalcontrolmps_torch import control, engine, groundstate, sector
from optimalcontrolmps_torch import seeds, sites
from optimalcontrolmps_torch.ops import gates
from optimalcontrolmps_torch.optimize import penalty


T, DT, M, L, D, NPART, GAMMA = 0.5, 0.01, 8, 5, 4, 5, 1e-6
N = int(round(T / DT)) + 1


@pytest.fixture(scope="module")
def prob():
    st_j = jsector.make_sector_stepper(L, D, NPART, 1.0, DT)
    fields = {k: np.asarray(v) for k, v in dataclasses.asdict(st_j).items()}
    st_t = sector.stepper_from_numpy(fields, "cpu")
    psi_i = jsector.sector_ground_state(L, D, NPART, 1.0, 2.5)
    psi_f = jsector.sector_ground_state(L, D, NPART, 1.0, 50.0)
    rng = np.random.default_rng(5)
    u = jseeds.adiabatic_seed(2.5, 50.0, N) + rng.normal(0, 0.3, N)
    return st_j, fields, st_t, psi_i, psi_f, u


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# host-side constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["N", "A", "Adag", "N(N-1)", "NN", "Id"])
def test_site_operators_equal(name):
    np.testing.assert_array_equal(sites.op(name, D), jsites.op(name, D))


def test_site_hopping_and_gate_equal():
    np.testing.assert_array_equal(sites.nn1_diag(D), jsites.nn1_diag(D))
    np.testing.assert_array_equal(sites.hop_two_site(1.0, D),
                                  jsites.hop_two_site(1.0, D))
    np.testing.assert_allclose(gates.j_gate(1.0, D, DT),
                               jgates.j_gate(1.0, D, DT), atol=1e-14)


def test_sector_basis_and_hamiltonian_equal():
    states, flat = groundstate.sector_basis(L, D, NPART)
    states_j, flat_j = jgs.sector_basis(L, D, NPART)
    np.testing.assert_array_equal(states, states_j)
    np.testing.assert_array_equal(flat, flat_j)
    assert groundstate.sector_dim(L, D, NPART) == 121 == len(states)
    np.testing.assert_allclose(
        groundstate.sector_hamiltonian(L, D, NPART, 1.0, 2.5),
        jgs.sector_hamiltonian(L, D, NPART, 1.0, 2.5), atol=1e-14)


@pytest.mark.parametrize("field", ["WJ_fwd_p", "WJ_bwd_p", "nn1_p",
                                   "nn1_inv_p", "nn1_vals", "occ"])
def test_stepper_fields_equal(prob, field):
    _, fields, _, _, _, _ = prob
    st = sector.make_sector_stepper(L, D, NPART, 1.0, DT, device="cpu")
    assert (st.ns, st.ns_p) == (121, 128)
    np.testing.assert_allclose(getattr(st, field).numpy(), fields[field],
                               atol=1e-14)


@pytest.mark.parametrize("U", [2.5, 50.0])
def test_ground_states_equal(U):
    np.testing.assert_allclose(
        sector.sector_ground_state(L, D, NPART, 1.0, U,
                                   device="cpu").numpy(),
        jsector.sector_ground_state(L, D, NPART, 1.0, U), atol=1e-14)


def test_seeds_equal():
    np.testing.assert_array_equal(seeds.linspace(0.0, 100.0, N),
                                  jseeds.linspace(0.0, 100.0, N))
    np.testing.assert_array_equal(seeds.adiabatic_seed(2.5, 50.0, N),
                                  jseeds.adiabatic_seed(2.5, 50.0, N))
    np.testing.assert_array_equal(
        seeds.linsigmoid_seed(2.5, 50.0, N, rng=np.random.default_rng(3)),
        jseeds.linsigmoid_seed(2.5, 50.0, N, rng=np.random.default_rng(3)))
    np.testing.assert_array_equal(
        seeds.random_coeff_seed(-1, 1, M, rng=np.random.default_rng(3)),
        jseeds.random_coeff_seed(-1, 1, M, rng=np.random.default_rng(3)))


def test_basis_equal_and_converts():
    u0 = jseeds.linsigmoid_seed(2.5, 50.0, N, rng=np.random.default_rng(1))
    b_j = jcontrol.chopped_sine_basis(u0, DT, T, M)
    b_t = control.chopped_sine_basis(u0, DT, T, M, device="cpu")
    for name in ("u0", "S", "f"):
        np.testing.assert_allclose(getattr(b_t, name).numpy(),
                                   np.asarray(getattr(b_j, name)), atol=1e-14)
    b_f = control.basis_from_numpy(b_j.u0, b_j.S, b_j.f, "cpu")
    c = np.random.default_rng(2).normal(size=M)
    np.testing.assert_allclose(b_f.convert_control(_t(c)).numpy(),
                               np.asarray(b_j.convert_control(jnp.asarray(c))),
                               atol=1e-12)
    H = np.random.default_rng(4).normal(size=(N, N))
    np.testing.assert_allclose(b_f.convert_hessian(_t(H)).numpy(),
                               np.asarray(b_j.convert_hessian(jnp.asarray(H))),
                               atol=1e-10)


def test_regularization_and_penalty_equal(prob):
    u = prob[5]
    ut = _t(u)
    assert abs(float(engine.regularization(ut, GAMMA, DT))
               - float(jengine.regularization(u, GAMMA, DT))) < 1e-14
    np.testing.assert_allclose(
        engine.regularization_grad(ut, GAMMA, DT).numpy(),
        np.asarray(jengine.regularization_grad(jnp.asarray(u), GAMMA, DT)),
        atol=1e-14)
    np.testing.assert_array_equal(
        engine.regularization_hessian(N, GAMMA, DT, device="cpu").numpy(),
        np.asarray(jengine.regularization_hessian(N, GAMMA, DT)))
    v = u - 10.0  # some controls below the bound u_min=2
    assert abs(float(penalty.bound_penalty(_t(v)))
               - float(jpenalty.bound_penalty(jnp.asarray(v)))) < 1e-10


# ---------------------------------------------------------------------------
# propagation and derivatives, float64
# ---------------------------------------------------------------------------

def test_rollout_final_cost_fidelities(prob):
    st_j, _, st_t, psi_i, psi_f, u = prob
    pi, pf, ut = _t(psi_i), _t(psi_f), _t(u)
    np.testing.assert_allclose(
        sector.rollout_final(st_t, pi, ut).numpy(),
        np.asarray(jsector.rollout_final(st_j, psi_i, u)), atol=1e-12)
    assert abs(float(sector.cost(st_t, pi, pf, ut, GAMMA))
               - float(jsector.cost(st_j, psi_i, psi_f, u, GAMMA))) < 1e-12
    np.testing.assert_allclose(
        sector.fidelities(st_t, pi, pf, ut).numpy(),
        np.asarray(jsector.fidelities(st_j, psi_i, psi_f, u)), atol=1e-12)


def test_rollout_and_costate_trajectories(prob):
    st_j, _, st_t, psi_i, psi_f, u = prob
    np.testing.assert_allclose(
        sector.rollout(st_t, _t(psi_i), _t(u)).numpy(),
        np.asarray(jsector.rollout(st_j, psi_i, u)), atol=1e-12)
    np.testing.assert_allclose(
        sector.costate_rollout(st_t, _t(psi_f), _t(u)).numpy(),
        np.asarray(jsector.costate_rollout(st_j, psi_f, u)), atol=1e-12)


def test_adjoint_gradient(prob):
    st_j, _, st_t, psi_i, psi_f, u = prob
    g_t, _ = sector.gradient(st_t, _t(psi_i), _t(psi_f), _t(u), GAMMA)
    g_j, _ = jsector.gradient(st_j, psi_i, psi_f, u, GAMMA)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g_t.numpy(), g_j,
                               atol=1e-10 * max(np.max(np.abs(g_j)), 1.0))


def test_autograd_cost_gradient(prob):
    st_j, _, st_t, psi_i, psi_f, u = prob
    J_t, g_t = sector.cost_and_gradient_exact(st_t, _t(psi_i), _t(psi_f),
                                              _t(u), GAMMA)
    J_j, g_j = jsector.cost_and_gradient_exact(st_j, psi_i, psi_f,
                                               jnp.asarray(u), GAMMA)
    g_j = np.asarray(g_j)
    assert abs(float(J_t) - float(J_j)) < 1e-12
    np.testing.assert_allclose(g_t.numpy(), g_j,
                               atol=1e-10 * max(np.max(np.abs(g_j)), 1.0))


def test_sector_step_batched_rows(prob):
    """The batched row step used by the Hessian equals the JAX step on
    each padded row."""
    st_j, _, st_t, psi_i, _, u = prob
    rows = np.stack([np.pad(psi_i, (0, 7)) * (k + 1) for k in range(3)])
    out = sector.sector_step(st_t, _t(rows), _t(u[3]), _t(u[4]))
    for k in range(3):
        ref = np.asarray(jsector.sector_step(st_j, jnp.asarray(rows[k]),
                                             u[3], u[4]))
        np.testing.assert_allclose(out[k].numpy(), ref, atol=1e-12)


def test_hessian(prob):
    st_j, _, st_t, psi_i, psi_f, u = prob
    u_s = u[:11]  # T = 0.1 keeps the JAX compile short
    H_t = sector.hessian(st_t, _t(psi_i), _t(psi_f), _t(u_s), GAMMA).numpy()
    H_j = np.asarray(jsector.hessian(st_j, psi_i, psi_f, jnp.asarray(u_s),
                                     GAMMA))
    np.testing.assert_allclose(H_t, H_j, atol=1e-10 * np.max(np.abs(H_j)))
    np.testing.assert_allclose(H_t, H_t.T, atol=1e-15)
