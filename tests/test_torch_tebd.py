"""The port's TEBD propagator against the exact statevector, at 1e-9.

The dense oracle is the JAX package's `exact.exact_step` (and the port's
`exact.exact_step` is held to it); the port's snake and brick sweeps run
from the same numpy ground states, forward and backward, on L = 2..5 with
chi at the exact rank bound (tests/test_tebd.py:45 tolerance). Statevectors
are compared with the global phase fixed.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu import exact as jexact
from optimalcontrolmps_tpu import groundstate as jgs
from optimalcontrolmps_torch import exact, groundstate, mps, tebd
from optimalcontrolmps_torch.sites import op


D, J, DT = 3, 1.0, 0.01
STEPS = 6


def _phase_fixed_err(v, ref):
    v, ref = np.asarray(v), np.asarray(ref)
    ph = np.vdot(v, ref)
    return np.abs(v * ph / abs(ph) - ref).max()


def _start(L):
    vec = jgs.ground_statevector(L, D, L, J, 2.5)
    chi = tebd.exact_rank_bound(L, D + 1)
    A = torch.as_tensor(mps.from_statevector(vec, L, D + 1, chi))[None]
    return vec, chi, A


@pytest.mark.parametrize("L", [2, 3, 4, 5])
@pytest.mark.parametrize("sweep", ["snake", "brick"])
@pytest.mark.parametrize("forward", [True, False])
def test_tebd_matches_exact_statevector(L, sweep, forward):
    vec, chi, A = _start(L)
    method = "range" if sweep == "brick" else "eigh"
    st = tebd.make_stepper(L, D, J, DT, chi, trunc_method=method,
                           sweep=sweep, device="cpu")
    est = jexact.make_exact_stepper(L, D, J, DT)
    u = np.linspace(2.5, 30.0, STEPS + 1)
    psi = jnp.asarray(vec)
    for i in range(STEPS):
        A = tebd.tebd_step(st, A, u[i], u[i + 1], forward)
        psi = jexact.exact_step(est, psi, u[i], u[i + 1], forward)
    assert _phase_fixed_err(mps.to_statevector(A)[0], psi) < 1e-9


def test_port_exact_step_matches_jax():
    L = 4
    vec = jgs.ground_statevector(L, D, L, J, 2.5)
    est_j = jexact.make_exact_stepper(L, D, J, DT)
    est_t = exact.make_exact_stepper(L, D, J, DT, device="cpu")
    np.testing.assert_array_equal(exact.statevector_nn1_total(L, D),
                                  jexact.statevector_nn1_total(L, D))
    psi_j, psi_t = jnp.asarray(vec), torch.as_tensor(vec)
    for forward in (True, False):
        psi_j = jexact.exact_step(est_j, psi_j, 3.0, 7.0, forward)
        psi_t = exact.exact_step(est_t, psi_t, 3.0, 7.0, forward)
        np.testing.assert_allclose(psi_t.numpy(), np.asarray(psi_j),
                                   atol=1e-13)


@pytest.mark.parametrize("method,gauge", [("svd", "qr"), ("rsvd", "qr"),
                                          ("eigh", "cholesky")])
def test_other_truncations_and_gauges_match_eigh(method, gauge):
    L = 5
    _, chi, A = _start(L)
    st_m = tebd.make_stepper(L, D, J, DT, chi, trunc_method=method,
                             gauge_method=gauge, device="cpu")
    st_e = tebd.make_stepper(L, D, J, DT, chi, device="cpu")
    B, C = A, A
    for i in range(4):
        B = tebd.tebd_step(st_m, B, 2.5 + i, 3.5 + i)
        C = tebd.tebd_step(st_e, C, 2.5 + i, 3.5 + i)
    # CholeskyQR's ridge leaves its isometries 1e-6 off, so the norm drifts
    # by as much; the direction of the state is compared
    ov = complex(mps.overlap(B, C)[0]) / float(mps.norm(B)[0] * mps.norm(C)[0])
    assert abs(abs(ov) - 1.0) < 1e-9


def test_lanes_step_independently_and_conserve():
    """A batch of three lanes with their own controls equals three single
    steps; norm and particle number are conserved."""
    L = 4
    _, chi, A = _start(L)
    st = tebd.make_stepper(L, D, J, DT, chi, device="cpu")
    u_from = torch.tensor([2.5, 7.0, 20.0], dtype=torch.float64)
    u_to = torch.tensor([3.0, 9.0, 15.0], dtype=torch.float64)
    batch = tebd.tebd_step(st, A.expand(3, *A.shape[1:]), u_from, u_to)
    for k in range(3):
        one = tebd.tebd_step(st, A, float(u_from[k]), float(u_to[k]))
        np.testing.assert_allclose(mps.to_statevector(batch[k:k + 1]),
                                   mps.to_statevector(one), atol=1e-12)
    np.testing.assert_allclose(mps.norm(batch).numpy(), 1.0, atol=1e-12)
    total_n = mps.expectation_values(batch, op("N", D)).real.sum(-1)
    np.testing.assert_allclose(total_n.numpy(), L, atol=1e-8)


def test_make_stepper_guards():
    with pytest.raises(ValueError, match="brick"):
        tebd.make_stepper(5, D, J, DT, 10, trunc_method="range",
                          sweep="brick", device="cpu")
    with pytest.raises(ValueError, match="range"):
        tebd.make_stepper(4, 2, J, DT, 4, trunc_method="range",
                          device="cpu")
    with pytest.raises(ValueError, match="requires trunc_method='range'"):
        tebd.make_stepper(4, 2, J, DT, 9, sweep="brick", device="cpu")
    assert tebd.make_stepper(4, 2, J, DT, 9, sweep="vidal",
                             device="cpu").sweep == "vidal"
    with pytest.raises(NotImplementedError, match="eigh"):
        tebd.make_stepper(4, 2, J, DT, 9, trunc_method="nssub",
                          device="cpu")
    tebd.make_stepper(4, 2, J, DT, 9, trunc_method="range", device="cpu")
    assert tebd.exact_rank_bound(5, 5) == 25


def test_initialize_state_matches_jax():
    from optimalcontrolmps_tpu import mps as jmps
    A = groundstate.initialize_state(4, D, 4, J, 2.5, 16, device="cpu")
    A_j = jgs.initialize_state(4, D, 4, J, 2.5, 16)
    np.testing.assert_allclose(mps.to_statevector(A[None])[0].numpy(),
                               np.asarray(jmps.to_statevector(A_j)),
                               atol=1e-12)
    # method="dmrg" (the JAX package's DMRG above its exact limit) lands on
    # the same state
    A_d = groundstate.initialize_state(4, D, 4, J, 2.5, 16, method="dmrg",
                                       device="cpu")
    ov = mps.overlap(A_d[None], A[None])
    assert abs(abs(complex(ov[0])) - 1.0) < 1e-8
