"""Parity of the port's DMRG ground states with the JAX package's.

tests/test_dmrg.py's checks, with both packages on the CPU in complex128:
* `ramp_schedule` equal to JAX's (the reference's maxm ramp, :11-17);
* L=5, d=4, chi=25: the energy within 1e-9 of the exact sector ground
  state and (on one chi stage) of JAX's DMRG energy, |overlap| with the
  exact state within 1e-8 of 1 (:20-27);
* L=6, d=3, chi=20 (truncating): the particle number to 1e-6, the norm to
  1e-9, the energy from above within 1e-6 of exact (:30-43);
* `bh_mpo` bitwise equal to JAX's (it is numpy in both);
* `groundstate.initialize_state` takes DMRG above EXACT_DIAG_MAX_DIM sector
  states and for method="dmrg".
"""

import numpy as np
import pytest
import torch

from optimalcontrolmps_tpu import dmrg as jdmrg
from optimalcontrolmps_torch import dmrg, groundstate, mps
from optimalcontrolmps_torch.sites import op


def test_ramp_schedule_matches_jax():
    for chi in (8, 10, 25, 64, 128, 200, 256):
        assert dmrg.ramp_schedule(chi) == jdmrg.ramp_schedule(chi)
    assert dmrg.ramp_schedule(128) == [10, 20, 50, 100, 128]


@pytest.mark.parametrize("penalty", [0.0, 2.0])
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_bh_mpo_is_bitwise_jax(penalty, dtype):
    kw = dict(npart=5, number_penalty=penalty) if penalty else {}
    W = dmrg.bh_mpo(5, 4, 1.0, 2.5, dtype=dtype, **kw)
    Wj = jdmrg.bh_mpo(5, 4, 1.0, 2.5, dtype=dtype, **kw)
    assert W.dtype == Wj.dtype and W.shape == (5, 5, 5, 5)
    np.testing.assert_array_equal(W, Wj)


def test_lanczos_ground_of_a_hermitian_matrix():
    """The Lanczos kernel alone: lowest eigenpair of a random Hermitian
    matrix of dimension 40 at depth 25 (full reorthogonalization)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(40, 40)) + 1j * rng.normal(size=(40, 40))
    H = torch.as_tensor(a + a.conj().T)
    w = np.linalg.eigvalsh(H.numpy())
    e, v = dmrg._lanczos_ground(lambda x: H @ x,
                                torch.ones(40, dtype=torch.complex128), k=40)
    assert abs(e - w[0]) < 1e-9
    assert float(torch.linalg.vector_norm(H @ v - e * v)) < 1e-6


def test_dmrg_matches_exact_and_jax():
    L, d, npart = 5, 4, 5
    E0 = np.linalg.eigvalsh(
        groundstate.sector_hamiltonian(L, d, npart, 1.0, 2.5))[0]
    A, e, hist = dmrg.dmrg_ground_state(L, d, npart, 1.0, 2.5, chi=25,
                                        n_sweeps=5, device="cpu",
                                        return_history=True)
    assert A.shape == (L, 25, d + 1, 25) and A.dtype == torch.complex128
    assert abs(e - E0) < 1e-9
    vec = groundstate.ground_statevector(L, d, npart, 1.0, 2.5)
    ov = abs(np.vdot(mps.to_statevector(A[None])[0].numpy(), vec))
    assert abs(ov - 1.0) < 1e-8
    assert [h[0] for h in hist[:3]] == [10, 20, 25]
    # against JAX's DMRG on one chi stage (each stage is a compiled program)
    e1 = dmrg.dmrg_ground_state(L, d, npart, 1.0, 2.5, chi=25, n_sweeps=5,
                                schedule=[25], device="cpu")[1]
    _, ej = jdmrg.dmrg_ground_state(L, d, npart, 1.0, 2.5, chi=25,
                                   n_sweeps=5, schedule=[25])
    assert abs(e1 - float(ej)) < 1e-9 and abs(e1 - E0) < 1e-9


def test_dmrg_conserves_particle_number():
    """The (N - npart)^2 penalty keeps the dense DMRG in the sector."""
    L, d, npart = 6, 3, 6
    A, e = dmrg.dmrg_ground_state(L, d, npart, 1.0, 3.0, chi=20,
                                  n_sweeps=5, device="cpu")
    ntot = float(mps.expectation_values(A[None], op("N", d)).real.sum())
    assert abs(ntot - npart) < 1e-6
    assert abs(float(mps.norm(A[None])[0]) - 1.0) < 1e-9
    E0 = np.linalg.eigvalsh(
        groundstate.sector_hamiltonian(L, d, npart, 1.0, 3.0))[0]
    assert E0 - 1e-10 <= e < E0 + 1e-6


def test_initialize_state_takes_dmrg_above_the_exact_limit(monkeypatch):
    """method="auto" runs DMRG above EXACT_DIAG_MAX_DIM sector states,
    method="dmrg" always; both give the sector's ground state here."""
    calls = []
    real = groundstate.dmrg_ground_state

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(groundstate, "dmrg_ground_state", spy)
    L, d, npart, chi = 4, 2, 4, 9
    vec = groundstate.ground_statevector(L, d, npart, 1.0, 2.5)
    A = groundstate.initialize_state(L, d, npart, 1.0, 2.5, chi,
                                     device="cpu")
    assert calls == []
    monkeypatch.setattr(groundstate, "EXACT_DIAG_MAX_DIM",
                        groundstate.sector_dim(L, d, npart) - 1)
    A_auto = groundstate.initialize_state(L, d, npart, 1.0, 2.5, chi,
                                          device="cpu",
                                          dtype=torch.complex64)
    A_dmrg = groundstate.initialize_state(L, d, npart, 1.0, 2.5, chi,
                                          method="dmrg", device="cpu")
    assert len(calls) == 2 and calls[0]["dtype"] == torch.complex64
    assert A_auto.dtype == torch.complex64
    for B, tol in ((A, 1e-12), (A_auto, 1e-5), (A_dmrg, 1e-8)):
        got = mps.to_statevector(B[None].to(torch.complex128))[0].numpy()
        assert abs(abs(np.vdot(got, vec)) - 1.0) < tol
    with pytest.raises(ValueError, match="method"):
        groundstate.initialize_state(L, d, npart, 1.0, 2.5, chi,
                                     method="lanczos", device="cpu")


def test_dmrg_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dmrg.dmrg_ground_state(3, 2, 3, 1.0, 2.5, chi=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        groundstate.initialize_state(3, 2, 3, 1.0, 2.5, 4, method="dmrg")
