"""The port's host library (csrc/ocmps_native.cpp, optimalcontrolmps_torch/
native.py) against its plain-Python twins and the JAX package, at
tests/test_native.py's cases:
* enumeration: exact against the port's Python twin and the JAX package's
  groundstate.sector_basis; the count against sector_dim;
* the COO Hamiltonian: indices exact and values to 1e-12 against the twin
  (entry for entry), the dense matrix against the JAX package's to 1e-12;
* linsigmoid_batch: bitwise equal to the JAX package's native library
  (built from the same source with the same flags) when it loads.
"""

import numpy as np
import pytest

from optimalcontrolmps_tpu import groundstate as jgs
from optimalcontrolmps_tpu import native as jnative
from optimalcontrolmps_torch import groundstate, native

CASES = [(5, 4, 5), (4, 3, 6), (6, 2, 6)]


@pytest.mark.parametrize("case", CASES)
def test_enumeration_matches_twin_and_jax(case):
    states, flat = native.sector_basis(*case)
    py_states, py_flat = groundstate.sector_basis_python(*case)
    np.testing.assert_array_equal(states, py_states)
    np.testing.assert_array_equal(flat, py_flat)
    j_states, j_flat = jgs.sector_basis(*case)
    np.testing.assert_array_equal(states, np.asarray(j_states))
    np.testing.assert_array_equal(flat, np.asarray(j_flat))
    assert native.sector_count(*case) == len(py_states)
    assert (np.diff(flat) > 0).all()
    # groundstate.sector_basis takes the host library
    np.testing.assert_array_equal(groundstate.sector_basis(*case)[0], states)


@pytest.mark.parametrize("case", CASES)
def test_coo_hamiltonian_matches_twin(case):
    r, c, v, n = native.sector_hamiltonian_coo(*case, 1.0, 2.5)
    pr, pc, pv, pn = groundstate.sector_hamiltonian_coo_python(*case, 1.0,
                                                               2.5)
    assert n == pn
    np.testing.assert_array_equal(r, pr)
    np.testing.assert_array_equal(c, pc)
    np.testing.assert_allclose(v, pv, rtol=0, atol=1e-12)


def test_dense_hamiltonian_matches_jax_and_ground_energy():
    L, d, npart = 5, 4, 5
    H = groundstate.sector_hamiltonian(L, d, npart, 1.0, 2.5)
    assert np.abs(H - H.T).max() < 1e-12
    Hj = np.asarray(jgs.sector_hamiltonian(L, d, npart, 1.0, 2.5))
    np.testing.assert_allclose(H, Hj, rtol=0, atol=1e-12)
    assert abs(np.linalg.eigvalsh(H)[0] - np.linalg.eigvalsh(Hj)[0]) < 1e-12


@pytest.mark.parametrize("case", [(5, 4, 5), (8, 3, 8), (12, 5, 12)])
def test_sector_dim_matches_sector_count(case):
    assert groundstate.sector_dim(*case) == native.sector_count(*case)


def test_linsigmoid_batch_bitwise_equal_to_jax_native():
    b = native.linsigmoid_batch(2.5, 50.0, 201, 8, seed=3)
    assert b.shape == (8, 201)
    assert np.all(np.abs(b[:, 0] - 2.5) < 0.05)
    assert np.all(np.abs(b[:, -1] - 50.0) < 0.05)
    assert np.abs(b[0] - b[1]).max() > 0.1
    if jnative.load() is None:
        pytest.skip("the JAX package's native library did not load")
    ref = jnative.linsigmoid_batch(2.5, 50.0, 201, 8, seed=3)
    assert np.array_equal(b, ref)
