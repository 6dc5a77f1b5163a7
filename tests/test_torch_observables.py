"""The port's observables and small driver helpers against the JAX package's.

The fixture of tests/test_observables_io.py (L=5, d=4, chi=30, the U=3
ground state split from its exact vector) goes, as the same numpy arrays,
through optimalcontrolmps_tpu.observables (CPU, x64) and
optimalcontrolmps_torch.observables (device="cpu", complex128, a batch of
one state); the values agree to 1e-10. The numpy helpers the analysis
drivers call (sites, seeds, ramps, the saveRowmat writer) agree exactly,
files byte for byte; `streaming.rollout_measure` stacks tuple and dict
measures field by field; `profiling` keeps the JAX package's accounting.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optimalcontrolmps_tpu import groundstate as jgs
from optimalcontrolmps_tpu import io as jio
from optimalcontrolmps_tpu import mps as jmps
from optimalcontrolmps_tpu import observables as jobs
from optimalcontrolmps_tpu import profiling as jprof
from optimalcontrolmps_tpu import seeds as jseeds
from optimalcontrolmps_tpu import sites as jsites
from optimalcontrolmps_tpu.drivers import common as jcommon
from optimalcontrolmps_torch import io as tio
from optimalcontrolmps_torch import mps as tmps
from optimalcontrolmps_torch import observables as tobs
from optimalcontrolmps_torch import profiling as tprof
from optimalcontrolmps_torch import seeds as tseeds
from optimalcontrolmps_torch import sites as tsites
from optimalcontrolmps_torch import streaming as tstreaming
from optimalcontrolmps_torch.drivers import common as tcommon


L, D, NPART, CHI = 5, 4, 5, 30
TOL = 1e-10


@pytest.fixture(scope="module")
def state():
    """(numpy MPS, JAX MPS, the port's batch of it) of the U=3 ground
    state, and the product Mott state's numpy MPS."""
    vec = jgs.ground_statevector(L, D, NPART, 1.0, 3.0)
    A = jmps.from_statevector(vec, L, D + 1, CHI)
    mott = jmps.product_state([1] * L, D + 1, CHI)
    return A, jnp.asarray(A), torch.as_tensor(A)[None], mott


def ops(*names):
    return [jsites.op(n, D) for n in names]


@pytest.mark.parametrize("i,j", [(0, 3), (2, 2), (4, 1)])
def test_correlation_function_matches_jax(state, i, j):
    _, jA, tA, _ = state
    adag, a = ops("Adag", "A")
    want = complex(jobs.correlation_function(jA, adag, i, a, j))
    got = tobs.correlation_function(tA, adag, i, a, j)
    assert got.shape == (1,)
    assert abs(complex(got[0]) - want) < TOL


def test_correlation_matrix_matches_jax(state):
    _, jA, tA, _ = state
    adag, a = ops("Adag", "A")
    want = np.asarray(jobs.correlation_matrix(jA, adag, a))
    got = tobs.correlation_matrix(tA, adag, a)[0].numpy()
    assert np.abs(got - want).max() < TOL
    assert np.abs(got - got.conj().T).max() < TOL
    assert abs(np.trace(got).real - NPART) < 1e-8


def test_window_correlations_match_jax_and_pairs(state):
    """The shared-environment pass equals JAX's and the port's own
    per-pair correlation_function values."""
    _, jA, tA, _ = state
    a, adag, n = ops("A", "Adag", "N")
    start, end = 1, L - 1
    want = jobs.window_correlations(jA, a, adag, n, start, end)
    got = tobs.window_correlations(tA, a, adag, n, start, end)
    for w, g in zip(want, got):
        assert g.shape == (1, end - start)
        assert np.abs(g[0].numpy() - np.asarray(w)).max() < TOL
    eye = np.eye(D + 1)
    exp0 = float(tobs.correlation_function(tA, n, start, eye, start)[0].real)
    for k, j in enumerate(range(start + 1, end + 1)):
        sp = float(tobs.correlation_function(tA, adag, start, a, j)[0].real)
        dd = float(tobs.correlation_function(tA, n, start, n, j)[0].real)
        expj = float(tobs.correlation_function(tA, n, j, eye, j)[0].real)
        assert abs(float(got[0][0, k]) - sp) < TOL
        assert abs(float(got[1][0, k]) - dd) < TOL
        assert abs(float(got[2][0, k]) - (dd - exp0 * expj)) < TOL


def test_condensate_fraction_matches_jax_and_mott_is_one(state):
    _, jA, tA, mott = state
    adag, a = ops("Adag", "A")
    want = float(jobs.condensate_fraction(jA, adag, a))
    got = float(tobs.condensate_fraction(tA, adag, a)[0])
    assert abs(got - want) < TOL
    assert 1.0 < got < NPART
    lam_mott = tobs.condensate_fraction(torch.as_tensor(mott)[None], adag, a)
    assert abs(float(lam_mott[0]) - 1.0) < TOL


def test_defect_metrics_match_jax(state):
    _, jA, tA, mott = state
    n, nn = ops("N", "NN")
    pairs = ((jobs.mean_density_deviation(jA, n),
              tobs.mean_density_deviation(tA, n)),
             (jobs.number_fluctuation(jA, n, nn),
              tobs.number_fluctuation(tA, n, nn)))
    for want, got in pairs:
        assert got.shape == (1,)
        assert abs(float(got[0]) - float(want)) < TOL
    tm = torch.as_tensor(mott)[None]
    assert float(tobs.mean_density_deviation(tm, n)[0]) < 1e-12
    assert abs(float(tobs.number_fluctuation(tm, n, nn)[0])) < 1e-12


def test_reexports_match_jax(state):
    _, jA, tA, _ = state
    (n,) = ops("N")
    assert tobs.expectation_values is tmps.expectation_values
    assert tobs.entanglement_entropies is tmps.entanglement_entropies
    assert np.abs(tobs.expectation_values(tA, n)[0].numpy()
                  - np.asarray(jobs.expectation_values(jA, n))).max() < TOL
    assert np.abs(tobs.entanglement_entropies(tA)[0].numpy()
                  - np.asarray(jobs.entanglement_entropies(jA))).max() < 1e-8


def test_a_batch_gives_each_state_its_own_values(state):
    """Two states in one batch: each row equals its state alone."""
    A, _, tA, mott = state
    both = torch.as_tensor(np.stack([A, mott]))
    adag, a, n, nn = ops("Adag", "A", "N", "NN")
    alone = torch.cat([tA, torch.as_tensor(mott)[None]])
    for f in (lambda s: tobs.correlation_matrix(s, adag, a),
              lambda s: tobs.correlation_function(s, adag, 0, a, 3),
              lambda s: tobs.window_correlations(s, a, adag, n, 0, 3)[2],
              lambda s: tobs.condensate_fraction(s, adag, a),
              lambda s: tobs.number_fluctuation(s, n, nn)):
        batch = f(both)
        rows = torch.cat([f(alone[k:k + 1]) for k in range(2)])
        assert torch.allclose(batch, rows, atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the drivers' numpy helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 4, 7])
def test_site_helpers_equal_jax(d):
    assert tsites.local_dim(d) == jsites.local_dim(d) == d + 1
    np.testing.assert_array_equal(tsites.n_diag(d), jsites.n_diag(d))


@pytest.mark.parametrize("a,b,c", [(0.0, 5e-3, 5.0), (0.0, 0.01, 0.1),
                                   (0.3, 0.07, 2.0)])
def test_generate_range_equals_jax(a, b, c):
    np.testing.assert_array_equal(tseeds.generate_range(a, b, c),
                                  jseeds.generate_range(a, b, c))


@pytest.mark.parametrize("name", ["exp_ramp", "quench_ramp"])
def test_ramps_equal_jax(name):
    for n in (11, 601, 1001):
        np.testing.assert_array_equal(
            getattr(tcommon, name)(2.5, 50.0, n),
            getattr(jcommon, name)(2.5, 50.0, n))


def test_write_rowmat_is_byte_equal(tmp_path):
    rng = np.random.default_rng(3)
    rows = np.column_stack([np.arange(7) * 5e-3, rng.normal(size=(7, 4)),
                            rng.integers(0, 70, size=(7, 2))])
    jio.write_rowmat(str(tmp_path / "j.txt"), rows)
    tio.write_rowmat(str(tmp_path / "t.txt"), rows)
    assert ((tmp_path / "t.txt").read_bytes()
            == (tmp_path / "j.txt").read_bytes())


# ---------------------------------------------------------------------------
# streaming and profiling
# ---------------------------------------------------------------------------

def _walk(psi, a, b):
    return psi * 0.5 + a - b


@pytest.mark.parametrize("kind", ["tensor", "tuple", "dict"])
def test_rollout_measure_stacks_each_field(kind):
    psi0 = torch.arange(3.0)
    u = torch.tensor([1.0, 2.0, 4.0, 8.0])
    fields = {"x": lambda s: s.clone(), "total": lambda s: s.sum()}
    measure = {"tensor": fields["x"],
               "tuple": lambda s: (fields["x"](s), fields["total"](s)),
               "dict": lambda s: {k: f(s) for k, f in fields.items()}}[kind]
    out = tstreaming.rollout_measure(_walk, psi0, u, measure)
    states = [psi0]
    for i in range(3):
        states.append(_walk(states[-1], u[i], u[i + 1]))
    want = {"x": torch.stack(states),
            "total": torch.stack([s.sum() for s in states])}
    if kind == "tensor":
        assert torch.equal(out, want["x"])
    elif kind == "tuple":
        assert isinstance(out, tuple) and len(out) == 2
        assert torch.equal(out[0], want["x"])
        assert torch.equal(out[1], want["total"])
    else:
        assert set(out) == {"x", "total"}
        for k in out:
            assert torch.equal(out[k], want[k])


def test_propagation_counter_equals_jax():
    j, t = jprof.PropagationCounter(11), tprof.PropagationCounter(11)
    for c in (j, t):
        c.add_cost().add_gradient().add_hessian()
        c.add_iteration(ls_trials=2, exact_hessian=True)
        c.add_iteration()
    assert (t.count, t.history) == (j.count, j.history)


def test_device_timer_and_trace_on_the_cpu(tmp_path):
    timer = tprof.DeviceTimer().start()
    with tprof.trace(str(tmp_path / "tr")) as prof:
        with tprof.annotate("matmul"):
            x = torch.ones(8, 8) @ torch.ones(8, 8)
    lap = timer.stop(x, {"y": [x]})
    assert lap >= 0.0 and timer.laps == [lap] and timer.mean == lap
    assert (tmp_path / "tr" / "trace.json").exists()
    assert any(e.key == "matmul" for e in prof.key_averages())
