"""The quench cell and the Vidal multistart cell at small sizes on the CPU.

* reference/observables.py gives what the program's
  `observables.window_correlations` and `vidal.bond_vn_entropy` give, to
  1e-12, on a seeded random state;
* `bh_N20_quench.prep_quench`'s check passes the program, the control
  (the reference one precision below in its place) fails it, and so does
  each of three faults this file plants in the program: a ground-state
  search stopped one sweep early, the window measured one step late, the
  quench stepped at chi / 2. At this size the chain's sector is small, so
  the search is forced where the driver would diagonalize exactly, and
  an early stop is planted in both searches and in the final state's
  alone;
* `bh_N20.vidal_multistart`'s check passes the program and fails when two
  lanes' gradients are swapped.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from optimalcontrolmps_torch import dmrg, groundstate, mps, observables, vidal
from optimalcontrolmps_torch.drivers import analyze_quench
from optimalcontrolmps_torch.sites import op

from benchmark import harness
from benchmark.reference import observables as ref_obs
from benchmark.tests.small import SEED

CPU = torch.device("cpu")
QUENCH = "bh_N20_quench.prep_quench"
MULTI = "bh_N20.vidal_multistart"
SMALL = {
    QUENCH: ({"N": 6, "Npart": 6, "d": 3, "maxBondDim": 16, "chi_prep": 8,
              "T": 0.02, "window": [1, 4], "name": "small"}, {}),
    MULTI: ({"N": 8, "Npart": 8, "d": 3, "maxBondDim": 12, "T": 0.05,
             "name": "small"}, {"lanes": 3}),
}


def _spec(cell):
    spec = harness.cell_spec(cell)
    cfg, tr = SMALL[cell]
    spec["config"].update(cfg)
    spec["traffic"].update(tr)
    return spec


def _answers(cell, units=2):
    spec = _spec(cell)
    unit = harness.load_module("units", spec["unit"])
    ctx = unit.setup(spec["config"], spec["traffic"], SEED, CPU,
                     harness.Spans(CPU))
    try:
        return spec, unit, [unit.run(ctx, k, harness.Spans(CPU))["answers"]
                            for k in range(units)]
    finally:
        unit.release(ctx)


def _over(spec, unit, answers, control=False):
    got = unit.check(spec["config"], spec["traffic"], SEED, answers, CPU,
                     control=control)
    return [k for k, v in spec["limits"].items() if not got[k] <= v]


@pytest.fixture
def searched(monkeypatch):
    """The driver's ground states by the search at every size."""
    monkeypatch.setattr(groundstate, "EXACT_DIAG_MAX_DIM", 0)


def test_reference_observables_are_the_programs():
    L, d, chi = 6, 3, 16
    rng = np.random.default_rng(SEED)
    A = rng.normal(size=(L, chi, d + 1, chi)) \
        + 1j * rng.normal(size=(L, chi, d + 1, chi))
    A[0, 1:] = 0.0
    A[-1, :, :, 1:] = 0.0
    st = vidal.from_mps(A, device=CPU)
    sp, dd, rdd = observables.window_correlations(
        st.B[None], op("A", d), op("Adag", d), op("N", d), 1, 4)
    want = ref_obs.window_correlators(A, d, 1, 4)
    for got, ref in zip((sp, dd, rdd), want):
        np.testing.assert_allclose(got[0].numpy(), ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(vidal.bond_vn_entropy(st).numpy(),
                               ref_obs.entropies(st.lam.numpy()),
                               rtol=0, atol=1e-12)
    assert abs(ref_obs.total_number(st.B, d)
               - float(mps.expectation_values(st.B[None], op("N", d))
                       .real.sum())) < 1e-12


def test_quench_check_passes_the_program_and_fails_the_control(searched):
    spec, unit, answers = _answers(QUENCH)
    assert not _over(spec, unit, answers)
    assert _over(spec, unit, answers, control=True)


def _stopped_one_sweep_early(search):
    def early(*args, n_sweeps=None, **kw):
        _, _, hist = search(*args, n_sweeps=n_sweeps, **kw,
                            return_history=True)
        last = hist[-1][0]
        made = sum(1 for c, _ in hist if c == last)
        return search(*args, n_sweeps=made - 1, **kw)
    return early


def _final_search_stopped_early(search, U_final):
    """The search at U_final alone (dmrg_ground_state(L, d, npart, J, U,
    chi, ...)) stopped after one sweep, each Lanczos solve after two
    vectors. One sweep early is no fault here: at this size the Mott
    state's first sweep already lands within 5.3e-13 of E_ref."""
    def early(*args, **kw):
        if args[4] != U_final:
            return search(*args, **kw)
        return search(*args, **{**kw, "n_sweeps": 1, "krylov": 2})
    return early


def _measured_one_step_late(rollout):
    def late(step_fwd, psi0, u, measure):
        psi1 = step_fwd(psi0, u[..., 0], u[..., 1])
        return rollout(step_fwd, psi1, torch.cat([u[..., 1:], u[..., -1:]],
                                                 dim=-1), measure)
    return late


def _at_half_chi(effective_chi):
    def half(*args):
        return effective_chi(*args) // 2
    return half


@pytest.mark.parametrize("fault", ["stopped_one_sweep_early",
                                   "final_search_stopped_early",
                                   "measured_one_step_late", "at_half_chi"])
def test_quench_check_fails_a_planted_fault(fault, searched, monkeypatch):
    if fault == "stopped_one_sweep_early":
        monkeypatch.setattr(groundstate, "dmrg_ground_state",
                            _stopped_one_sweep_early(dmrg.dmrg_ground_state))
    elif fault == "final_search_stopped_early":
        # the U_final state: the quench never reads it, the check must
        monkeypatch.setattr(groundstate, "dmrg_ground_state",
                            _final_search_stopped_early(
                                dmrg.dmrg_ground_state,
                                analyze_quench.U_FINAL))
    elif fault == "measured_one_step_late":
        monkeypatch.setattr(analyze_quench, "rollout_measure",
                            _measured_one_step_late(
                                analyze_quench.rollout_measure))
    else:
        monkeypatch.setattr(analyze_quench, "effective_chi",
                            _at_half_chi(analyze_quench.effective_chi))
    spec, unit, answers = _answers(QUENCH, units=1)
    assert _over(spec, unit, answers)


def test_multistart_check_passes_and_fails_swapped_lanes():
    spec, unit, answers = _answers(MULTI, units=1)
    assert answers[0]["g"].shape == (3, 11)
    assert not _over(spec, unit, answers)
    g = answers[0]["g"]
    answers[0]["g"] = g[[1, 0, 2]]
    assert _over(spec, unit, answers)
