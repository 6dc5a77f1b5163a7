"""The lockstep L-BFGS replayed as CUDA graphs against the same solver run
eagerly, on the card, at the flagship's own batch and width.

`flagship.batch_objective` declares itself capture-safe, so on the card
`minimize_lbfgs_batch` replays its trials and iterations as CUDA graphs; a
copy of the objective without the declaration runs every step eagerly.
The arithmetic is the same, op by op, so the two must agree bitwise, lane
by lane, with the same kernel launches.

Every test here needs an NVIDIA GPU with nvcc, is marked `cuda`, and skips
without a card; the file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_lbfgs_graph.py
"""

import pytest
import torch

from optimalcontrolmps_torch import flagship
from optimalcontrolmps_torch.ops import sector_chain as sc
from optimalcontrolmps_torch.optimize import lbfgs

B = 4096        # the flagship batch
MAX_ITER = 20   # cut from the flagship's 150

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def prob():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return flagship.make_problem("cuda")


def _undeclared(make):
    """batch_objective without the capture-safe declaration."""
    def batch_objective(prob):
        fg = make(prob)
        return lambda C: fg(C)
    return batch_objective


def _chip_phase(prob, monkeypatch, declared: bool):
    """chip_phase at B lanes; returns the result, the kernels' launches and
    the solver's counters over the call."""
    if not declared:
        monkeypatch.setattr(flagship, "batch_objective",
                            _undeclared(flagship.batch_objective))
    cs = flagship.multistart_coeffs(B, prob.basis.M, seed=7)
    sc.reset_counts()
    lbfgs.reset_counts()
    res = flagship.chip_phase(prob, cs, max_iter=MAX_ITER)
    torch.cuda.synchronize()
    monkeypatch.undo()
    return res, {"fwd": sc.fwd_launches, "bwd": sc.bwd_launches,
                 "eager": lbfgs.trials_eager,
                 "replayed": lbfgs.trials_replayed,
                 "captured": lbfgs.graphs_captured}


def _assert_same(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert torch.equal(x, y), (name, (x != y).sum().item())


def test_graphed_solve_equals_eager(prob, monkeypatch):
    res_g, n_g = _chip_phase(prob, monkeypatch, declared=True)
    res_e, n_e = _chip_phase(prob, monkeypatch, declared=False)
    _assert_same(res_g, res_e)
    assert (n_g["fwd"], n_g["bwd"]) == (n_e["fwd"], n_e["bwd"])
    assert n_g["fwd"] == n_g["bwd"] > MAX_ITER
    assert n_g["replayed"] > 0 and n_g["captured"] == 2
    assert n_g["eager"] == 2   # the start and the warm-up trial
    assert n_g["eager"] + n_g["replayed"] == n_g["fwd"]
    assert (n_e["replayed"], n_e["captured"]) == (0, 0)
    assert n_e["eager"] == n_e["fwd"]


def test_fault_planted_before_the_call_is_captured(prob, monkeypatch):
    """The benchmark's `no_update` fault (steepest descent) replaces the
    two-loop recursion through the module: the graphs must capture it."""
    def no_update(g, S, Y, rho, head, count, m):
        return g

    runs = []
    for declared in (True, False):
        monkeypatch.setattr(lbfgs, "_two_loop_batch", no_update)
        if not declared:
            monkeypatch.setattr(flagship, "batch_objective",
                                _undeclared(flagship.batch_objective))
        cs = flagship.multistart_coeffs(B, prob.basis.M, seed=7)
        lbfgs.reset_counts()
        runs.append(flagship.chip_phase(prob, cs, max_iter=MAX_ITER))
        replayed = lbfgs.trials_replayed
        monkeypatch.undo()
        assert (replayed > 0) == declared
    _assert_same(*runs)
    sound = flagship.chip_phase(
        prob, flagship.multistart_coeffs(B, prob.basis.M, seed=7),
        max_iter=MAX_ITER)
    assert not torch.equal(sound.x, runs[0].x)
