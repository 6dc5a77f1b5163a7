"""The ground-state search's and the quench driver's spans and counters, on
the CPU.

* `dmrg.matvecs` is sweeps x 2 (L - 1) x krylov, `host_syncs` one per
  Lanczos solve, `sweeps` the history's length;
* `ops/trunc.svd_calls` counts the "svd" splits by matrix shape, and the
  search's by its theta's;
* spans change nothing: with no collector installed, and with one,
  `dmrg_ground_state` and `analyze_quench.run` return what they return
  with every span replaced by an empty context, bitwise; the collector
  sees `dmrg.search`, `dmrg.lanczos`, `dmrg.split`,
  `observables.window` and `quench.rollout`;
* `analyze_quench.run` with a state cache and an output prefix writes
  only there, and returns the cache's path.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from optimalcontrolmps_torch import dmrg, groundstate, observables, profiling
from optimalcontrolmps_torch.drivers import analyze_quench
from optimalcontrolmps_torch.ops import trunc

INPUT = """input
{{
tstep = 0.01
T = 0.05
N = {n}
Npart = {n}
d = 2
maxBondDim = 6
backend = cpu
}}
"""


def _search(**kw):
    # looked up on the module, so that `_no_spans` reaches it
    return dmrg.dmrg_ground_state(5, 2, 5, 1.0, 2.5, 6, n_sweeps=3,
                                  krylov=7, device="cpu",
                                  return_history=True, **kw)


def _no_spans(monkeypatch):
    """Every span of the search and the driver an empty context, and the
    functions a span wraps whole unwrapped."""
    def empty(name):
        return contextlib.nullcontext()
    for mod in (dmrg, analyze_quench):
        monkeypatch.setattr(mod, "span", empty)
    monkeypatch.setattr(dmrg, "dmrg_ground_state",
                        dmrg.dmrg_ground_state.__wrapped__)
    monkeypatch.setattr(observables, "window_correlations",
                        observables.window_correlations.__wrapped__)


@pytest.mark.parametrize("L,chi,krylov", [(5, 6, 7), (4, 3, 4)])
def test_matvecs_are_sweeps_times_bonds_times_krylov(L, chi, krylov):
    dmrg.reset_counts()
    _, _, hist = dmrg.dmrg_ground_state(L, 2, L, 1.0, 2.5, chi, n_sweeps=3,
                                        krylov=krylov, device="cpu",
                                        return_history=True)
    assert dmrg.sweeps == len(hist) >= 2
    assert dmrg.matvecs == dmrg.sweeps * 2 * (L - 1) * krylov
    assert dmrg.host_syncs == dmrg.sweeps * 2 * (L - 1)
    dmrg.reset_counts()
    assert dmrg.sweeps == dmrg.matvecs == dmrg.host_syncs == 0


def test_svd_calls_count_by_shape():
    trunc.reset_counts()
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(2, 12, 10, dtype=torch.complex128, generator=gen)
    b = torch.randn(1, 6, 8, dtype=torch.complex128, generator=gen)
    trunc.split_truncate(a, 4, keep_left=True, method="svd")
    trunc.split_truncate(a, 4, keep_left=False, method="svd")
    trunc.split_truncate(b, 3, keep_left=True, method="svd")
    trunc.split_truncate(b, 3, keep_left=True, method="eigh")
    assert trunc.svd_calls == {(12, 10): 2, (6, 8): 1}
    assert trunc.eigh_calls == {6: 1}
    trunc.reset_counts()
    assert trunc.svd_calls == {}


def test_search_counts_one_svd_per_bond_update():
    trunc.reset_counts()
    dmrg.reset_counts()
    _search()
    p = 3
    shapes = {(c * p, p * c) for c in dmrg.ramp_schedule(6)}
    assert set(trunc.svd_calls) == shapes
    assert sum(trunc.svd_calls.values()) == dmrg.sweeps * 2 * 4


def test_spans_change_no_search_result(monkeypatch):
    plain = _search()
    with profiling.collect_spans("cpu") as seen:
        collected = _search()
    with monkeypatch.context() as m:
        _no_spans(m)
        before = _search()
    for got in (plain, collected):
        assert torch.equal(got[0], before[0])
        assert got[1] == before[1] and got[2] == before[2]
    assert {"dmrg.search", "dmrg.lanczos", "dmrg.split"} <= set(seen)
    assert seen["dmrg.search"] >= seen["dmrg.lanczos"] > 0


def _quench(tmp_path, tag):
    cfg = tmp_path / f"Input_{tag}"
    cfg.write_text(INPUT.format(n=4))
    out = tmp_path / f"out_{tag}"
    out.mkdir()
    return analyze_quench.run(str(cfg), ramp="quench",
                              out_prefix=str(out) + os.sep, startpoint=0,
                              endpoint=2, chi_prep=4,
                              state_cache=str(tmp_path / f"c_{tag}" /
                                              "states.npz"))


def test_spans_change_no_quench_result(tmp_path, monkeypatch):
    plain = _quench(tmp_path, "plain")
    with profiling.collect_spans("cpu") as seen:
        collected = _quench(tmp_path, "collected")
    with monkeypatch.context() as m:
        _no_spans(m)
        before = _quench(tmp_path, "before")
    for got in (plain, collected):
        for key in ("entropies", "sp", "dd", "rdd", "vn_sampled"):
            np.testing.assert_array_equal(got[key], before[key])
        assert got["chi"] == before["chi"]
    assert {"observables.window", "quench.rollout"} <= set(seen)
    assert seen["quench.rollout"] >= seen["observables.window"] > 0


def test_quench_writes_only_where_it_is_told(tmp_path, monkeypatch):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    # the search, not exact diagonalization, makes the states at this size
    monkeypatch.setattr(groundstate, "EXACT_DIAG_MAX_DIM", 0)
    dmrg.reset_counts()
    cfg = tmp_path / "Input"
    cfg.write_text(INPUT.format(n=5))
    cache = tmp_path / "cache" / "states.npz"
    out = tmp_path / "out"
    out.mkdir()
    res = analyze_quench.run(str(cfg), ramp="quench",
                             out_prefix=str(out / "q_"), startpoint=0,
                             endpoint=3, chi_prep=4, state_cache=str(cache))
    assert dmrg.sweeps > 0
    made = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                  for d, _, files in os.walk(tmp_path) for f in files)
    tags = ("EntanglementEntropies", "SingleParticleCorr",
            "DensityDensityCorr", "RescaledDensityDensityCorr")
    assert made == sorted([os.path.join("cache", "states.npz"), "Input"]
                          + [os.path.join("out", f"q_{t}_Quench.txt")
                             for t in tags])
    assert res["state_cache"] == str(cache)
    with np.load(cache) as z:
        assert z["psi_i"].shape == z["psi_f"].shape == (5, 4, 3, 4)
    assert res["entropies"].shape == (6, 4) and res["sp"].shape == (6, 3)
