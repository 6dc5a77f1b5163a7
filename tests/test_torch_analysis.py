"""The port's analysis drivers against the JAX package's, on the CPU.

The TINY config of tests/test_drivers.py:20-36 (L=3, d=2, T=0.1, N_t=11;
L=4 for analyze_quench), with `backend = cpu`, goes through the JAX driver
(CPU, x64) and the port's (complex128); fidelities, gradients,
correlators, entropies and the defect columns agree to 1e-8, and both
write files of the same names and shapes. The ramp file comes from the
port's optimize_ramp and feeds both packages' extend_time_evolution (11 +
100 rows) and calculate_defects. Every state cache lives under tmp_path.
"""

import os

import numpy as np
import pytest
import torch

from optimalcontrolmps_tpu.drivers import analyze_bond_dim as janalyze_bd
from optimalcontrolmps_tpu.drivers import analyze_quench as janalyze_q
from optimalcontrolmps_tpu.drivers import calculate_defects as jdefects
from optimalcontrolmps_tpu.drivers import extend_time_evolution as jextend
from optimalcontrolmps_tpu.drivers import prep_states as jprep
from optimalcontrolmps_tpu.drivers import test_runtimes as jruntimes
from optimalcontrolmps_torch import vidal as tvidal
from optimalcontrolmps_torch.drivers import analyze_bond_dim as tanalyze_bd
from optimalcontrolmps_torch.drivers import analyze_quench as tanalyze_q
from optimalcontrolmps_torch.drivers import calculate_defects as tdefects
from optimalcontrolmps_torch.drivers import extend_time_evolution as textend
from optimalcontrolmps_torch.drivers import optimize_ramp as toptimize
from optimalcontrolmps_torch.drivers import prep_states as tprep
from optimalcontrolmps_torch.drivers import test_runtimes as truntimes

torch.set_num_threads(2)

TOL = 1e-8
TINY = """input
{{
tstep = 0.01
T = 0.1
N = {n}
Npart = {n}
d = 2
M = 4
gamma = 1e-6
maxBondDim = 10
optTol = 1e-6
useBFGS = yes
maxIter = 10
cacheProgress = yes
engine = {engine}
backend = cpu
}}
"""
QUENCH_FILES = ("EntanglementEntropies", "SingleParticleCorr",
                "DensityDensityCorr", "RescaledDensityDensityCorr")


def _cfg(directory, engine="mps", n=3):
    path = directory / f"InputFile_{engine}_{n}"
    path.write_text(TINY.format(engine=engine, n=n))
    return str(path)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < tol


def _same_files(jdir, tdir, names):
    """Both packages wrote each file, with the same shape."""
    for name in names:
        j, t = np.loadtxt(jdir / name), np.loadtxt(tdir / name)
        assert j.shape == t.shape, name


@pytest.fixture(scope="module")
def ramp(tmp_path_factory):
    """A BHrampInitialFinal.txt from the port's optimize_ramp on TINY."""
    d = tmp_path_factory.mktemp("ramp")
    toptimize.run(_cfg(d), seed=1, out_prefix=str(d) + os.sep)
    return str(d / "BHrampInitialFinal.txt")


@pytest.fixture(scope="module")
def jax_extend(tmp_path_factory, ramp):
    d = tmp_path_factory.mktemp("jext")
    out = jextend.run(_cfg(d), ramp, out_prefix=str(d) + os.sep)
    return d, out


@pytest.mark.parametrize("engine", ["mps", "vidal", "sector"])
def test_extend_time_evolution_matches_jax(tmp_path, ramp, jax_extend,
                                           engine):
    """11 + 100 rows on every engine of the port (chi = 3 is the exact
    rank bound, so all three are the JAX run's MPS propagation)."""
    jdir, jout = jax_extend
    out = textend.run(_cfg(tmp_path, engine), ramp,
                      out_prefix=str(tmp_path) + os.sep)
    assert len(out["times"]) == len(out["fid_final"]) == 11 + 100
    np.testing.assert_array_equal(out["times"], jout["times"])
    _close(out["fid_final"], jout["fid_final"])
    names = ("BHrampInitialFinal_extendedT0.1.txt",
             "ExpectationN_extendedT0.1.txt")
    _same_files(jdir, tmp_path, names)
    for name in names:
        _close(np.loadtxt(tmp_path / name), np.loadtxt(jdir / name))


@pytest.fixture(scope="module")
def jax_defects(tmp_path_factory, ramp):
    return jdefects.run(_cfg(tmp_path_factory.mktemp("jdef")),
                        ramp_path=ramp)


@pytest.mark.parametrize("engine", ["mps", "vidal"])
def test_calculate_defects_matches_jax(tmp_path, ramp, jax_defects, engine):
    out = tdefects.run(_cfg(tmp_path, engine), ramp_path=ramp)
    np.testing.assert_array_equal(out["times"], jax_defects["times"])
    for key in ("fids", "rho", "f2"):
        _close(out[key], jax_defects[key])
    assert np.all(out["fids"] <= 1.0 + 1e-9)
    np.testing.assert_allclose(out["expn"].sum(axis=1), 3.0, atol=1e-10)


def test_calculate_defects_takes_only_mps_engines(tmp_path, ramp):
    with pytest.raises(ValueError, match="engine"):
        tdefects.run(_cfg(tmp_path, "sector"), ramp_path=ramp)


@pytest.mark.parametrize("ramp_kind", ["quench", "exp"])
def test_analyze_quench_matches_jax(tmp_path, ramp_kind):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    kw = dict(ramp=ramp_kind, startpoint=0, endpoint=2, chunk=5)
    want = janalyze_q.run(_cfg(jdir, n=4), out_prefix=str(jdir) + os.sep,
                          state_cache=str(jdir / "states.npz"), **kw)
    got = tanalyze_q.run(_cfg(tdir, n=4), out_prefix=str(tdir) + os.sep,
                         state_cache=str(tdir / "states.npz"), **kw)
    assert got["entropies"].shape == (11, 3)
    assert got["sp"].shape == (11, 2)
    for key in ("entropies", "sp", "dd", "rdd", "vn_sampled"):
        _close(got[key], want[key])
    assert got["chi"] == want["chi"]
    assert np.all(got["entropies"] >= -1e-9)
    tag = ramp_kind.capitalize()
    _same_files(jdir, tdir, [f"{f}_{tag}.txt" for f in QUENCH_FILES])


@pytest.fixture(scope="module")
def bond_dim_runs(tmp_path_factory):
    """Both packages' analyze_bond_dim at bond_dims (2, 3): chi 2 truncates
    and preps its own states (the JAX package writes them under the
    working directory's .state_cache, here a temporary one)."""
    jdir, tdir = (tmp_path_factory.mktemp(n) for n in ("jbd", "tbd"))
    old = os.getcwd()
    os.chdir(jdir)
    try:
        want = janalyze_bd.run(_cfg(jdir), bond_dims=(2, 3), chunk=5,
                               out_prefix=str(jdir) + os.sep,
                               state_cache=str(jdir / "states.npz"))
    finally:
        os.chdir(old)
    got = tanalyze_bd.run(_cfg(tdir), bond_dims=(2, 3), chunk=5,
                          out_prefix=str(tdir) + os.sep,
                          state_cache=str(tdir / "states.npz"))
    return jdir, want, tdir, got


@pytest.mark.parametrize("maxm", [2, 3])
def test_analyze_bond_dim_matches_jax(bond_dim_runs, maxm):
    _, want, _, got = bond_dim_runs
    g, w = got[maxm], want[maxm]
    assert g["chi"] == w["chi"] == maxm
    assert g["fids"].shape == (11,)
    for key in ("fids", "grad", "s2", "disc", "vn_entropy"):
        _close(g[key], w[key])
    np.testing.assert_array_equal(g["occupancy"], w["occupancy"])


def test_analyze_bond_dim_writes_jax_files(bond_dim_runs):
    jdir, _, tdir, _ = bond_dim_runs
    names = ["DMRGstateBondDim.txt", "TimeEvolBondDimT0.1runtimes.txt"]
    for m in (2, 3):
        names += [f"TimeEvolBondDimT0.1maxM{m}.txt",
                  f"SchmidtDataT0.1maxM{m}.txt"]
    _same_files(jdir, tdir, names)
    for name in names[:1] + names[2:]:
        _close(np.loadtxt(tdir / name), np.loadtxt(jdir / name))
    # the chi = 2 study states are cached beside the state cache
    assert (tdir / "L3d2n3chi2.npz").exists()


def test_analyze_bond_dim_gradient_failure_raises(tmp_path, monkeypatch):
    """A failing gradient raises, after the propagation's files are
    written; no NaN column, no runtimes file."""
    def broken(*args, **kw):
        raise RuntimeError("gradient failed")
    monkeypatch.setattr(tvidal, "gradient_segmented", broken)
    prefix = str(tmp_path) + os.sep
    with pytest.raises(RuntimeError, match="gradient failed"):
        tanalyze_bd.run(_cfg(tmp_path), bond_dims=(3,), out_prefix=prefix,
                        state_cache=str(tmp_path / "states.npz"))
    rows = np.loadtxt(tmp_path / "TimeEvolBondDimT0.1maxM3.txt")
    assert rows.shape[0] == 11 and np.all(rows[:, 3] == 0.0)
    assert (tmp_path / "SchmidtDataT0.1maxM3.txt").exists()
    assert not (tmp_path / "TimeEvolBondDimT0.1runtimes.txt").exists()


def test_test_runtimes_matches_jax():
    """The port's tables at B = 1, 2 with the Hessian; its cost equals
    the JAX driver's (B = 1, no Hessian) at every batch size."""
    want = jruntimes.run(horizons=(0.05,), batches=(1,), with_hessian=False)
    got = truntimes.run(horizons=(0.05,), batches=(1, 2), device="cpu")
    assert abs(got["costs"][0.05] - want["costs"][0.05]) < TOL
    for costs in got["batch_costs"][0.05]:
        _close(costs, np.full(costs.shape, want["costs"][0.05]))
    assert len(got["grad"][0]) == len(got["hess"][0]) == 3
    assert all(t > 0 for t in got["grad"][0][1:] + got["hess"][0][1:])


def _refuse(*args, **kw):
    raise AssertionError("the cache was not used")


def test_a_jax_state_cache_loads_in_the_port(tmp_path, monkeypatch):
    path = str(tmp_path / "jax.npz")
    np.savez(path, **jprep.compute(3, 2, 3, 1.0, 2.5, 50.0, 5, 3))
    monkeypatch.setattr(tprep, "compute", _refuse)
    psi_i, psi_f = tprep.ensure_boundary_states(3, 2, 3, 1.0, 2.5, 50.0, 5,
                                                path, chi_prep=3,
                                                device="cpu")
    with np.load(path) as z:
        np.testing.assert_array_equal(psi_i, z["psi_i"])
        np.testing.assert_array_equal(psi_f, z["psi_f"])
    assert psi_i.shape == (3, 5, 3, 5) and psi_i.dtype == np.complex128


def test_a_port_state_cache_loads_in_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "torch.npz")
    psi_i, psi_f = tprep.ensure_boundary_states(3, 2, 3, 1.0, 2.5, 50.0, 5,
                                                path, chi_prep=3,
                                                device="cpu")
    want = jprep.compute(3, 2, 3, 1.0, 2.5, 50.0, 5, 3)
    _close(psi_i, want["psi_i"], 1e-12)
    _close(psi_f, want["psi_f"], 1e-12)
    monkeypatch.setattr(jprep, "compute", _refuse)
    j_i, j_f = jprep.ensure_boundary_states(3, 2, 3, 1.0, 2.5, 50.0, 5,
                                            path, chi_prep=3)
    np.testing.assert_array_equal(j_i, psi_i)
    np.testing.assert_array_equal(j_f, psi_f)
    with np.load(path) as z:
        np.testing.assert_array_equal(z["meta"], want["meta"])
        np.testing.assert_array_equal(z["controls"], want["controls"])


def test_prep_states_recomputes_a_stale_cache(tmp_path):
    path = str(tmp_path / "states.npz")
    tprep.ensure_boundary_states(3, 2, 3, 1.0, 2.5, 50.0, 3, path,
                                 device="cpu")
    psi_i, _ = tprep.ensure_boundary_states(3, 2, 3, 1.0, 3.0, 50.0, 3,
                                            path, device="cpu")
    with np.load(path) as z:
        np.testing.assert_array_equal(z["controls"], [1.0, 3.0, 50.0])
        np.testing.assert_array_equal(z["psi_i"], psi_i)
