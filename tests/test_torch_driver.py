"""The port's optimize_ramp driver (L-BFGS mode) against the JAX package's.

The TINY config of tests/test_drivers.py:20-36 (L=3, d=2, T=0.1, N_t=11,
M=4), with `backend = cpu` for the port, runs through both drivers. The
infidelities agree within 1e-5 and u_final within atol 1e-3
(tests/test_drivers.py:67-69), and both write the same files. The
multistart=4 case holds the port's lockstep `minimize_lbfgs_batch` to the
JAX driver's vmap(minimize_lbfgs).
"""

import os

import numpy as np
import pytest
import torch

from optimalcontrolmps_tpu.drivers import optimize_ramp as jdriver
from optimalcontrolmps_torch import config, io
from optimalcontrolmps_torch.drivers import common
from optimalcontrolmps_torch.drivers import optimize_ramp as driver

torch.set_num_threads(2)

TINY = """input
{{
tstep = 0.01
T = 0.1
N = 3
Npart = 3
d = 2
M = 4
gamma = 1e-6
maxBondDim = 10
optTol = 1e-6
useBFGS = yes
maxIter = 10
cacheProgress = yes
engine = {engine}
{extra}
}}
"""
FILES = ["BHrampInitialFinal.txt", "GROUPHessian.txt", "GRAPEHessian.txt",
         "ExpectationN.txt", "ProgressCache.txt", "checkpoint.json"]


def _cfg(tmp_path, name, engine, extra=""):
    path = tmp_path / name
    path.write_text(TINY.format(engine=engine, extra=extra))
    return str(path)


def _both(tmp_path, engine, extra=""):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    out_j = jdriver.run(_cfg(tmp_path, "cfg_j", engine, extra), seed=1,
                        out_prefix=str(jdir) + os.sep)
    out_t = driver.run(_cfg(tmp_path, "cfg_t", engine,
                            extra + "\nbackend = cpu"),
                       seed=1, out_prefix=str(tdir) + os.sep)
    return out_j, out_t, jdir, tdir


def _same_outcome(out_j, out_t, jdir, tdir):
    assert abs(out_t["infidelity"] - out_j["infidelity"]) < 1e-5
    np.testing.assert_allclose(out_t["u_final"], out_j["u_final"], atol=1e-3)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for f in FILES:
        assert (tdir / f).exists(), f
    expn = np.loadtxt(tdir / "ExpectationN.txt")
    assert expn.shape == (11, 4)
    np.testing.assert_allclose(expn[:, 1:].sum(axis=1), 3.0, atol=1e-8)


def test_mps_driver_matches_jax(tmp_path):
    out_j, out_t, jdir, tdir = _both(tmp_path, "mps")
    _same_outcome(out_j, out_t, jdir, tdir)
    assert out_t["status"]["iterations"] == out_j["status"]["iterations"]
    ramp_t = io.read_ramp_file(str(tdir / "BHrampInitialFinal.txt"))
    ramp_j = io.read_ramp_file(str(jdir / "BHrampInitialFinal.txt"))
    np.testing.assert_allclose(ramp_t["fid_final"], ramp_j["fid_final"],
                               atol=1e-8)
    lines_t = (tdir / "ProgressCache.txt").read_text().splitlines()
    lines_j = (jdir / "ProgressCache.txt").read_text().splitlines()
    assert len(lines_t) == len(lines_j) == out_t["status"]["iterations"]


def test_batched_lbfgs_matches_vmapped(tmp_path):
    """multistart = 4: the port's lockstep batch against JAX's vmap."""
    out_j, out_t, jdir, tdir = _both(tmp_path, "mps", "multistart = 4")
    _same_outcome(out_j, out_t, jdir, tdir)
    np.testing.assert_allclose(out_t["status"]["batch_costs"],
                               out_j["status"]["batch_costs"], rtol=2e-4)


def test_sector_driver_matches_jax(tmp_path):
    out_j, out_t, jdir, tdir = _both(tmp_path, "sector")
    _same_outcome(out_j, out_t, jdir, tdir)


@pytest.mark.parametrize("exact", ["yes", "no"])
def test_sector_multistart_matches_vmapped(tmp_path, exact):
    """multistart = 4 on the sector engine: the vmapped one-lane objective
    (autograd or adjoint gradient) in the lockstep batch, against JAX."""
    out_j, out_t, jdir, tdir = _both(
        tmp_path, "sector", f"multistart = 4\nexactGradient = {exact}")
    _same_outcome(out_j, out_t, jdir, tdir)
    np.testing.assert_allclose(out_t["status"]["batch_costs"],
                               out_j["status"]["batch_costs"], rtol=2e-4)


@pytest.mark.parametrize("extra,match", [
    ("useBFGS = no", "interior-point"),
    ("resume = yes", "resume"),
    ("checkpointEvery = 2", "checkpointEvery"),
    ("engine = vidal", "Vidal"),
])
def test_unported_modes_are_refused(tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        driver.run(_cfg(tmp_path, "cfg", "mps", extra + "\nbackend = cpu"),
                   out_prefix=str(tmp_path) + os.sep)


def test_config_round_trip_and_problem_setup(tmp_path):
    path = _cfg(tmp_path, "cfg", "auto", "backend = cpu")
    cfg = config.parse_input_file(path)
    out = tmp_path / "copy"
    config.write_input_file(str(out), cfg.values)
    assert config.parse_input_file(str(out)).values == cfg.values
    p = common.build_problem(cfg, engine="auto")
    assert p.kind == "sector" and p.device == torch.device("cpu")
    p = common.build_problem(cfg, engine="mps")
    assert p.kind == "mps" and p.chi == 3 == common.effective_chi(10, 3, 3)
    assert p.psi_i.shape == (3, 3, 3, 3) and p.n_steps == 11
    np.testing.assert_allclose(common.time_axis(p), np.arange(11) * 0.01)
