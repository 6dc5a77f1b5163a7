"""The port's optimize_ramp and amoeba_opt drivers against the JAX package's.

The TINY config of tests/test_drivers.py:20-36 (L=3, d=2, T=0.1, N_t=11,
M=4), with `backend = cpu` for the port, runs through both drivers. The
infidelities agree within 1e-5 and u_final within atol 1e-3
(tests/test_drivers.py:67-69), and both write the same files. The
multistart=4 case holds the port's lockstep `minimize_lbfgs_batch` to the
JAX driver's vmap(minimize_lbfgs). With `useBFGS = no` the interior point
runs in its three modes (chunked one ramp, multistart batch, host loop on
the MPS engine) against the JAX driver; the checkpoint, resume and state
cache round trips run in the port, and a JAX checkpoint resumes in it.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from optimalcontrolmps_tpu.drivers import optimize_ramp as jdriver
from optimalcontrolmps_torch import config, io
from optimalcontrolmps_torch import engine as tengine
from optimalcontrolmps_torch.drivers import common
from optimalcontrolmps_torch.drivers import optimize_ramp as driver


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
    ("truncMethod = nssub", "eigh"),
    ("exactGradient = yes", "exactGradient"),
])
def test_unported_modes_are_refused(tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        driver.run(_cfg(tmp_path, "cfg", "mps", extra + "\nbackend = cpu"),
                   out_prefix=str(tmp_path) + os.sep)


# ---------------------------------------------------------------------------
# useBFGS = no: the interior point
# ---------------------------------------------------------------------------

def _progress_rows(path):
    return [line.split("\t") for line in
            path.read_text().strip().splitlines()]


def _ip_state(extra):
    return {k: extra[k] for k in ("duals", "mu", "iters", "kkt")}


@pytest.mark.parametrize("engine", ["sector", "mps"])
def test_interior_point_driver_matches_jax(tmp_path, engine):
    """useBFGS = no, one ramp (chunked jit mode): the same iterates, files
    and per-iteration ProgressCache lines as the JAX driver."""
    out_j, out_t, jdir, tdir = _both(tmp_path, engine, "useBFGS = no")
    _same_outcome(out_j, out_t, jdir, tdir)
    assert out_t["status"]["iterations"] == out_j["status"]["iterations"]
    assert abs(out_t["status"]["f"] - out_j["status"]["f"]) < 1e-10
    np.testing.assert_allclose(out_t["u_final"], out_j["u_final"], atol=1e-8)
    rows_t = _progress_rows(tdir / "ProgressCache.txt")
    rows_j = _progress_rows(jdir / "ProgressCache.txt")
    assert rows_t == rows_j
    assert len(rows_t) == out_t["status"]["iterations"]
    # the final checkpoint carries the primal-dual state, cost unscaled
    ck = json.loads((tdir / "checkpoint.json").read_text())["extra"]
    assert len(ck["duals"]) == 4 and ck["iters"] == len(rows_t)
    assert ck["cost"] == pytest.approx(out_t["status"]["f"], rel=1e-15)


def test_multistart_interior_point_lanes(tmp_path):
    """multistart = 3, useBFGS = no: the lockstep batch, whose lane 0 starts
    where the one-ramp run starts and walks its iterates (the batch against
    JAX's vmap lane by lane is tests/test_torch_interior_point.py's)."""
    prefix = str(tmp_path) + os.sep
    base = "useBFGS = no\nbackend = cpu\ncacheProgress = no"
    one = driver.run(_cfg(tmp_path, "c1", "sector", base), out_prefix=prefix)
    out = driver.run(_cfg(tmp_path, "c3", "sector", base + "\nmultistart = 3"),
                     out_prefix=prefix)
    costs = out["status"]["batch_costs"]
    assert len(costs) == 3 and out["status"]["f"] == min(costs)
    assert costs[0] == pytest.approx(one["status"]["f"], rel=1e-12)
    assert "history" not in out["status"]


@pytest.fixture(scope="module")
def host_runs(tmp_path_factory):
    """ipMode = host on the MPS engine (tests/test_drivers.py:181 runs it on
    vidal), in both drivers, with resume = yes so that the JAX driver
    writes its state cache too. Then the port resumes from the JAX
    driver's checkpoint and state cache."""
    tmp = tmp_path_factory.mktemp("host")
    extra = ("useBFGS = no\nipMode = host\nhessianRowBlock = 5\n"
             "hessianProgress = no\nmuStrategy = adaptive\nmaxIter = 3\n"
             "resume = yes")
    first = _both(tmp, "mps", extra)
    jit_dir = tmp / "torch_jit"
    jit_dir.mkdir()
    out_jit = driver.run(_cfg(tmp, "cfg_jit", "mps", extra.replace(
        "ipMode = host", "ipMode = jit") + "\nbackend = cpu"),
        seed=1, out_prefix=str(jit_dir) + os.sep)
    jdir, tdir2 = first[2], tmp / "torch_resumed"
    tdir2.mkdir()
    for f in ("checkpoint.json", "states.npz"):
        shutil.copy(jdir / f, tdir2 / f)
    cfg2 = _cfg(tmp, "cfg_t2", "mps", extra + "\nbackend = cpu\nmaxIter = 1"
                "\nwriteHessians = no")
    out_t2 = driver.run(cfg2, seed=1, out_prefix=str(tdir2) + os.sep)
    p = common.build_problem(config.parse_input_file(cfg2), engine="mps")
    return first, (out_t2, tdir2, p), out_jit


def test_host_ip_mode_matches_jax(host_runs):
    (out_j, out_t, jdir, tdir), _, _ = host_runs
    _same_outcome(out_j, out_t, jdir, tdir)
    assert out_t["status"]["iterations"] == out_j["status"]["iterations"] == 3
    assert abs(out_t["status"]["f"] - out_j["status"]["f"]) < 1e-10
    assert _progress_rows(tdir / "ProgressCache.txt") == \
        _progress_rows(jdir / "ProgressCache.txt")
    ck_t = json.loads((tdir / "checkpoint.json").read_text())["extra"]
    ck_j = json.loads((jdir / "checkpoint.json").read_text())["extra"]
    assert len(ck_t["duals"]) == 4
    np.testing.assert_allclose(np.concatenate(ck_t["duals"]),
                               np.concatenate(ck_j["duals"]), rtol=1e-6)
    assert ck_t["mu"] == pytest.approx(ck_j["mu"], rel=1e-6)


def test_host_and_jit_modes_agree(host_runs):
    """ipMode = host (segmented gradient, streaming Hessian, host loop)
    and the chunked jit mode (stacked gradient, dense Hessian, lockstep
    loop) take the same first step: f after iteration 1 to 1e-10."""
    (_, out_host, _, _), _, out_jit = host_runs
    h_host = out_host["status"]["history"]
    h_jit = out_jit["status"]["history"]
    assert h_host[0] == h_jit[0]
    assert abs(h_host[1][1] - h_jit[1][1]) <= 1e-10 * abs(h_jit[1][1])
    assert out_jit["status"]["f"] == pytest.approx(out_host["status"]["f"],
                                                   rel=1e-6)


def test_jax_checkpoint_resumes_in_the_port(host_runs):
    """The port resumes from the JAX driver's checkpoint.json and
    states.npz: from its control (1% into the box), multipliers and
    barrier, on the JAX driver's boundary states."""
    (_, _, jdir, _), (out_t2, tdir2, p), _ = host_runs
    ck = json.loads((jdir / "checkpoint.json").read_text())
    start = out_t2["resumed_from"]
    np.testing.assert_array_equal(start["x"], ck["control"])
    assert start["mu"] == ck["extra"]["mu"]
    assert start["duals"] == ck["extra"]["duals"]
    states = np.load(jdir / "states.npz")
    np.testing.assert_array_equal(p.psi_i.numpy(), states["psi_i"])
    x0 = torch.as_tensor(ck["control"], dtype=torch.float64).clamp(
        -19.6, 19.6)
    f0 = float(tengine.cost(p.stepper, p.psi_i, p.psi_f,
                            p.basis.convert_control(x0), p.gamma))
    assert out_t2["status"]["history"][0] == (1, pytest.approx(f0,
                                                               rel=1e-13))
    assert out_t2["status"]["f"] <= f0


def test_resume_and_state_cache_round_trip(tmp_path, monkeypatch):
    """Chunked jit mode with resume = yes: the first run starts cold and
    writes states.npz and a checkpoint after each ipChunk; the second run
    loads the states and starts from the checkpoint's x (after the 1% box
    clip), multipliers and barrier."""
    extra = ("useBFGS = no\nmaxIter = 4\nipChunk = 2\nresume = yes\n"
             "backend = cpu")
    saved = []
    real_save = io.save_checkpoint
    monkeypatch.setattr(driver.io, "save_checkpoint", lambda path, c,
                        extra=None: (saved.append((np.asarray(c), extra)),
                                     real_save(path, c, extra=extra)))
    prefix = str(tmp_path) + os.sep
    out1 = driver.run(_cfg(tmp_path, "cfg", "mps", extra), out_prefix=prefix)
    assert "resumed_from" not in out1
    # two chunk checkpoints, then the final one; the ProgressCache
    # iteration column counts on across chunks
    assert [e["iters"] for _, e in saved[:2]] == [2, 4]
    rows = _progress_rows(tmp_path / "ProgressCache.txt")
    assert [int(r[0]) for r in rows] == [1, 2, 3, 4]
    ck = json.loads((tmp_path / "checkpoint.json").read_text())
    assert _ip_state(ck["extra"]) == _ip_state(saved[-1][1])
    states_mtime = os.path.getmtime(tmp_path / "states.npz")

    assert io.load_states(str(tmp_path / "states.npz"), {}) is None
    cfg = _cfg(tmp_path, "cfg", "mps", extra)
    p = common.build_problem(config.parse_input_file(cfg), engine="mps",
                             state_cache=str(tmp_path / "states.npz"))
    out2 = driver.run(cfg, out_prefix=prefix)
    assert os.path.getmtime(tmp_path / "states.npz") == states_mtime
    start = out2["resumed_from"]
    np.testing.assert_array_equal(start["x"], ck["control"])
    assert start["mu"] == ck["extra"]["mu"]
    assert start["duals"] == ck["extra"]["duals"]
    # the solve starts at the control clipped 1% into the box
    x0 = torch.as_tensor(ck["control"], dtype=torch.float64).clamp(
        -19.6, 19.6)
    f0 = float(tengine.cost(p.stepper, p.psi_i, p.psi_f,
                            p.basis.convert_control(x0), p.gamma))
    assert out2["status"]["history"][0] == (1, pytest.approx(f0, rel=1e-13))
    # each chunk checkpoint's cost is the cost at its control
    c, e = saved[1]
    assert e["cost"] == pytest.approx(float(tengine.cost(
        p.stepper, p.psi_i, p.psi_f, p.basis.convert_control(
            torch.as_tensor(c)), p.gamma)), rel=1e-12)


def test_lbfgs_checkpoint_every(tmp_path, monkeypatch):
    """checkpointEvery = 3 on the L-BFGS path: a checkpoint after each
    chunk with the unscaled cost and the iterations so far, and the
    ProgressCache iteration column counting on across chunks."""
    saved = []
    real_save = io.save_checkpoint
    monkeypatch.setattr(driver.io, "save_checkpoint", lambda path, c,
                        extra=None: (saved.append((np.asarray(c), extra)),
                                     real_save(path, c, extra=extra)))
    out = driver.run(_cfg(tmp_path, "cfg", "sector",
                          "checkpointEvery = 3\nObjScaling = 2\n"
                          "newtonPolish = no\nbackend = cpu"),
                     out_prefix=str(tmp_path) + os.sep)
    chunks = [e for _, e in saved[:-1]]
    n = out["status"]["iterations"]
    assert [e["iters"] for e in chunks] == \
        [min(3 * (k + 1), n) for k in range(len(chunks))]
    assert chunks[-1]["iters"] == n
    rows = _progress_rows(tmp_path / "ProgressCache.txt")
    assert [int(r[0]) for r in rows] == list(range(1, n + 1))
    # unscaled: the driver's f (which reports J / ObjScaling)
    assert chunks[-1]["cost"] == pytest.approx(out["status"]["f"],
                                               rel=1e-14)
    assert saved[-1][1]["cost"] == pytest.approx(out["status"]["f"],
                                                 rel=1e-14)


def test_amoeba_opt_smoke(tmp_path):
    """The AmoebaOpt driver, the port's form of tests/test_drivers.py:120
    (TINY, mps, maxIter = 40): a finite cost below c = 0's, evaluations,
    the reference's files, and one ProgressCache line per iteration (the
    simplex against JAX's is tests/test_torch_nelder_mead.py's)."""
    from optimalcontrolmps_torch.drivers import amoeba_opt

    cfg = _cfg(tmp_path, "cfg", "mps", "maxIter = 40\nbackend = cpu")
    out = amoeba_opt.run(cfg, seed=1, out_prefix=str(tmp_path) + os.sep)
    assert np.isfinite(out["f"]) and out["n_evals"] > 0
    assert out["iterations"] == 40
    p = common.build_problem(config.parse_input_file(cfg), engine="mps")
    u0 = p.basis.convert_control(torch.zeros(p.M, dtype=torch.float64))
    assert out["f"] < float(tengine.cost(p.stepper, p.psi_i, p.psi_f, u0,
                                         p.gamma))
    for f in ("BHrampInitialFinal.txt", "ProgressCache.txt"):
        assert (tmp_path / f).exists(), f
    rows = _progress_rows(tmp_path / "ProgressCache.txt")
    assert [int(r[0]) for r in rows] == list(range(1, 41))
    assert float(rows[-1][1]) == pytest.approx(out["f"], rel=1e-9)


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


# ---------------------------------------------------------------------------
# engine = vidal
# ---------------------------------------------------------------------------

HOST_VIDAL = """input
{
tstep = 0.01
T = 0.1
N = 4
Npart = 4
d = 2
M = 5
gamma = 1e-6
maxBondDim = 16
optTol = 1e-6
useBFGS = no
maxIter = 3
cacheProgress = yes
engine = vidal
ipMode = host
hessianRowBlock = 5
hessianProgress = no
muStrategy = adaptive
stateCache = yes
%s
}
"""


def test_vidal_host_ip_driver_matches_jax(tmp_path):
    """tests/test_drivers.py:181-226 (engine = vidal, ipMode = host: the
    segmented gradient, the streaming Hessian with snake rows, the host
    loop, the streaming finalize) in both drivers: the same iterates,
    ProgressCache lines and files. The JAX driver's Vidal states.npz
    (`<name>_B`, `<name>_lam`) then loads into the port's problem."""
    outs, dirs = [], []
    for name, extra in (("jax", ""), ("torch", "backend = cpu")):
        d = tmp_path / name
        d.mkdir()
        cfg = tmp_path / f"cfg_{name}"
        cfg.write_text(HOST_VIDAL % extra)
        run = jdriver.run if name == "jax" else driver.run
        outs.append(run(str(cfg), seed=1, out_prefix=str(d) + os.sep))
        dirs.append(d)
    (out_j, out_t), (jdir, tdir) = outs, dirs
    assert out_t["status"]["iterations"] == out_j["status"]["iterations"]
    assert abs(out_t["status"]["f"] - out_j["status"]["f"]) < 1e-10
    assert abs(out_t["infidelity"] - out_j["infidelity"]) < 1e-10
    assert _progress_rows(tdir / "ProgressCache.txt") == \
        _progress_rows(jdir / "ProgressCache.txt")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    expn = np.loadtxt(tdir / "ExpectationN.txt")
    assert expn.shape == (11, 5)
    np.testing.assert_allclose(expn[:, 1:].sum(axis=1), 4.0, atol=1e-8)
    np.testing.assert_allclose(expn, np.loadtxt(jdir / "ExpectationN.txt"),
                               atol=1e-8)
    ck = json.loads((tdir / "checkpoint.json").read_text())["extra"]
    assert len(ck["duals"]) == 4

    # the JAX driver's state cache, read by the port's build_problem
    cfg = config.parse_input_file(str(tmp_path / "cfg_torch"))
    jstates = np.load(jdir / "states.npz")
    assert {"psi_i_B", "psi_i_lam", "psi_f_B", "psi_f_lam"} <= set(
        jstates.files)
    p = common.build_problem(cfg, engine="vidal",
                             state_cache=str(jdir / "states.npz"))
    np.testing.assert_array_equal(p.psi_i.B.numpy(), jstates["psi_i_B"])
    np.testing.assert_array_equal(p.psi_f.lam.numpy(), jstates["psi_f_lam"])
    mine = np.load(tdir / "states.npz")
    np.testing.assert_allclose(mine["psi_i_lam"], jstates["psi_i_lam"],
                               atol=1e-10)


@pytest.mark.parametrize("extra", [
    "useBFGS = yes", "useBFGS = yes\nmultistart = 3",
    "useBFGS = no\nmultistart = 3"])
def test_vidal_driver_modes_match_the_mps_engine(tmp_path, extra):
    """engine = vidal in L-BFGS (one ramp and a multistart batch) and in
    the multistart interior point, whose lanes and Hessians go through the
    Vidal engine: on TINY, chi = 3 is the exact rank bound, so every lane
    equals the MPS engine's run (the gate product is the same)."""
    outs = []
    for engine in ("vidal", "mps"):
        d = tmp_path / engine
        d.mkdir()
        outs.append(driver.run(_cfg(tmp_path, "cfg_" + engine, engine,
                                    extra + "\nbackend = cpu"),
                               seed=1, out_prefix=str(d) + os.sep))
    out_v, out_m = outs
    assert out_v["status"]["iterations"] == out_m["status"]["iterations"]
    assert out_v["status"]["f"] == pytest.approx(out_m["status"]["f"],
                                                 rel=1e-8)
    if "multistart" in extra:
        np.testing.assert_allclose(out_v["status"]["batch_costs"],
                                   out_m["status"]["batch_costs"], rtol=1e-8)
    np.testing.assert_allclose(out_v["u_final"], out_m["u_final"],
                               atol=1e-6)
