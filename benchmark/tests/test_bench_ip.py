"""The interior-point cell at small sizes on the CPU: the plain references
of the exact Hessian (reference/hessian.py) and of one interior-point
iteration (reference/interior_point.py) against the program's, and the
cell's check against the program, planted faults and the control.

The faults are planted here, not in `faults.py`: rows that are never
stepped past their own time, a row channel that keeps half of chi, an
interior point that keeps its start, one that steps against its Newton
direction, and the reference in complex64 in the program's place (the
control)."""

from __future__ import annotations

import functools
import time

import numpy as np
import pytest
import torch

from optimalcontrolmps_torch import tebd, vidal
from optimalcontrolmps_torch.optimize import interior_point

from benchmark import harness
from benchmark.reference import chain, dmrg
from benchmark.reference import hessian as ref_hess
from benchmark.reference import interior_point as ref_ip
from benchmark.tests.small import SEED

CELL = "bh_N20_ip.ip_host"
L, D, NPART, J, DT, GAMMA, N_T = 6, 2, 6, 1.0, 0.005, 1e-6, 7
EXACT_CHI = tebd.exact_rank_bound(L, D + 1)     # 27


@functools.lru_cache(maxsize=None)
def _states(chi: int) -> tuple:
    return tuple(dmrg.ground_state(L, D, NPART, J, U, chi)[0]
                 for U in (2.5, 50.0))


@pytest.mark.parametrize("chi,tol", [
    (EXACT_CHI, 1e-10),
    # below the exact rank every step truncates: the reference and the
    # program order their products differently, and eigh's kept subspace
    # moves with the rounding by eps / (the gap at the cut); 1e-8 leaves
    # room over that on these states, where complex64 reads 1e-8 and more
    (6, 1e-8)])
def test_reference_is_the_programs_hessian(chi, tol):
    states = _states(chi)
    u = np.linspace(2.5, 50.0, N_T) \
        + np.random.default_rng(SEED).normal(0.0, 2.0, N_T)
    st = tebd.make_stepper(L, D, J, DT, chi, sweep="vidal", device="cpu")
    psi = [vidal.from_mps(A, device="cpu") for A in states]
    ut = torch.as_tensor(u)
    H_stream = vidal.hessian_streaming(st, *psi, ut, GAMMA, row_block=3)
    H_dense = vidal.hessian(st, *psi, ut, GAMMA)
    Jp, gp = vidal.cost_and_gradient(st, *psi, ut, GAMMA)
    rs = chain.Stepper(D, J, DT, chi, 1e-12)
    canon = [tuple(torch.as_tensor(x) for x in chain.canonical_form(A))
             for A in states]
    Jr, gr, Hr = ref_hess.exact_hessian(rs, *canon, u, GAMMA, rows=2)
    # the regularization's part is exact in both: compare the rest
    fid = Hr - ref_hess.regularization_hessian(N_T, GAMMA, DT).numpy()
    scale = np.abs(fid).max()
    for H in (H_stream, H_dense):
        assert np.abs(H.numpy() - Hr).max() <= tol * scale
    assert abs(float(Jp) - Jr) <= 1e-14
    assert np.abs(gp.numpy() - gr).max() <= 1e-12 * np.abs(gr).max()


@pytest.mark.parametrize("pull", [
    # the Newton step fits the trust radius
    0.5,
    # it does not: the shifted steps decide
    100.0])
def test_reference_iteration_is_the_programs(pull):
    """One iteration of the host interior point on a convex quartic in 4
    variables with a 6-point path constraint, against the reference's."""
    rng = np.random.default_rng(SEED)
    M, N = 4, 6
    A = rng.normal(size=(M, M))
    Q = A @ A.T + 0.5 * np.eye(M)
    b = rng.normal(size=M) * pull
    B = rng.normal(size=(N, M))
    u0 = np.full(N, 40.0)

    def cost(x):
        x = np.asarray(x)
        return 0.5 * x @ Q @ x + b @ x + 0.01 * np.sum(x ** 4)

    def fgh(x):
        x = x.numpy()
        return (torch.tensor(cost(x)),
                torch.as_tensor(Q @ x + b + 0.04 * x ** 3),
                torch.as_tensor(Q + np.diag(0.12 * x ** 2)))

    x0 = rng.normal(size=M)
    res = interior_point.minimize_interior_point_host(
        fgh, torch.as_tensor(x0), B=B, u0=u0, tol=1e-8, max_iter=1,
        fun=lambda x: cost(x.numpy()))
    xs = np.clip(x0, -19.6, 19.6)
    want = ref_ip.first_step(cost, cost(xs), *(v.numpy() for v in
                                               fgh(torch.as_tensor(xs))[1:]),
                             x0, B, u0, 1e-8, (-20.0, 20.0, 2.0, 100.0))
    assert np.abs(want["x"] - xs).max() > 1e-3
    for name in ("x", "z_lo", "z_hi", "w_lo", "w_hi"):
        got = getattr(res, name).numpy()
        assert np.abs(got - want[name]).max() \
            <= 1e-12 * np.abs(want[name]).max(), name
    assert float(res.mu) == want["mu"]


# -- the cell's check ---------------------------------------------------------

def small_spec(chi: int = 6) -> dict:
    """The cell at L=6, d=2, N_t=7, M=4, chi 6 (truncating). ipMode is set
    to host: `auto` takes the host loop only at chi >= 64 or N_t > 256."""
    spec = harness.cell_spec(CELL)
    cfg = spec["config"]
    cfg.update({"N": L, "Npart": NPART, "d": D, "maxBondDim": chi,
                "T": DT * (N_T - 1), "M": 4, "name": "small_ip"})
    cfg["driver"] = {**cfg["driver"], "ipMode": "host"}
    return spec


def run_small(spec) -> dict:
    return harness.run_cell(spec, SEED, 0.2, False, torch.device("cpu"),
                            time.perf_counter())


def rows_unstepped(monkeypatch):
    """Rows never leave their own time: the row step returns its input."""
    monkeypatch.setattr(vidal, "tebd_step",
                        lambda st, A, u_from, u_to, forward=True: A)


def rows_half_chi(monkeypatch):
    """The row channel keeps chi / 2 of its chi directions at every bond
    (the rest zero, so every shape stays)."""
    old = tebd.split_truncate

    def half(theta, chi, keep_left, method="eigh", svd_driver=None):
        left, right = old(theta, chi, keep_left, method=method,
                          svd_driver=svd_driver)
        keep = (torch.arange(chi) < chi // 2).to(left.dtype)
        return left * keep, right * keep[:, None]
    monkeypatch.setattr(tebd, "split_truncate", half)


def test_check_passes_the_program():
    rec = run_small(small_spec())
    assert rec["correct"], rec["compared"]
    assert rec["units"][0]["counts"]["row_steps"] == N_T * (N_T - 1) // 2
    assert {"hessian.rows", "hessian.apply_dh", "hessian.psi_xi",
            "gradient.segmented", "ip.iteration",
            "ip.line_search"} <= set(rec["units"][0]["spans"])


def ip_keeps_its_start(monkeypatch):
    """The interior point takes no step: every iteration returns its
    state."""
    monkeypatch.setattr(interior_point._IPCore, "iter_apply",
                        lambda self, s, P, a_use: s)


def ip_against_newton(monkeypatch):
    """The interior point steps along minus its Newton direction."""
    old = interior_point._IPCore.iter_prep

    def flipped(self, s, f, g, H):
        P = old(self, s, f, g, H)
        return {**P, "dx": -P["dx"]}
    monkeypatch.setattr(interior_point._IPCore, "iter_prep", flipped)


@pytest.mark.parametrize("fault,gap", [(rows_unstepped, "hess_gap"),
                                       (rows_half_chi, "hess_gap"),
                                       (ip_keeps_its_start, "step_gap"),
                                       (ip_against_newton, "step_gap")])
def test_check_fails_a_planted_fault(monkeypatch, fault, gap):
    fault(monkeypatch)
    rec = run_small(small_spec())
    assert not rec["correct"], rec["compared"]
    assert rec["compared"][gap]["value"] > rec["compared"][gap]["limit"]


def test_check_fails_the_control():
    spec = small_spec()
    unit = harness.load_module("units", spec["unit"])
    dev = torch.device("cpu")
    cfg, tr, lim = spec["config"], spec["traffic"], spec["limits"]
    ctx = unit.setup(cfg, tr, SEED, dev, harness.Spans(dev))
    answers = [unit.run(ctx, 0, harness.Spans(dev))["answers"]]
    unit.release(ctx)
    ctl = unit.check(cfg, tr, SEED, answers, dev, control=True)
    assert [k for k, v in lim.items() if not ctl[k] <= v]
