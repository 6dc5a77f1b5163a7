"""The port's interior-point tracing on the CPU: the counters (exact-Hessian
row steps, Trotter steps, eigh calls by size, host interior-point
iterations and trials), the spans (`profiling.span`, summed only under
`collect_spans`), and the host-mode solve factored out of the driver
(`optimize_ramp.solve_ip_host`) against the driver's `run`."""

import os

import numpy as np
import pytest
import torch

from optimalcontrolmps_torch import (engine, groundstate, profiling,
                                     streaming, tebd, vidal)
from optimalcontrolmps_torch.config import parse_input_file
from optimalcontrolmps_torch.drivers import common
from optimalcontrolmps_torch.drivers import optimize_ramp as driver
from optimalcontrolmps_torch.ops import trunc
from optimalcontrolmps_torch.optimize import interior_point
from torch_branches import trajectory_branch  # noqa: F401 (a fixture)

L, D, NPART, J, DT, GAMMA, CHI, N_T = 4, 2, 4, 1.0, 0.01, 1e-6, 6, 7


@pytest.fixture(scope="module")
def problem():
    st = tebd.make_stepper(L, D, J, DT, CHI, device="cpu")
    psi = [groundstate.initialize_state(L, D, NPART, J, U, CHI,
                                        device="cpu") for U in (2.5, 50.0)]
    u = torch.as_tensor(np.linspace(2.5, 50.0, N_T)
                        + np.random.default_rng(3).normal(0.0, 1.0, N_T))
    return st, psi, u


def _replayed_counts(row_block: int) -> tuple:
    """The checkpointed branch's psi and xi steps that re-make a state:
    (the segmented gradient's re-propagated segments, the Hessian's psi
    and xi checkpoint sweeps, each row block's psi and xi and each time
    block's xi)."""
    n = N_T - 1
    K = streaming.pick_segment(n)
    R = streaming.pick_row_block(n, row_block)
    S = n // R
    return ((n // K) * (K - 1),
            2 * n + S * (2 * R - 1) + S * (S + 1) // 2 * (R - 1))


@pytest.mark.parametrize("row_block", [1, 2, 3, 6])
def test_streaming_row_steps_are_the_references_count(problem, row_block,
                                                      trajectory_branch):
    """BlockHessian steps N_t (N_t - 1) / 2 rows for every row block R
    dividing N_t - 1: R (R + 1) / 2 in each diagonal block, R^2 in each of
    the S (S - 1) / 2 blocks below it."""
    st, (pi, pf), u = problem
    streaming.reset_counts()
    tebd.reset_counts()
    engine.hessian_streaming(st, pi, pf, u, GAMMA, row_block=row_block)
    assert streaming.row_steps == N_T * (N_T - 1) // 2
    # tebd.steps: the gradient's psi and xi, 2 n; checkpointed, also its
    # re-propagated segments and the Hessian's psi and xi; and the rows
    n = N_T - 1
    replayed = sum(_replayed_counts(row_block))
    if trajectory_branch == "kept":
        assert tebd.steps == 2 * n + streaming.row_steps
    else:
        assert tebd.steps == 2 * n + replayed + streaming.row_steps


@pytest.mark.parametrize("row_block", [2, 6])
def test_kept_and_replayed_counters(problem, row_block, trajectory_branch):
    """One gradient and one hessian_streaming call on its aux: kept, the
    gradient counts one kept call, the Hessian one call that took them,
    and nothing is re-stepped; checkpointed, nothing is kept and the
    segments' and the Hessian's psi and xi steps are replayed."""
    st, (pi, pf), u = problem
    grad, hess = _replayed_counts(row_block)
    kept = trajectory_branch == "kept"
    streaming.reset_counts()
    _, aux = engine.gradient_segmented(st, pi, pf, u, GAMMA)
    assert (streaming.kept_trajectories, streaming.kept_hessians) == (
        int(kept), 0)
    assert streaming.replayed_steps == (0 if kept else grad)
    streaming.reset_counts()
    engine.hessian_streaming(st, pi, pf, u, GAMMA, aux=aux,
                             row_block=row_block)
    assert (streaming.kept_trajectories, streaming.kept_hessians) == (
        0, int(kept))
    assert streaming.replayed_steps == (0 if kept else hess)
    assert streaming.row_steps == N_T * (N_T - 1) // 2
    streaming.reset_counts()
    assert (streaming.kept_trajectories, streaming.kept_hessians,
            streaming.replayed_steps, streaming.row_steps) == (0, 0, 0, 0)


@pytest.mark.parametrize("row_block", [2, 3])
def test_streaming_hessian_applies_dh_a_row_block_at_a_time(
        problem, row_block, trajectory_branch, monkeypatch):
    """dH's batches hold at most R states on either branch, so its working
    set is a row block's. Kept, dH meets each xi_j once and each psi_i a
    row starts from once, N_t + n states; checkpointed, each row block's
    psi and xi and each time block's xi, 2 n + S (S + 1) / 2 R."""
    st, (pi, pf), u = problem
    _, aux = engine.gradient_segmented(st, pi, pf, u, GAMMA)
    widths, apply = [], engine.mpslib.apply_site_sum_diag

    def counted(A, *args, **kw):
        widths.append(A.shape[0])
        return apply(A, *args, **kw)

    monkeypatch.setattr(engine.mpslib, "apply_site_sum_diag", counted)
    engine.hessian_streaming(st, pi, pf, u, GAMMA, aux=aux,
                             row_block=row_block)
    n = N_T - 1
    R = streaming.pick_row_block(n, row_block)
    S = n // R
    assert max(widths) <= R
    assert sum(widths) == (N_T + n if trajectory_branch == "kept"
                           else 2 * n + S * (S + 1) // 2 * R)


def test_trajectories_fit_weighs_three_trajectories_against_free_memory(
        monkeypatch):
    """psi_t, xi_t and the dH images of xi_t, n_times states each, against
    half the host's available memory on the CPU (here 10^6 bytes)."""
    monkeypatch.setattr(streaming.os, "sysconf", lambda name: 1000)
    x = torch.zeros(1000, dtype=torch.float64)        # 8000 bytes
    assert streaming.trajectories_fit(x, 20)          # 480000 bytes
    assert not streaming.trajectories_fit(x, 21)      # 504000 bytes
    state = vidal.VidalState(x[:500], x[:500])        # two fields
    assert streaming.trajectories_fit(state, 20)
    assert not streaming.trajectories_fit(state, 21)


def test_trajectories_fit_counts_the_allocators_unused_blocks_on_the_card(
        monkeypatch):
    """On the card free memory is mem_get_info's free bytes plus what the
    caching allocator reserves beyond what is allocated: here 4 * 10^5 +
    (7 - 5) * 10^5 bytes, so 3 * 10^5 may be kept."""
    monkeypatch.setattr(streaming.torch.cuda, "mem_get_info",
                        lambda dev: (400_000, 10 ** 9))
    monkeypatch.setattr(streaming.torch.cuda, "memory_reserved",
                        lambda dev: 700_000)
    monkeypatch.setattr(streaming.torch.cuda, "memory_allocated",
                        lambda dev: 500_000)

    class OnTheCard:                                  # 8000 bytes
        device = torch.device("cuda", 0)

        def numel(self):
            return 1000

        def element_size(self):
            return 8

    assert streaming.trajectories_fit(OnTheCard(), 12)      # 288000 bytes
    assert not streaming.trajectories_fit(OnTheCard(), 13)  # 312000 bytes


def test_dense_row_steps_skip_the_masked_rows(problem):
    """engine.hessian steps only rows 1 .. N_t - 3, each up to t_{N_t - 2}:
    (N_t - 3)(N_t - 2) / 2."""
    st, (pi, pf), u = problem
    streaming.reset_counts()
    engine.hessian(st, pi, pf, u, GAMMA)
    assert streaming.row_steps == (N_T - 3) * (N_T - 2) // 2


def test_eigh_counter_counts_calls_by_size():
    trunc.reset_counts()
    g = torch.Generator().manual_seed(0)
    for m, b in ((3, 1), (5, 4), (5, 2)):
        a = torch.randn(b, m, m, generator=g, dtype=torch.float64)
        trunc.eigh(a + a.transpose(-2, -1))
    theta = torch.randn(2, 6, 4, generator=g, dtype=torch.complex128)
    trunc.split_truncate(theta, 3, keep_left=True)
    trunc.split_truncate(theta, 3, keep_left=False)
    assert trunc.eigh_calls == {3: 1, 5: 2, 6: 1, 4: 1}
    trunc.reset_counts()
    assert trunc.eigh_calls == {}


def test_vidal_steps_count_the_batch(problem):
    st, (pi, pf), u = problem
    stv = tebd.make_stepper(L, D, J, DT, CHI, sweep="vidal", device="cpu")
    psi = vidal.from_mps(pi, device="cpu")
    vidal.reset_counts()
    vidal.rollout_final(stv, psi, torch.stack([u, u, u]))
    assert vidal.steps == 3 * (N_T - 1)


def test_spans_leave_values_bitwise_unchanged(problem):
    """The spans wait and add seconds only under a collector; the values
    are the same bits with one and without."""
    st, (pi, pf), u = problem
    H0 = engine.hessian_streaming(st, pi, pf, u, GAMMA, row_block=3)
    g0, _ = engine.gradient_segmented(st, pi, pf, u, GAMMA)
    with profiling.collect_spans("cpu") as spans:
        H1 = engine.hessian_streaming(st, pi, pf, u, GAMMA, row_block=3)
        g1, _ = engine.gradient_segmented(st, pi, pf, u, GAMMA)
    assert torch.equal(H0, H1) and torch.equal(g0, g1)
    assert set(spans) == {"gradient.segmented", "hessian.psi_xi",
                          "hessian.apply_dh", "hessian.rows"}
    assert all(v > 0.0 for v in spans.values())
    before = dict(spans)
    engine.hessian(st, pi, pf, u, GAMMA)
    assert spans == before              # no collector installed
    with profiling.collect_spans() as outer:
        with profiling.span("a"):
            with profiling.span("b"):
                pass
    assert set(outer) == {"a", "b"} and outer["a"] >= outer["b"]


HOST = """input
{
tstep = 0.01
T = 0.1
N = 4
Npart = 4
d = 2
M = 4
gamma = 1e-6
maxBondDim = 16
optTol = 1e-6
useBFGS = no
maxIter = 3
engine = %s
ipMode = host
hessianRowBlock = 5
hessianProgress = no
muStrategy = adaptive
backend = cpu
writeHessians = no
}
"""


@pytest.mark.parametrize("eng", ["mps", "vidal"])
def test_factored_solve_is_the_drivers(tmp_path, eng):
    """tests/test_torch_driver.py's host-mode case: solve_ip_host on the
    problem the driver builds returns the iterate and cost that
    optimize_ramp.run returns, and counts its iterations and trials."""
    cfg_path = tmp_path / "InputFile"
    cfg_path.write_text(HOST % eng)
    out = driver.run(str(cfg_path), seed=1,
                     out_prefix=str(tmp_path) + os.sep)
    cfg = parse_input_file(str(cfg_path))
    p = common.build_problem(cfg, seed=1, engine=eng)
    assert driver.ip_on_host(cfg, p)
    interior_point.reset_counts()
    seen = []
    res = driver.solve_ip_host(
        cfg, p, torch.zeros(p.M, dtype=torch.float64),
        observe=lambda c, Jc, g, H: seen.append((c.clone(), Jc, g, H)))
    np.testing.assert_array_equal(res.x.numpy(), out["c_opt"])
    assert float(res.f) == out["status"]["f"]
    assert int(res.iterations) == out["status"]["iterations"] == 3
    assert interior_point.host_iterations == 3
    assert interior_point.host_trials >= 3
    assert len(seen) == 3 and not seen[0][0].any()
    assert seen[0][3].shape == (p.M, p.M)
