"""Cost / gradient / Hessian engine for MPS optimal control.

Counterpart of optimalcontrolmps_tpu/engine.py (the reference's
OptimalControl<BH_tDMRG>). Rollouts are Python loops over `tebd.tebd_step`
that return stacked states; callers thread the results explicitly.

Batching: where the JAX package vmaps, these functions take a control batch.
`psi0` and `psi_target` are one MPS each, (L, chi, p, chi); `u` is one
control (N_t,) or a batch (B, N_t), and every result carries the same
leading batch axis as `u` (none for one control). All lanes of a batch step
together, one bond update per bond for the whole batch.

    J(u) = 0.5 (1 - |<psi_target|psi(T)>|^2) + gamma/2 sum_i (u_{i+1}-u_i)^2/dt
    g_i  = dt Re(<xi_i| dH/du |psi_i> <psi(T)|psi_target> 1j) + reg
    H    : exact row propagation (every row state stepped as one batch)

`gradient_segmented` and `hessian_streaming` give the same gradient and
Hessian with few states in flight (streaming.py), for the host-mode
interior point. `hessian(row_shard=mesh)` splits the row loop over the
ranks of a mesh's "rows" axis (the JAX package's row_sharding).

The regularization helpers act on the last axis, so they serve a (B, N)
batch as well as one (N,) control.
"""

from __future__ import annotations

import bisect

import torch

from . import mps as mpslib
from .device import resolve_device
from .parallel.comm import all_reduce_sum
from .parallel.mesh import row_shard as _row_slice
from .profiling import span
from .streaming import (BlockHessian, assemble_hessian, count_row_steps,
                        pick_row_block, rollout_measure,
                        segmented_adjoint_gradient)
from .tebd import TEBDStepper, tebd_step

__all__ = [
    "rollout", "rollout_final", "costate_rollout", "cost", "fidelities",
    "fidelities_streaming", "gradient", "gradient_lowmem",
    "gradient_segmented", "cost_and_gradient", "hessian",
    "hessian_streaming", "regularization", "regularization_grad",
    "regularization_hessian",
]


# ---------------------------------------------------------------------------
# regularization (exact stencils of the reference)
# ---------------------------------------------------------------------------

def regularization(u, gamma, dt):
    d = torch.diff(u, dim=-1)
    return 0.5 * gamma * torch.sum(d * d, dim=-1) / dt


def regularization_grad(u, gamma, dt):
    """One-sided endpoint stencils, central differences inside."""
    interior = -gamma * (u[..., 2:] + u[..., :-2] - 2.0 * u[..., 1:-1]) / dt
    first = -gamma * (-5.0 * u[..., 1] + 4.0 * u[..., 2] - u[..., 3]
                      + 2.0 * u[..., 0]) / dt
    last = -gamma * (-5.0 * u[..., -2] + 4.0 * u[..., -3] - u[..., -4]
                     + 2.0 * u[..., -1]) / dt
    return torch.cat([first[..., None], interior, last[..., None]], dim=-1)


def regularization_hessian(n, gamma, dt, dtype=torch.float64, device=None):
    """Tridiagonal gamma/dt with the four edge couplings and the two edge
    diagonal entries zero (fixed endpoints). device=None means the card."""
    device = resolve_device(device)
    g = gamma / dt
    main = torch.zeros(n, dtype=dtype, device=device)
    main[1:-1] = 2.0 * g
    off = torch.zeros(n - 1, dtype=dtype, device=device)
    off[1:-1] = -g
    return torch.diag(main) + torch.diag(off, 1) + torch.diag(off, -1)


# ---------------------------------------------------------------------------
# batching helpers
# ---------------------------------------------------------------------------

def _lanes(psi, u):
    """(one MPS, u (N,) or (B, N)) -> (A (B, L, chi, p, chi), U (B, N),
    whether u was a batch)."""
    batched = u.dim() == 2
    U = u if batched else u[None]
    A = psi[None].expand(U.shape[0], *psi.shape)
    return A, U, batched


def _out(x, batched):
    return x if batched else x[0]


def _overlap_with(target, A):
    """<target|A_b> for one MPS `target` against a batch A; (B,)."""
    return mpslib.overlap(target[None].expand(A.shape[0], *target.shape), A)


# ---------------------------------------------------------------------------
# rollouts
# ---------------------------------------------------------------------------

def _rollout_lanes(st, A, U):
    B, n = U.shape
    traj = torch.empty((B, n, *A.shape[1:]), dtype=A.dtype, device=A.device)
    traj[:, 0] = A
    for i in range(n - 1):
        A = tebd_step(st, A, U[:, i], U[:, i + 1], forward=True)
        traj[:, i + 1] = A
    return traj


def _costate_lanes(st, X, U):
    B, n = U.shape
    traj = torch.empty((B, n, *X.shape[1:]), dtype=X.dtype, device=X.device)
    traj[:, n - 1] = X
    for i in range(n - 1, 0, -1):
        X = tebd_step(st, X, U[:, i], U[:, i - 1], forward=False)
        traj[:, i - 1] = X
    return traj


def rollout(st: TEBDStepper, psi0, u):
    """Forward sweep: psi_t for all N_t times, (N_t, L, chi, p, chi) or
    (B, N_t, ...) (the reference's calcPsi)."""
    A, U, batched = _lanes(psi0, u)
    return _out(_rollout_lanes(st, A, U), batched)


def _final_lanes(st, A, U):
    for i in range(U.shape[1] - 1):
        A = tebd_step(st, A, U[:, i], U[:, i + 1], forward=True)
    return A


def rollout_final(st: TEBDStepper, psi0, u):
    """Forward sweep returning psi(T) only."""
    A, U, batched = _lanes(psi0, u)
    return _out(_final_lanes(st, A, U), batched)


def costate_rollout(st: TEBDStepper, psi_target, u):
    """Backward sweep from the target, ordered by time (xi_t[N_t-1] =
    psi_target): xi_{i-1} = step(xi_i, u_i, u_{i-1}, backward) (calcXi)."""
    X, U, batched = _lanes(psi_target, u)
    return _out(_costate_lanes(st, X, U), batched)


# ---------------------------------------------------------------------------
# cost / fidelity
# ---------------------------------------------------------------------------

def cost(st: TEBDStepper, psi0, psi_target, u, gamma):
    """J(u) (calcCost). Differentiate it with `gradient`: autodiff through
    the truncating rollout is not supported."""
    A, U, batched = _lanes(psi0, u)
    ov = _overlap_with(psi_target, _final_lanes(st, A, U))
    fid = (ov * ov.conj()).real
    return _out(0.5 * (1.0 - fid) + regularization(U, gamma, st.dt), batched)


def fidelities(st: TEBDStepper, psi0, psi_target, u):
    """|<psi_target|psi(t_i)>|^2 for every i (calcFidelityForAllT)."""
    A, U, batched = _lanes(psi0, u)
    traj = _rollout_lanes(st, A, U)
    B, n = U.shape
    ov = _overlap_with(psi_target, traj.reshape(B * n, *traj.shape[2:]))
    return _out((ov * ov.conj()).real.reshape(B, n), batched)


def fidelities_streaming(st: TEBDStepper, psi0, psi_target, u):
    """fidelities() with one state per lane in flight instead of the
    trajectory stack; same values."""
    A, U, batched = _lanes(psi0, u)

    def measure(s):
        ov = _overlap_with(psi_target, s)
        return (ov * ov.conj()).real

    fids = rollout_measure(
        lambda s, ua, ub: tebd_step(st, s, ua, ub, forward=True),
        A, U, measure)
    return _out(fids.T, batched)


# ---------------------------------------------------------------------------
# gradient
# ---------------------------------------------------------------------------

def _div_t(st: TEBDStepper, xi_t, psi_t):
    """divT_i = <xi_i| dH/du |psi_i>, dH/du = sum_j 0.5 n_j(n_j-1)
    (calcDivT), for (B, N_t, L, chi, p, chi) stacks -> (B, N_t)."""
    B, n = psi_t.shape[:2]
    return mpslib.sandwich_site_sum(xi_t.reshape(B * n, *xi_t.shape[2:]),
                                    psi_t.reshape(B * n, *psi_t.shape[2:]),
                                    0.5 * st.nn1).reshape(B, n)


def gradient(st: TEBDStepper, psi0, psi_target, u, gamma):
    """Analytic gradient dJ/du (calcAnalyticGradient + calcFidelityGrad).
    Returns (g, (psi_t, xi_t, divT, ov)), ov = <psi(T)|psi_target>."""
    A, U, batched = _lanes(psi0, u)
    X = _lanes(psi_target, u)[0]
    psi_t = _rollout_lanes(st, A, U)
    xi_t = _costate_lanes(st, X, U)
    divT = _div_t(st, xi_t, psi_t)
    ov = mpslib.overlap(psi_t[:, -1], X)
    g = (st.dt * (divT * ov[:, None] * 1j).real
         + regularization_grad(U, gamma, st.dt))
    return _out(g, batched), tuple(_out(x, batched)
                                   for x in (psi_t, xi_t, divT, ov))


def gradient_lowmem(st: TEBDStepper, psi0, psi_target, u, gamma):
    """Memory-light gradient: xi is never stored, divT is computed inline
    during the one backward sweep (the reference's BFGS mode). Returns
    (g, (psi_t, None, divT, ov))."""
    A, U, batched = _lanes(psi0, u)
    X = _lanes(psi_target, u)[0]
    half = 0.5 * st.nn1
    psi_t = _rollout_lanes(st, A, U)
    n = U.shape[1]
    divT = torch.empty(U.shape, dtype=psi_t.dtype, device=psi_t.device)
    divT[:, n - 1] = mpslib.sandwich_site_sum(X, psi_t[:, -1], half)
    xi = X
    for i in range(n - 1, 0, -1):
        xi = tebd_step(st, xi, U[:, i], U[:, i - 1], forward=False)
        divT[:, i - 1] = mpslib.sandwich_site_sum(xi, psi_t[:, i - 1], half)
    ov = mpslib.overlap(psi_t[:, -1], X)
    g = (st.dt * (divT * ov[:, None] * 1j).real
         + regularization_grad(U, gamma, st.dt))
    return _out(g, batched), (_out(psi_t, batched), None,
                              _out(divT, batched), _out(ov, batched))


def cost_and_gradient(st: TEBDStepper, psi0, psi_target, u, gamma):
    """Cost and gradient sharing one forward sweep."""
    g, (_, _, _, ov) = gradient(st, psi0, psi_target, u, gamma)
    fid = (ov * ov.conj()).real
    return 0.5 * (1.0 - fid) + regularization(u, gamma, st.dt), g


# ---------------------------------------------------------------------------
# Hessian: batched row propagation
# ---------------------------------------------------------------------------

def hessian(st: TEBDStepper, psi0, psi_target, u, gamma, aux=None,
            row_shard=None):
    """Exact dense Hessian of J for one control u (N_t,) (calcHessian_*).

    Row i needs psiH_i(t_j) = U(t_j <- t_i) dH psi_i for j > i. All row
    states are one batch: at each time j the rows with 1 <= i < j step
    together (rows i >= j are frozen, and row 0 and rows past N_t-2 are
    masked out of H, as in the JAX package), then every active row is
    overlapped with xiH_j. aux: (psi_t, xi_t, divT, ov) from `gradient`.
    The row loop is the span `hessian.rows`; its steps add to
    `streaming.row_steps`: (N_t - 3)(N_t - 2) / 2 of them, split over the
    ranks of a row shard.

    row_shard: a `parallel.mesh.Mesh`; this rank then steps only its rows
    along the mesh's "rows" axis (row i on row rank i mod n_rows,
    `parallel.mesh.row_shard`), and the overlap matrix, zero where another
    rank's rows are, is summed over the rows group: every entry has one
    writer, so every rank returns the whole Hessian.
    """
    n = u.shape[0]
    dt = st.dt
    half = 0.5 * st.nn1
    if aux is None:
        _, aux = gradient(st, psi0, psi_target, u, gamma)
    psi_t, xi_t, divT, ov = aux

    # xiH_j = dH|xi_j> and the row states psiH_i(t_i) = dH|psi_i>,
    # normalized, with their norms
    xiH, xiH_norm = mpslib.apply_site_sum_diag(xi_t, half,
                                               method=st.trunc_method)
    rows, row_norm = mpslib.apply_site_sum_diag(psi_t, half,
                                                method=st.trunc_method)

    # the rows that are ever stepped (1 <= i < j <= N_t - 2), this rank's
    mine = torch.arange(n, device=rows.device)
    if row_shard is not None:
        mine = mine[_row_slice(row_shard, n)]
    mine = mine[(mine >= 1) & (mine <= n - 3)]
    ovm = torch.zeros((n, n), dtype=rows.dtype, device=rows.device)
    states = rows[mine]
    rows_h = mine.tolist()
    with span("hessian.rows"):
        for j in range(2, n - 1):      # j = 1 has no active row i >= 1
            a = bisect.bisect_left(rows_h, j)   # this rank's rows i < j
            if a == 0:
                continue
            act = tebd_step(st, states[:a], u[j - 1], u[j], forward=True)
            count_row_steps(a)
            states[:a] = act
            # <xiH_j|psiH_i(t_j)>
            ovm[j, mine[:a]] = _overlap_with(xiH[j], act)
    if row_shard is not None:
        ovm = all_reduce_sum(ovm, row_shard.rows_group)

    diag_ov = mpslib.overlap(xiH, rows)
    return assemble_hessian(ovm, row_norm, xiH_norm, diag_ov, divT, ov, dt,
                            regularization_hessian(n, gamma, dt,
                                                   dtype=row_norm.dtype,
                                                   device=rows.device))


# ---------------------------------------------------------------------------
# streaming: segmented gradient, block Hessian
# ---------------------------------------------------------------------------

def _step_fwd(st):
    return lambda s, a, b: tebd_step(st, s, a, b, forward=True)


def gradient_segmented(st: TEBDStepper, psi0, psi_target, u, gamma,
                       seg=None):
    """`gradient` with O(sqrt(N_t)) states in memory: the forward sweep
    keeps segment-start checkpoints and the backward sweep re-propagates
    one segment at a time (streaming.segmented_adjoint_gradient); the same
    values for one more forward rollout. Returns (g, (psiT, divT, ov))."""
    A, U, batched = _lanes(psi0, u)
    X = _lanes(psi_target, u)[0]
    half = 0.5 * st.nn1
    g, aux = segmented_adjoint_gradient(
        _step_fwd(st),
        lambda x, ui, uim1: tebd_step(st, x, ui, uim1, forward=False),
        lambda x, p: mpslib.sandwich_site_sum(x, p, half),
        mpslib.overlap,
        lambda uu: regularization_grad(uu, gamma, st.dt),
        A, X, U, st.dt, seg=seg)
    return _out(g, batched), tuple(_out(x, batched) for x in aux)


def hessian_streaming(st: TEBDStepper, psi0, psi_target, u, gamma,
                      aux=None, row_block: int = 64, progress=None):
    """`hessian` for one control u (N_t,) with O(row_block) row states in
    flight (streaming.BlockHessian); the same values. aux: (psiT, divT, ov)
    from gradient_segmented, recomputed when None. progress(c, s) is called
    after each block. The BlockHessian is built per call: it holds no
    compiled program, so there is nothing to cache."""
    n = u.shape[0]
    if aux is None:
        _, aux = gradient_segmented(st, psi0, psi_target, u, gamma)
    _, divT, ov = aux
    half = 0.5 * st.nn1
    bh = BlockHessian(
        n, pick_row_block(n - 1, row_block), fwd=_step_fwd(st),
        bwd=lambda s, a, b: tebd_step(st, s, a, b, forward=False),
        apply_dh=lambda A: mpslib.apply_site_sum_diag(
            A, half, method=st.trunc_method),
        row_step=_step_fwd(st), overlap=mpslib.overlap)
    ovm, row_norm, xih_norm, diag_ov = bh.ov_data(
        psi0[None], psi_target[None], u, progress=progress)
    return assemble_hessian(ovm, row_norm, xih_norm, diag_ov, divT, ov,
                            st.dt, regularization_hessian(
                                n, gamma, st.dt, dtype=row_norm.dtype,
                                device=row_norm.device))
