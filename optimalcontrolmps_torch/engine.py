"""Cost / gradient / Hessian of MPS optimal control: the one derivative
layer of both MPS engines.

Counterpart of optimalcontrolmps_tpu/engine.py (the reference's
OptimalControl<BH_tDMRG>). `Engine` holds the algorithms once (the three
rollouts, cost and fidelities, the stacked, memory-light and segmented
adjoint gradients, the dense and streaming exact Hessians), written over
what an engine supplies: its Trotter step, the plain MPS tensor of its
states and the stepper of the Hessian's rows. This module binds it to
`tebd.tebd_step` (the fixed-rank MPS engine), `vidal.py` to `vidal_step`.
Rollouts are Python loops over the step that return stacked states.

Batching: where the JAX package vmaps, these functions take a control batch.
`psi0` and `psi_target` are one state each (an MPS (L, chi, p, chi), or a
`vidal.VidalState`); `u` is one control (N_t,) or a batch (B, N_t), and
every result carries the same leading batch axis as `u` (none for one
control). All lanes of a batch step together, one bond update per bond for
the whole batch.

    J(u) = 0.5 (1 - |<psi_target|psi(T)>|^2) + gamma/2 sum_i (u_{i+1}-u_i)^2/dt
    g_i  = dt Re(<xi_i| dH/du |psi_i> <psi(T)|psi_target> 1j) + reg
    H    : exact row propagation (every row state stepped as one batch)

`gradient_segmented` and `hessian_streaming` give the same gradient and
Hessian for the host-mode interior point (streaming.py): few row states in
flight, psi and xi kept from the gradient when they fit and re-derived
from checkpoints when not. `hessian(row_shard=mesh)` splits the row loop
over the ranks of a mesh's "rows" axis (the JAX package's row_sharding)
through the mesh's own methods; this module imports nothing of
`parallel/`.

The regularization helpers act on the last axis, so they serve a (B, N)
batch as well as one (N,) control.
"""

from __future__ import annotations

import bisect

import torch

from . import mps as mpslib
from .device import resolve_device
from .profiling import span
from .streaming import (BlockHessian, GradientAux, adjoint_gradient,
                        assemble_hessian, count_row_steps, infidelity_cost,
                        pick_row_block, rollout_measure,
                        segmented_adjoint_gradient)
from .tebd import TEBDStepper, tebd_step

__all__ = [
    "Engine", "rollout", "rollout_final", "costate_rollout", "cost",
    "fidelities", "fidelities_streaming", "gradient", "gradient_lowmem",
    "gradient_segmented", "cost_and_gradient", "cost_and_gradient_from",
    "hessian", "hessian_streaming", "to_lanes", "from_lanes",
    "regularization", "regularization_grad", "regularization_hessian",
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
# states: a tensor, or a NamedTuple of tensors with the same leading axes
# ---------------------------------------------------------------------------

def _map(f, *states):
    """f on each tensor of the states (a tensor each, or NamedTuples of
    one type); the result has the states' structure."""
    if isinstance(states[0], tuple):
        return type(states[0])(*map(f, *states))
    return f(*states)


def to_lanes(psi, u):
    """(one state, u (N,) or (B, N)) -> (the state expanded to B lanes,
    U (B, N), whether u was a batch)."""
    batched = u.dim() == 2
    U = u if batched else u[None]
    return (_map(lambda x: x[None].expand(U.shape[0], *x.shape), psi), U,
            batched)


def from_lanes(x, batched):
    """A lane-batched result (a tensor or a state) with the lane axis
    dropped when u was one control."""
    return x if batched else _map(lambda t: t[0], x)


def _trajectory(S, n):
    """Empty buffers for n times of the state batch S, the time axis after
    the lane axis."""
    return _map(lambda x: torch.empty((x.shape[0], n, *x.shape[1:]),
                                      dtype=x.dtype, device=x.device), S)


def _put(traj, i, S):
    _map(lambda t, x: t[:, i].copy_(x), traj, S)


def _fill(states):
    """A list of state batches, one per time, put in one `_trajectory`
    buffer; each entry of the list is dropped once copied."""
    traj = _trajectory(states[0], len(states))
    for i in range(len(states)):
        _put(traj, i, states[i])
        states[i] = None
    return traj


def _overlap_with(target, A):
    """<target|A_b> for one MPS `target` against a batch A; (B,)."""
    return mpslib.overlap(target[None].expand(A.shape[0], *target.shape), A)


def _div_t(st: TEBDStepper, xi_t, psi_t):
    """divT_i = <xi_i| dH/du |psi_i>, dH/du = sum_j 0.5 n_j(n_j-1)
    (calcDivT), for (B, N_t, L, chi, p, chi) stacks -> (B, N_t)."""
    B, n = psi_t.shape[:2]
    return mpslib.sandwich_site_sum(xi_t.reshape(B * n, *xi_t.shape[2:]),
                                    psi_t.reshape(B * n, *psi_t.shape[2:]),
                                    0.5 * st.nn1).reshape(B, n)


# ---------------------------------------------------------------------------
# the derivative algorithms, over an engine's step
# ---------------------------------------------------------------------------

class Engine:
    """The derivative functions of an MPS engine, over what it supplies:

    step(st, S, u_from, u_to, forward=)  one Trotter step of a state batch;
    mps(S)                 the plain MPS batch of S (S itself by default);
    row_stepper(st)        the stepper of the exact Hessian's rows, which
                           are plain MPS batches (st itself by default);
    row_step(st_row, A, u_from, u_to, forward=)  their step (`step` by
                           default).

    The public methods are an engine module's functions: engine.py and
    vidal.py each bind an instance."""

    def __init__(self, step, mps=lambda s: s, row_stepper=lambda st: st,
                 row_step=None):
        self.step = step
        self.mps = mps
        self.row_stepper = row_stepper
        self.row_step = step if row_step is None else row_step

    def _rollout(self, st, S, U):
        n = U.shape[1]
        traj = _trajectory(S, n)
        _put(traj, 0, S)
        for i in range(n - 1):
            S = self.step(st, S, U[:, i], U[:, i + 1], forward=True)
            _put(traj, i + 1, S)
        return traj

    def _costate(self, st, X, U):
        n = U.shape[1]
        traj = _trajectory(X, n)
        _put(traj, n - 1, X)
        for i in range(n - 1, 0, -1):
            X = self.step(st, X, U[:, i], U[:, i - 1], forward=False)
            _put(traj, i - 1, X)
        return traj

    def _final(self, st, S, U):
        for i in range(U.shape[1] - 1):
            S = self.step(st, S, U[:, i], U[:, i + 1], forward=True)
        return S

    def rollout(self, st: TEBDStepper, psi0, u):
        """Forward sweep: psi_t for all N_t times, a time axis in front of
        the state's axes ((N_t, L, chi, p, chi) for an MPS), after the lane
        axis for a control batch (the reference's calcPsi)."""
        S, U, batched = to_lanes(psi0, u)
        return from_lanes(self._rollout(st, S, U), batched)

    def rollout_final(self, st: TEBDStepper, psi0, u):
        """Forward sweep returning psi(T) only."""
        S, U, batched = to_lanes(psi0, u)
        return from_lanes(self._final(st, S, U), batched)

    def costate_rollout(self, st: TEBDStepper, psi_target, u):
        """Backward sweep from the target, ordered by time (xi_t[N_t-1] =
        psi_target): xi_{i-1} = step(xi_i, u_i, u_{i-1}, backward)
        (calcXi)."""
        X, U, batched = to_lanes(psi_target, u)
        return from_lanes(self._costate(st, X, U), batched)

    def cost(self, st: TEBDStepper, psi0, psi_target, u, gamma):
        """J(u) (calcCost). Differentiate it with `gradient`: autodiff
        through the truncating rollout is not supported."""
        S, U, batched = to_lanes(psi0, u)
        ov = _overlap_with(self.mps(psi_target),
                           self.mps(self._final(st, S, U)))
        return from_lanes(infidelity_cost(ov)
                          + regularization(U, gamma, st.dt), batched)

    def fidelities(self, st: TEBDStepper, psi0, psi_target, u):
        """|<psi_target|psi(t_i)>|^2 for every i (calcFidelityForAllT)."""
        S, U, batched = to_lanes(psi0, u)
        traj = self.mps(self._rollout(st, S, U))
        B, n = U.shape
        ov = _overlap_with(self.mps(psi_target),
                           traj.reshape(B * n, *traj.shape[2:]))
        return from_lanes((ov * ov.conj()).real.reshape(B, n), batched)

    def fidelities_streaming(self, st: TEBDStepper, psi0, psi_target, u):
        """fidelities() with one state per lane in flight instead of the
        trajectory stack; same values."""
        S, U, batched = to_lanes(psi0, u)
        target = self.mps(psi_target)

        def measure(s):
            ov = _overlap_with(target, self.mps(s))
            return (ov * ov.conj()).real

        fids = rollout_measure(
            lambda s, ua, ub: self.step(st, s, ua, ub, forward=True),
            S, U, measure)
        return from_lanes(fids.T, batched)

    def gradient(self, st: TEBDStepper, psi0, psi_target, u, gamma):
        """Analytic gradient dJ/du (calcAnalyticGradient +
        calcFidelityGrad). Returns (g, (psi_t, xi_t, divT, ov)), psi_t and
        xi_t stacked as `rollout` stacks, ov = <psi(T)|psi_target>."""
        S, U, batched = to_lanes(psi0, u)
        X = to_lanes(psi_target, u)[0]
        psi_t = self._rollout(st, S, U)
        xi_t = self._costate(st, X, U)
        divT = _div_t(st, self.mps(xi_t), self.mps(psi_t))
        ov = mpslib.overlap(self.mps(psi_t)[:, -1], self.mps(X))
        g = (adjoint_gradient(divT, ov, st.dt)
             + regularization_grad(U, gamma, st.dt))
        return from_lanes(g, batched), tuple(from_lanes(x, batched)
                                             for x in (psi_t, xi_t, divT, ov))

    def gradient_lowmem(self, st: TEBDStepper, psi0, psi_target, u, gamma):
        """Memory-light gradient: xi is never stored, divT is computed
        inline during the one backward sweep (the reference's BFGS mode).
        Returns (g, (psi_t, None, divT, ov))."""
        S, U, batched = to_lanes(psi0, u)
        X = to_lanes(psi_target, u)[0]
        half = 0.5 * st.nn1
        psi_t = self._rollout(st, S, U)
        P = self.mps(psi_t)
        n = U.shape[1]
        divT = torch.empty(U.shape, dtype=P.dtype, device=P.device)
        divT[:, n - 1] = mpslib.sandwich_site_sum(self.mps(X), P[:, -1], half)
        xi = X
        for i in range(n - 1, 0, -1):
            xi = self.step(st, xi, U[:, i], U[:, i - 1], forward=False)
            divT[:, i - 1] = mpslib.sandwich_site_sum(self.mps(xi),
                                                      P[:, i - 1], half)
        ov = mpslib.overlap(P[:, -1], self.mps(X))
        g = (adjoint_gradient(divT, ov, st.dt)
             + regularization_grad(U, gamma, st.dt))
        return from_lanes(g, batched), (from_lanes(psi_t, batched), None,
                                        from_lanes(divT, batched),
                                        from_lanes(ov, batched))

    def gradient_segmented(self, st: TEBDStepper, psi0, psi_target, u,
                           gamma, seg=None):
        """`gradient` for the host-mode interior point
        (streaming.segmented_adjoint_gradient): it keeps psi_t and xi_t
        when they fit (`streaming.trajectories_fit`), else it holds
        O(sqrt(N_t)) states, segment-start checkpoints from which the
        backward sweep re-propagates one segment at a time (segments of
        `seg` steps); the same values either way. Returns (g,
        streaming.GradientAux (psiT, divT, ov, psi_t, xi_t)), psi_t and
        xi_t in `rollout`'s layout, or None when not kept."""
        S, U, batched = to_lanes(psi0, u)
        X = to_lanes(psi_target, u)[0]
        half = 0.5 * st.nn1
        mps = self.mps
        g, aux = segmented_adjoint_gradient(
            lambda s, a, b: self.step(st, s, a, b, forward=True),
            lambda x, a, b: self.step(st, x, a, b, forward=False),
            lambda x, s: mpslib.sandwich_site_sum(mps(x), mps(s), half),
            lambda s, t: mpslib.overlap(mps(s), mps(t)),
            lambda uu: regularization_grad(uu, gamma, st.dt),
            S, X, U, st.dt, seg=seg)
        if aux.psi_t is not None:
            # one list at a time, so that three trajectories are the most
            # held (streaming.trajectories_fit)
            aux = aux._replace(psi_t=_fill(aux.psi_t))
            aux = aux._replace(xi_t=_fill(aux.xi_t))
        return from_lanes(g, batched), GradientAux(
            *(x if x is None else from_lanes(x, batched) for x in aux))

    def hessian(self, st: TEBDStepper, psi0, psi_target, u, gamma, aux=None,
                row_shard=None):
        """Exact dense Hessian of J for one control u (N_t,)
        (calcHessian_*).

        Row i needs psiH_i(t_j) = U(t_j <- t_i) dH psi_i for j > i. All
        row states are one batch of plain MPS, stepped by the row channel:
        at each time j the rows with 1 <= i < j step together (rows i >= j
        are frozen, and row 0 and rows past N_t-2 are masked out of H, as
        in the JAX package), then every active row is overlapped with
        xiH_j. aux: (psi_t, xi_t, divT, ov) from `gradient`. The row loop
        is the span `hessian.rows`; its steps add to
        `streaming.row_steps`: (N_t - 3)(N_t - 2) / 2 of them, split over
        the ranks of a row shard.

        row_shard: a `parallel.mesh.Mesh`; this rank then steps only its
        rows along the mesh's "rows" axis (row i on row rank i mod n_rows,
        `Mesh.row_slice`), and the overlap matrix, zero where another
        rank's rows are, is summed over the rows group (`Mesh.rows_sum`):
        every entry has one writer, so every rank returns the whole
        Hessian.
        """
        n = u.shape[0]
        if aux is None:
            _, aux = self.gradient(st, psi0, psi_target, u, gamma)
        psi_t, xi_t, divT, ov = aux
        st_row = self.row_stepper(st)
        dt = st_row.dt
        half = 0.5 * st_row.nn1

        # xiH_j = dH|xi_j> and the row states psiH_i(t_i) = dH|psi_i>,
        # normalized, with their norms
        xiH, xiH_norm = mpslib.apply_site_sum_diag(
            self.mps(xi_t), half, method=st_row.trunc_method)
        rows, row_norm = mpslib.apply_site_sum_diag(
            self.mps(psi_t), half, method=st_row.trunc_method)

        # the rows that are ever stepped (1 <= i < j <= N_t - 2), this rank's
        mine = torch.arange(n, device=rows.device)
        if row_shard is not None:
            mine = mine[row_shard.row_slice(n)]
        mine = mine[(mine >= 1) & (mine <= n - 3)]
        ovm = torch.zeros((n, n), dtype=rows.dtype, device=rows.device)
        states = rows[mine]
        rows_h = mine.tolist()
        with span("hessian.rows"):
            for j in range(2, n - 1):      # j = 1 has no active row i >= 1
                a = bisect.bisect_left(rows_h, j)   # this rank's rows i < j
                if a == 0:
                    continue
                act = self.row_step(st_row, states[:a], u[j - 1], u[j],
                                    forward=True)
                count_row_steps(a)
                states[:a] = act
                # <xiH_j|psiH_i(t_j)>
                ovm[j, mine[:a]] = _overlap_with(xiH[j], act)
        if row_shard is not None:
            ovm = row_shard.rows_sum(ovm)

        diag_ov = mpslib.overlap(xiH, rows)
        return assemble_hessian(ovm, row_norm, xiH_norm, diag_ov, divT, ov,
                                dt, regularization_hessian(
                                    n, gamma, dt, dtype=row_norm.dtype,
                                    device=rows.device))

    def hessian_streaming(self, st: TEBDStepper, psi0, psi_target, u,
                          gamma, aux=None, row_block: int = 64,
                          progress=None):
        """`hessian` for one control u (N_t,) with O(row_block) row states
        in flight (streaming.BlockHessian); the same values. aux: the
        GradientAux of gradient_segmented, recomputed when None; its kept
        psi_t and xi_t, when it has them, are the Hessian's psi and xi,
        else BlockHessian re-derives them from checkpoints.
        progress(c, s) is called after each block. The BlockHessian is
        built per call: it holds no compiled program, so there is nothing
        to cache."""
        n = u.shape[0]
        if aux is None:
            _, aux = self.gradient_segmented(st, psi0, psi_target, u, gamma)
        divT, ov = aux.divT, aux.ov
        kept = (None if aux.psi_t is None
                else (self.mps(aux.psi_t), self.mps(aux.xi_t)))
        st_row = self.row_stepper(st)
        half = 0.5 * st.nn1
        bh = BlockHessian(
            n, pick_row_block(n - 1, row_block),
            fwd=lambda s, a, b: self.step(st, s, a, b, forward=True),
            bwd=lambda s, a, b: self.step(st, s, a, b, forward=False),
            apply_dh=lambda A: mpslib.apply_site_sum_diag(
                A, half, method=st_row.trunc_method),
            row_step=lambda A, a, b: self.row_step(st_row, A, a, b,
                                                   forward=True),
            overlap=mpslib.overlap, get_b=self.mps)
        ovm, row_norm, xih_norm, diag_ov = bh.ov_data(
            to_lanes(psi0, u)[0], to_lanes(psi_target, u)[0], u,
            progress=progress, kept=kept)
        return assemble_hessian(ovm, row_norm, xih_norm, diag_ov, divT, ov,
                                st.dt, regularization_hessian(
                                    n, gamma, st.dt, dtype=row_norm.dtype,
                                    device=row_norm.device))


def cost_and_gradient_from(gradient, st, psi0, psi_target, u, gamma):
    """Cost and gradient sharing one forward sweep: `gradient`'s g (an
    engine's `gradient`) and the cost from its overlap."""
    g, aux = gradient(st, psi0, psi_target, u, gamma)
    return infidelity_cost(aux[3]) + regularization(u, gamma, st.dt), g


# ---------------------------------------------------------------------------
# the fixed-rank MPS engine (tebd.tebd_step)
# ---------------------------------------------------------------------------

# the step is looked up here at each call, so a replacement of
# `engine.tebd_step` is the step that runs
_MPS = Engine(lambda st, A, a, b, forward: tebd_step(st, A, a, b,
                                                     forward=forward))
rollout = _MPS.rollout
rollout_final = _MPS.rollout_final
costate_rollout = _MPS.costate_rollout
cost = _MPS.cost
fidelities = _MPS.fidelities
fidelities_streaming = _MPS.fidelities_streaming
gradient = _MPS.gradient
gradient_lowmem = _MPS.gradient_lowmem
gradient_segmented = _MPS.gradient_segmented
hessian = _MPS.hessian
hessian_streaming = _MPS.hessian_streaming


def cost_and_gradient(st: TEBDStepper, psi0, psi_target, u, gamma):
    """Cost and gradient sharing one forward sweep (of this module's
    `gradient`, looked up at the call)."""
    return cost_and_gradient_from(gradient, st, psi0, psi_target, u, gamma)
