"""Streaming trajectories: measurements, the adjoint gradient and the exact
Hessian with few states in flight.

Counterpart of optimalcontrolmps_tpu/streaming.py, generic over the engine
(states are whatever `step_fwd` / `step_bwd` take; the MPS engine's are
(B, L, chi, p, chi) batches):

* `infidelity_cost` and `adjoint_gradient`: the two leaf formulas of
  every engine, J = 0.5 (1 - |ov|^2) and g_i = dt Re(divT_i ov i), each
  caller adding its regularization term.
* `rollout_measure`: one state in flight, measure(psi_i) at every time
  (a tensor, or a tuple or dict of them).
* `segmented_adjoint_gradient`: the analytic adjoint gradient. When the
  trajectories fit (`trajectories_fit`) it keeps every psi_i and xi_i it
  makes, 2 (N_t - 1) steps, and hands them on; otherwise it checkpoints,
  N_t/K segment-start states plus the K states of one segment, for one
  more forward rollout less one step a segment.
* `BlockHessian` and `assemble_hessian`: the exact Hessian with O(R) row
  states instead of O(N_t). The (j, i) plane is cut into R x R blocks;
  one block of rows at a time is stepped through the later time blocks.
  The psi_i the rows start from and the xiH_j partners come from the
  gradient's kept trajectories, dH applied once to each xi_j, or else are
  re-derived from checkpoints of psi and xi. The overlaps stay on the
  device until the one assembly.

Spans (`profiling.span`): `gradient.segmented`; in `BlockHessian.ov_data`
`hessian.psi_xi` (a block's psi and xi: their steps, or with kept
trajectories the views of the kept states, which cost next to nothing),
`hessian.apply_dh` and `hessian.rows` (the row steps and their
overlaps). Counters (`reset_counts`): `row_steps`, the exact
Hessians' row steps (rows times Trotter steps, here and in
`engine.hessian`); `kept_trajectories`, the gradient calls that kept psi_t
and xi_t; `kept_hessians`, the BlockHessian calls that took them;
`replayed_steps`, the psi and xi Trotter steps that re-make a state the
call's gradient made (the segments re-propagated from their checkpoints,
every psi and xi step of a checkpointed BlockHessian), times the lanes.
"""

from __future__ import annotations

import math
import os
from typing import Any, NamedTuple

import torch

from .profiling import span

__all__ = ["infidelity_cost", "adjoint_gradient", "rollout_measure",
           "pick_segment", "trajectories_fit", "GradientAux",
           "segmented_adjoint_gradient", "pick_row_block", "BlockHessian",
           "assemble_hessian", "row_steps", "kept_trajectories",
           "kept_hessians", "replayed_steps", "count_row_steps",
           "reset_counts"]

# row states stepped one Trotter step, summed over the exact Hessians' row
# batches: the Hessian's part of the reference's Nprop
row_steps = 0
# gradient calls that kept every psi_i and xi_i
kept_trajectories = 0
# BlockHessian calls that took them
kept_hessians = 0
# psi and xi Trotter steps that re-make a state the gradient made, summed
# over the lanes
replayed_steps = 0

# the share of its device's free memory that a gradient's kept
# trajectories may take
_KEEP_SHARE = 0.5


def reset_counts() -> None:
    global row_steps, kept_trajectories, kept_hessians, replayed_steps
    row_steps = kept_trajectories = kept_hessians = replayed_steps = 0


def count_row_steps(n: int) -> None:
    global row_steps
    row_steps += int(n)


def _count_replayed(n: int) -> None:
    global replayed_steps
    replayed_steps += int(n)


def _count_kept() -> None:
    global kept_trajectories
    kept_trajectories += 1


def _count_kept_hessian() -> None:
    global kept_hessians
    kept_hessians += 1


def infidelity_cost(ov):
    """0.5 (1 - |ov|^2) of the overlap ov = <psi(T)|psi_target> (any
    shape): the cost without its regularization."""
    return 0.5 * (1.0 - (ov * ov.conj()).real)


def adjoint_gradient(divT, ov, dt):
    """g_i = dt Re(divT_i ov i): divT (..., N_t) against ov (...,); the
    gradient without its regularization."""
    return dt * (divT * ov[..., None] * 1j).real


def rollout_measure(step_fwd, psi0, u, measure):
    """measure(psi_i) for every i in 0..N_t-1, stacked on a new leading
    time axis. step_fwd(psi, u_from, u_to) -> psi'; u carries time on its
    last axis ((N_t,) or (B, N_t)); only one state is ever live. measure
    returns a tensor, a tuple of tensors or a dict of them; each field is
    stacked on its own, and the result has the same structure."""
    psi = psi0
    out = [measure(psi)]
    for i in range(u.shape[-1] - 1):
        psi = step_fwd(psi, u[..., i], u[..., i + 1])
        out.append(measure(psi))
    first = out[0]
    if isinstance(first, dict):
        return {k: torch.stack([m[k] for m in out]) for k in first}
    if isinstance(first, tuple):
        return tuple(torch.stack(f) for f in zip(*out))
    return torch.stack(out)


def pick_segment(n_steps: int, target: int | None = None) -> int:
    """Largest divisor of n_steps <= target (default ~sqrt(n_steps)), so
    every segment has the same length."""
    if target is None:
        target = max(1, int(round(float(n_steps) ** 0.5)))
    target = min(target, n_steps)
    for k in range(target, 0, -1):
        if n_steps % k == 0:
            return k
    return 1


def trajectories_fit(state, n_times: int) -> bool:
    """Whether a gradient keeps its trajectories: the bytes of n_times
    copies of `state` (a tensor or a tuple of them, its batch included),
    three times over, are at most `_KEEP_SHARE` of the memory free on the
    state's device. Three trajectories are the most held at once: psi_t
    and xi_t, with the buffer `engine.Engine` fills from one of them, or
    with BlockHessian's dH images of xi_t (made R states at a time, so
    dH's working set stays that of a row block). Free memory is
    `torch.cuda.mem_get_info`'s plus what the caching allocator holds
    unused on the card, the host's available physical pages on the
    CPU."""
    tensors = state if isinstance(state, tuple) else (state,)
    nbytes = 3 * n_times * sum(t.numel() * t.element_size()
                               for t in tensors)
    dev = tensors[0].device
    if dev.type == "cuda":
        free = (torch.cuda.mem_get_info(dev)[0]
                + torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return nbytes <= _KEEP_SHARE * free


class GradientAux(NamedTuple):
    """What `segmented_adjoint_gradient` hands on besides g: psi(T), divT
    (..., N_t), the overlap ov, and the kept trajectories psi_t and xi_t
    (lists of the states psi_0 .. psi_{N_t-1} and xi_0 .. xi_{N_t-1};
    `engine.Engine` puts them in trajectory buffers), None when it
    checkpointed."""
    psiT: Any
    divT: torch.Tensor
    ov: torch.Tensor
    psi_t: Any = None
    xi_t: Any = None


@span("gradient.segmented")
def segmented_adjoint_gradient(step_fwd, step_bwd, sandwich, overlap,
                               reg_grad, psi0, psi_target, u, dt,
                               seg: int | None = None):
    """Adjoint gradient, keeping every psi_i and xi_i when they fit
    (`trajectories_fit`: 2 (N_t - 1) Trotter steps), else with O(N_t/K +
    K) states in memory (segments of K steps, K from `seg`, re-propagated
    from their checkpoints: K - 1 more steps a segment).

    step_fwd(psi, u_i, u_{i+1}), step_bwd(xi, u_i, u_{i-1}): Trotter steps;
    sandwich(xi, psi) = <xi|dH/du|psi>; overlap(psiT, target) =
    <psi(T)|target>; reg_grad(u): the regularization gradient, or None.
    u carries time on its last axis; states and their scalars carry any
    leading batch axis the callables use.

    Returns (g, GradientAux) with g_i = dt Re(divT_i ov i) + reg, the
    stacked gradient's formula and values; either way every state is made
    by the same steps from the same inputs.
    """
    n_steps = u.shape[-1] - 1
    keep = trajectories_fit(psi0, n_steps + 1)
    # keeping is checkpointing every state: segments of one step
    K = 1 if keep else pick_segment(n_steps, seg)
    S = n_steps // K
    lanes = math.prod(u.shape[:-1])

    # forward, keeping each segment's start state
    cps = []
    psi = psi0
    for s in range(S):
        cps.append(psi)
        for i in range(s * K, s * K + K):
            psi = step_fwd(psi, u[..., i], u[..., i + 1])
    psiT = psi
    ov = overlap(psiT, psi_target)

    # backward over the segments, each re-propagated from its checkpoint:
    # xi_{i-1} = step_bwd(xi_i, u_i, u_{i-1}),
    # div_{i-1} = <xi_{i-1}|dH|psi_{i-1}>
    div = [None] * (n_steps + 1)
    div[n_steps] = sandwich(psi_target, psiT)
    xi = psi_target
    xis = [xi]                       # xi_{N_t-1}, xi_{N_t-2}, ... if kept
    for s in reversed(range(S)):
        psis = [cps[s]]
        for i in range(s * K, s * K + K - 1):
            psis.append(step_fwd(psis[-1], u[..., i], u[..., i + 1]))
        _count_replayed((K - 1) * lanes)
        for k in reversed(range(K)):
            i = s * K + k + 1
            xi = step_bwd(xi, u[..., i], u[..., i - 1])
            div[i - 1] = sandwich(xi, psis[k])
            if keep:
                xis.append(xi)
    divT = torch.stack(div, dim=-1)
    g = adjoint_gradient(divT, ov, dt)
    if reg_grad is not None:
        g = g + reg_grad(u)
    if not keep:
        return g, GradientAux(psiT, divT, ov)
    _count_kept()
    return g, GradientAux(psiT, divT, ov, cps + [psiT], xis[::-1])


def pick_row_block(n_steps: int, target: int = 64) -> int:
    """The row-block size of BlockHessian: the largest divisor of n_steps
    <= target."""
    return pick_segment(n_steps, min(target, n_steps))


class BlockHessian:
    """The exact Hessian's overlap data with O(R) live row states.

    The dense Hessian (engine.hessian) carries every row state psiH_i =
    dH psi_i through one time loop: N_t states. Here the time axis is cut
    into S segments of R steps (R | N_t - 1); the rows of one segment are
    made at once and stepped block by block through the later segments
    against the xiH_j partners of each (row block, time block). Rows are
    stepped only from their own time on, so the row work is ~N_t^2/2
    steps, as in the dense Hessian.

    psi_i and xi_j come from the gradient's kept trajectories when it
    kept them (`ov_data(kept=)`): dH is then applied once to each xi_j
    and once to each psi_i a row starts from, and no state is re-stepped.
    Otherwise psi and xi are checkpointed at the segment edges (2S
    states), and each block's psi and xi are re-derived from the nearest
    checkpoint (R - 1 or R extra steps per block, a 1/R overhead).

    fwd(psi, u_i, u_{i+1}) and bwd(xi, u_i, u_{i-1}) step one-state
    batches; get_b(state) is its plain MPS batch (the state itself when
    None; the Vidal engine's `to_mps`); row_step(rows, u_j, u_{j+1}) steps
    a batch of plain-MPS rows; apply_dh(states) -> (normalized dH states,
    norms); overlap(phi, psi) per batch element.
    """

    def __init__(self, n: int, R: int, fwd, bwd, apply_dh, row_step,
                 overlap, get_b=None):
        if (n - 1) % R:
            raise ValueError(f"R={R} must divide N_t - 1 = {n - 1}")
        self.n, self.R, self.S = n, R, (n - 1) // R
        self.fwd, self.bwd = fwd, bwd
        self.apply_dh, self.row_step = apply_dh, row_step
        self.overlap = overlap
        self.get_b = get_b if get_b is not None else (lambda s: s)

    def _dh(self, states):
        with span("hessian.apply_dh"):
            return self.apply_dh(states)

    def _kept(self, kept):
        """(rows(c), diag(c), later(s)) over the kept plain-MPS stacks
        (psi_t, xi_t): dH of psi_{cR .. cR+R-1}, and with their norms dH
        of xi_{cR .. cR+R-1} and of xi_{sR+1 .. sR+R}, slices of the dH
        images of every xi_j, made R at a time. A block's states are
        views of the stacks, taken under `hessian.psi_xi` as `_replayed`
        steps them."""
        R = self.R
        P, X = kept
        _count_kept_hessian()

        def take(states, a):
            with span("hessian.psi_xi"):
                return states[a:a + R]

        # filled in place: the images and their copy are never held at once
        XH = XN = None
        for j in range(0, self.n, R):
            h, nrm = self._dh(take(X, j))
            if XH is None:
                XH = h.new_empty((self.n, *h.shape[1:]))
                XN = nrm.new_empty((self.n, *nrm.shape[1:]))
            XH[j:j + R], XN[j:j + R] = h, nrm
        return (lambda c: self._dh(take(P, c * R)),
                lambda c: (XH[c * R:c * R + R], XN[c * R:c * R + R]),
                lambda s: (XH[s * R + 1:s * R + R + 1],
                           XN[s * R + 1:s * R + R + 1]))

    def _replayed(self, psi0, psi_target, u):
        """`_kept`'s three callables with psi and xi re-derived from
        checkpoints at the segment edges; every step counts as replayed."""
        R, S, get_b = self.R, self.S, self.get_b

        def fwd(x, i):
            _count_replayed(1)
            return self.fwd(x, u[i], u[i + 1])

        def bwd(x, i):
            _count_replayed(1)
            return self.bwd(x, u[i], u[i - 1])

        def dh(states):
            return self._dh(torch.cat([get_b(x) for x in states]))

        with span("hessian.psi_xi"):
            psi_cps, psi = [], psi0          # psi_{sR}
            for s in range(S):
                psi_cps.append(psi)
                for i in range(s * R, s * R + R):
                    psi = fwd(psi, i)
            xi_cps, xi = [None] * S, psi_target   # xi_{(s+1)R}
            for s in reversed(range(S)):
                xi_cps[s] = xi
                for i in range(s * R + R, s * R, -1):
                    xi = bwd(xi, i)

        def rows(c):
            with span("hessian.psi_xi"):
                bs = [psi_cps[c]]                # psi_{cR .. cR+R-1}
                for i in range(c * R, c * R + R - 1):
                    bs.append(fwd(bs[-1], i))
            return dh(bs)

        def diag(c):
            with span("hessian.psi_xi"):
                xs, x = [None] * R, xi_cps[c]    # xi_{cR .. cR+R-1}
                for k in reversed(range(R)):
                    x = bwd(x, c * R + k + 1)
                    xs[k] = x
            return dh(xs)

        def later(s):
            with span("hessian.psi_xi"):
                xs, x = [None] * R, xi_cps[s]    # xi_{sR+1 .. sR+R}
                xs[R - 1] = x
                for k in range(R - 2, -1, -1):
                    x = bwd(x, s * R + k + 2)
                    xs[k] = x
            return dh(xs)

        return rows, diag, later

    def ov_data(self, psi0, psi_target, u, progress=None, kept=None):
        """(ovm[j, i] = <xiH_j|psiH_i(t_j)>, row_norm, xih_norm, diag_ov)
        for the control u (n,), as tensors on the states' device.
        psi0 and psi_target are one-state batches. kept: the plain MPS
        stacks (psi_t, xi_t), (N_t, ...) each, of a gradient's kept
        trajectories, or None to re-derive psi and xi. progress(c, s) is
        called after the block of rows c has been stepped through time
        block s."""
        n, R, S = self.n, self.R, self.S
        rows_at, diag_at, later_at = (
            self._kept(kept) if kept is not None
            else self._replayed(psi0, psi_target, u))
        cdt = self.get_b(psi0).dtype
        rdt = cdt.to_real()
        dev = self.get_b(psi0).device
        ovm = torch.zeros((n, n), dtype=cdt, device=dev)
        row_norm = torch.zeros(n, dtype=rdt, device=dev)
        xih_norm = torch.zeros(n, dtype=rdt, device=dev)
        diag_ov = torch.zeros(n, dtype=cdt, device=dev)
        for c in range(S):
            i0 = c * R
            rows, rn = rows_at(c)                # dH psi_{i0 .. i0+R-1}
            xih, xn = diag_at(c)                 # dH xi_{i0 .. i0+R-1}
            row_norm[i0:i0 + R] = rn
            xih_norm[i0:i0 + R] = xn
            diag_ov[i0:i0 + R] = self.overlap(xih, rows)
            for s in range(c, S):
                j0 = s * R
                xih, xn = later_at(s)            # dH xi_{j0+1 .. j0+R}
                with span("hessian.rows"):
                    for k in range(R):
                        # rows i <= j0 + k step from t_{j0+k} to t_{j0+k+1}
                        na = R if s > c else k + 1
                        stepped = self.row_step(rows[:na], u[j0 + k],
                                                u[j0 + k + 1])
                        count_row_steps(na)
                        rows = torch.cat([stepped, rows[na:]])
                        ovm[j0 + 1 + k, i0:i0 + R] = self.overlap(
                            xih[k:k + 1].expand(R, *xih.shape[1:]), rows)
                xih_norm[j0 + 1:j0 + R + 1] = xn
                if progress is not None:
                    progress(c, s)
        return ovm, row_norm, xih_norm, diag_ov


def assemble_hessian(ovm, row_norm, xih_norm, diag_ov, divT, ov, dt,
                     reg_hess=None):
    """The exact Hessian from its overlap data (the reference's
    calcHessian term structure): interior rows and columns only, 1 <= i <
    j <= N_t - 2 off the diagonal, times dt^2, plus reg_hess."""
    n = ovm.shape[0]
    Hd = (ov * diag_ov * xih_norm * row_norm).real - (divT * divT.conj()).real
    val1 = (ov * ovm * xih_norm[:, None] * row_norm[None, :]).real
    val2 = -(divT[None, :] * divT.conj()[:, None]).real
    idx = torch.arange(n, device=ovm.device)
    jj, ii = idx[:, None], idx[None, :]
    mask = (ii >= 1) & (jj > ii) & (jj <= n - 2)
    Hoff = torch.where(mask, val1 + val2, torch.zeros_like(val1))
    interior = (idx >= 1) & (idx <= n - 2)
    H = Hoff + Hoff.T + torch.diag(torch.where(interior, Hd,
                                               torch.zeros_like(Hd)))
    H = H * dt * dt
    return H if reg_hess is None else H + reg_hess
