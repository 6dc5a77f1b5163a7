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
* `segmented_adjoint_gradient`: the analytic adjoint gradient with
  two-level checkpointing, N_t/K segment-start states plus the K states of
  one segment instead of the 2 N_t of the stacked gradient, for one more
  forward rollout.
* `BlockHessian` and `assemble_hessian`: the exact Hessian with O(R) row
  states instead of O(N_t). The (j, i) plane is cut into R x R blocks;
  one block of rows at a time is stepped through the later time blocks,
  and the xiH_j partners are re-derived from checkpoints of xi. The
  overlaps stay on the device until the one assembly.

Spans (`profiling.span`): `gradient.segmented`; in `BlockHessian.ov_data`
`hessian.psi_xi` (the psi and xi steps), `hessian.apply_dh` and
`hessian.rows` (the row steps and their overlaps). `row_steps` counts the
exact Hessians' row steps (rows times Trotter steps, here and in
`engine.hessian`).
"""

from __future__ import annotations

import torch

from .profiling import span

__all__ = ["infidelity_cost", "adjoint_gradient", "rollout_measure",
           "pick_segment", "segmented_adjoint_gradient",
           "pick_row_block", "BlockHessian", "assemble_hessian",
           "row_steps", "count_row_steps", "reset_counts"]

# row states stepped one Trotter step, summed over the exact Hessians' row
# batches: the Hessian's part of the reference's Nprop
row_steps = 0


def reset_counts() -> None:
    global row_steps
    row_steps = 0


def count_row_steps(n: int) -> None:
    global row_steps
    row_steps += int(n)


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


@span("gradient.segmented")
def segmented_adjoint_gradient(step_fwd, step_bwd, sandwich, overlap,
                               reg_grad, psi0, psi_target, u, dt,
                               seg: int | None = None):
    """Adjoint gradient with O(N_t/K + K) states in memory.

    step_fwd(psi, u_i, u_{i+1}), step_bwd(xi, u_i, u_{i-1}): Trotter steps;
    sandwich(xi, psi) = <xi|dH/du|psi>; overlap(psiT, target) =
    <psi(T)|target>; reg_grad(u): the regularization gradient, or None.
    u carries time on its last axis; states and their scalars carry any
    leading batch axis the callables use.

    Returns (g, (psiT, divT, ov)) with g_i = dt Re(divT_i ov i) + reg, the
    stacked gradient's formula and values.
    """
    n_steps = u.shape[-1] - 1
    K = pick_segment(n_steps, seg)
    S = n_steps // K

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
    for s in reversed(range(S)):
        psis = [cps[s]]
        for i in range(s * K, s * K + K - 1):
            psis.append(step_fwd(psis[-1], u[..., i], u[..., i + 1]))
        for k in reversed(range(K)):
            i = s * K + k + 1
            xi = step_bwd(xi, u[..., i], u[..., i - 1])
            div[i - 1] = sandwich(xi, psis[k])
    divT = torch.stack(div, dim=-1)
    g = adjoint_gradient(divT, ov, dt)
    if reg_grad is not None:
        g = g + reg_grad(u)
    return g, (psiT, divT, ov)


def pick_row_block(n_steps: int, target: int = 64) -> int:
    """The row-block size of BlockHessian: the largest divisor of n_steps
    <= target."""
    return pick_segment(n_steps, min(target, n_steps))


class BlockHessian:
    """The exact Hessian's overlap data with O(R) live row states.

    The dense Hessian (engine.hessian) carries every row state psiH_i =
    dH psi_i through one time loop: N_t states. Here the time axis is cut
    into S segments of R steps (R | N_t - 1); psi and xi are checkpointed
    at the segment edges (2S states); the rows of one segment are made at
    once and stepped block by block through the later segments, and the
    xiH_j partners of each (row block, time block) are re-derived from the
    nearest xi checkpoint (R - 1 extra steps per block, a 1/R overhead).
    Rows are stepped only from their own time on, so the row work is
    ~N_t^2/2 steps, as in the dense Hessian.

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

    def ov_data(self, psi0, psi_target, u, progress=None):
        """(ovm[j, i] = <xiH_j|psiH_i(t_j)>, row_norm, xih_norm, diag_ov)
        for the control u (n,), as tensors on the states' device.
        psi0 and psi_target are one-state batches. progress(c, s) is called
        after the block of rows c has been stepped through time block s."""
        n, R, S = self.n, self.R, self.S
        fwd, bwd = self.fwd, self.bwd

        def apply_dh(states):
            with span("hessian.apply_dh"):
                return self.apply_dh(torch.cat([get_b(x) for x in states]))

        with span("hessian.psi_xi"):
            psi_cps, psi = [], psi0          # psi_{sR}
            for s in range(S):
                psi_cps.append(psi)
                for i in range(s * R, s * R + R):
                    psi = fwd(psi, u[i], u[i + 1])
            xi_cps, xi = [None] * S, psi_target   # xi_{(s+1)R}
            for s in reversed(range(S)):
                xi_cps[s] = xi
                for i in range(s * R + R, s * R, -1):
                    xi = bwd(xi, u[i], u[i - 1])

        get_b = self.get_b
        cdt = get_b(psi0).dtype
        rdt = cdt.to_real()
        dev = get_b(psi0).device
        ovm = torch.zeros((n, n), dtype=cdt, device=dev)
        row_norm = torch.zeros(n, dtype=rdt, device=dev)
        xih_norm = torch.zeros(n, dtype=rdt, device=dev)
        diag_ov = torch.zeros(n, dtype=cdt, device=dev)
        for c in range(S):
            i0 = c * R
            with span("hessian.psi_xi"):
                bs = [psi_cps[c]]                # psi_{i0 .. i0+R-1}
                for i in range(i0, i0 + R - 1):
                    bs.append(fwd(bs[-1], u[i], u[i + 1]))
                xs, x = [None] * R, xi_cps[c]    # xi_{i0 .. i0+R-1}
                for k in reversed(range(R)):
                    x = bwd(x, u[i0 + k + 1], u[i0 + k])
                    xs[k] = x
            rows, rn = apply_dh(bs)
            xih, xn = apply_dh(xs)
            row_norm[i0:i0 + R] = rn
            xih_norm[i0:i0 + R] = xn
            diag_ov[i0:i0 + R] = self.overlap(xih, rows)
            for s in range(c, S):
                j0 = s * R
                with span("hessian.psi_xi"):
                    xs, x = [None] * R, xi_cps[s]    # xi_{j0+1 .. j0+R}
                    xs[R - 1] = x
                    for k in range(R - 2, -1, -1):
                        x = bwd(x, u[j0 + k + 2], u[j0 + k + 1])
                        xs[k] = x
                xih, xn = apply_dh(xs)
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
