"""Second-order Suzuki-Trotter TEBD propagator for the Bose-Hubbard chain.

Counterpart of optimalcontrolmps_tpu/tebd.py. One step applies

    psi <- D(u_to) * (odd J-gates) * (even J-gates) * D(u_from) * psi

with D(u) = prod_i exp(-0.25j u dt n_i(n_i-1)) and the J-gates exp(-i dt h)
on even bonds left to right, then odd bonds right to left, truncating back
to a fixed chi after every bond (the reference's BH_tDMRG::step). The
diagonal phases commute with every truncation decision, so they are applied
to all sites before and after the sweeps, as in the JAX package.

Every state is a batch (B, L, chi, p, chi) and every bond update works on
the whole batch at once: the multistart lanes, or a Hessian's row states,
are one call. The controls are scalars or (B,) tensors, one per state. The
two-site theta of each bond comes from `ops.bond_theta.bond_theta` (the CUDA
kernel on the card, its plain twin on the CPU).

Backward propagation negates the controls and uses the conjugate (negative
dt) J-gate, the reference's co-state convention.
"""

from __future__ import annotations

import dataclasses

import torch

from . import mps as mpslib
from .device import resolve_device
from .ops.bond_theta import bond_theta
from .ops.gates import j_gate
from .ops.trunc import split_truncate
from .sites import nn1_diag

__all__ = ["TEBDStepper", "make_stepper", "exact_rank_bound", "phase",
           "tebd_step", "steps", "reset_counts"]

# Trotter steps taken by `tebd_step`, summed over the states of each batch
steps = 0


def reset_counts() -> None:
    global steps
    steps = 0


@dataclasses.dataclass(frozen=True)
class TEBDStepper:
    """Constants of the propagator: the bond gates and the dH/du diagonal."""
    gate_fwd: torch.Tensor   # (p*p, p*p) exp(-i dt h)
    gate_bwd: torch.Tensor   # conj, for backward sweeps
    nn1: torch.Tensor        # (p,) n(n-1); dH/du = 0.5 sum_i this
    L: int
    p: int
    chi: int
    dt: float
    trunc_method: str
    gauge_method: str = "qr"
    sweep: str = "snake"


def exact_rank_bound(L: int, p: int) -> int:
    """Largest Schmidt rank over all bonds of an L-site chain with local
    dimension p: max_k min(p^k, p^(L-k))."""
    best = 1
    for k in range(1, L):
        best = max(best, min(p ** k, p ** (L - k)))
    return best


def make_stepper(L: int, d: int, J: float, dt: float, chi: int,
                 dtype=torch.complex128, trunc_method: str = "eigh",
                 gauge_method: str = "qr", sweep: str = "snake",
                 device=None) -> TEBDStepper:
    """Build a stepper (the reference's BH_tDMRG constructor).

    sweep="snake": the reference's sequential even-L2R / odd-R2L sweep with
    canonical-center moves; needed whenever truncation is real.
    sweep="brick": all even bonds as one batch, then all odd bonds, with
    exact 'range' splits and no gauge moves; valid only when chi reaches the
    exact rank bound.
    sweep="vidal": canonical-form brick updates with real truncation, the
    Schmidt values carried in the state (`vidal.VidalState`); step with
    `vidal.vidal_step`, whose only truncation is "eigh".
    device=None means the card.
    """
    if sweep not in ("snake", "brick", "vidal"):
        raise ValueError(f"unknown sweep {sweep!r}")
    if trunc_method == "nssub":
        raise NotImplementedError(
            "trunc_method='nssub' is the JAX package's matmul-only route for "
            "a TPU without factorizations; the port truncates with 'eigh' "
            "(torch.linalg.eigh), on every sweep")
    if sweep == "vidal" and trunc_method != "eigh":
        raise ValueError("sweep='vidal' supports trunc_method 'eigh' (the "
                         f"Schmidt values are its eigenvalues); got "
                         f"{trunc_method!r}")
    bound = exact_rank_bound(L, d + 1)
    if sweep == "brick" and chi < bound:
        raise ValueError(
            f"sweep='brick' requires chi >= exact rank bound {bound} "
            f"(L={L}, p={d + 1}); got chi={chi}. Use sweep='snake' when "
            f"truncation is real.")
    if trunc_method == "range" and chi < bound:
        raise ValueError(
            f"trunc_method='range' is only exact when chi >= the exact rank "
            f"bound {bound} (L={L}, p={d + 1}); got chi={chi}. Use "
            f"'eigh'/'svd'/'rsvd' when truncation is real.")
    if sweep == "brick" and trunc_method != "range":
        raise ValueError("sweep='brick' requires trunc_method='range'; "
                         f"got {trunc_method!r}")
    device = resolve_device(device)
    gf = torch.as_tensor(j_gate(J, d, dt), dtype=dtype, device=device)
    return TEBDStepper(
        gate_fwd=gf, gate_bwd=gf.conj().resolve_conj(),
        nn1=torch.as_tensor(nn1_diag(d), dtype=dtype.to_real(), device=device),
        L=L, p=d + 1, chi=chi, dt=float(dt), trunc_method=trunc_method,
        gauge_method=gauge_method, sweep=sweep)


def _scale(x, nrm):
    """x (B, ...) times 1/nrm (B,), where nrm > 1e-16."""
    s = torch.where(nrm > 1e-16, 1.0 / nrm, torch.ones_like(nrm))
    return x * s.to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))


def _apply_bond(Ai, Aj, gate, chi, keep_left, method, renorm=True):
    """Contract two sites (B, l, p, m), (B, m, q, r), apply the bond gate,
    truncate back to chi. Snake mode: the center must lie on site i or j;
    afterwards it sits on j (keep_left) or i, renormalized. Brick mode
    passes renorm=False."""
    B, l, p, _ = Ai.shape
    _, _, q, r = Aj.shape
    theta = bond_theta(Ai, Aj, gate)
    left, right = split_truncate(theta, chi, keep_left=keep_left,
                                 method=method)
    Ai_new = left.reshape(B, l, p, chi)
    Aj_new = right.reshape(B, chi, q, r)
    if not renorm:
        return Ai_new, Aj_new
    # the center goes on to the next bond's kernel, which reads sites with
    # contiguous inner dimensions; a split may leave it column-major
    if keep_left:
        c = Aj_new.contiguous()
        return Ai_new, _scale(c, torch.linalg.vector_norm(c, dim=(1, 2, 3)))
    c = Ai_new.contiguous()
    return _scale(c, torch.linalg.vector_norm(c, dim=(1, 2, 3))), Aj_new


def _brick_stage(T, bonds, gate, chi, method):
    """Apply the gate to DISJOINT bonds as one batch: the bonds are stacked
    into the batch axis (they commute, so simultaneous application equals
    the sequential sweep)."""
    if not bonds:
        return T
    B = T[0].shape[0]
    Ai = torch.cat([T[b] for b in bonds])
    Aj = torch.cat([T[b + 1] for b in bonds])
    Ai2, Aj2 = _apply_bond(Ai, Aj, gate, chi, keep_left=True, method=method,
                           renorm=False)
    for k, b in enumerate(bonds):
        T[b] = Ai2[k * B:(k + 1) * B]
        T[b + 1] = Aj2[k * B:(k + 1) * B]
    return T


def phase(st: TEBDStepper, u, B, dtype):
    """(B, p) diagonal exp(-0.25j u dt n(n-1)); u scalar or (B,)."""
    u = torch.as_tensor(u, dtype=st.nn1.dtype, device=st.nn1.device)
    u = u.reshape(-1, 1).expand(B, 1)
    return torch.exp((-0.25j * st.dt) * u * st.nn1[None, :]).to(dtype)


def tebd_step(st: TEBDStepper, A, u_from, u_to, forward: bool = True):
    """One full Trotter step of a batch A (B, L, chi, p, chi); the center
    is at site 0 on entry and exit. u_from, u_to: scalars or (B,). Adds B
    to `steps`."""
    global steps
    if st.sweep == "vidal":
        raise TypeError("sweep='vidal' states are vidal.VidalState; step "
                        "them with vidal.vidal_step")
    L, chi, method, gauge = st.L, st.chi, st.trunc_method, st.gauge_method
    B = A.shape[0]
    steps += B
    gate = st.gate_fwd if forward else st.gate_bwd
    sign = 1.0 if forward else -1.0
    ph_from = phase(st, sign * torch.as_tensor(u_from), B, A.dtype)
    ph_to = phase(st, sign * torch.as_tensor(u_to), B, A.dtype)

    A = A * ph_from[:, None, None, :, None]
    T = list(A.unbind(1))

    if st.sweep == "brick":
        T = _brick_stage(T, list(range(0, L - 1, 2)), gate, chi, method)
        T = _brick_stage(T, list(range(1, L - 1, 2)), gate, chi, method)
        A = torch.stack(T, dim=1) * ph_to[:, None, None, :, None]
        nrm = mpslib.norm(A)
        A = A.clone()
        A[:, 0] = _scale(A[:, 0], nrm)
        return A

    if L == 2:
        T[0], T[1] = _apply_bond(T[0], T[1], gate, chi, keep_left=False,
                                 method=method)
    else:
        pos = 0
        for b in range(0, L - 1, 2):            # even bonds, left to right
            while pos < b:
                T[pos], T[pos + 1] = mpslib.move_right(T[pos], T[pos + 1],
                                                       method=gauge)
                pos += 1
            T[b], T[b + 1] = _apply_bond(T[b], T[b + 1], gate, chi,
                                         keep_left=True, method=method)
            pos = b + 1
        for b in range(L - 2 - (L % 2 == 0), 0, -2):   # odd, right to left
            while pos > b + 1:
                T[pos - 1], T[pos] = mpslib.move_left(T[pos - 1], T[pos],
                                                      method=gauge)
                pos -= 1
            T[b], T[b + 1] = _apply_bond(T[b], T[b + 1], gate, chi,
                                         keep_left=False, method=method)
            pos = b
        while pos > 0:                           # center back to site 0
            T[pos - 1], T[pos] = mpslib.move_left(T[pos - 1], T[pos],
                                                  method=gauge)
            pos -= 1

    T[0] = T[0] * ph_to[:, None, :, None]
    T[0] = _scale(T[0], torch.linalg.vector_norm(T[0], dim=(1, 2, 3)))
    return torch.stack([T[0]] + [t * ph_to[:, None, :, None]
                                 for t in T[1:]], dim=1)
