"""Fixed particle-number sector engine: dense propagator + derivatives.

Counterpart of optimalcontrolmps_tpu/sector.py. Every two-site J-gate
conserves total N, so the even-then-odd gate product of one Trotter step is
one precomputed (ns, ns) sector matrix WJ, and the control phases
D(u) = exp(-0.25j u dt sum_i n_i(n_i-1)) are diagonal. One Trotter step is

    psi <- D(u_to) . WJ . D(u_from) . psi

The rollouts carry HALF-PHASED states h_i = D(u_i) psi_i, so each step is one
matrix-vector product and one merged phase D(u)^2, with one normalization at
the end (every step is unitary). States are padded to ns_p (a multiple of 128
for ns >= 64) exactly as the JAX package pads them.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .engine import (regularization, regularization_grad,
                     regularization_hessian)
from .groundstate import sector_basis, sector_ground_vector
from .streaming import adjoint_gradient, assemble_hessian, infidelity_cost
from .ops.gates import j_gate
from .device import resolve_device

__all__ = [
    "SectorStepper", "make_sector_stepper", "stepper_from_numpy",
    "sector_step", "sector_ground_state", "expectation_n", "rollout",
    "rollout_final", "costate_rollout", "cost", "fidelities",
    "fidelities_streaming", "gradient", "gradient_lowmem",
    "cost_and_gradient", "cost_and_gradient_exact", "hessian",
    "SECTOR_MAX_DIM",
]

# largest sector the dense engine takes (sector.py:58 of the JAX package)
SECTOR_MAX_DIM = 4096

@lru_cache(maxsize=32)
def _sector_jgate_product(L: int, d: int, npart: int, J: float,
                          dt: float) -> np.ndarray:
    """(ns, ns) matrix of (odd-bond J-gates) . (even-bond J-gates) in the
    sector basis: the control-independent part of one Trotter step."""
    states, _ = sector_basis(L, d, npart)
    ns = states.shape[0]
    p = d + 1
    lookup = {tuple(int(x) for x in s): k for k, s in enumerate(states)}
    g = j_gate(J, d, dt)  # (p*p, p*p), exp(-i dt h_bond)

    def bond_matrix(i: int) -> np.ndarray:
        W = np.zeros((ns, ns), dtype=np.complex128)
        for k in range(ns):
            s = states[k]
            a, b = int(s[i]), int(s[i + 1])
            col = g[:, a * p + b]
            tot = a + b
            for c in range(max(0, tot - d), min(d, tot) + 1):
                dd = tot - c
                amp = col[c * p + dd]
                if amp == 0.0:
                    continue
                t = s.copy()
                t[i], t[i + 1] = c, dd
                W[lookup[tuple(int(x) for x in t)], k] += amp
        return W

    # even bonds then odd bonds (disjoint-bond gates commute within a stage)
    WJ = np.eye(ns, dtype=np.complex128)
    for i in range(0, L - 1, 2):
        WJ = bond_matrix(i) @ WJ
    for i in range(1, L - 1, 2):
        WJ = bond_matrix(i) @ WJ
    return WJ


@dataclasses.dataclass(frozen=True)
class SectorStepper:
    """Precomputed step constants. The `*_p` fields are padded to ns_p:
    identity on the pad block of WJ, zero nn1, and pad entries of nn1_inv_p
    index a 0.0 in nn1_vals."""
    WJ_fwd: torch.Tensor    # (ns, ns) J-gate product
    WJ_bwd: torch.Tensor    # conj (the inverse product, for co-states)
    nn1: torch.Tensor       # (ns,) sum_i n_i(n_i-1) per sector state
    occ: torch.Tensor       # (ns, L) occupation numbers
    nn1_vals: torch.Tensor  # (k,) distinct values of nn1
    nn1_inv: torch.Tensor   # (ns,) index of each state's nn1 into nn1_vals
    WJ_fwd_p: torch.Tensor  # (ns_p, ns_p)
    WJ_bwd_p: torch.Tensor
    nn1_p: torch.Tensor     # (ns_p,)
    nn1_inv_p: torch.Tensor  # (ns_p,)
    L: int
    d: int
    npart: int
    ns: int
    ns_p: int
    dt: float


_META = ("L", "d", "npart", "ns", "ns_p", "dt")


def stepper_from_numpy(fields: dict, device=None) -> SectorStepper:
    """SectorStepper from host arrays, e.g. the JAX stepper's fields
    `{k: np.asarray(v) for k, v in dataclasses.asdict(st).items()}`, on
    `device` (None means the card)."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(SectorStepper):
        v = fields[f.name]
        if f.name in _META:
            kw[f.name] = float(v) if f.name == "dt" else int(v)
        else:
            arr = np.asarray(v)
            if arr.dtype == np.int32:
                arr = arr.astype(np.int64)
            kw[f.name] = torch.as_tensor(arr, device=device)
    return SectorStepper(**kw)


def make_sector_stepper(L: int, d: int, npart: int, J: float, dt: float,
                        dtype=torch.complex128, device=None) -> SectorStepper:
    """device=None means the card."""
    device = resolve_device(device)
    states, _ = sector_basis(L, d, npart)
    ns = states.shape[0]
    if ns > SECTOR_MAX_DIM:
        raise ValueError(
            f"sector dim {ns} > SECTOR_MAX_DIM={SECTOR_MAX_DIM}; "
            "use the MPS engine (tebd/engine) for this problem size")
    WJ = _sector_jgate_product(L, d, npart, float(J), float(dt))
    nn1 = np.sum(states * (states - 1.0), axis=1)
    vals, inv = np.unique(nn1, return_inverse=True)

    ns_p = int(-(-ns // 128) * 128) if ns >= 64 else ns
    if ns_p > ns:
        WJp = np.eye(ns_p, dtype=WJ.dtype)
        WJp[:ns, :ns] = WJ
        nn1_p = np.concatenate([nn1, np.zeros(ns_p - ns, nn1.dtype)])
        zw = np.where(vals == 0.0)[0]
        if zw.size == 0:
            vals = np.concatenate([vals, [0.0]])
            zi = vals.size - 1
        else:
            zi = int(zw[0])
        inv_p = np.concatenate([inv, np.full(ns_p - ns, zi, inv.dtype)])
    else:
        WJp, nn1_p, inv_p = WJ, nn1, inv

    rdt = dtype.to_real()

    def c(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def r(a):
        return torch.as_tensor(a, dtype=rdt, device=device)

    def i(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return SectorStepper(
        WJ_fwd=c(WJ), WJ_bwd=c(np.conj(WJ)), nn1=r(nn1),
        occ=r(states.astype(np.float64)), nn1_vals=r(vals), nn1_inv=i(inv),
        WJ_fwd_p=c(WJp), WJ_bwd_p=c(np.conj(WJp)), nn1_p=r(nn1_p),
        nn1_inv_p=i(inv_p), L=L, d=d, npart=npart, ns=ns, ns_p=ns_p,
        dt=float(dt))


def sector_ground_state(L: int, d: int, npart: int, J: float, U: float,
                        dtype=torch.complex128, device=None) -> torch.Tensor:
    """(ns,) exact sector ground state, largest amplitude made positive.
    device=None means the card."""
    device = resolve_device(device)
    return torch.as_tensor(sector_ground_vector(L, d, npart, J, U),
                           dtype=dtype, device=device)


def expectation_n(st: SectorStepper, psi) -> torch.Tensor:
    """Per-site <n_i> of (..., ns) sector vectors: sum_k |psi_k|^2 occ[k, i]
    (the Fock basis is diagonal in n)."""
    return (psi * psi.conj()).real @ st.occ


def _phase_p(st: SectorStepper, u, power, dtype,
             padded: bool = False) -> torch.Tensor:
    """Gathered phase exp(-0.25j * power * u * dt * nn1); power=2 is the
    merged phase D(u)^2 of two adjacent half steps. u is a scalar."""
    small = torch.exp((-0.25j * power * st.dt) * u * st.nn1_vals)
    return small[st.nn1_inv_p if padded else st.nn1_inv].to(dtype)


def _phase_rows(st: SectorStepper, u, power, dtype,
                padded: bool = False) -> torch.Tensor:
    """(len(u), ns) stacked gathered phases."""
    small = torch.exp((-0.25j * power * st.dt) * u[:, None]
                      * st.nn1_vals[None])
    return small[:, st.nn1_inv_p if padded else st.nn1_inv].to(dtype)


def _pad(st: SectorStepper, v: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last axis of a logical (..., ns) vector to ns_p."""
    if st.ns_p == st.ns:
        return v
    z = torch.zeros(*v.shape[:-1], st.ns_p - st.ns, dtype=v.dtype,
                    device=v.device)
    return torch.cat([v, z], dim=-1)


def _normalize_rows(v: torch.Tensor) -> torch.Tensor:
    nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.where(nrm > 1e-16, nrm, torch.ones_like(nrm)).to(v.dtype)


def sector_step(st: SectorStepper, psi: torch.Tensor, u_from,
                u_to) -> torch.Tensor:
    """One forward Trotter step on padded (..., ns_p) sector rows: one
    (rows, ns_p) @ W^T product. Each row is normalized."""
    psi = psi * _phase_p(st, u_from, 1, psi.dtype, True)
    psi = psi @ st.WJ_fwd_p.T
    psi = psi * _phase_p(st, u_to, 1, psi.dtype, True)
    return _normalize_rows(psi)


# ---------------------------------------------------------------------------
# rollouts (merged-phase chains; time is a Python loop)
# ---------------------------------------------------------------------------

def rollout(st: SectorStepper, psi0, u):
    """(N_t, ns) psi_t for all times."""
    dtype = psi0.dtype
    P = _phase_rows(st, u[1:], 2, dtype, True)
    h = _pad(st, psi0) * _phase_p(st, u[0], 1, dtype, True)
    traj = []
    for i in range(u.shape[0] - 1):
        h = st.WJ_fwd_p @ h
        traj.append(h)
        h = h * P[i]
    # traj[i] = W h_i: psi_{i+1} = D(u_{i+1}) traj[i]
    psi = torch.stack(traj)[:, :st.ns] * _phase_rows(st, u[1:], 1, dtype)
    return torch.cat([psi0[None], _normalize_rows(psi)], dim=0)


def rollout_final(st: SectorStepper, psi0, u):
    """(ns,) psi(T) only."""
    dtype = psi0.dtype
    P = _phase_rows(st, u[1:], 2, dtype, True)
    h = _pad(st, psi0) * _phase_p(st, u[0], 1, dtype, True)
    for i in range(u.shape[0] - 1):
        h = (st.WJ_fwd_p @ h) * P[i]
    # strip the doubled trailing phase
    psiT = h[:st.ns] * _phase_p(st, u[-1], -1, dtype)
    return _normalize_rows(psiT)


def costate_rollout(st: SectorStepper, psi_target, u):
    """(N_t, ns) xi_t backward from the target, ordered by time:
    gx_{i-1} = D(-u_{i-1})^2 (conj(WJ) gx_i)."""
    dtype = psi_target.dtype
    u_rev = torch.flip(u[:-1], dims=(0,))
    P = _phase_rows(st, u_rev, -2, dtype, True)
    gx = _pad(st, psi_target) * _phase_p(st, u[-1], -1, dtype, True)
    traj = []
    for k in range(u.shape[0] - 1):
        gx = st.WJ_bwd_p @ gx
        traj.append(gx)
        gx = gx * P[k]
    xi = torch.stack(traj)[:, :st.ns] * _phase_rows(st, u_rev, -1, dtype)
    xi = torch.cat([psi_target[None], _normalize_rows(xi)], dim=0)
    return torch.flip(xi, dims=(0,))


# ---------------------------------------------------------------------------
# cost / gradient / Hessian
# ---------------------------------------------------------------------------

def cost(st: SectorStepper, psi0, psi_target, u, gamma):
    psiT = rollout_final(st, psi0, u)
    ov = torch.sum(psi_target.conj() * psiT)
    return infidelity_cost(ov) + regularization(u, gamma, st.dt)


def fidelities(st: SectorStepper, psi0, psi_target, u):
    ovs = rollout(st, psi0, u) @ psi_target.conj()
    return (ovs * ovs.conj()).real


def fidelities_streaming(st: SectorStepper, psi0, psi_target, u):
    """API parity with engine.fidelities_streaming: sector states are (ns,)
    vectors, so the stacked trajectory is already small."""
    return fidelities(st, psi0, psi_target, u)


def _div_t(st: SectorStepper, xi_t, psi_t):
    """divT_i = <xi_i| dH/du |psi_i>, dH/du = 0.5 nn1 (diagonal)."""
    half = 0.5 * st.nn1
    return torch.sum(xi_t.conj() * half[None, :] * psi_t, dim=1)


def gradient(st: SectorStepper, psi0, psi_target, u, gamma):
    """Adjoint gradient, mirroring the reference formula (it carries an
    O(dt^2) bias of ~1e-4 relative). Returns (g, (psi_t, xi_t, divT, ov))."""
    psi_t = rollout(st, psi0, u)
    xi_t = costate_rollout(st, psi_target, u)
    divT = _div_t(st, xi_t, psi_t)
    ov = torch.sum(psi_t[-1].conj() * psi_target)  # <psi(T)|psi_target>
    g = adjoint_gradient(divT, ov, st.dt) + regularization_grad(u, gamma,
                                                                st.dt)
    return g, (psi_t, xi_t, divT, ov)


def gradient_lowmem(st: SectorStepper, psi0, psi_target, u, gamma):
    """Memory-light gradient (the reference's BFGS mode): xi is never
    stored and divT is computed inline during the backward sweep. Both
    sweeps carry half-phased states h_i = D(u_i) psi_i, gx_i = D(-u_i) xi_i
    with one merged phase per step and no per-step normalization, and
        divT_i = <gx_i| D(-u_i)^2 (0.5 nn1) |h_i>.
    Returns (g, (None, None, divT, ov))."""
    dtype = psi0.dtype
    half = (0.5 * st.nn1_p).to(dtype)
    n = u.shape[0]
    h = _pad(st, psi0) * _phase_p(st, u[0], 1, dtype, True)
    h_t = [h]
    P = _phase_rows(st, u[1:], 2, dtype, True)
    for i in range(n - 1):
        h = (st.WJ_fwd_p @ h) * P[i]
        h_t.append(h)
    hT = h

    Pm2 = _phase_rows(st, u, -2, dtype, True)
    gx = _pad(st, psi_target) * _phase_p(st, u[-1], -1, dtype, True)
    divT = [None] * n
    divT[n - 1] = torch.sum(gx.conj() * Pm2[n - 1] * half * hT)
    for i in range(n - 1, 0, -1):
        gx = (st.WJ_bwd_p @ gx) * Pm2[i - 1]
        divT[i - 1] = torch.sum(gx.conj() * Pm2[i - 1] * half * h_t[i - 1])
    divT = torch.stack(divT)

    # ov = <psi(T)|psi_target>; psi_T = D(-u_{N-1}) hT, normalized once
    ov = torch.sum(hT.conj() * _phase_p(st, u[-1], 1, dtype, True)
                   * _pad(st, psi_target))
    ov = ov / torch.clamp(torch.linalg.vector_norm(hT), min=1e-16).to(dtype)
    g = adjoint_gradient(divT, ov, st.dt) + regularization_grad(u, gamma,
                                                                st.dt)
    return g, (None, None, divT, ov)


def cost_and_gradient(st: SectorStepper, psi0, psi_target, u, gamma):
    """Cost and adjoint gradient sharing one forward sweep."""
    g, (_, _, _, ov) = gradient(st, psi0, psi_target, u, gamma)
    return infidelity_cost(ov) + regularization(u, gamma, st.dt), g


def cost_and_gradient_exact(st: SectorStepper, psi0, psi_target, u, gamma):
    """Exact dJ/du of the computed cost by reverse-mode autograd through
    the rollout. Returns (J, g), both detached."""
    with torch.enable_grad():
        uu = u.detach().requires_grad_(True)
        J = cost(st, psi0, psi_target, uu, gamma)
        (g,) = torch.autograd.grad(J, uu)
    return J.detach(), g


def hessian(st: SectorStepper, psi0, psi_target, u, gamma):
    """Exact dense Hessian by row propagation: all N_t row states are
    stepped together, one batched (rows, ns_p) @ W^T product per time step,
    and rows with i >= j stay frozen."""
    n = u.shape[0]
    dt = st.dt
    half = 0.5 * st.nn1_p

    _, (psi_t, xi_t, divT, ov) = gradient(st, psi0, psi_target, u, gamma)
    psi_t = _pad(st, psi_t)
    xi_t = _pad(st, xi_t)

    def apply_dh(v):
        w = half[None, :] * v
        nrm = torch.linalg.vector_norm(w, dim=1)
        w = w / torch.where(nrm > 1e-300, nrm,
                            torch.ones_like(nrm))[:, None].to(w.dtype)
        return w, nrm

    xiH, xiH_norm = apply_dh(xi_t)
    states, row_norm = apply_dh(psi_t)
    rows0 = states

    idx = torch.arange(n, device=u.device)
    ov_rows = []
    # only 1 <= j <= n-2 contributes (edge rows/cols stay zero)
    for j in range(1, n - 1):
        stepped = sector_step(st, states, u[j - 1], u[j])
        states = torch.where((idx < j)[:, None], stepped, states)
        ov_rows.append(states @ xiH[j].conj())  # <xiH_j | psiH_i(t_j)>

    diag_ov = torch.sum(xiH.conj() * rows0, dim=1)
    # ovm[j, i]; rows 0 and n-1 are masked out (built out of place, so the
    # Hessian can be vmapped over controls)
    zero = torch.zeros((1, n), dtype=states.dtype, device=u.device)
    ovm = torch.cat([zero, torch.stack(ov_rows), zero])
    return assemble_hessian(ovm, row_norm, xiH_norm, diag_ov, divT, ov, dt,
                            regularization_hessian(n, gamma, dt,
                                                   dtype=row_norm.dtype,
                                                   device=u.device))
