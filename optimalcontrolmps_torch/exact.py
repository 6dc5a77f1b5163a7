"""Exact dense statevector propagator for small chains (the tests' oracle).

Counterpart of optimalcontrolmps_tpu/exact.py: the same Trotter product as
`tebd.tebd_step`, D(u_to) J_odd J_even D(u_from), applied to the full p**L
vector with no truncation. Vectors may carry leading batch axes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.gates import j_gate
from .sites import nn1_diag
from .device import resolve_device

__all__ = ["ExactStepper", "make_exact_stepper", "exact_step",
           "statevector_nn1_total"]

def statevector_nn1_total(L: int, d: int) -> np.ndarray:
    """Diagonal of sum_i n_i(n_i-1) over the full p**L basis."""
    per_site = nn1_diag(d)
    tot = np.zeros((1,), dtype=np.float64)
    for _ in range(L):
        tot = (tot[:, None] + per_site[None, :]).reshape(-1)
    return tot


@dataclasses.dataclass(frozen=True)
class ExactStepper:
    gate_fwd: torch.Tensor    # (p^2, p^2)
    gate_bwd: torch.Tensor
    nn1_total: torch.Tensor   # (p**L,)
    L: int
    p: int
    dt: float


def make_exact_stepper(L: int, d: int, J: float, dt: float,
                       dtype=torch.complex128, device=None) -> ExactStepper:
    """device=None means the card."""
    device = resolve_device(device)
    gf = torch.as_tensor(j_gate(J, d, dt), dtype=dtype, device=device)
    return ExactStepper(
        gate_fwd=gf, gate_bwd=gf.conj(),
        nn1_total=torch.as_tensor(statevector_nn1_total(L, d),
                                  dtype=dtype.to_real(), device=device),
        L=L, p=d + 1, dt=float(dt))


def _apply_bond_dense(psi, gate, i, L, p):
    """Two-site gate on sites (i, i+1) of (..., p**L) vectors."""
    lead = psi.shape[:-1]
    m = psi.reshape(*lead, p ** i, p * p, p ** (L - i - 2))
    m = torch.einsum('PQ,...aQb->...aPb', gate, m)
    return m.reshape(*lead, -1)


def exact_step(st: ExactStepper, psi, u_from, u_to, forward: bool = True):
    """One Trotter step on (..., p**L) vectors; u_from, u_to scalars."""
    L, p = st.L, st.p
    gate = st.gate_fwd if forward else st.gate_bwd
    sign = 1.0 if forward else -1.0
    psi = psi * torch.exp((-0.25j * sign * float(u_from) * st.dt)
                          * st.nn1_total).to(psi.dtype)
    for i in range(0, L - 1, 2):
        psi = _apply_bond_dense(psi, gate, i, L, p)
    for i in range(L - 2 - (L % 2 == 0), 0, -2):
        psi = _apply_bond_dense(psi, gate, i, L, p)
    psi = psi * torch.exp((-0.25j * sign * float(u_to) * st.dt)
                          * st.nn1_total).to(psi.dtype)
    nrm = torch.linalg.vector_norm(psi, dim=-1, keepdim=True)
    return psi / torch.where(nrm > 1e-16, nrm,
                             torch.ones_like(nrm)).to(psi.dtype)
