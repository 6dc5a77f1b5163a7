"""Correlation functions and physics observables of MPS batches.

Counterpart of optimalcontrolmps_tpu/observables.py on the port's batched
MPS (B, L, chi, p, chi): two-point correlators by environment contraction,
correlation matrices, the condensate fraction (largest eigenvalue of the
single-particle density matrix), per-site expectation values, bond
entanglement entropies and the defect metrics. Every function returns one
value per state of the batch.

Operator order as in the reference's correlationFunction:
`correlation_function(psi, op1, i, op2, j)` is <psi| Op1_i Op2_j |psi>,
with Op2 acting first when i == j, so ("Adag", i, "A", i) gives <n_i> and
the single-particle density matrix is Hermitian with the occupations on
its diagonal.
"""

from __future__ import annotations

import torch

from .mps import (_env_step, _left_envs, _right_envs, entanglement_entropies,
                  expectation_values)

__all__ = [
    "correlation_function", "correlation_matrix", "window_correlations",
    "condensate_fraction", "expectation_values", "entanglement_entropies",
    "mean_density_deviation", "number_fluctuation",
]


def _op(o, psi):
    return torch.as_tensor(o, dtype=psi.dtype, device=psi.device)


def _insert(env, A, o):
    """env (B, a, c) carried over one site A (B, chi, p, chi) with the
    operator o (p, p) acting on the ket: sum env[a c] conj(A[a q b])
    o[q p] A[c p d] -> (B, b, d)."""
    return _env_step(env, A, torch.einsum('qp,bcpd->bcqd', o, A))


def _carry(env, A):
    """env carried over one site with no operator."""
    return _env_step(env, A, A)


def _close(env, renv):
    """Contract a left environment with the right one of the same site."""
    return (env * renv).sum((-2, -1))


def correlation_function(psi, op1, i: int, op2, j: int):
    """<psi| Op1_i Op2_j |psi> for dense (p, p) operators; (B,)."""
    op1, op2 = _op(op1, psi), _op(op2, psi)
    lenvs = _left_envs(psi, psi)
    renvs = _right_envs(psi, psi)
    if i == j:
        return _close(_insert(lenvs[i], psi[:, i], op1 @ op2), renvs[i])
    if i > j:
        i, j, op1, op2 = j, i, op2, op1
    env = _insert(lenvs[i], psi[:, i], op1)
    for k in range(i + 1, j):
        env = _carry(env, psi[:, k])
    return _close(_insert(env, psi[:, j], op2), renvs[j])


def correlation_matrix(psi, op1, op2):
    """(B, L, L) C_ij = <Op1_i Op2_j>: C_ii = <(Op1 Op2)_i>, C_ij for j > i
    from the Op1-inserted environment carried rightward, C_ji = conj(C_ij).
    One O(L^2) pass sharing the environments."""
    L = psi.shape[1]
    op1, op2 = _op(op1, psi), _op(op2, psi)
    lenvs = _left_envs(psi, psi)
    renvs = _right_envs(psi, psi)
    C = torch.zeros((psi.shape[0], L, L), dtype=psi.dtype,
                    device=psi.device)
    prod = op1 @ op2
    for i in range(L):
        C[:, i, i] = _close(_insert(lenvs[i], psi[:, i], prod), renvs[i])
        env = _insert(lenvs[i], psi[:, i], op1)
        for j in range(i + 1, L):
            C[:, i, j] = _close(_insert(env, psi[:, j], op2), renvs[j])
            C[:, j, i] = C[:, i, j].conj()
            if j < L - 1:
                env = _carry(env, psi[:, j])
    return C


def window_correlations(psi, op_a, op_adag, op_n, start: int, end: int):
    """The correlators the reference's AnalyzeQuench records for the window
    of sites start..end, from ONE pass of environments (not one rebuild
    per pair, as through correlation_function). Returns (sp, dd, rdd),
    each (B, end - start), real, for j in (start, end]:
      sp_j  = <adag_start a_j>           single-particle correlator
      dd_j  = <n_start n_j>              density-density
      rdd_j = dd_j - <n_start><n_j>      connected density-density"""
    op_a, op_adag, op_n = (_op(o, psi) for o in (op_a, op_adag, op_n))
    lenvs = _left_envs(psi, psi)
    renvs = _right_envs(psi, psi)
    exp_n = {j: _close(_insert(lenvs[j], psi[:, j], op_n), renvs[j])
             for j in range(start, end + 1)}
    env_sp = _insert(lenvs[start], psi[:, start], op_adag)
    env_dd = _insert(lenvs[start], psi[:, start], op_n)
    sp, dd, rdd = [], [], []
    for j in range(start + 1, end + 1):
        spj = _close(_insert(env_sp, psi[:, j], op_a), renvs[j])
        ddj = _close(_insert(env_dd, psi[:, j], op_n), renvs[j])
        sp.append(spj.real)
        dd.append(ddj.real)
        rdd.append((ddj - exp_n[start] * exp_n[j]).real)
        if j < end:
            env_sp = _carry(env_sp, psi[:, j])
            env_dd = _carry(env_dd, psi[:, j])
    return (torch.stack(sp, dim=-1), torch.stack(dd, dim=-1),
            torch.stack(rdd, dim=-1))


def condensate_fraction(psi, op1, op2):
    """Largest eigenvalue of the correlation matrix (the reference's
    correlationTerm); (B,). For ("Adag", "A") it is the condensate
    occupation; divide by Npart for the fraction."""
    return torch.linalg.eigvalsh(correlation_matrix(psi, op1, op2))[..., -1]


def mean_density_deviation(psi, n_op, filling: float = 1.0):
    """rho = sum_i |<n_i> - filling| / L (CalculateDefects); (B,)."""
    n = expectation_values(psi, n_op).real
    return (n - filling).abs().mean(-1)


def number_fluctuation(psi, n_op, nn_op):
    """sum_i (<n_i^2> - <n_i>^2) / L, the F2 defect metric before its
    normalization by the initial value; (B,)."""
    n = expectation_values(psi, n_op).real
    n2 = expectation_values(psi, nn_op).real
    return (n2 - n * n).mean(-1)
