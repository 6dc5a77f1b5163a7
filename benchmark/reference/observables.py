"""Plain reference of the quench analysis' measurements of one MPS: the
window correlators AnalyzeQuench records (AnalyzeQuench.cpp:128-183), a
site's expectation value, an MPO's expectation value, and the von Neumann
entropy of a bond from its Schmidt values.

Written from the definitions in plain PyTorch and NumPy; it imports nothing
of the program. A state is one MPS A (L, chi, p, chi), every bond padded to
chi. Every number is its own transfer-matrix sweep over the whole chain,
from the identity on the left edge to the trace on the right, with the
operators inserted on the ket at their sites, divided by <A|A>; nothing is
shared between two numbers, and no canonical form is assumed. For sites
s < j:

    sp_j  = <adag_s a_j>,   dd_j = <n_s n_j>,   rdd_j = dd_j - <n_s><n_j>,

for j in (start, end], and

    S_b = -sum_k w_k log w_k,   w_k = lam_k^2 / sum lam^2   (w_k > 0),

the entanglement entropy of bond b from its Schmidt values lam.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def boson_ops(d: int):
    """(a, adag, n) as (p, p) float64 numpy, p = d + 1."""
    n = np.arange(d + 1, dtype=np.float64)
    a = np.diag(np.sqrt(n[1:]), k=1)
    return a, a.T.copy(), np.diag(n)


def _transfer(env, A, o=None):
    """env'[b, d] = sum env[a, c] conj(A[a, q, b]) o[q, p] A[c, p, d]."""
    ket = A if o is None else torch.einsum('qp,cpd->cqd', o, A)
    t = torch.einsum('ac,cqd->aqd', env, ket)
    return torch.einsum('aqb,aqd->bd', A.conj(), t)


def _sweep(A, ops: dict):
    """trace of the environment carried from the left edge (the identity)
    over every site, ops[i] inserted on the ket at site i."""
    env = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
    for i in range(A.shape[0]):
        o = ops.get(i)
        if o is not None:
            o = torch.as_tensor(o, dtype=A.dtype, device=A.device)
        env = _transfer(env, A[i], o)
    return torch.trace(env)


def expectation(A, ops: dict, norm=None):
    """<A| prod_i ops[i] |A> / <A|A> for on-site operators {site: (p, p)},
    one sweep from the left edge (norm: <A|A>, else its own sweep)."""
    A = torch.as_tensor(A)
    if norm is None:
        norm = _sweep(A, {})
    return complex(_sweep(A, ops) / norm)


def window_correlators(A, d: int, start: int, end: int):
    """(sp, dd, rdd), each (end - start,) float64 numpy, every number by its
    own sweep (`expectation`)."""
    A = torch.as_tensor(A)
    norm = _sweep(A, {})
    a, adag, n = boson_ops(d)
    dens = {j: expectation(A, {j: n}, norm).real
            for j in range(start, end + 1)}
    sp, dd, rdd = [], [], []
    for j in range(start + 1, end + 1):
        sp.append(expectation(A, {start: adag, j: a}, norm).real)
        ddj = expectation(A, {start: n, j: n}, norm).real
        dd.append(ddj)
        rdd.append(ddj - dens[start] * dens[j])
    return np.asarray(sp), np.asarray(dd), np.asarray(rdd)


def total_number(A, d: int) -> float:
    """sum_j <n_j>."""
    A = torch.as_tensor(A)
    norm = _sweep(A, {})
    n = boson_ops(d)[2]
    return float(sum(expectation(A, {j: n}, norm).real
                     for j in range(A.shape[0])))


def mpo_expectation(A, W) -> float:
    """<A|W|A> / <A|A> of an MPO W[wl, wr, p, q] on every site, with the
    boundary vectors vL = e_3, vR = e_0 of `reference/dmrg.mpo`."""
    A = torch.as_tensor(A)
    W = torch.as_tensor(W, dtype=A.dtype, device=A.device)
    chi = A.shape[1]
    env = torch.zeros((W.shape[0], chi, chi), dtype=A.dtype, device=A.device)
    env[3] = torch.eye(chi, dtype=A.dtype, device=A.device)
    for i in range(A.shape[0]):
        # env'[x, b, d] =
        #     env[w, a, c] conj(A[a, q, b]) W[w, x, q, p] A[c, p, d]
        t = torch.einsum('wac,cpd->wapd', env, A[i])
        t = torch.einsum('wxqp,wapd->xaqd', W, t)
        env = torch.einsum('aqb,xaqd->xbd', A[i].conj(), t)
    return float((torch.trace(env[0]) / _sweep(A, {})).real)


def entropies(lam) -> np.ndarray:
    """(..., L-1) von Neumann entropies of Schmidt values lam (..., L-1,
    chi), float64."""
    w = np.asarray(lam, dtype=np.float64) ** 2
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-300)
    safe = np.where(w > 0.0, w, 1.0)
    return -np.sum(np.where(w > 0.0, w * np.log(safe), 0.0), axis=-1)
