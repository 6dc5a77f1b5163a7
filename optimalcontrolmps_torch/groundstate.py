"""Fixed particle-number sector of the Bose-Hubbard chain, ground states.

Counterpart of optimalcontrolmps_tpu/groundstate.py: the sector basis and
Hamiltonian from the host library (`native.py`, with plain-Python twins),
and `initialize_state` (an MPS on a torch device), by
exact diagonalization of the sector or, above EXACT_DIAG_MAX_DIM states,
by DMRG (`dmrg.py`). Hamiltonian:
    H = -J sum_i (a_i adag_{i+1} + adag_i a_{i+1}) + U/2 sum_i n_i(n_i-1)
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import mps as mpslib
from . import native
from .device import resolve_device
from .dmrg import dmrg_ground_state

__all__ = ["sector_basis", "sector_basis_python", "sector_hamiltonian",
           "sector_hamiltonian_coo_python", "sector_dim",
           "sector_ground_vector", "ground_statevector", "initialize_state",
           "EXACT_DIAG_MAX_DIM"]

# exact diagonalization up to this sector dimension, DMRG above it
EXACT_DIAG_MAX_DIM = 20_000


@lru_cache(maxsize=64)
def sector_basis(L: int, d: int, npart: int) -> tuple:
    """All occupation tuples with sum = npart, each n_i <= d, in
    lexicographic order (site 0 most significant), enumerated by the host
    library (`native.py`).

    Returns (states, flat): states is an int64 array (nstates, L), flat
    holds each state's full-space basis index (row-major, site 0 slowest)."""
    return native.sector_basis(L, d, npart)


def sector_basis_python(L: int, d: int, npart: int) -> tuple:
    """`sector_basis` in plain Python: the host library's twin."""
    states = []

    def rec(prefix, remaining, sites_left):
        if sites_left == 0:
            if remaining == 0:
                states.append(tuple(prefix))
            return
        lo = max(0, remaining - d * (sites_left - 1))
        hi = min(d, remaining)
        for n in range(lo, hi + 1):
            rec(prefix + [n], remaining - n, sites_left - 1)

    rec([], npart, L)
    arr = np.array(states, dtype=np.int64).reshape(-1, L)
    weights = (d + 1) ** np.arange(L - 1, -1, -1)
    return arr, arr @ weights


def sector_hamiltonian_coo_python(L: int, d: int, npart: int, J: float,
                                  U: float) -> tuple:
    """(rows, cols, vals, n) of the sector Hamiltonian in plain Python, the
    host library's twin entry for entry: per state k its diagonal, then
    for each bond i the hops a_i adag_{i+1} and adag_i a_{i+1} that exist
    (row = the state reached, col = k)."""
    states, _ = sector_basis_python(L, d, npart)
    lookup = {tuple(s): k for k, s in enumerate(states.tolist())}
    rows, cols, vals = [], [], []
    for k, s in enumerate(states.tolist()):
        diag = 0.0
        for n in s:
            diag += 0.5 * U * n * (n - 1.0)
        rows.append(k)
        cols.append(k)
        vals.append(diag)
        for i in range(L - 1):
            ni, nj = s[i], s[i + 1]
            if ni >= 1 and nj + 1 <= d:
                t = list(s)
                t[i] -= 1
                t[i + 1] += 1
                rows.append(lookup[tuple(t)])
                cols.append(k)
                vals.append(-J * np.sqrt(float(ni)) * np.sqrt(float(nj + 1)))
            if nj >= 1 and ni + 1 <= d:
                t = list(s)
                t[i] += 1
                t[i + 1] -= 1
                rows.append(lookup[tuple(t)])
                cols.append(k)
                vals.append(-J * np.sqrt(float(nj)) * np.sqrt(float(ni + 1)))
    return (np.array(rows, dtype=np.int64), np.array(cols, dtype=np.int64),
            np.array(vals, dtype=np.float64), len(states))


def sector_hamiltonian(L: int, d: int, npart: int, J: float,
                       U: float) -> np.ndarray:
    """Dense Hamiltonian restricted to the fixed-N sector, summed from the
    host library's COO."""
    r, c, v, n = native.sector_hamiltonian_coo(L, d, npart, J, U)
    H = np.zeros((n, n), dtype=np.float64)
    np.add.at(H, (r, c), v)
    return H


def sector_dim(L: int, d: int, npart: int) -> int:
    """Number of occupation configurations with sum npart, each <= d."""
    counts = np.zeros(npart + 1, dtype=np.int64)
    counts[0] = 1
    for _ in range(L):
        new = np.zeros_like(counts)
        for n in range(npart + 1):
            new[n] = counts[max(0, n - d):n + 1].sum()
        counts = new
    return int(counts[npart])


def sector_ground_vector(L: int, d: int, npart: int, J: float,
                         U: float) -> np.ndarray:
    """(ns,) exact ground state of the fixed-N sector, largest amplitude
    made positive."""
    _, v = np.linalg.eigh(sector_hamiltonian(L, d, npart, J, U))
    g = v[:, 0]
    return g * np.sign(g[int(np.argmax(np.abs(g)))])


def ground_statevector(L: int, d: int, npart: int, J: float,
                       U: float) -> np.ndarray:
    """The sector ground state embedded in the full p**L space."""
    _, flat = sector_basis(L, d, npart)
    full = np.zeros((d + 1) ** L, dtype=np.complex128)
    full[flat] = sector_ground_vector(L, d, npart, J, U)
    return full


def initialize_state(L: int, d: int, npart: int, J: float, U: float,
                     chi: int, dtype=None, method: str = "auto",
                     n_sweeps: int = 8, device=None):
    """Ground-state MPS (L, chi, p, chi) on `device` (None means the card):
    the reference's InitializeState. method "exact" diagonalizes the fixed-N
    sector and splits the vector by successive SVDs; "dmrg" runs
    `dmrg.dmrg_ground_state` (n_sweeps at the target chi); "auto" takes
    exact up to EXACT_DIAG_MAX_DIM sector states, DMRG above."""
    device = resolve_device(device)
    dtype = torch.complex128 if dtype is None else dtype
    if method == "auto":
        method = ("exact" if sector_dim(L, d, npart) <= EXACT_DIAG_MAX_DIM
                  else "dmrg")
    if method == "dmrg":
        A, _ = dmrg_ground_state(L, d, npart, J, U, chi, n_sweeps=n_sweeps,
                                 dtype=dtype, device=device)
        return A
    if method != "exact":
        raise ValueError(f"unknown method {method!r}: 'auto', 'exact' or "
                         f"'dmrg'")
    vec = ground_statevector(L, d, npart, J, U)
    A = mpslib.from_statevector(vec, L, d + 1, chi)
    return torch.as_tensor(A, dtype=dtype, device=device)
