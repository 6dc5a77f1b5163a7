"""Fixed particle-number sector of the Bose-Hubbard chain (numpy).

Counterpart of optimalcontrolmps_tpu/groundstate.py:26-135, pure-Python
paths only. Hamiltonian:
    H = -J sum_i (a_i adag_{i+1} + adag_i a_{i+1}) + U/2 sum_i n_i(n_i-1)
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["sector_basis", "sector_hamiltonian", "sector_dim"]


@lru_cache(maxsize=64)
def sector_basis(L: int, d: int, npart: int) -> tuple:
    """All occupation tuples with sum = npart, each n_i <= d, in
    lexicographic order (site 0 most significant).

    Returns (states, flat): states is an int array (nstates, L), flat holds
    each state's full-space basis index (row-major, site 0 slowest)."""
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
    arr = np.array(states, dtype=np.int64)
    weights = (d + 1) ** np.arange(L - 1, -1, -1)
    return arr, arr @ weights


def sector_hamiltonian(L: int, d: int, npart: int, J: float,
                       U: float) -> np.ndarray:
    """Dense Hamiltonian restricted to the fixed-N sector."""
    states, _ = sector_basis(L, d, npart)
    ns = len(states)
    lookup = {tuple(s): k for k, s in enumerate(states)}
    H = np.zeros((ns, ns), dtype=np.float64)
    for k, s in enumerate(states):
        H[k, k] += 0.5 * U * float(np.sum(s * (s - 1.0)))
        for i in range(L - 1):
            ni, nj = s[i], s[i + 1]
            # a_i adag_{i+1}: |ni-1, nj+1>
            if ni >= 1 and nj + 1 <= d:
                t = list(s)
                t[i] -= 1
                t[i + 1] += 1
                H[lookup[tuple(t)], k] += -J * np.sqrt(ni) * np.sqrt(nj + 1)
            # adag_i a_{i+1}: |ni+1, nj-1>
            if nj >= 1 and ni + 1 <= d:
                t = list(s)
                t[i] += 1
                t[i + 1] -= 1
                H[lookup[tuple(t)], k] += -J * np.sqrt(nj) * np.sqrt(ni + 1)
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
