"""Bose-Hubbard local Hilbert space and site operators (numpy).

Counterpart of optimalcontrolmps_tpu/sites.py. Operators are dense
(d+1, d+1) matrices on the occupation basis |0>, ..., |d>:
  N |n> = n |n>,  A |n> = sqrt(n) |n-1>,  Adag |n> = sqrt(n+1) |n+1>,
  N(N-1) |n> = n(n-1) |n>,  NN |n> = n^2 |n>,  Id = identity.
"""

from __future__ import annotations

import numpy as np

__all__ = ["local_dim", "op", "n_diag", "nn1_diag", "hop_two_site"]


def local_dim(d: int) -> int:
    """Local dimension for the Fock cutoff d (occupations 0..d)."""
    return d + 1


def n_diag(d: int) -> np.ndarray:
    """Diagonal of the number operator: [0, 1, ..., d]."""
    return np.arange(d + 1, dtype=np.float64)


def nn1_diag(d: int) -> np.ndarray:
    """Diagonal of the pair-counting operator N(N-1): n*(n-1)."""
    n = np.arange(d + 1, dtype=np.float64)
    return n * (n - 1.0)


def op(name: str, d: int) -> np.ndarray:
    """Dense (d+1, d+1) matrix for the named site operator."""
    p = d + 1
    n = np.arange(p, dtype=np.float64)
    if name == "N":
        return np.diag(n)
    if name == "A":
        return np.diag(np.sqrt(n[1:]), k=1)
    if name == "Adag":
        return np.diag(np.sqrt(n[1:]), k=-1)
    if name == "N(N-1)":
        return np.diag(n * (n - 1.0))
    if name == "NN":
        return np.diag(n * n)
    if name == "Id":
        return np.eye(p)
    raise ValueError(f"Operator {name!r} not recognized")


def hop_two_site(J: float, d: int) -> np.ndarray:
    """Two-site hopping Hamiltonian h = -J (A x Adag + Adag x A), a real
    symmetric (p^2, p^2) matrix with p = d+1."""
    a = op("A", d)
    adag = op("Adag", d)
    return -J * (np.kron(a, adag) + np.kron(adag, a))
