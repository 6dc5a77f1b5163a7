"""ctypes bindings of the port's host library (csrc/ocmps_native.cpp).

Counterpart of optimalcontrolmps_tpu/native: fixed-N sector enumeration,
the sector Hamiltonian in COO form and batched linsigmoid seed ramps, in
C++ on the host. The library is built with g++ into
`optimalcontrolmps_torch/build/` at first use (`ops._build.load_native`);
a failed build raises. `groundstate.sector_basis` and
`groundstate.sector_hamiltonian` always take this route; their Python
twins (`groundstate.sector_basis_python`, `sector_hamiltonian_coo_python`)
are the plain versions the tests hold it against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .ops._build import load_native

__all__ = ["sector_count", "sector_enumerate", "sector_basis",
           "sector_hamiltonian_coo", "linsigmoid_batch"]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def sector_count(L: int, d: int, npart: int) -> int:
    """Number of occupation vectors with sum npart, each n_i <= d."""
    return int(load_native().ocmps_sector_count(L, d, npart))


def sector_enumerate(L: int, d: int, npart: int) -> np.ndarray:
    """(n, L) uint8 occupation vectors in lexicographic order (site 0
    most significant)."""
    lib = load_native()
    n = lib.ocmps_sector_count(L, d, npart)
    states = np.empty((n, L), dtype=np.uint8)
    got = lib.ocmps_sector_enumerate(L, d, npart, _ptr(states, ctypes.c_uint8),
                                     n)
    if got != n:
        raise RuntimeError(f"ocmps_sector_enumerate wrote {got} of {n} "
                           f"states (L={L}, d={d}, npart={npart})")
    return states


def sector_basis(L: int, d: int, npart: int) -> tuple:
    """(states int64 (n, L), flat int64 (n,)) as groundstate.sector_basis:
    flat is each state's full-space index (row-major, site 0 slowest)."""
    states = sector_enumerate(L, d, npart).astype(np.int64)
    weights = ((d + 1) ** np.arange(L - 1, -1, -1)).astype(np.int64)
    return states, states @ weights


def sector_hamiltonian_coo(L: int, d: int, npart: int, J: float,
                           U: float) -> tuple:
    """(rows, cols, vals, n) of the sector Hamiltonian: per state k its
    diagonal entry, then for each bond i the two hops (a_i adag_{i+1},
    adag_i a_{i+1}) that exist; duplicates are summed by the caller (COO)."""
    lib = load_native()
    states = sector_enumerate(L, d, npart)
    n = states.shape[0]
    cap = n * (1 + 2 * (L - 1))
    rows = np.empty(cap, dtype=np.int64)
    cols = np.empty(cap, dtype=np.int64)
    vals = np.empty(cap, dtype=np.float64)
    nnz = lib.ocmps_sector_hamiltonian(
        L, d, npart, _ptr(states, ctypes.c_uint8), n, float(J), float(U),
        _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
        _ptr(vals, ctypes.c_double))
    return rows[:nnz], cols[:nnz], vals[:nnz], n


def linsigmoid_batch(u_start: float, u_end: float, length: int, batch: int,
                     seed: int = 0) -> np.ndarray:
    """(batch, length) float64 linsigmoid seed ramps, one mt19937_64
    stream per ramp from `seed` (the JAX package's native ramps, bit for
    bit on the same machine)."""
    out = np.empty((batch, length), dtype=np.float64)
    load_native().ocmps_linsigmoid_batch(
        float(u_start), float(u_end), length, batch, seed,
        _ptr(out, ctypes.c_double))
    return out
