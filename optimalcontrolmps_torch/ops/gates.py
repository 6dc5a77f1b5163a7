"""Trotter J-gate construction (numpy).

Counterpart of optimalcontrolmps_tpu/ops/gates.py:j_gate.
"""

from __future__ import annotations

import numpy as np

from ..sites import hop_two_site

__all__ = ["j_gate"]


def j_gate(J: float, d: int, dt: float, dtype=np.complex128) -> np.ndarray:
    """Two-site gate exp(-i dt h) for h = -J (A Adag + Adag A): a
    (p^2, p^2) unitary, p = d+1, built from the eigendecomposition of the
    real symmetric h."""
    h = hop_two_site(J, d)
    w, v = np.linalg.eigh(h)
    g = (v * np.exp(-1j * dt * w)) @ v.T
    return g.astype(dtype)
