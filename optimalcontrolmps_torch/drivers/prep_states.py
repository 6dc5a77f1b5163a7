"""Boundary ground states for the analysis drivers, cached in an npz.

Counterpart of optimalcontrolmps_tpu/drivers/prep_states.py:

    python -m optimalcontrolmps_torch.drivers.prep_states \\
        L d npart J U_i U_f chi out.npz [chi_prep]

makes the ground states at U_i and U_f with `groundstate.initialize_state`
(exact diagonalization of the sector up to 20 000 states, DMRG above it) in
complex128 at chi_prep, zero-pads them to chi and writes psi_i, psi_f,
meta = [L, d, npart, chi, chi_prep] and controls = [J, U_i, U_f] to the
npz: the JAX package's format, so a cache written by either package loads
in the other. `ensure_boundary_states`, the library entry, reads the cache
when its parameters match and computes and writes it otherwise. Unlike the
JAX package, which moves the work into a CPU subprocess, the port runs it
in-process on the device it is given (None: the card).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import groundstate, mps

__all__ = ["compute", "ensure_boundary_states", "main"]


def compute(L: int, d: int, npart: int, J: float, u_i: float, u_f: float,
            chi: int, chi_prep: int | None = None, device=None) -> dict:
    """The cache's arrays (host numpy): the two ground states at
    min(chi, chi_prep), complex128, padded to chi."""
    cp = min(chi, chi_prep) if chi_prep else chi
    out = {}
    for tag, u in (("psi_i", u_i), ("psi_f", u_f)):
        A = groundstate.initialize_state(L, d, npart, J, float(u), cp,
                                         dtype=torch.complex128,
                                         device=device)
        out[tag] = mps.pad_chi(A.cpu().numpy(), chi)
    out["meta"] = np.asarray([L, d, npart, chi, cp], dtype=np.int64)
    out["controls"] = np.asarray([J, u_i, u_f], dtype=np.float64)
    return out


def ensure_boundary_states(L, d, npart, J, u_i, u_f, chi, cache_path,
                           chi_prep=None, device=None):
    """(psi_i, psi_f) as host complex128 (L, chi, p, chi) arrays: from
    cache_path when its meta and controls match, else computed on `device`
    and written there."""
    want_meta = np.asarray(
        [L, d, npart, chi, min(chi, chi_prep) if chi_prep else chi],
        dtype=np.int64)
    want_ctl = np.asarray([J, u_i, u_f], dtype=np.float64)
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path) as z:
            if (np.array_equal(z["meta"], want_meta)
                    and np.allclose(z["controls"], want_ctl)):
                return z["psi_i"], z["psi_f"]
        print(f"NOTE: state cache {cache_path} has different parameters; "
              "recomputing")
    out = compute(L, d, npart, J, u_i, u_f, chi, chi_prep, device=device)
    if cache_path:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)),
                    exist_ok=True)
        np.savez(cache_path, **out)
    return out["psi_i"], out["psi_f"]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 8:
        print(__doc__)
        return 2
    L, d, npart = int(argv[0]), int(argv[1]), int(argv[2])
    J, u_i, u_f = float(argv[3]), float(argv[4]), float(argv[5])
    chi, out_path = int(argv[6]), argv[7]
    chi_prep = int(argv[8]) if len(argv) > 8 else None
    out = compute(L, d, npart, J, u_i, u_f, chi, chi_prep)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **out)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
