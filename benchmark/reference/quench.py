"""Plain reference of AnalyzeQuench on the long chain: the quench from a
given boundary state, measured at every step, and the ground-state
search that makes the boundary state.

Written from the method's definition in plain PyTorch and NumPy; it
imports nothing of the program. The quench starts from an MPS psi_i (L,
chi_prep, p, chi_prep), brings it into Vidal's canonical form
(`chain.canonical_form`), pads every bond with zeros to the quench's chi
and takes the reference's quenchRamp (U_initial at the first time, U_final
at every later one) through `chain.step`, the truncating Trotter step, in
the stepper's precision. At every time, the start included, it records
each bond's entropy from its Schmidt values and the window's correlators
(`observables.window_correlators`).

The ground states come from `dmrg.py`'s search. `ground_state` runs the
same schedule and sweeps in another dtype: in complex64 it is the control
of the program's complex128 search.

Where this departs from ITensor (AnalyzeQuench.cpp with
InitializeState.hpp:53-57): every bond keeps a fixed chi, zero-padded,
where ITensor keeps the Schmidt values above its cutoff (1e-9 in the
ground-state search) up to maxM; the search's bond dimension stops at
chi_prep where ITensor's schedule climbs to 200; the dense search holds
the particle number by a penalty where ITensor conserves it by block
structure. The program departs alike, so the reference and the program
differ only at rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from . import chain, dmrg, observables
from .sector import F64


def pad(A, chi: int) -> np.ndarray:
    """A (L, c, p, c) zero-padded to (L, chi, p, chi)."""
    L, c, p, _ = A.shape
    out = np.zeros((L, chi, p, chi), dtype=A.dtype)
    out[:, :c, :, :c] = A
    return out


def quench_ramp(cfg: dict) -> np.ndarray:
    """The reference's quenchRamp over N_t = T / tstep + 1 times."""
    n = int(round(cfg["T"] / cfg["tstep"])) + 1
    u = np.full(n, float(cfg["U_final"]))
    u[0] = cfg["U_initial"]
    return u


def quench_chi(cfg: dict) -> int:
    """The quench's bond dimension: maxBondDim, at most p^(L // 2)."""
    return int(min(cfg["maxBondDim"], (cfg["d"] + 1) ** (cfg["N"] // 2)))


def quench(cfg: dict, psi_i, prec=F64, device="cpu") -> dict:
    """{"S": (N_t, L-1), "sp", "dd", "rdd": (N_t, end - start)} float64 of
    the quench from psi_i in the precision `prec`."""
    chi = quench_chi(cfg)
    start, end = cfg["window"]
    B, lam = chain.canonical_form(psi_i)
    B = torch.as_tensor(pad(B, chi), device=device).to(prec.cdtype)
    lam_full = np.zeros((lam.shape[0], chi))
    lam_full[:, :lam.shape[1]] = lam
    lam = torch.as_tensor(lam_full, device=device).to(prec.rdtype)
    st = chain.Stepper(cfg["d"], cfg["J"], cfg["tstep"], chi,
                       cfg["density_jitter"], prec=prec, device=device)
    u = quench_ramp(cfg)
    rows = {k: [] for k in ("S", "sp", "dd", "rdd")}
    for i in range(len(u)):
        if i > 0:
            B, lam = chain.step(st, B, lam, float(u[i - 1]), float(u[i]))
        rows["S"].append(observables.entropies(lam.cpu().numpy()))
        sp, dd, rdd = observables.window_correlators(
            B.to(torch.complex128), cfg["d"], start, end)
        rows["sp"].append(sp)
        rows["dd"].append(dd)
        rows["rdd"].append(rdd)
    return {k: np.asarray(v) for k, v in rows.items()}


def ground_state(cfg: dict, U: float, chi: int, dtype=torch.complex128,
                 device="cpu"):
    """(MPS (L, chi, p, chi) complex128 numpy, energy) of `dmrg.py`'s
    search (its schedule, sweeps, Krylov depth, penalty and tolerance from
    the configuration's `dmrg`) with its states, environments and MPO in
    `dtype`."""
    dm = cfg["dmrg"]
    L, d, npart = cfg["N"], cfg["d"], cfg["Npart"]
    if dtype == torch.complex128:
        return dmrg.ground_state(L, d, npart, cfg["J"], U, chi,
                                 n_sweeps=dm["sweeps"], krylov=dm["krylov"],
                                 penalty=dm["number_penalty"],
                                 e_tol=dm["e_tol"], device=device)
    # dmrg.ground_state's loop, in `dtype`
    p = d + 1
    W = torch.as_tensor(dmrg.mpo(L, d, cfg["J"], U, npart,
                                 dm["number_penalty"]),
                        device=device).to(dtype)
    occ = [0] * L
    left = npart
    for i in range(L - 1, -1, -1):
        if left >= 1:
            occ[i] = 1
            left -= 1
    occ[0] += max(left, 0)
    A = np.zeros((L, 1, p, 1), np.complex128)
    for i, n in enumerate(occ):
        A[i, 0, n, 0] = 1.0
    schedule = [m for m in (10, 20, 50, 100, 200) if m < chi] + [chi]
    A = torch.as_tensor(pad(A, schedule[0]), device=device).to(dtype)
    e = None
    for stage, c in enumerate(schedule):
        if A.shape[1] < c:
            A = torch.as_tensor(pad(A.cpu().numpy(), c), device=device)
        A = A.to(dtype)
        final = stage == len(schedule) - 1
        e = None
        for _ in range(dm["sweeps"] if final else 1):
            e_prev = e
            A, e = dmrg._sweep(A, W, c, dm["krylov"])
            if (final and e_prev is not None
                    and abs(e_prev - e) < dm["e_tol"] * max(1.0, abs(e))):
                break
    return A.cpu().numpy().astype(np.complex128), e
