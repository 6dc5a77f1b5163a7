"""Bond-dimension convergence study: the reference's AnalyzeBondDim driver.

Counterpart of optimalcontrolmps_tpu/drivers/analyze_bond_dim.py:

    python -m optimalcontrolmps_torch.drivers.analyze_bond_dim \\
        [InputFile [BHrampInitialFinal.txt]] [--bond-dims 20,30,...]
        [--no-grad] [--chunk K] [--chi-prep C] [--out-prefix P]

Propagates one ramp (a ramp file's final control, or the exponential ramp)
at several static bond dimensions on the Vidal engine, one state in
flight (`vidal.rollout_diagnostics`, a chunk of K steps at a time), and
records per step the fidelity with the final ground state, the Renyi-2
entropy of every bond (exp(S2), its effective rank, stands for the
reference's adaptive link dimensions) and the weight each truncation
discarded; at chunk ends the full Schmidt spectra. The adjoint gradient
follows (`vidal.gradient_segmented`: the trajectories kept when they fit
on the device, else O(sqrt(N_t)) states). Files:

  TimeEvolBondDimT{T}maxM{M}.txt   t, u, F(t), gradient(t), exp(S2) per bond
  SchmidtDataT{T}maxM{M}.txt       chunk-end t, per-bond occupied rank,
                                   von Neumann entropy, discarded weight
  TimeEvolBondDimT{T}runtimes.txt  maxM, propagation s, gradient s
  DMRGstateBondDim.txt             per-bond occupied rank of psi_i, psi_f

The propagation files are written before the gradient runs; a gradient
that fails raises (the JAX package writes a NaN column and goes on).
Without an InputFile: the reference's N=20, Npart=20, d=7, tstep 5e-3,
T=5, on the card.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .. import io, mps as mpslib, tebd, vidal
from ..precision import enforce_matmul_precision
from ..streaming import pick_segment
from .common import (J_HOP, U_FINAL, U_INITIAL, analysis_setup,
                     effective_chi, exp_ramp)
from .prep_states import ensure_boundary_states

__all__ = ["DEFAULT_BOND_DIMS", "OCC_CUTOFF", "run", "main"]

# the reference's bond dimensions (1000 is capped at the exact rank bound)
DEFAULT_BOND_DIMS = (20, 30, 40, 50, 1000)

# occupancy cutoff on the Schmidt weights lam^2: the fixed-rank reading of
# the reference's truncation cutoff 1e-8
OCC_CUTOFF = 1e-8


def _weights(lams: np.ndarray) -> np.ndarray:
    """Normalized Schmidt weights lam^2, in float64 (a float32 spectrum
    would underflow the 1e-300 floors to 0)."""
    w = np.asarray(lams, dtype=np.float64) ** 2
    return w / np.maximum(w.sum(axis=-1, keepdims=True), 1e-300)


def _occupancy(lams: np.ndarray, cutoff: float = OCC_CUTOFF) -> np.ndarray:
    """Per-bond count of Schmidt weights lam^2 above cutoff."""
    return (_weights(lams) > cutoff).sum(axis=-1)


def _vn_entropy(lams: np.ndarray) -> np.ndarray:
    """Per-bond von Neumann entropy from Schmidt values (host)."""
    w = _weights(lams)
    return -(np.where(w > 1e-14, w * np.log(np.maximum(w, 1e-300)),
                      0.0)).sum(axis=-1)


def run(cfg_path=None, ramp_path=None, bond_dims=DEFAULT_BOND_DIMS,
        dtype=None, chunk: int = 50, chi_prep: int = 64,
        want_gradient: bool = True, out_prefix: str = "",
        state_cache: str | None = None, seg=None, device=None) -> dict:
    """device None: the config's backend (the card without a config);
    dtype None: complex128 on the CPU, complex64 on the card. The states
    of a study chi below chi_prep are cached beside state_cache."""
    enforce_matmul_precision()
    a = analysis_setup(cfg_path, device, dtype, T=5.0)
    tstep, T, L, npart, d = a.tstep, a.T, a.L, a.npart, a.d
    device, dtype = a.device, a.dtype

    if ramp_path is not None:
        control = io.read_ramp_file(ramp_path)["u_final"]
    else:
        control = exp_ramp(U_INITIAL, U_FINAL, int(T / tstep + 1))
    times = np.arange(len(control)) * tstep
    u = torch.as_tensor(control, dtype=a.real, device=device)
    n_steps = len(control)
    K = pick_segment(n_steps - 1, chunk)

    # boundary states at chi_prep (cached), zero-padded to each study chi
    cp = min(chi_prep, effective_chi(10 ** 9, L, d + 1))
    cache = state_cache or os.path.join(
        ".state_cache", f"L{L}d{d}n{npart}chi{cp}.npz")
    psi_i_h, psi_f_h = ensure_boundary_states(
        L, d, npart, J_HOP, U_INITIAL, U_FINAL, cp, cache, chi_prep=cp,
        device=device)

    # DMRGstateBondDim.txt: the per-bond occupied rank of the prep states
    occ_i, occ_f = (_occupancy(vidal.schmidt_values(vidal.from_mps(
        A, device=device))) for A in (psi_i_h, psi_f_h))
    io.write_rowmat(out_prefix + "DMRGstateBondDim.txt",
                    np.stack([occ_i, occ_f], axis=1))

    results = {}
    for maxm in bond_dims:
        chi = effective_chi(maxm, L, d + 1)
        print(f"Calculating time-evolution for maxM = {maxm} "
              f"(chi={chi}, trunc=eigh, chunk={K})", flush=True)
        st = tebd.make_stepper(L, d, J_HOP, tstep, chi, dtype=dtype,
                               sweep="vidal", device=device)
        if chi >= cp:
            pi_h, pf_h = psi_i_h, psi_f_h
        else:
            # a study chi below the shared prep chi: prep directly at chi
            pi_h, pf_h = ensure_boundary_states(
                L, d, npart, J_HOP, U_INITIAL, U_FINAL, chi,
                os.path.join(os.path.dirname(cache),
                             f"L{L}d{d}n{npart}chi{chi}.npz"),
                chi_prep=chi, device=device)
        vi, vf = (vidal.from_mps(mpslib.pad_chi(A, chi).astype(a.np_complex),
                                 device=device) for A in (pi_h, pf_h))

        t0 = time.time()
        state, recs = vi, []
        spectra = [vidal.schmidt_values(vi)]
        for c in range(0, n_steps - 1, K):
            state, diag = vidal.rollout_diagnostics(
                st, state, u[c:c + K + 1], psi_target=vf)
            # row 0 re-measures the chunk's start: keep it for the first
            recs.append({k: v[0 if c == 0 else 1:] for k, v in diag.items()})
            spectra.append(vidal.schmidt_values(state))
        fids, s2s, discs = (torch.cat([r[k] for r in recs]).cpu().numpy()
                            for k in ("fid", "s2", "disc"))
        t_fid = time.time() - t0

        samp_t = times[::K]
        occ = np.stack([_occupancy(sp) for sp in spectra])
        vn = np.stack([_vn_entropy(sp) for sp in spectra])

        def write_files(g):
            rows = np.column_stack(
                [times, u.cpu().numpy(), fids,
                 g if g is not None else np.zeros_like(fids), np.exp(s2s)])
            io.write_rowmat(
                out_prefix + f"TimeEvolBondDimT{T:.1f}maxM{maxm}.txt", rows)
            io.write_rowmat(
                out_prefix + f"SchmidtDataT{T:.1f}maxM{maxm}.txt",
                np.column_stack([samp_t, occ, vn, discs[::K]]))

        # the propagation's files first: the gradient is the heavier part
        write_files(None)
        g, t_grad = None, 0.0
        if want_gradient:
            t0 = time.time()
            g = vidal.gradient_segmented(st, vi, vf, u, 0.0,
                                         seg=seg)[0].cpu().numpy()
            t_grad = time.time() - t0
            write_files(g)

        results[maxm] = {"chi": chi, "fids": fids, "grad": g, "s2": s2s,
                         "disc": discs, "occupancy": occ, "vn_entropy": vn,
                         "t_fidelity": t_fid, "t_gradient": t_grad}
        print(f"maxBondDim {maxm} (chi={chi}): final fidelity "
              f"{fids[-1]:.8f}, max disc/step {discs.max():.3e}, "
              f"fid wall {t_fid:.1f}s, grad wall {t_grad:.1f}s", flush=True)

    io.write_rowmat(out_prefix + f"TimeEvolBondDimT{T:.1f}runtimes.txt",
                    [[m, results[m]["t_fidelity"],
                      results[m]["t_gradient"]] for m in bond_dims])

    # the convergence table per t over the studied bond dimensions
    print("\nt\t" + "\t".join(f"F(chi={results[m]['chi']})"
                              for m in bond_dims))
    for i in range(0, len(times), max(1, len(times) // 20)):
        row = "\t".join(f"{results[m]['fids'][i]:.8f}" for m in bond_dims)
        print(f"{times[i]:g}\t{row}")
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    flags = {"--bond-dims": ("bond_dims",
                             lambda v: tuple(int(x) for x in v.split(","))),
             "--chunk": ("chunk", int), "--chi-prep": ("chi_prep", int),
             "--out-prefix": ("out_prefix", str)}
    opts, rest, i = {}, [], 0
    while i < len(argv):
        a = argv[i]
        if a in flags:
            key, conv = flags[a]
            opts[key] = conv(argv[i + 1])
            i += 2
        elif a == "--no-grad":
            opts["want_gradient"] = False
            i += 1
        else:
            rest.append(a)
            i += 1
    if len(rest) < 2:
        print("No input detected ... using standard parameters")
    run(rest[0] if rest else None, rest[1] if len(rest) >= 2 else None,
        **opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
