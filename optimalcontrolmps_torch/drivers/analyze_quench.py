"""Quench physics: the reference's AnalyzeQuench driver.

Counterpart of optimalcontrolmps_tpu/drivers/analyze_quench.py:

    python -m optimalcontrolmps_torch.drivers.analyze_quench \\
        [InputFile] [--ramp quench|exp|FILE]

Propagates a quench, the exponential ramp or a ramp file's final control
on the Vidal engine with one state in flight, and records at every step
the von Neumann entropy of every bond (from the Schmidt values the state
carries) and the correlators of the site window startpoint..endpoint
(0-based 6..12 by default, the reference's 1-based 7..13) by
`observables.window_correlations`. Writes, in the reference's saveRowmat
format, EntanglementEntropies_{tag}.txt, SingleParticleCorr_{tag}.txt,
DensityDensityCorr_{tag}.txt and RescaledDensityDensityCorr_{tag}.txt
(tag Quench, Exp or Opt). The port's Schmidt values are always vectors, so
the per-step entropy is the von Neumann one and the JAX package's Renyi-2
and ...Sampled files of its matrix carriers are not written; the result's
`vn_sampled` holds the entropies at chunk ends, as JAX's does.

Without an InputFile: the reference's N=20, Npart=20, d=7, tstep 5e-3,
T=3, maxM 1000, on the card. The boundary state comes from
`prep_states.ensure_boundary_states` at chi_prep (cached in state_cache,
default .state_cache/L{L}d{d}n{npart}chi{cp}.npz).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .. import io, mps as mpslib, observables, tebd, vidal
from ..precision import enforce_matmul_precision
from ..sites import op
from ..streaming import pick_segment, rollout_measure
from .common import (J_HOP, U_FINAL, U_INITIAL, analysis_setup,
                     effective_chi, exp_ramp, quench_ramp)
from .prep_states import ensure_boundary_states

__all__ = ["run", "main"]


def run(cfg_path=None, ramp: str = "exp", out_prefix: str = "",
        dtype=None, startpoint: int = 6, endpoint: int = 12,
        chunk: int = 50, chi_prep: int = 64, state_cache: str | None = None,
        device=None) -> dict:
    """startpoint/endpoint: 0-based sites. device None: the config's
    backend (the card without a config); dtype None: complex128 on the
    CPU, complex64 on the card."""
    enforce_matmul_precision()
    a = analysis_setup(cfg_path, device, dtype, T=3.0)
    tstep, T, L, npart, d = a.tstep, a.T, a.L, a.npart, a.d
    device, dtype = a.device, a.dtype
    maxm = 1000 if a.cfg is None else a.cfg.get_int("maxBondDim", 1000)

    n_steps = int(T / tstep + 1)
    if ramp == "exp":
        control, tag = exp_ramp(U_INITIAL, U_FINAL, n_steps), "Exp"
    elif ramp == "quench":
        control, tag = quench_ramp(U_INITIAL, U_FINAL, n_steps), "Quench"
    else:
        control, tag = io.read_ramp_file(ramp)["u_final"], "Opt"
    u = torch.as_tensor(control, dtype=a.real, device=device)
    n_steps = len(control)
    K = pick_segment(n_steps - 1, chunk)
    sp_end = min(endpoint, L - 1)

    chi = effective_chi(maxm, L, d + 1)
    st = tebd.make_stepper(L, d, J_HOP, tstep, chi, dtype=dtype,
                           sweep="vidal", device=device)
    cp = min(chi_prep, chi)
    cache = state_cache or os.path.join(
        ".state_cache", f"L{L}d{d}n{npart}chi{cp}.npz")
    psi_i_h, _ = ensure_boundary_states(
        L, d, npart, J_HOP, U_INITIAL, U_FINAL, cp, cache, chi_prep=cp,
        device=device)
    vi = vidal.from_mps(mpslib.pad_chi(psi_i_h, chi).astype(a.np_complex),
                        device=device)

    a_op, adag_op, n_op = op("A", d), op("Adag", d), op("N", d)

    def measure(s):
        sp, dd, rdd = observables.window_correlations(
            s.B, a_op, adag_op, n_op, startpoint, sp_end)
        return {"S": vidal.bond_vn_entropy(s)[0], "sp": sp[0], "dd": dd[0],
                "rdd": rdd[0]}

    t0 = time.time()
    res = rollout_measure(
        lambda s, a, b: vidal.vidal_step(st, s, a, b, forward=True),
        vidal.VidalState(vi.B[None], vi.lam[None]), u, measure)
    res = {k: v.cpu().numpy() for k, v in res.items()}
    wall = time.time() - t0

    io.write_rowmat(out_prefix + f"EntanglementEntropies_{tag}.txt",
                    res["S"])
    io.write_rowmat(out_prefix + f"SingleParticleCorr_{tag}.txt", res["sp"])
    io.write_rowmat(out_prefix + f"DensityDensityCorr_{tag}.txt", res["dd"])
    io.write_rowmat(out_prefix + f"RescaledDensityDensityCorr_{tag}.txt",
                    res["rdd"])
    # the entropies at the chunk ends, with their times (the JAX package's
    # exact samples of its Renyi-2 path; here the per-step values are
    # already von Neumann)
    times = np.arange(n_steps) * tstep
    vn_sampled = np.column_stack([times[::K], res["S"][::K]])
    print(f"Wrote 4 files for ramp {tag} ({n_steps} steps, chi={chi}, "
          f"trunc=eigh, wall {wall:.1f}s)")
    return {"entropies": res["S"], "sp": res["sp"], "dd": res["dd"],
            "rdd": res["rdd"], "vn_sampled": vn_sampled, "wall": wall,
            "chi": chi}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ramp, rest, i = "exp", [], 0
    while i < len(argv):
        if argv[i] == "--ramp":
            ramp = argv[i + 1]
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    if not rest:
        print("No input detected ... using standard parameters")
    run(rest[0] if rest else None, ramp=ramp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
