"""Defect metrics along a ramp: the reference's CalculateDefects driver.

Counterpart of optimalcontrolmps_tpu/drivers/calculate_defects.py:

    python -m optimalcontrolmps_torch.drivers.calculate_defects \\
        [InputFile [BHrampInitialFinal.txt]]

Propagates a control (the ramp file's final column, or the adiabatic seed)
with one state in flight and prints, per time, t, the fidelity F(t) with
the final ground state, rho(t) = mean_i |<n_i> - 1| and F2(t), the mean
over sites of the number fluctuation <n_i^2> - <n_i>^2 relative to its
initial value. Without an InputFile it runs the reference's defaults
(N=20, Npart=20, d=7, tstep 5e-3, T=5); maxBondDim is 70 when the config
has none. The config's `engine` (mps, the default, or vidal) propagates on
its `backend` (the card unless cpu).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import io, seeds, tebd, vidal
from ..config import InputGroup, parse_input_file
from ..device import resolve_device
from ..mps import expectation_values, overlap
from ..precision import enforce_matmul_precision
from ..sites import op
from ..streaming import rollout_measure
from .common import U_FINAL, U_INITIAL, build_problem, default_dtype

__all__ = ["run", "main"]


def run(cfg_path=None, ramp_path=None, device=None, dtype=None) -> dict:
    """dtype: the config's precision; without a config, complex128 on the
    CPU and complex64 on the card."""
    enforce_matmul_precision()
    if cfg_path is not None:
        cfg = parse_input_file(cfg_path)
    else:
        cfg = InputGroup("input", {"tstep": "5e-3", "T": "5", "N": "20",
                                   "Npart": "20", "d": "7"})
        device = resolve_device(device)
        dtype = default_dtype(device) if dtype is None else dtype
    cfg.values.setdefault("M", "1")
    cfg.values.setdefault("maxBondDim", "70")

    tstep = cfg.get_real("tstep", 1e-2)
    if ramp_path is not None:
        ramp = io.read_ramp_file(ramp_path)
        control, times = ramp["u_final"], ramp["times"]
    else:
        times = seeds.generate_range(0.0, tstep, cfg.get_real("T", 6))
        control = seeds.adiabatic_seed(U_INITIAL, U_FINAL, len(times))

    cfg.values["T"] = str((len(control) - 1) * tstep)
    engine = cfg.get_string("engine", "mps")
    if engine not in ("mps", "vidal"):
        raise ValueError(f"calculate_defects propagates an MPS: engine "
                         f"'mps' or 'vidal', not {engine!r}")
    p = build_problem(cfg, u0=control, engine=engine, device=device,
                      dtype=dtype)
    st = p.stepper
    real = torch.float64 if p.dtype == torch.complex128 else torch.float32
    u = torch.as_tensor(control, dtype=real, device=p.device)
    n_op, nn_op = op("N", p.d), op("NN", p.d)

    if p.kind == "vidal":
        psi0 = vidal.VidalState(p.psi_i.B[None], p.psi_i.lam[None])
        target = p.psi_f.B[None]

        def step(s, a, b):
            return vidal.vidal_step(st, s, a, b, forward=True)

        def mps_of(s):
            return s.B
    else:
        psi0, target = p.psi_i[None], p.psi_f[None]

        def step(s, a, b):
            return tebd.tebd_step(st, s, a, b, forward=True)

        def mps_of(s):
            return s

    def measure(s):
        A = mps_of(s)
        ov = overlap(target, A)
        return ((ov * ov.conj()).real[0],
                expectation_values(A, n_op).real[0],
                expectation_values(A, nn_op).real[0])

    fids, expn, expnn = (x.cpu().numpy() for x in
                         rollout_measure(step, psi0, u, measure))

    # the reference's defect metrics (CalculateDefects.cpp:82-104) on the
    # streamed <n_i>, <n_i^2>: rho is observables.mean_density_deviation
    # per step; F2 divides each site's fluctuation by its initial value
    # before the mean, where observables.number_fluctuation is the mean of
    # the unnormalized ones
    f2_init = expnn[0] - expn[0] ** 2
    rho = np.abs(expn - 1.0).mean(axis=1)
    f2 = ((expnn - expn ** 2) / f2_init[None, :]).mean(axis=1)

    for i in range(len(times)):
        print(f"{times[i]:g}\t{fids[i]:g}\t{rho[i]:g}\t{f2[i]:g}")
    return {"times": times, "fids": fids, "rho": rho, "f2": f2,
            "expn": expn, "expnn": expnn}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("No input detected ... using standard parameters")
    run(argv[0] if len(argv) >= 1 else None,
        argv[1] if len(argv) >= 2 else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
