"""An optimized ramp extended by 100 constant-control steps: the
reference's ExtendTimeEvolution driver.

Counterpart of optimalcontrolmps_tpu/drivers/extend_time_evolution.py:

    python -m optimalcontrolmps_torch.drivers.extend_time_evolution \\
        InputFile BHrampInitialFinal.txt

Both controls of the ramp file (initial and final) are held at their last
value for 100 more steps of tstep; the fidelities of both and the
populations <n_i>(t) under the final control are written to
BHrampInitialFinal_extendedT{T}.txt and ExpectationN_extendedT{T}.txt, in
the JAX package's columns. The config's `engine` (mps, the default; vidal;
sector; auto) propagates, on its `backend` (the card unless cpu).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import io
from ..backends import engine_for
from ..config import parse_input_file
from ..precision import enforce_matmul_precision
from .common import build_problem, populations

__all__ = ["run", "main"]

EXTRA_STEPS = 100


def run(cfg_path: str, ramp_path: str, out_prefix: str = "",
        device=None) -> dict:
    enforce_matmul_precision()
    cfg = parse_input_file(cfg_path)
    ramp = io.read_ramp_file(ramp_path)
    tstep = cfg.get_real("tstep", 1e-2)
    T = cfg.get_real("T")

    pad = np.arange(1, EXTRA_STEPS + 1)
    times = np.concatenate([ramp["times"], T + pad * tstep])
    u_init = np.concatenate([ramp["u_init"],
                             np.full(EXTRA_STEPS, ramp["u_init"][-1])])
    u_final = np.concatenate([ramp["u_final"],
                              np.full(EXTRA_STEPS, ramp["u_final"][-1])])

    cfg.values["T"] = str((len(u_init) - 1) * tstep)
    p = build_problem(cfg, u0=u_init, engine=cfg.get_string("engine", "mps"),
                      device=device)
    st, psi_i, psi_f = p.stepper, p.psi_i, p.psi_f
    real = torch.float64 if p.dtype == torch.complex128 else torch.float32
    eng = engine_for(st)

    def control(u):
        return torch.as_tensor(u, dtype=real, device=p.device)

    fid_i = eng.fidelities_streaming(st, psi_i, psi_f, control(u_init))
    print("Calculated initial control")
    fid_f = eng.fidelities_streaming(st, psi_i, psi_f, control(u_final))
    print("Calculated final control")
    fid_i, fid_f = fid_i.cpu().numpy(), fid_f.cpu().numpy()

    tag = f"{T:.1f}"
    io.write_ramp_file(out_prefix + f"BHrampInitialFinal_extendedT{tag}.txt",
                       times, u_init, fid_i, u_final, fid_f)
    print("Saved ramp data")
    expn = populations(p, control(u_final)).cpu().numpy()
    io.write_expectation_file(out_prefix + f"ExpectationN_extendedT{tag}.txt",
                              times, expn)
    print("Saved population data")
    return {"times": times, "fid_init": fid_i, "fid_final": fid_f,
            "expn": expn}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(f"Usage: {sys.argv[0]} InputFile BHrampInitialFinal.txt")
        return 0
    run(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
