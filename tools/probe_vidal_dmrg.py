"""The Vidal and DMRG phases of chip_smoke.py alone, on the card.

    python tools/probe_vidal_dmrg.py [exact] [dmrg] [scaled]

Needs one NVIDIA GPU with nvcc. Builds the kernels, then runs what
chip_smoke.py's `vidal_exact`, `dmrg_exact` and `vidal_scaled` phases need
and those phases themselves (the ones named, or all three), with
chip_smoke.py's helpers and gates:

* the MPS engine's cost and gradient on the shipped T=2.0 problem on the
  card at c=0 and at chip_smoke.C_RAND (what check_card_vs_cpu hands
  `vidal_exact`), and ip_mps's host-mode run (its f after iteration 1);
* `drive_vidal_exact`, `drive_dmrg_exact`, `drive_vidal_scaled`.

Prints each phase's wall time and JSON line; exits non-zero on a failed
gate, like chip_smoke.py.
"""

import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from optimalcontrolmps_torch import engine  # noqa: E402
from optimalcontrolmps_torch.drivers import common, optimize_ramp  # noqa
from optimalcontrolmps_torch.ops import _build  # noqa: E402
from optimalcontrolmps_torch.precision import enforce_matmul_precision  # noqa


def mps_card_readings() -> dict:
    """chip_smoke.check_card_vs_cpu's card readings (eigh split)."""
    p = common.build_problem(cs.example_config(engine="mps"), engine="mps")
    out = {}
    for label, c in (("c=0 eigh", np.zeros(10)),
                     ("random c eigh", cs.C_RAND)):
        u = p.basis.convert_control(torch.as_tensor(c, device=p.device))
        J, g = engine.cost_and_gradient(p.stepper, p.psi_i, p.psi_f, u,
                                        p.gamma)
        out[label] = (float(J), g.cpu())
    return out


def ip_mps_host_f1() -> float:
    """f after iteration 1 of chip_smoke.drive_ip_mps's host-mode run."""
    cfg = cs.example_config(engine="mps", useBFGS="no", T=cs.MPS_IP_T,
                            maxIter=cs.MPS_IP_MAX_ITER, ipMode="host",
                            hessianRowBlock=cs.ROW_BLOCK,
                            hessianProgress="no")
    with tempfile.TemporaryDirectory() as tmp:
        out, _, _ = cs.run_driver(optimize_ramp, cfg, tmp)
    return out["status"]["history"][1][1]


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False; this probe needs a GPU")
    enforce_matmul_precision()
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda, flush=True)
    want = set(sys.argv[1:]) or {"exact", "dmrg", "scaled"}
    phases = cs.Phases()
    _build.build_all()
    phases.done("build")
    if "exact" in want:
        mps_card = mps_card_readings()
        phases.done("mps engine on the card (c=0, C_RAND)")
        t0 = time.perf_counter()
        f1 = ip_mps_host_f1()
        print(f"ip_mps host f after iteration 1: {f1!r} "
              f"({time.perf_counter() - t0:.1f} s)")
        phases.done("ip_mps host")
        cs.drive_vidal_exact(mps_card, f1)
        phases.done("vidal_exact")
    if "dmrg" in want:
        cs.drive_dmrg_exact()
        phases.done("dmrg_exact")
    if "scaled" in want:
        cs.drive_vidal_scaled()
        phases.done("vidal_scaled")


if __name__ == "__main__":
    main()
