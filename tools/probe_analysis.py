"""The analysis phases of chip_smoke.py alone, on the card.

    python tools/probe_analysis.py [chain] [shipped] [card_vs_cpu]

Needs one NVIDIA GPU with nvcc. Builds the kernels, then runs chip_smoke's
`analysis_chain`, `analysis_shipped` (after `drive_ip_sector`, whose
converged ramp it extends) and `analysis_card_vs_cpu` phases (the ones
named, or all three) with chip_smoke.py's helpers and gates. Prints the
card's name and power limit, each phase's wall time and JSON line, and the
bond theta's launches; exits non-zero on a failed gate, like chip_smoke.py.
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from optimalcontrolmps_torch.ops import _build  # noqa: E402
from optimalcontrolmps_torch.precision import enforce_matmul_precision  # noqa


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False; this probe needs a GPU")
    enforce_matmul_precision()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda, flush=True)
    want = set(sys.argv[1:]) or {"chain", "shipped", "card_vs_cpu"}
    phases = cs.Phases()
    _build.build_all()
    phases.done("build")
    launches = 0
    if "chain" in want:
        launches += cs.drive_analysis_chain()["launches"]
        phases.done("analysis_chain")
    if "shipped" in want:
        ramp = cs.drive_ip_sector()["ramp_text"]
        phases.done("ip_sector")
        launches += cs.drive_analysis_shipped(ramp)["launches"]
        phases.done("analysis_shipped")
    if "card_vs_cpu" in want:
        launches += cs.drive_analysis_card_vs_cpu()["launches"]
        phases.done("analysis_card_vs_cpu")
    print(f"bond_theta launches over the analysis phases: {launches}")


if __name__ == "__main__":
    main()
