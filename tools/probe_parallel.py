"""The multi-device and host-library phases of chip_smoke.py alone, on the
card.

    python tools/probe_parallel.py [one] [two] [native]

Needs one NVIDIA GPU with nvcc. Builds the kernels, makes the long chain's
prep state as chip_smoke's `analysis_chain` does (N=20, d=7, DMRG at chi
64, in a temporary directory), then runs chip_smoke's `parallel_1rank`,
`parallel_2rank` (which needs `one`'s references) and `native` phases (the
ones named, or all three) with chip_smoke.py's helpers and gates. Prints
the card's name and power limit, each phase's wall time and JSON line, and
the launches per kernel; exits non-zero on a failed gate.
"""

import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from optimalcontrolmps_torch.ops import _build  # noqa: E402
from optimalcontrolmps_torch.precision import enforce_matmul_precision  # noqa


def prep_state():
    """The U_i = 2.5 ground state of the long chain, as analysis_chain's
    prep_states makes it (host array)."""
    from optimalcontrolmps_torch.drivers import prep_states
    n, d, chi = cs.ANALYSIS_N, cs.ANALYSIS_D, cs.ANALYSIS_CHI_PREP
    with tempfile.TemporaryDirectory() as tmp:
        psi_i, _ = prep_states.ensure_boundary_states(
            n, d, n, 1.0, 2.5, 50.0, chi, os.path.join(tmp, "states.npz"),
            chi_prep=chi)
    return psi_i


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False; this probe needs a GPU")
    enforce_matmul_precision()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda, flush=True)
    want = set(sys.argv[1:]) or {"one", "two", "native"}
    phases = cs.Phases()
    _build.build_all()
    phases.done("build")
    launches = {}
    if want & {"one", "two"}:
        psi = prep_state()
        phases.done("prep state (DMRG, N=20, chi 64)")
        one = cs.drive_parallel_1rank(psi)
        launches["parallel_1rank"] = one["res"]["launches"]
        phases.done("parallel_1rank")
        if "two" in want:
            launches["parallel_2rank"] = cs.drive_parallel_2rank(one)[
                "launches"]
            phases.done("parallel_2rank")
    if "native" in want:
        cs.drive_native()
        phases.done("native")
    print(f"launches: {launches}")


if __name__ == "__main__":
    main()
