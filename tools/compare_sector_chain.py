"""The sector-chain kernels of two trees of the repo, timed on one card.

    python tools/compare_sector_chain.py ROOT [ROOT ...]

Each ROOT is the top of a checkout (this one, or an older commit unpacked
with `git archive`); they run in the order given, one process each, so
that `PARENT THIS THIS PARENT` compares two versions on one card in turns.
Needs one NVIDIA GPU with nvcc. Each process imports `optimalcontrolmps_torch`
from its ROOT and this tree's `chip_smoke.py` for its timing helper, prints
what ptxas reported for the sector-chain library, and prints one JSON line:
per (B, N_t) in TIMED the time per call by CUDA events (the median of five
readings of 20 calls, all in `*_ms_runs`), on the flagship's constants with
controls from numpy seed 0 (chip_smoke's inputs). The kernels' agreement
with their twins is checked by tests/test_torch_cuda_kernels.py.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the flagship batch and two ranks' share of it (parallel_2rank)
TIMED = ((4096, 201), (2048, 201))


def one(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from optimalcontrolmps_torch import flagship
    from optimalcontrolmps_torch.ops import _build
    from optimalcontrolmps_torch.ops import sector_chain as sc
    from optimalcontrolmps_torch.seeds import adiabatic_seed
    assert os.path.abspath(sc.__file__).startswith(os.path.abspath(root))

    _build.load_sector_chain()
    for line in _build.build_log.get("sector_chain", {}).get(
            "ptxas", "").splitlines():
        if any(k in line for k in ("registers", "Compiling", "spill",
                                   "C7514")):
            print(f"  ptxas: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    prob = flagship.make_problem(dev)
    Wr, Wi, nn1, h0r, h0i = sc.chain_constants(prob.st, prob.psi_i)
    dt = prob.st.dt

    def reading(B, n_t):
        rng = np.random.default_rng(0)
        u = torch.as_tensor((adiabatic_seed(2.5, 50.0, n_t)[None]
                             + rng.normal(0.0, 0.3, (B, n_t))
                             ).astype(np.float32), device=dev)
        hT = sc.chain_fwd(dt, Wr, Wi, nn1, u, h0r, h0i)
        g = [torch.as_tensor(rng.normal(size=(B, 128)).astype(np.float32),
                             device=dev) for _ in range(2)]
        row = {"B": B, "n_t": n_t}
        row["fwd_ms_runs"] = [cs.cuda_ms(
            lambda: sc.chain_fwd(dt, Wr, Wi, nn1, u, h0r, h0i), 20)
            for _ in range(5)]
        row["bwd_ms_runs"] = [cs.cuda_ms(
            lambda: sc.chain_bwd(dt, Wr, Wi, nn1, u, *hT, *g), 20)
            for _ in range(5)]
        row["fwd_ms"] = sorted(row["fwd_ms_runs"])[2]
        row["bwd_ms"] = sorted(row["bwd_ms_runs"])[2]
        return row

    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0),
                      "rows": [reading(B, n_t) for B, n_t in TIMED]}),
          flush=True)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)


if __name__ == "__main__":
    main()
