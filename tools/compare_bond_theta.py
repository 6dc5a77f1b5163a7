"""The bond-theta kernel of two trees of the repo, timed on one card.

    python tools/compare_bond_theta.py ROOT [ROOT ...]

Each ROOT is the top of a checkout (this one, or an older commit unpacked
with `git archive`); they are run in the order given, one process each, so
that `PARENT THIS THIS PARENT` compares two versions on one card in turns.
Needs one NVIDIA GPU with nvcc. Each process imports `optimalcontrolmps_torch`
from its ROOT and this tree's `chip_smoke.py` for its timing helpers, and at
the shapes below (numpy seed 0 inputs, contiguous) prints one JSON line: per
shape the per-call time by CUDA events over 50 back-to-back calls (`ms`,
the median of five such readings, all in `ms_runs`),
the kernel's device time per launch by torch.profiler (`device_ms`), the
one-einsum yardstick (`library_ms`), the error against the twin, or why the
tree refused the shape.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("complex128", 4, 25, 5), ("complex64", 4, 25, 5),
          ("complex64", 8, 128, 8), ("complex128", 2, 128, 8),
          ("complex128", 1, 200, 8))


def one(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from optimalcontrolmps_torch.ops import bond_theta as bt
    assert os.path.abspath(bt.__file__).startswith(os.path.abspath(root))
    rows = []
    for name, B, chi, p in SHAPES:
        dtype = getattr(torch, name)
        Ai, Aj, G = cs.theta_inputs(B, chi, p, dtype)
        row = {"dtype": name, "B": B, "chi": chi, "p": p}
        try:
            out = bt.bond_theta(Ai, Aj, G)
        except (RuntimeError, ValueError) as exc:
            rows.append({**row, "refused": str(exc)})
            continue
        ref = bt.bond_theta_reference(Ai, Aj, G)
        row["rel_err"] = float(torch.max(torch.abs(out - ref))
                               / torch.max(torch.abs(ref)))
        # the host's enqueue bounds small shapes and swings between
        # processes, so the median of five readings of 50 calls each
        row["ms_runs"] = [cs.cuda_ms(lambda: bt.bond_theta(Ai, Aj, G), 50)
                          for _ in range(5)]
        row["ms"] = sorted(row["ms_runs"])[2]
        row["device_ms"] = cs.kernel_device_ms(
            lambda: bt.bond_theta(Ai, Aj, G), 50, "bond_theta_kernel")
        G4 = G.reshape(p, p, p, p)
        row["library_ms"] = cs.cuda_ms(
            lambda: torch.einsum('PQpq,bapc,bcqd->baPQd', G4, Ai, Aj), 50)
        rows.append(row)
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0),
                      "rows": rows}), flush=True)


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
