"""The bond update's eigensolver fan-out on the card: the table that chose
`ops/trunc.py`'s `_FANOUT_WIDTH` and `_ONE_CALL_MAX_N`, and a Vidal unit's
eigh counters.

    python tools/probe_eigh_fanout.py [--vidal-unit] [--first-use]
        [--no-table]

Needs one NVIDIA GPU. Runs chip_smoke.py's `check_eigh_fanout`: the
fanned-out eigh against one torch.linalg.eigh call, bitwise, at the cells'
shapes, then the median milliseconds per eigh of a batch at each width
(1: one call) at every batch 1-12 of 560 x 560 and at 4 and 8 matrices
of n = 48-256, all complex128.

--vidal-unit also runs one unit of the benchmark's `bh_N20.vidal_gradient`
cell (its set-up makes the DMRG boundary states first, ~30 s, cached in
benchmark/.cache/) and prints the unit's `eigh_calls`, `eigh_fanout` and
Vidal steps.

--first-use times, each in a fresh process and in turns with the fan-out
off (`_FANOUT_WIDTH` 1) and on: the process's first and second
`ops.trunc.eigh` of (10, 560, 560) and (4, 125, 125), and the set-up of
the benchmark's `bh_L5.mps_gradient` and `bh_N20.vidal_gradient` cells
(what the pool's threads, streams and solver handles add to `setup_s`).

Writes everything as one JSON object to chiprun_out/eigh_fanout_probe.json
and prints it last.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import check_eigh_fanout  # noqa: E402
from optimalcontrolmps_torch import vidal  # noqa: E402
from optimalcontrolmps_torch.ops import trunc  # noqa: E402


def vidal_unit() -> dict:
    """One unit of bh_N20.vidal_gradient after its set-up, with the eigh
    and Vidal-step counters read over the unit alone."""
    from benchmark import harness
    harness.set_cache_dirs()
    spec = harness.cell_spec("bh_N20.vidal_gradient")
    unit = harness.load_module("units", spec["unit"])
    spans = harness.Spans(torch.device("cuda"))
    ctx = unit.setup(spec["config"], spec["traffic"], 2147483659,
                     torch.device("cuda"), spans)
    torch.cuda.synchronize()
    trunc.reset_counts()
    vidal.reset_counts()
    t0 = time.perf_counter()
    unit.run(ctx, 1, spans)
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0,
            "eigh_calls": dict(trunc.eigh_calls),
            "eigh_fanout": dict(trunc.eigh_fanout),
            "vidal_steps": vidal.steps}


FIRST_USE = """
import sys, time
t_start = time.perf_counter()
sys.path.insert(0, {root!r})
import torch
from optimalcontrolmps_torch.ops import trunc
if {width} == 1:
    trunc._FANOUT_WIDTH = 1
out = {{}}
if {cell!r}:
    from benchmark import harness
    harness.set_cache_dirs()
    spec = harness.cell_spec({cell!r})
    unit = harness.load_module("units", spec["unit"])
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unit.setup(spec["config"], spec["traffic"], 2147483659, dev,
               harness.Spans(dev))
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
else:
    for B, n in ((10, 560), (4, 125)):
        a = torch.randn(B, n, n, dtype=torch.complex128, device="cuda")
        a = a + a.mH
        laps = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trunc.eigh(a)
            torch.cuda.synchronize()
            laps.append(time.perf_counter() - t0)
        out[f"{{B}}x{{n}}"] = laps
out["process_s"] = time.perf_counter() - t_start
print(out)
"""


def first_use() -> list:
    """Fresh processes, fan-out off and on in turns (off, on, on, off),
    after one process that builds what a checkout's first run builds
    (kernels, host library, DMRG states), not counted."""
    rows = []
    for cell in ("", "bh_L5.mps_gradient", "bh_N20.vidal_gradient"):
        for k, width in enumerate((0, 1, 0, 0, 1)):
            code = FIRST_USE.format(root=ROOT, width=width, cell=cell)
            r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                               capture_output=True, text=True, timeout=600)
            line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() \
                else r.stderr[-500:]
            tag = "builds, not counted" if k == 0 else (
                "off" if width == 1 else "on")
            print(f"first use: cell {cell or 'none'}, fan-out {tag}: "
                  f"{line}", flush=True)
            if k:
                rows.append({"cell": cell, "fanout": width != 1,
                             "out": line})
    return rows


def main(argv) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, f"torch {torch.__version__}", flush=True)
    out = {"device": smi, "torch": torch.__version__,
           "fanout_width": trunc._FANOUT_WIDTH,
           "one_call_max_n": trunc._ONE_CALL_MAX_N}
    if "--first-use" in argv:
        out["first_use"] = first_use()
    out.update(check_eigh_fanout(table="--no-table" not in argv))
    if "--vidal-unit" in argv:
        out["vidal_unit"] = vidal_unit()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "eigh_fanout_probe.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
