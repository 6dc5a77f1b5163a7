"""Cells cut to sizes a CPU test holds, and a helper that drives the rest
of a run (set-up, window, check) on the CPU with a fault planted."""

from __future__ import annotations

import time

import torch

from benchmark import harness
from benchmark.faults import planted

SEED = (1 << 31) + 977

# (config changes, traffic changes) per cell
SMALL = {
    "bh_L5.multistart": ({"T": 0.2},
                         {"lanes": 16, "max_iter": 40, "check_lanes": 4}),
    "bh_L5.mps_gradient": ({"T": 0.1}, {}),
    "bh_N20.vidal_gradient": ({"N": 8, "Npart": 8, "d": 3, "maxBondDim": 12,
                               "T": 0.05, "name": "small"},
                              {"check_units": 1}),
}


def small_spec(cell: str) -> dict:
    spec = harness.cell_spec(cell)
    cfg, tr = SMALL[cell]
    spec["config"].update(cfg)
    spec["traffic"].update(tr)
    return spec


def run_small(cell: str, fault: str | None = None,
              seed: int = SEED) -> dict:
    """One run of the cell at its small size on the CPU with the planted
    `fault` (benchmark/faults.py) in place while the program runs."""
    spec = small_spec(cell)
    with planted(cell, fault):
        return harness.run_cell(spec, seed, 0.2, False, torch.device("cpu"),
                                time.perf_counter())
