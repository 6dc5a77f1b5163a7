"""Each cell's check against a planted fault (`benchmark/faults.py`): the
rest of a run (set-up, window, check) at a small size on the CPU, with the
timed path broken underneath, must come out not correct, and the same run
unbroken correct."""

from __future__ import annotations

import pytest

from benchmark.faults import FAULTS
from benchmark.tests.small import run_small


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_is_correct(cell):
    rec = run_small(cell)
    assert rec["correct"], rec["compared"]


@pytest.mark.parametrize("cell,fault", sorted(
    (c, f) for c in FAULTS for f in FAULTS[c]))
def test_fault_is_caught(cell, fault):
    rec = run_small(cell, fault)
    assert not rec["correct"], rec["compared"]
