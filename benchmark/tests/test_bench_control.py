"""The control: the plain reference put in the program's place one
precision below the configuration's (TF32 products for float32, float32
for float64) must fail a cell's limits where the program passes them. At
a small size on the CPU; on the card at the cells' own sizes,
`benchmark/control.py` gives the readings the limits were set from."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests.small import SEED, SMALL, small_spec


def _over(readings, limits):
    return [k for k, v in limits.items() if not readings[k] <= v]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_where_the_program_passes(cell):
    spec = small_spec(cell)
    unit = harness.load_module("units", spec["unit"])
    dev = torch.device("cpu")
    ctx = unit.setup(spec["config"], spec["traffic"], SEED, dev,
                     harness.Spans(dev))
    answers = [unit.run(ctx, k, harness.Spans(dev))["answers"]
               for k in range(2)]
    unit.release(ctx)
    cfg, tr, lim = spec["config"], spec["traffic"], spec["limits"]
    assert not _over(unit.check(cfg, tr, SEED, answers, dev), lim)
    assert _over(unit.check(cfg, tr, SEED, answers, dev, control=True), lim)
