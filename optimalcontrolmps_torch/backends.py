"""Engine dispatch: pick the derivative engine matching a stepper.

Counterpart of optimalcontrolmps_tpu/backends.py. Both engines export the
same function surface (rollout, rollout_final, costate_rollout, cost,
fidelities, fidelities_streaming, gradient, gradient_lowmem,
cost_and_gradient, hessian), so callers write `eng = engine_for(stepper)`
once:

* `engine` - fixed-rank MPS TEBD (`tebd.TEBDStepper`);
* `sector` - dense fixed-N propagation (`sector.SectorStepper`);
* `vidal` - canonical-form brick TEBD with truncation (sweep="vidal").
"""

from __future__ import annotations

from . import engine, sector, vidal
from .groundstate import sector_dim
from .sector import SECTOR_MAX_DIM, SectorStepper

__all__ = ["engine_for", "sector_fits"]


def engine_for(stepper):
    """Return the engine module (`engine`, `sector` or `vidal`)."""
    if isinstance(stepper, SectorStepper):
        return sector
    if getattr(stepper, "sweep", None) == "vidal":
        return vidal
    return engine


def sector_fits(L: int, d: int, npart: int) -> bool:
    """True when the fixed-N sector is small enough for the dense engine."""
    return sector_dim(L, d, npart) <= SECTOR_MAX_DIM
