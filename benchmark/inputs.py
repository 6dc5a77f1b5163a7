"""Seeded controls for the gradient units: for each lane the reference's
randomized seed ramp between the configuration's two interactions plus a
smooth perturbation in the sine basis, u = ramp + S (f c), c ~ N(0, sigma)
over `modes` sines. One seed gives the same lanes."""

from __future__ import annotations

import numpy as np

from benchmark.reference.sector import linsigmoid_ramp, sine_basis


def seeded_ramps(cfg: dict, lanes: int, modes: int, sigma: float,
                 seed: int) -> np.ndarray:
    """(lanes, N_t) float64 controls."""
    n = int(round(cfg["T"] / cfg["tstep"])) + 1
    rng = np.random.default_rng(seed)
    S, f = sine_basis(n, cfg["tstep"], cfg["T"], modes)
    out = np.empty((lanes, n))
    for b in range(lanes):
        c = rng.normal(0.0, sigma, modes)
        out[b] = linsigmoid_ramp(cfg["U_initial"], cfg["U_final"], n, rng) \
            + S * (f @ c)
    return out
