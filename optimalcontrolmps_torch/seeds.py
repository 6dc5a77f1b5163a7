"""Initial-ramp seed generators (numpy).

Counterpart of the numpy functions of optimalcontrolmps_tpu/seeds.py:28-120,
including the reference's accumulating `a += step` linspace.
"""

from __future__ import annotations

import numpy as np

__all__ = ["linspace", "generate_range", "sigmoid", "linsigmoid_seed",
           "adiabatic_seed", "random_coeff_seed"]


def linspace(a: float, b: float, n: int) -> np.ndarray:
    """Accumulates `a += step` while a <= b + 1e-7; n points for
    well-behaved inputs."""
    step = (b - a) / (n - 1)
    out = []
    x = a
    while x <= b + 1e-7:
        out.append(x)
        x += step
    return np.asarray(out, dtype=np.float64)


def generate_range(a: float, b: float, c: float) -> np.ndarray:
    """MATLAB-style a:b:c, accumulating `x += b` while x <= c + 1e-7."""
    out = []
    x = a
    while x <= c + 1e-7:
        out.append(x)
        x += b
    return np.asarray(out, dtype=np.float64)


def sigmoid(x, k: float, offset: float) -> np.ndarray:
    """1 / (1 + exp(-k (x - offset)))."""
    x = np.asarray(x, dtype=np.float64)
    return 1.0 / (1.0 + np.exp(-k * (x - offset)))


def linsigmoid_seed(u_start: float, u_end: float, length: int,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Randomized linear+sigmoid seed:
    a ~ U(0.01, 0.15), c ~ U(0.06, 0.18), d ~ U(60, 80)."""
    if rng is None:
        rng = np.random.default_rng()
    x = linspace(0.0, 100.0, length)
    a = rng.uniform(0.01, 0.15)
    c = rng.uniform(0.06, 0.18)
    d_ = rng.uniform(60.0, 80.0)
    b = u_end - u_start - a * x[-1]
    n = x.shape[0]
    S = 1.0 / (1.0 + np.exp(-0.7 * (x - 5.0)))
    S[n // 2:] = (1.0 / (1.0 + np.exp(0.9 * (x - 93.0))))[n // 2:]
    S[0] = 0.0
    S[-1] = 0.0
    ramp = a * x + b / (1.0 + np.exp(-c * (x - d_))) + u_start
    base = (u_end - u_start) / (1.0 + np.exp(-0.2 * (x - 40.0))) + u_start
    return S * ramp + (1.0 - S) * base


def adiabatic_seed(u_start: float, u_end: float, length: int) -> np.ndarray:
    """Deterministic piecewise sigmoid->exponential ramp."""
    x = linspace(0.0, 100.0, length)
    p, k, xs, a = 3.5, 1.0 / 3.0, 40.0, 0.01
    low = (p - u_start - a * xs) / (1.0 + np.exp(-k * (x - xs / 2.0))) \
        + u_start + a * x
    high = np.exp(np.log(u_end - p + 1.0) / (100.0 - xs) * (x - xs)) + p - 1.0
    return np.where(x < xs, low, high)


def random_coeff_seed(lo: float, hi: float, n: int,
                      rng: np.random.Generator | None = None) -> np.ndarray:
    """Uniform random vector."""
    if rng is None:
        rng = np.random.default_rng()
    return rng.uniform(lo, hi, size=n)
