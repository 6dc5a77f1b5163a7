"""Quadratic bound penalty on the converted control.

Counterpart of optimalcontrolmps_tpu/optimize/penalty.py:

    P(u) = gamma_bound * sum_i [ (u_i - u_max)_+^2 + (u_min - u_i)_+^2 ]

summed over the last axis, with the reference defaults u_min=2, u_max=100,
gamma_bound=100; `make_penalized_cost` adds it to a cost, as the
reference's OCWrapper does for the derivative-free Amoeba.
"""

from __future__ import annotations

import torch

__all__ = ["bound_penalty", "make_penalized_cost"]


def bound_penalty(u, u_min: float = 2.0, u_max: float = 100.0,
                  gamma_bound: float = 100.0):
    over = torch.clamp(u - u_max, min=0.0)
    under = torch.clamp(u_min - u, min=0.0)
    return gamma_bound * (torch.sum(over * over, dim=-1)
                          + torch.sum(under * under, dim=-1))


def make_penalized_cost(cost_fn, convert_control=None, u_min: float = 2.0,
                        u_max: float = 100.0, gamma_bound: float = 100.0):
    """The reference's OCWrapper: f(x) = cost_fn(x) + bound_penalty(u(x)),
    with u = convert_control(x) (x itself if None); for (M,) or (B, M)."""
    def f(x):
        u = convert_control(x) if convert_control is not None else x
        return cost_fn(x) + bound_penalty(u, u_min, u_max, gamma_bound)
    return f
