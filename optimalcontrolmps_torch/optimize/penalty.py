"""Quadratic bound penalty on the converted control.

Counterpart of optimalcontrolmps_tpu/optimize/penalty.py:

    P(u) = gamma_bound * sum_i [ (u_i - u_max)_+^2 + (u_min - u_i)_+^2 ]

summed over the last axis, with the reference defaults u_min=2, u_max=100,
gamma_bound=100.
"""

from __future__ import annotations

import torch

__all__ = ["bound_penalty"]


def bound_penalty(u, u_min: float = 2.0, u_max: float = 100.0,
                  gamma_bound: float = 100.0):
    over = torch.clamp(u - u_max, min=0.0)
    under = torch.clamp(u_min - u, min=0.0)
    return gamma_bound * (torch.sum(over * over, dim=-1)
                          + torch.sum(under * under, dim=-1))
