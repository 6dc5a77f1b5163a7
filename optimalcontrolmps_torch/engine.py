"""Control regularization (exact stencils of the reference).

Counterpart of optimalcontrolmps_tpu/engine.py:123-149. The MPS engine
itself is not ported yet. `regularization` and `regularization_grad` act on
the last axis, so a (B, N) control batch works as well as one (N,) control.
"""

from __future__ import annotations

import torch

__all__ = ["regularization", "regularization_grad", "regularization_hessian"]


def regularization(u, gamma, dt):
    d = torch.diff(u, dim=-1)
    return 0.5 * gamma * torch.sum(d * d, dim=-1) / dt


def regularization_grad(u, gamma, dt):
    """One-sided endpoint stencils, central differences inside."""
    interior = -gamma * (u[..., 2:] + u[..., :-2] - 2.0 * u[..., 1:-1]) / dt
    first = -gamma * (-5.0 * u[..., 1] + 4.0 * u[..., 2] - u[..., 3]
                      + 2.0 * u[..., 0]) / dt
    last = -gamma * (-5.0 * u[..., -2] + 4.0 * u[..., -3] - u[..., -4]
                     + 2.0 * u[..., -1]) / dt
    return torch.cat([first[..., None], interior, last[..., None]], dim=-1)


def regularization_hessian(n, gamma, dt, dtype=torch.float64, device="cpu"):
    """Tridiagonal gamma/dt with the four edge couplings and the two edge
    diagonal entries zero (fixed endpoints)."""
    g = gamma / dt
    main = torch.zeros(n, dtype=dtype, device=device)
    main[1:-1] = 2.0 * g
    off = torch.zeros(n - 1, dtype=dtype, device=device)
    off[1:-1] = -g
    return torch.diag(main) + torch.diag(off, 1) + torch.diag(off, -1)
