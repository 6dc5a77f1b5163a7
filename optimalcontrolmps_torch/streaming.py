"""Streaming rollouts: measure along a trajectory with one state in flight.

Counterpart of optimalcontrolmps_tpu/streaming.py:44-64 (`rollout_measure`).
The segmented adjoint gradient and the block-streamed Hessian of that module
belong to the streaming slice (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import torch

__all__ = ["rollout_measure"]


def rollout_measure(step_fwd, psi0, u, measure):
    """measure(psi_i) for every i in 0..N_t-1, stacked on a new leading
    time axis. step_fwd(psi, u_from, u_to) -> psi'; u carries time on its
    last axis ((N_t,) or (B, N_t)); only one state is ever live."""
    psi = psi0
    out = [measure(psi)]
    for i in range(u.shape[-1] - 1):
        psi = step_fwd(psi, u[..., i], u[..., i + 1])
        out.append(measure(psi))
    return torch.stack(out)
