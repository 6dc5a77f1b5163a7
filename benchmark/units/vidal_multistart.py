"""Unit: one cost and adjoint gradient of the Vidal engine
(`vidal.cost_and_gradient`) for `lanes` lanes of seeded controls stepped
together, as a multistart over seeds steps them: every Vidal stage solves
the lanes' bonds in one batched bond update, so `ops/trunc.eigh` gets
lanes x 10 (or 9) matrices of 560 x 560 at once.

Set-up, the boundary states and the stepper are `vidal_gradient`'s (by
import); the warm-up adds the lanes' shapes. The lanes are drawn as
`vidal_gradient` draws its one (`inputs.seeded_ramps`, from the unit's
seed; lane 0 is that unit's lane). The check runs `vidal_gradient`'s
check on every lane of `check_units` units drawn from the seed: the
reference's truncating Vidal steps in complex128, one lane at a time.
"""

from __future__ import annotations

import torch

from optimalcontrolmps_torch import vidal

from benchmark import harness, peaks
from benchmark.inputs import seeded_ramps
from benchmark.units import vidal_gradient

release = vidal_gradient.release


def _controls(ctx, s):
    tr = ctx.tr
    u = seeded_ramps(ctx.cfg, tr["lanes"], tr["modes"], tr["sigma"], s)
    return torch.as_tensor(u, dtype=ctx.dtype.to_real(), device=ctx.device)


def setup(cfg, traffic, seed, device, spans):
    ctx = vidal_gradient.setup(cfg, traffic, seed, device, spans)
    # three steps forward and back of every lane
    u = _controls(ctx, harness.unit_seed(seed, vidal_gradient.WARM_SALT))
    vidal.cost_and_gradient(ctx.st, *ctx.psi, u[:, :4], cfg["gamma"])
    return ctx


def run(ctx, k, spans):
    u = _controls(ctx, harness.unit_seed(ctx.seed, k))
    with spans("cost_and_gradient"):
        J, g = vidal.cost_and_gradient(ctx.st, *ctx.psi, u, ctx.cfg["gamma"])
    return {"work": {"gradients": u.shape[0]},
            "answers": {"u": u.cpu().numpy(), "J": J.cpu().numpy(),
                        "g": g.cpu().numpy()}}


def probes(ctx):
    """CUDA-event times of the bond theta at the two stages' shapes with
    every lane's bonds stacked: (lanes x 10 | lanes x 9, chi, p)."""
    from optimalcontrolmps_torch.ops.bond_theta import bond_theta
    lanes = ctx.tr["lanes"]
    one = ctx.psi[0].B
    L, chi, p, _ = one.shape
    c128 = ctx.dtype == torch.complex128
    out = []
    for parity in (0, 1):
        bonds = list(range(parity, L - 1, 2))
        Bi = torch.stack([one[b] for b in bonds]).repeat(lanes, 1, 1, 1)
        Bj = torch.stack([one[b + 1] for b in bonds]).repeat(lanes, 1, 1, 1)
        ms = harness.cuda_ms(lambda: bond_theta(Bi, Bj, ctx.st.gate_fwd), 50)
        out.append({"B": Bi.shape[0], "chi": chi, "p": p, "ms": ms,
                    "bound_ms": peaks.bond_theta_ms(Bi.shape[0], chi, p,
                                                    c128)})
    return {"bond_theta": out}


def check(cfg, traffic, seed, answers, device, control: bool = False):
    """grad_gap: the largest max|g - g_ref| / max|g_ref| over every lane of
    `check_units` units drawn from the seed (`vidal_gradient.check` on
    each lane; control=True: the reference one precision below in the
    program's place)."""
    lanes = [{"u": answers[i]["u"][b], "g": answers[i]["g"][b]}
             for i in harness.sample(seed, 2, len(answers),
                                     traffic["check_units"])
             for b in range(len(answers[i]["u"]))]
    return vidal_gradient.check(cfg, dict(traffic, check_units=len(lanes)),
                                seed, lanes, device, control=control)
