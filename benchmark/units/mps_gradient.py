"""Unit: one batched cost and adjoint gradient of the MPS/TEBD engine
(`engine.cost_and_gradient`, the reference's own engine) over the
traffic's lanes of seeded controls.

The check compares every unit's costs and gradients with the reference's
sector propagation under the same Trotter splitting: at the exact Schmidt
rank bound the MPS truncates nothing, so both compute the same numbers.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from optimalcontrolmps_torch import engine, groundstate, tebd
from optimalcontrolmps_torch.precision import enforce_matmul_precision

from benchmark import harness, peaks
from benchmark.inputs import seeded_ramps
from benchmark.reference import sector as ref

WARM_SALT = 1 << 40
DTYPES = {"double": torch.complex128, "single": torch.complex64}


def _chi(cfg):
    return min(cfg["maxBondDim"],
               tebd.exact_rank_bound(cfg["N"], cfg["d"] + 1))


def setup(cfg, traffic, seed, device, spans):
    enforce_matmul_precision()
    dtype = DTYPES[cfg["precision"]]
    chi = _chi(cfg)
    if chi < tebd.exact_rank_bound(cfg["N"], cfg["d"] + 1):
        raise ValueError("the mps_gradient check needs the exact rank bound")
    ctx = SimpleNamespace(cfg=cfg, tr=traffic, seed=seed, device=device,
                          dtype=dtype)
    ctx.st = tebd.make_stepper(cfg["N"], cfg["d"], cfg["J"], cfg["tstep"],
                               chi, dtype=dtype, trunc_method="eigh",
                               sweep="snake", device=device)
    ctx.psi = [groundstate.initialize_state(
        cfg["N"], cfg["d"], cfg["Npart"], cfg["J"], U, chi, dtype=dtype,
        device=device) for U in (cfg["U_initial"], cfg["U_final"])]
    # the window's step and contractions at the window's lanes: a few steps
    U = _controls(ctx, harness.unit_seed(seed, WARM_SALT))[:, :4]
    engine.cost_and_gradient(ctx.st, *ctx.psi, U, cfg["gamma"])
    return ctx


def _controls(ctx, s):
    tr = ctx.tr
    U = seeded_ramps(ctx.cfg, tr["lanes"], tr["modes"], tr["sigma"], s)
    return torch.as_tensor(U, dtype=ctx.dtype.to_real(), device=ctx.device)


def run(ctx, k, spans):
    U = _controls(ctx, harness.unit_seed(ctx.seed, k))
    with spans("cost_and_gradient"):
        J, g = engine.cost_and_gradient(ctx.st, *ctx.psi, U,
                                        ctx.cfg["gamma"])
    return {"work": {"gradients": U.shape[0]},
            "answers": {"U": U.cpu().numpy(), "J": J.cpu().numpy(),
                        "g": g.cpu().numpy()}}


def probes(ctx):
    """CUDA-event time of the bond theta at the path's shape: the lanes'
    two middle sites of the initial state."""
    from optimalcontrolmps_torch.ops.bond_theta import bond_theta
    lanes = ctx.tr["lanes"]
    A = ctx.psi[0]
    mid = ctx.cfg["N"] // 2 - 1
    Ai = A[mid].expand(lanes, *A.shape[1:]).contiguous()
    Aj = A[mid + 1].expand(lanes, *A.shape[1:]).contiguous()
    _, chi, p, _ = Ai.shape
    ms = harness.cuda_ms(lambda: bond_theta(Ai, Aj, ctx.st.gate_fwd), 200)
    c128 = ctx.dtype == torch.complex128
    return {"bond_theta": [{"B": lanes, "chi": chi, "p": p, "ms": ms,
                            "bound_ms": peaks.bond_theta_ms(lanes, chi, p,
                                                            c128)}]}


def release(ctx):
    ctx.__dict__.clear()


def check(cfg, traffic, seed, answers, device, control: bool = False):
    """cost_gap: the largest |J - J_ref| over lanes and units; grad_gap: the
    largest max|g - g_ref| / max|g_ref| of a lane. control=True puts the
    reference in the program's place one precision below the stated one
    (float32 for double, TF32 products for single)."""
    ch = ref.make_chain(cfg["N"], cfg["d"], cfg["Npart"], cfg["J"],
                        cfg["tstep"], cfg["U_initial"], cfg["U_final"],
                        ref.F64, device)
    low = ref.F32 if cfg["precision"] == "double" else ref.TF32
    ctl = ref.make_chain(cfg["N"], cfg["d"], cfg["Npart"], cfg["J"],
                         cfg["tstep"], cfg["U_initial"], cfg["U_final"],
                         low, device) if control else None
    cost_gap = grad_gap = 0.0
    for a in answers:
        U = torch.as_tensor(a["U"], dtype=torch.float64, device=device)
        J, g = (x.cpu().numpy() for x in ref.adjoint_gradient(
            ch, U, cfg["gamma"]))
        Jp, gp = a["J"], a["g"]
        if control:
            Jp, gp = (x.cpu().numpy() for x in ref.adjoint_gradient(
                ctl, U.to(low.rdtype), cfg["gamma"]))
        cost_gap = max(cost_gap, float(np.max(np.abs(Jp - J))))
        grad_gap = max(grad_gap, float(np.max(
            np.abs(gp - g).max(-1) / np.abs(g).max(-1))))
    return {"cost_gap": cost_gap, "grad_gap": grad_gap}
