"""Unit: one cost and adjoint gradient of the Vidal engine
(`vidal.cost_and_gradient`), the long chain's truncating brick TEBD, for
one lane of seeded controls.

The boundary states are the benchmark's own: two-site DMRG
(reference/dmrg.py) at the configuration's bond dimension, made once per
checkout and kept under benchmark/.cache/, then handed to the program (as
an MPS it puts into canonical form itself) and to the reference (which
canonicalizes it again). The check runs the reference's truncating
Vidal steps in complex128 on a sample of the units drawn from the seed.
"""

from __future__ import annotations

import hashlib
import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from optimalcontrolmps_torch import tebd, vidal
from optimalcontrolmps_torch.precision import enforce_matmul_precision

from benchmark import harness, peaks
from benchmark.inputs import seeded_ramps
from benchmark.reference import chain as ref_chain, dmrg
from benchmark.reference import sector as ref

WARM_SALT = 1 << 40
DTYPES = {"double": torch.complex128, "single": torch.complex64}


def boundary_states(cfg: dict, device) -> list:
    """[A(U_initial), A(U_final)], complex128 numpy MPS (L, chi, p, chi),
    cached per configuration (never per seed) in benchmark/.cache/."""
    keys = {k: cfg[k] for k in ("N", "Npart", "d", "J", "maxBondDim",
                                "U_initial", "U_final", "dmrg")}
    tag = hashlib.sha256(json.dumps(keys, sort_keys=True).encode()
                         ).hexdigest()[:16]
    path = os.path.join(harness.CACHE, "states", f"{cfg['name']}_{tag}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return [z["psi_i"], z["psi_f"]]
    dm = cfg["dmrg"]
    states = [dmrg.ground_state(cfg["N"], cfg["d"], cfg["Npart"], cfg["J"], U,
                                cfg["maxBondDim"], n_sweeps=dm["sweeps"],
                                krylov=dm["krylov"],
                                penalty=dm["number_penalty"],
                                e_tol=dm["e_tol"], device=device)[0]
              for U in (cfg["U_initial"], cfg["U_final"])]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, psi_i=states[0], psi_f=states[1])
    os.replace(tmp, path)
    return states


def setup(cfg, traffic, seed, device, spans):
    enforce_matmul_precision()
    dtype = DTYPES[cfg["precision"]]
    ctx = SimpleNamespace(cfg=cfg, tr=traffic, seed=seed, device=device,
                          dtype=dtype)
    ctx.states = boundary_states(cfg, device)
    ctx.st = tebd.make_stepper(cfg["N"], cfg["d"], cfg["J"], cfg["tstep"],
                               cfg["maxBondDim"], dtype=dtype,
                               trunc_method="eigh", sweep="vidal",
                               device=device)
    cnp = np.complex128 if dtype == torch.complex128 else np.complex64
    ctx.psi = [vidal.from_mps(A.astype(cnp), device=device)
               for A in ctx.states]
    # three steps forward and back run every shape of the window's steps
    u = _controls(ctx, harness.unit_seed(seed, WARM_SALT))[:4]
    vidal.cost_and_gradient(ctx.st, *ctx.psi, u, cfg["gamma"])
    return ctx


def _controls(ctx, s):
    tr = ctx.tr
    u = seeded_ramps(ctx.cfg, 1, tr["modes"], tr["sigma"], s)[0]
    return torch.as_tensor(u, dtype=ctx.dtype.to_real(), device=ctx.device)


def run(ctx, k, spans):
    u = _controls(ctx, harness.unit_seed(ctx.seed, k))
    with spans("cost_and_gradient"):
        J, g = vidal.cost_and_gradient(ctx.st, *ctx.psi, u, ctx.cfg["gamma"])
    return {"work": {"gradients": 1},
            "answers": {"u": u.cpu().numpy(), "J": float(J),
                        "g": g.cpu().numpy()}}


def probes(ctx):
    """CUDA-event times of the bond theta at the two stages' shapes, on the
    initial state's even and odd bonds."""
    from optimalcontrolmps_torch.ops.bond_theta import bond_theta
    B = ctx.psi[0].B
    L = B.shape[0]
    _, chi, p, _ = B.shape
    c128 = ctx.dtype == torch.complex128
    out = []
    for parity in (0, 1):
        bonds = list(range(parity, L - 1, 2))
        Bi = torch.stack([B[b] for b in bonds])
        Bj = torch.stack([B[b + 1] for b in bonds])
        ms = harness.cuda_ms(lambda: bond_theta(Bi, Bj, ctx.st.gate_fwd), 50)
        out.append({"B": len(bonds), "chi": chi, "p": p, "ms": ms,
                    "bound_ms": peaks.bond_theta_ms(len(bonds), chi, p,
                                                    c128)})
    return {"bond_theta": out}


def release(ctx):
    ctx.__dict__.clear()


def check(cfg, traffic, seed, answers, device, control: bool = False):
    """grad_gap: the largest max|g - g_ref| / max|g_ref| over `check_units`
    units drawn from the seed. (The cost is not compared: it sits near 0.5
    at these fidelities, and one precision lower barely moves it.) The
    reference runs in complex128 with the configuration's density jitter;
    control=True runs it in the program's place one precision below the
    stated one (TF32 products for single, float32 for double)."""
    states = boundary_states(cfg, device)
    prec = ref.F64
    if control:
        prec = ref.TF32 if cfg["precision"] == "single" else ref.F32
    args = (cfg["d"], cfg["J"], cfg["tstep"], cfg["maxBondDim"],
            cfg["density_jitter"])
    exact = ref_chain.Stepper(*args, prec=ref.F64, device=device)

    def canon(p):
        out = []
        for A in states:
            Bc, lam = ref_chain.canonical_form(A)
            out.append((torch.as_tensor(Bc, device=device).to(p.cdtype),
                        torch.as_tensor(lam, device=device).to(p.rdtype)))
        return out

    psi = canon(ref.F64)
    if control:
        low = ref_chain.Stepper(*args, prec=prec, device=device)
        psi_low = canon(prec)
    grad_gap = 0.0
    for i in harness.sample(seed, 2, len(answers), traffic["check_units"]):
        a = answers[i]
        _, g = ref_chain.cost_and_gradient(exact, *psi, a["u"], cfg["gamma"])
        gp = a["g"]
        if control:
            gp = ref_chain.cost_and_gradient(low, *psi_low, a["u"],
                                             cfg["gamma"])[1]
        grad_gap = max(grad_gap, float(np.abs(gp - g).max()
                                       / np.abs(g).max()))
    return {"grad_gap": grad_gap}
