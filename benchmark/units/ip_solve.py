"""Unit: one solve of the driver's host-loop interior point
(`drivers.optimize_ramp.solve_ip_host`, the function `optimize_ramp.run`
calls for `useBFGS = no`, `ipMode = host` or `auto` at chi >= 64) on the
long chain, from the driver's own start: c = 0 over the seed ramp of
driver seed 1.

The problem is built once, in set-up, by the driver's `build_problem`
from the configuration's keys, its boundary states the benchmark's DMRG
states (handed over as in `vidal_gradient`). A unit is the configuration's
maxIter interior-point iterations, each one `fgh_host` (the segmented
gradient, `vidal.hessian_streaming`, the GROUP congruence), the KKT step
and its Armijo trials, then the final gradient. Every unit does the same
work: the run's seed changes none of it.

The program's spans (`profiling.collect_spans`) and counters (Hessian row
steps, Vidal and snake Trotter steps, eigh calls by size, interior-point
iterations and trials) go into the unit's `spans` and `counts`.

The check compares, for every unit, the GROUP Hessian, gradient and cost
that the interior point received at the start with the plain reference's
(reference/hessian.py), in complex128; the iterate and multipliers the
unit returned with the plain reference's interior-point iteration from
those (reference/interior_point.py); and the cost the unit returned with
the reference's cost at the unit's iterate.
"""

from __future__ import annotations

import contextlib
import inspect
import sys
from types import SimpleNamespace

import numpy as np
import torch

from optimalcontrolmps_torch import mps as mpslib
from optimalcontrolmps_torch import profiling, streaming, tebd, vidal
from optimalcontrolmps_torch.config import InputGroup
from optimalcontrolmps_torch.drivers import common
from optimalcontrolmps_torch.drivers.optimize_ramp import (ip_on_host,
                                                           solve_ip_host)
from optimalcontrolmps_torch.ops import trunc
from optimalcontrolmps_torch.optimize import interior_point
from optimalcontrolmps_torch.precision import enforce_matmul_precision

from benchmark import harness, peaks
from benchmark.reference import chain as ref_chain
from benchmark.reference import hessian as ref_hess
from benchmark.reference import interior_point as ref_ip
from benchmark.reference import sector as ref
from benchmark.units.vidal_gradient import boundary_states

INPUT_KEYS = ("N", "Npart", "d", "T", "tstep", "maxBondDim", "precision",
              "M", "gamma", "optTol", "maxIter")
DUALS = ("z_lo", "z_hi", "w_lo", "w_hi")
COUNTED = (streaming, tebd, vidal, trunc, interior_point)


def input_group(cfg: dict) -> InputGroup:
    """The InputFile the driver would read: the sizes and the driver's
    keys."""
    values = {k: cfg[k] for k in INPUT_KEYS}
    values.update({k: v for k, v in cfg["driver"].items() if k != "seed"})
    return InputGroup("input", values)


def _check_config(cfg: dict) -> None:
    """The configuration's fixed physics and bounds are the driver's."""
    ip = inspect.signature(interior_point.minimize_interior_point_host)
    want = {"J": common.J_HOP, "U_initial": common.U_INITIAL,
            "U_final": common.U_FINAL,
            "u_bounds": [ip.parameters["g_lb"].default,
                         ip.parameters["g_ub"].default],
            "c_bounds": [ip.parameters["x_lb"].default,
                         ip.parameters["x_ub"].default]}
    bad = {k: (cfg[k], v) for k, v in want.items() if cfg[k] != v}
    if bad:
        raise ValueError(f"the driver is built for other values: {bad} "
                         f"(config, program)")
    if cfg["maxIter"] != 1:
        raise ValueError("the check's reference takes one interior-point "
                         f"iteration; maxIter is {cfg['maxIter']}")


def _counts() -> dict:
    return {"row_steps": streaming.row_steps, "snake_steps": tebd.steps,
            "vidal_steps": vidal.steps, "eigh_calls": dict(trunc.eigh_calls),
            "ip_iterations": interior_point.host_iterations,
            "ls_trials": interior_point.host_trials}


def setup(cfg, traffic, seed, device, spans):
    _check_config(cfg)
    enforce_matmul_precision()
    ctx = SimpleNamespace(cfg=cfg, tr=traffic, seed=seed, device=device)
    ctx.inp = input_group(cfg)
    states = boundary_states(cfg, device)
    dtype = (torch.complex128 if cfg["precision"] == "double"
             else torch.complex64)
    cnp = np.complex128 if dtype == torch.complex128 else np.complex64
    psi = tuple(vidal.from_mps(A.astype(cnp), device=device) for A in states)
    ctx.p = common.build_problem(ctx.inp, seed=cfg["driver"]["seed"],
                                 engine=cfg["driver"]["engine"],
                                 device=device, states=psi)
    if not ip_on_host(ctx.inp, ctx.p):
        raise ValueError("the driver does not take the host interior point "
                         "for this configuration")
    ctx.c0 = torch.zeros(cfg["M"], dtype=ctx.p.basis.f.dtype, device=device)
    _warm_up(ctx)
    return ctx


def _warm_up(ctx) -> None:
    """One call of each shape a solve runs, on the built problem: a Vidal
    step forward and back, dH on a row block, one snake row step at every
    row batch (1 to the block), their overlaps, and the interior point's
    eigenvalues and solve. Nothing is compiled; this makes the solver and
    BLAS handles and the allocator's blocks."""
    p, st = ctx.p, ctx.p.stepper
    u = float(p.basis.u0[0])
    one = vidal.VidalState(p.psi_i.B[None], p.psi_i.lam[None])
    vidal.vidal_step(st, one, u, u)
    vidal.vidal_step(st, one, u, u, forward=False)
    R = streaming.pick_row_block(p.n_steps - 1,
                                 ctx.inp.get_int("hessianRowBlock"))
    rows, _ = mpslib.apply_site_sum_diag(
        vidal.to_mps(one).expand(R, *p.psi_i.B.shape).contiguous(),
        0.5 * st.nn1)
    row_st = vidal._snake_twin(st)
    for k in range(1, R + 1):
        tebd.tebd_step(row_st, rows[:k], u, u)
    mpslib.overlap(rows, rows)
    eye = torch.eye(len(ctx.c0), dtype=ctx.c0.dtype, device=ctx.device)
    torch.linalg.eigvalsh(eye)
    torch.linalg.solve(eye, ctx.c0[:, None])


def _solve(ctx):
    """One solve; (IPResult, [(J, g, H) the solver received]). The
    driver's progress lines go to standard error: standard output is the
    benchmark's result."""
    seen = []

    def observe(c, J, g, H):
        seen.append((J, g, H))

    with contextlib.redirect_stdout(sys.stderr):
        res = solve_ip_host(ctx.inp, ctx.p, ctx.c0, observe=observe)
    return res, seen


def run(ctx, k, spans):
    for mod in COUNTED:
        mod.reset_counts()
    with profiling.collect_spans(ctx.device) as prog:
        with spans("solve"):
            res, seen = _solve(ctx)
            x = res.x.cpu().numpy()
    spans.seconds.update(prog)
    J, g, H = seen[0]
    return {"work": {"solves": 1}, "counts": _counts(),
            "answers": {"J": float(J), "g": g.cpu().numpy(),
                        "H": H.cpu().numpy(), "x": x, "f": float(res.f),
                        "duals": [getattr(res, d).cpu().numpy()
                                  for d in DUALS]}}


def probes(ctx):
    """CUDA-event times of the bond theta at this path's shapes in the
    configuration's precision: the Vidal stages (even and odd bonds of
    the initial state) and the snake rows' batches (1 to the row block
    of identical sites)."""
    from optimalcontrolmps_torch.ops.bond_theta import bond_theta
    st = ctx.p.stepper
    B = ctx.p.psi_i.B
    L, chi, p, _ = B.shape
    c128 = B.dtype == torch.complex128
    shapes = []
    for parity in (0, 1):
        bonds = list(range(parity, L - 1, 2))
        shapes.append((torch.stack([B[b] for b in bonds]),
                       torch.stack([B[b + 1] for b in bonds])))
    n = ctx.p.n_steps
    R = streaming.pick_row_block(n - 1, ctx.inp.get_int("hessianRowBlock"))
    for rows in range(1, R + 1):
        shapes.append((B[L // 2 - 1].expand(rows, chi, p, chi).contiguous(),
                       B[L // 2].expand(rows, chi, p, chi).contiguous()))
    out = []
    for Bi, Bj in shapes:
        ms = harness.cuda_ms(lambda: bond_theta(Bi, Bj, st.gate_fwd), 50)
        out.append({"B": Bi.shape[0], "chi": chi, "p": p, "ms": ms,
                    "bound_ms": peaks.bond_theta_ms(Bi.shape[0], chi, p,
                                                    c128)})
    return {"bond_theta": out}


def release(ctx):
    ctx.__dict__.clear()


def reference_at_start(cfg, device, prec=ref.F64):
    """The plain reference's (J, g_c, H_c) at c = 0, its stepper, its
    canonical boundary states and its basis (u0, S, f)."""
    states = boundary_states(cfg, device)
    n = int(round(cfg["T"] / cfg["tstep"])) + 1
    st = ref_chain.Stepper(cfg["d"], cfg["J"], cfg["tstep"],
                           cfg["maxBondDim"], cfg["density_jitter"],
                           prec=prec, device=device)
    psi = []
    for A in states:
        Bc, lam = ref_chain.canonical_form(A)
        psi.append((torch.as_tensor(Bc, device=device).to(prec.cdtype),
                    torch.as_tensor(lam, device=device).to(prec.rdtype)))
    u0 = ref.linsigmoid_ramp(cfg["U_initial"], cfg["U_final"], n,
                             np.random.default_rng(
                                 123456789 * cfg["driver"]["seed"]))
    S, f = ref.sine_basis(n, cfg["tstep"], cfg["T"], cfg["M"])
    J, g_u, H_u = ref_hess.exact_hessian(st, *psi, u0, cfg["gamma"])
    g, H = ref_hess.group(S, f, g_u, H_u)
    return (J, g, H), st, psi, (u0, S, f)


def reference_answer(cfg, device, prec=ref.F64):
    """What the plain reference makes of a unit: (J, g_c, H_c) at c = 0,
    its interior-point iteration from there, the multipliers it ends with
    and the cost at its iterate, as a unit's answers; and its cost
    function c -> J(u(c))."""
    (J, g, H), st, psi, (u0, S, f) = reference_at_start(cfg, device, prec)
    B = np.asarray(S)[:, None] * np.asarray(f)

    def cost(c):
        return ref_hess.cost(st, *psi, u0 + B @ c, cfg["gamma"])

    step = ref_ip.first_step(cost, J, g, H, np.zeros(cfg["M"]), B, u0,
                             cfg["optTol"],
                             (*cfg["c_bounds"], *cfg["u_bounds"]))
    return {"J": J, "g": g, "H": H, "x": step["x"], "f": cost(step["x"]),
            "duals": [step[d] for d in DUALS]}, cost


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def check(cfg, traffic, seed, answers, device, control: bool = False):
    """hess_gap, grad_gap: max|X - X_ref| / max|X_ref| of the GROUP Hessian
    and gradient the interior point received at the start; cost_gap:
    |J - J_ref| there; step_gap: the same relative gap of the iterate the
    unit returned and of each of its multipliers, the largest, against the
    reference's iteration; step_cost_gap: |J - J_ref| at the iterate the
    unit returned. The largest over every unit, the reference in
    complex128. control=True puts the reference in complex64 in the
    program's place (its own Hessian, iteration and cost)."""
    want, cost = reference_answer(cfg, device)
    if control:
        answers = [reference_answer(cfg, device, ref.F32)[0]]
    gaps = dict.fromkeys(("hess_gap", "grad_gap", "cost_gap", "step_gap",
                          "step_cost_gap"), 0.0)
    for a in answers:
        step = max([_rel(a["x"], want["x"])]
                   + [_rel(v, w) for v, w in zip(a["duals"],
                                                  want["duals"])])
        for name, v in (("hess_gap", _rel(a["H"], want["H"])),
                        ("grad_gap", _rel(a["g"], want["g"])),
                        ("cost_gap", abs(a["J"] - want["J"])),
                        ("step_gap", step),
                        ("step_cost_gap", abs(a["f"] - cost(a["x"])))):
            gaps[name] = max(gaps[name], float(v))
    return gaps
