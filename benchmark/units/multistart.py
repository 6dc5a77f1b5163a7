"""Unit: one multistart batch of the flagship solve and the polish of its
best lane (`flagship.chip_phase`, then `flagship.polish`).

Unit k starts its lanes from the coefficient rows of the traffic's pool
batch k mod len(pool) (numpy rng seed: lane 0 at zero, the rest
N(0, sigma); the pool [7] is the flagship solve's own batch, the
deployment measured), its lanes in an order drawn from the run's seed and
k. Every lane runs alone, so the order changes no lane's work and every
seed gets the same work: the window holds whole units of one length.

The check takes every unit's best lane and a sample of its lanes drawn
from the seed: the cost and the gradient's max norm that the lockstep
L-BFGS reports for each (the sector-chain kernels' values at its iterate)
against the reference's at the same coefficients; how far the optimizer
took them (the median of their reference gradients' max norm, and the
best lane's distance in cost from the reference's own optimum near it);
and the polished optimum against the reference's own Newton polish from
the same start.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from optimalcontrolmps_torch import flagship
from optimalcontrolmps_torch.ops import sector_chain
from optimalcontrolmps_torch.precision import enforce_matmul_precision

from benchmark import harness, peaks
from benchmark.reference import sector as ref


def _check_config(cfg: dict) -> None:
    want = {"N": flagship.L, "d": flagship.D, "Npart": flagship.NPART,
            "tstep": flagship.DT, "gamma": flagship.GAMMA,
            "U_initial": flagship.U_I, "U_final": flagship.U_F,
            "basis_seed": flagship.BASIS_SEED}
    bad = {k: (cfg[k], v) for k, v in want.items() if cfg[k] != v}
    if bad:
        raise ValueError(f"the flagship solve is built for other sizes: "
                         f"{bad} (config, program)")


def starts(lanes: int, M: int, sigma: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    cs = np.zeros((lanes, M), dtype=np.float32)
    cs[1:] = rng.normal(0.0, sigma, (lanes - 1, M)).astype(np.float32)
    return cs


def unit_starts(cfg, tr, seed, k) -> np.ndarray:
    """Unit k's starts: pool batch k mod len(pool), lanes permuted."""
    pool = tr["pool"]
    cs = starts(tr["lanes"], cfg["M"], tr["start_sigma"], pool[k % len(pool)])
    perm = np.random.default_rng(harness.unit_seed(seed, k)).permutation(
        tr["lanes"])
    return cs[perm]


def setup(cfg, traffic, seed, device, spans):
    _check_config(cfg)
    enforce_matmul_precision()
    ctx = SimpleNamespace(cfg=cfg, tr=traffic, seed=seed, device=device)
    ctx.prob = flagship.make_problem(device, T=cfg["T"], M=cfg["M"])
    ctx.prob64 = flagship.make_problem(device, f64=True, T=cfg["T"],
                                       M=cfg["M"])
    # one lockstep iteration at the unit's batch builds and runs the
    # kernels at the window's shapes; a coarse polish runs every operation
    # of the polish once
    flagship.chip_phase(ctx.prob, unit_starts(cfg, traffic, seed, 0),
                        max_iter=1, tol=traffic["tol"])
    flagship.polish(ctx.prob64, np.zeros(cfg["M"]), tol=1e-3)
    return ctx


def run(ctx, k, spans):
    tr = ctx.tr
    B = tr["lanes"]
    s = harness.unit_seed(ctx.seed, k)
    cs = unit_starts(ctx.cfg, tr, ctx.seed, k)
    n0 = sector_chain.fwd_launches
    with spans("chip_phase"):
        res = flagship.chip_phase(ctx.prob, cs, max_iter=tr["max_iter"],
                                  tol=tr["tol"])
        f = res.f.cpu().numpy()
    trials = sector_chain.fwd_launches - n0
    best = int(np.argmin(f))
    c0 = res.x[best].cpu().numpy().astype(np.float64)
    with spans("polish"):
        pol = flagship.polish(ctx.prob64, c0)
    lanes = sorted(set(harness.sample(s, 1, B, tr["check_lanes"])) | {best})
    ctx.last = res
    idx = torch.as_tensor(lanes, device=res.x.device)
    return {
        "work": {"solves": B},
        "counts": {"trials": trials},
        "answers": {"x": res.x[idx].cpu().numpy(), "f": f[lanes],
                    "gn": res.grad_norm[idx].cpu().numpy(),
                    "best": lanes.index(best), "c0": c0,
                    "polish_cost": pol["best_cost_f64"]}}


def probes(ctx):
    """CUDA-event times of the two chain kernels' public calls at the
    window's (lanes, N_t), on the last unit's final controls."""
    st = ctx.prob.st
    consts = sector_chain.chain_constants(st, ctx.prob.psi_i)
    Wr, Wi, nn1, h0r, h0i = consts
    u = ctx.prob.basis.convert_control(ctx.last.x).to(Wr.dtype).contiguous()
    B, n_t = u.shape
    hT = sector_chain.chain_fwd(st.dt, Wr, Wi, nn1, u, h0r, h0i)
    g = torch.Generator(device=u.device).manual_seed(ctx.seed % (1 << 63))
    gT = [torch.randn(hT[0].shape, generator=g, device=u.device)
          for _ in range(2)]
    reps = 20
    out = {}
    for name, fn in (
            ("sector_chain_fwd",
             lambda: sector_chain.chain_fwd(st.dt, Wr, Wi, nn1, u, h0r, h0i)),
            ("sector_chain_bwd",
             lambda: sector_chain.chain_bwd(st.dt, Wr, Wi, nn1, u, *hT,
                                            *gT))):
        out[name] = {"ms": harness.cuda_ms(fn, reps), "B": B, "n_t": n_t,
                     "ns": st.ns,
                     "bound_ms": peaks.sector_chain_ms(name[-3:], B, n_t,
                                                       st.ns)}
    return out


def release(ctx):
    ctx.__dict__.clear()


def check(cfg, traffic, seed, answers, device, control: bool = False):
    """The compared numbers over the checked lanes of every unit: the
    largest gaps of cost and gradient against the reference; how far the
    optimizer took the lanes: the median of the reference's |g|_inf at the
    returned x (`lane_grad_median`; about half the lanes stall in float32
    a little above tol, so a share of lanes above tol does not separate a
    sound optimizer from a broken one) and the best lane's cost above the
    reference's polished optimum from it (`best_lane_gap`); and the
    polished optimum's gap.
    control=True puts the reference in the program's place, in the next
    precision below the one stated: TF32 products for the float32 lanes,
    float32 for the float64 polish (the optimizer's readings are the
    reference's own at the program's x and do not change)."""
    exact = ref.GroupProblem(cfg, ref.F64, device)
    lanes_ctl = ref.GroupProblem(cfg, ref.TF32, device) if control else None
    polish_ctl = ref.GroupProblem(cfg, ref.F32, device) if control else None
    gaps = dict.fromkeys(("lane_cost_gap", "lane_grad_gap",
                          "best_lane_gap", "polish_cost_gap"), 0.0)
    ref_gn = []
    for a in answers:
        J, G = exact.value_and_grad(a["x"].astype(np.float64))
        J = J.cpu().numpy()
        gn = G.abs().amax(-1).cpu().numpy()
        f, g = a["f"], a["gn"]
        if control:
            Jc, Gc = lanes_ctl.value_and_grad(a["x"])
            f, g = Jc.cpu().numpy(), Gc.abs().amax(-1).cpu().numpy()
        gaps["lane_cost_gap"] = max(gaps["lane_cost_gap"], float(
            np.max(np.abs(f - J))))
        gaps["lane_grad_gap"] = max(gaps["lane_grad_gap"],
                                    float(np.max(np.abs(g - gn))))
        ref_gn.append(gn)
        Jp = exact.polish(a["c0"])
        gaps["best_lane_gap"] = max(gaps["best_lane_gap"],
                                    float(J[a["best"]] - Jp))
        pc = polish_ctl.polish(a["c0"]) if control else a["polish_cost"]
        gaps["polish_cost_gap"] = max(gaps["polish_cost_gap"], abs(pc - Jp))
    gaps["lane_grad_median"] = float(np.median(np.concatenate(ref_gn)))
    return gaps
