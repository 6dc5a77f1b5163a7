"""GROUP optimal control of a ramp: the reference's OptimizeRamp driver.

Counterpart of optimalcontrolmps_tpu/drivers/optimize_ramp.py, L-BFGS mode
(`useBFGS = yes`, the bound-penalized limited-memory analogue of the
reference's IPOPT run) and the finalize step:

    python -m optimalcontrolmps_torch.drivers.optimize_ramp InputFile [seed]

Config keys: tstep, T, N, Npart, d, M, gamma, cacheProgress, maxBondDim,
threshold, optTol, useBFGS, maxIter, precision (single|double), engine
(auto|mps|sector), multistart (lockstep batch of starts), useGRAPE,
exactGradient, newtonPolish, writeHessians, ObjScaling, truncMethod, and
backend (cpu asks for the CPU; the default is the card).

Outputs (the reference's formats): BHrampInitialFinal.txt, ExpectationN.txt,
ProgressCache.txt (cacheProgress), GRAPEHessian.txt and GROUPHessian.txt
(writeHessians), checkpoint.json.

Not ported yet, and refused: `useBFGS = no` (the interior point), engine =
vidal, checkpointEvery / resume / stateCache.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import io
from ..backends import engine_for
from ..config import parse_input_file
from ..mps import expectation_values
from ..optimize import minimize_lbfgs, minimize_lbfgs_batch, minimize_newton
from ..optimize.penalty import bound_penalty
from ..precision import enforce_matmul_precision
from ..sector import expectation_n
from ..sites import op
from ..streaming import rollout_measure
from ..tebd import tebd_step
from .common import build_problem, print_banner, time_axis

__all__ = ["run", "main"]


class _IdentityBasis:
    """GRAPE: the decision variable is the time-sampled control itself."""

    @staticmethod
    def convert_control(c):
        return c

    @staticmethod
    def convert_gradient(g):
        return g

    @staticmethod
    def convert_hessian(H):
        return H


def _refuse_unported(cfg) -> None:
    if not cfg.get_yesno("useBFGS", False):
        raise NotImplementedError(
            "useBFGS = no runs the interior-point optimizer, which the port "
            "does not have yet (ROADMAP Queue 1 item 9, Slice 2); set "
            "useBFGS = yes")
    if cfg.get_string("engine", "auto") == "vidal":
        raise NotImplementedError("engine = vidal: the Vidal engine is not "
                                  "ported yet (ROADMAP Queue 1 item 12)")
    for key in ("resume", "stateCache"):
        if cfg.get_yesno(key, False):
            raise NotImplementedError(
                f"{key} = yes: checkpoint resume and the state cache are "
                f"not ported yet (ROADMAP Queue 1 item 10)")
    if cfg.get_int("checkpointEvery", 0) > 0:
        raise NotImplementedError(
            "checkpointEvery: chunked checkpointing is not ported yet "
            "(ROADMAP Queue 1 item 10)")


def _penalty_and_grad(basis, C):
    """bound_penalty of u(C) and its gradient in C, for (M,) or (B, M)."""
    with torch.enable_grad():
        C = C.detach().requires_grad_(True)
        P = bound_penalty(basis.convert_control(C))
        (gP,) = torch.autograd.grad(P.sum(), C)
    return P.detach(), gP


def run(cfg_path: str, seed: int = 1, out_prefix: str = "") -> dict:
    enforce_matmul_precision()
    cfg = parse_input_file(cfg_path)
    _refuse_unported(cfg)
    p = build_problem(cfg, seed=seed, engine=cfg.get_string("engine", "auto"))
    opt_tol = cfg.get_real("optTol", 1e-7)
    use_grape = cfg.get_yesno("useGRAPE", False)
    max_iter = cfg.get_int("maxIter", 200)
    cache = cfg.get_yesno("cacheProgress", False)
    multistart = cfg.get_int("multistart", 1)
    obj_scaling = cfg.get_real("ObjScaling", 1.0)

    print_banner(p, {"Use BFGS approximation": True,
                     "GRAPE (no parameterization)": use_grape,
                     "Optimization tolerance": opt_tol,
                     "MaxIter": max_iter,
                     "Multistart batch": multistart})

    st, psi_i, psi_f, basis, gamma = (p.stepper, p.psi_i, p.psi_f, p.basis,
                                      p.gamma)
    eng = engine_for(st)
    real = basis.f.dtype
    dev = p.device
    if use_grape:
        basis = _IdentityBasis()

    def cheap(c):
        return obj_scaling * eng.cost(st, psi_i, psi_f,
                                      basis.convert_control(c), gamma)

    # exactGradient: autograd through the rollout (default on the sector
    # engine, whose rollout is truncation-free); the MPS engine has the
    # analytic adjoint only
    exact_grad = cfg.get_yesno("exactGradient", p.kind == "sector")
    if exact_grad and p.kind != "sector":
        raise NotImplementedError(
            "exactGradient = yes on the MPS engine: autodiff through the "
            "truncating rollout is not supported; the engine's gradient is "
            "the analytic adjoint")

    def fg(c):
        """(M,) -> (J, g) for the sector engine or one MPS lane."""
        if exact_grad:
            g, J = torch.func.grad_and_value(cheap)(c)
            return J, g
        J, g_u = eng.cost_and_gradient(st, psi_i, psi_f,
                                       basis.convert_control(c), gamma)
        return obj_scaling * J, obj_scaling * basis.convert_gradient(g_u)

    def fg_batch(C):
        """(B, M) -> (J (B,), G (B, M)): one batched MPS gradient, or the
        one-lane sector objective vmapped over the lanes."""
        if p.kind == "sector":
            return torch.func.vmap(fg)(C)
        J, g_u = eng.cost_and_gradient(st, psi_i, psi_f,
                                       basis.convert_control(C), gamma)
        return obj_scaling * J, obj_scaling * basis.convert_gradient(
            g_u.T).T

    def with_penalty(f):
        def fg_pen(c):
            J, g = f(c)
            P, gP = _penalty_and_grad(basis, c)
            return J + P, g + gP
        return fg_pen

    progress_path = out_prefix + "ProgressCache.txt"
    per_iter_cache = cache and multistart <= 1

    def cb(it, f, gnorm, ls_trials):
        io.append_progress(progress_path, int(it), float(f) / obj_scaling,
                           p.T, io.nprop_per_iteration(
                               p.n_steps, ls_trials=int(ls_trials),
                               exact_hessian=False))

    dim = p.n_steps if use_grape else p.M
    c0 = (p.u0 if use_grape else np.zeros(dim))
    c0 = torch.as_tensor(c0, dtype=real, device=dev)

    t0 = time.time()
    if multistart > 1:
        rng = np.random.default_rng(123456789 * seed + 1)
        cs = c0.cpu().numpy()[None] + rng.normal(
            0.0, 0.5, (multistart, dim)).astype(c0.cpu().numpy().dtype)
        cs[0] = c0.cpu().numpy()
        res = minimize_lbfgs_batch(with_penalty(fg_batch),
                                   torch.as_tensor(cs, device=dev),
                                   max_iter=max_iter, tol=opt_tol)
        fs = res.f.cpu().numpy()
        k = int(np.argmin(fs))
        c_opt = res.x[k]
        status = {"f": float(fs[k]), "iterations": int(res.iterations[k]),
                  "converged": bool(res.converged[k]),
                  "n_evals": int(res.n_evals[k]),
                  "batch_costs": fs.tolist()}
    else:
        res = minimize_lbfgs(with_penalty(fg), c0, max_iter=max_iter,
                             tol=opt_tol,
                             callback=cb if per_iter_cache else None)
        c_opt = res.x
        status = {"f": float(res.f), "iterations": int(res.iterations),
                  "converged": bool(res.converged),
                  "n_evals": int(res.n_evals)}

    # Newton polish on the sector engine: the exact gradient of the computed
    # cost and the exact Hessian reach optTol where the adjoint's O(dt^2)
    # bias would floor ||g||
    if cfg.get_yesno("newtonPolish", True) and p.kind == "sector" \
            and not status["converged"]:
        def fgh_polish(c):
            with torch.enable_grad():
                cc = c.detach().requires_grad_(True)
                J = cheap(cc)
                (g,) = torch.autograd.grad(J, cc)
            H = obj_scaling * basis.convert_hessian(eng.hessian(
                st, psi_i, psi_f, basis.convert_control(c), gamma))
            return J.detach(), g, H

        nres = minimize_newton(fgh_polish, c_opt, fun=cheap, tol=opt_tol,
                               max_iter=30)
        if nres.f <= status["f"]:
            c_opt = nres.x
            status.update({"f": nres.f, "converged": nres.converged,
                           "polish_iterations": nres.iterations,
                           "grad_norm": nres.grad_norm})
    # the reference's accounting: N(2 iterations + extra line-search evals)
    n_iters = max(1, status["iterations"])
    ls_total = max(0, status.get("n_evals", n_iters) - n_iters)
    nprop = p.n_steps * (2 * n_iters + ls_total)
    wall = time.time() - t0
    status["f"] = status["f"] / obj_scaling
    if "batch_costs" in status:
        status["batch_costs"] = [v / obj_scaling
                                 for v in status["batch_costs"]]
    print(f"\n*** Optimization "
          f"{'converged' if status['converged'] else 'finished'}: "
          f"f = {status['f']:.3e} in {status['iterations']} iterations "
          f"({wall:.1f}s)")
    if cache and not per_iter_cache:
        io.append_progress(progress_path, status["iterations"], status["f"],
                           p.T, nprop)

    # finalize (the reference's finalize_solution): fidelity curves with one
    # state in flight, the ramp file, the Hessians, <N_i>(t)
    times = time_axis(p)
    u_init = basis.convert_control(c0)
    u_final = basis.convert_control(c_opt)
    fid_init = eng.fidelities_streaming(st, psi_i, psi_f, u_init)
    fid_final = eng.fidelities_streaming(st, psi_i, psi_f, u_final)
    u_init_np, u_final_np = u_init.cpu().numpy(), u_final.cpu().numpy()
    fid_final_np = fid_final.cpu().numpy()
    io.write_ramp_file(out_prefix + "BHrampInitialFinal.txt", times,
                       u_init_np, fid_init.cpu().numpy(), u_final_np,
                       fid_final_np)

    # writeHessians = yes|no|auto (auto: sector engine or N_t <= 128)
    wh = cfg.get_string("writeHessians", "auto").lower()
    if wh in ("yes", "true", "1") or (
            wh == "auto" and (p.kind == "sector" or p.n_steps <= 128)):
        H_grape = eng.hessian(st, psi_i, psi_f, u_final, gamma)
        io.write_matrix(out_prefix + "GRAPEHessian.txt",
                        H_grape.cpu().numpy())
        io.write_matrix(out_prefix + "GROUPHessian.txt",
                        basis.convert_hessian(H_grape).cpu().numpy())

    if p.kind == "sector":
        expn = expectation_n(st, eng.rollout(st, psi_i, u_final))
    else:
        n_op = op("N", p.d)
        expn = rollout_measure(
            lambda s, ua, ub: tebd_step(st, s, ua, ub, forward=True),
            psi_i[None], u_final,
            lambda s: expectation_values(s, n_op).real[0])
    io.write_expectation_file(out_prefix + "ExpectationN.txt", times,
                              expn.cpu().numpy())

    c_opt_np = c_opt.cpu().numpy()
    io.save_checkpoint(out_prefix + "checkpoint.json", c_opt_np,
                       extra={"cost": status["f"], "seed": seed,
                              "config": dict(cfg.values)})
    return {"c_opt": c_opt_np, "u_final": u_final_np, "status": status,
            "infidelity": float(1.0 - fid_final_np[-1])}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print(f"Usage: {sys.argv[0]} InputFile_BHcontrol [seed]")
        return 0
    seed = int(argv[1]) if len(argv) > 1 else 1
    if len(argv) <= 1:
        print("Default seed used")
    run(argv[0], seed=seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
