"""GROUP optimal control of a ramp: the reference's OptimizeRamp driver.

Counterpart of optimalcontrolmps_tpu/drivers/optimize_ramp.py:

    python -m optimalcontrolmps_torch.drivers.optimize_ramp InputFile [seed]

Optimizers:
* `useBFGS = no` (the default, the reference's IPOPT run): the exact-Hessian
  interior point, in one of three modes:
  - one ramp, re-entered every `ipChunk` iterations with the multipliers
    and the barrier carried over, a checkpoint after each chunk;
  - `multistart` > 1: a lockstep batch of starts;
  - `ipMode = host` (or `auto` on the MPS and Vidal engines when chi >= 64 or
    N_t > 256): the host-loop solver with the segmented gradient and the
    streaming Hessian (`hessianRowBlock`, `hessianProgress`), a checkpoint
    after every iteration.
* `useBFGS = yes`: bound-penalized L-BFGS (single ramp, optionally in
  `checkpointEvery`-iteration chunks, or a `multistart` lockstep batch),
  then the sector engine's Newton polish.

Config keys: tstep, T, N, Npart, d, M, gamma, cacheProgress, maxBondDim,
threshold, optTol, useBFGS, maxIter, precision (single|double), engine
(auto|mps|vidal|sector), multistart, useGRAPE, exactGradient, newtonPolish,
writeHessians, ObjScaling, truncMethod, muStrategy (monotone|adaptive),
maxCPUHours, ipChunk, ipMode (auto|jit|host), hessianRowBlock,
hessianProgress, checkpointEvery, resume, stateCache, and backend (cpu asks
for the CPU; the default is the card).

Outputs (the reference's formats): BHrampInitialFinal.txt, ExpectationN.txt,
ProgressCache.txt (cacheProgress), GRAPEHessian.txt and GROUPHessian.txt
(writeHessians), checkpoint.json, and states.npz (resume or stateCache).
`resume = yes` restarts from checkpoint.json: its control, and in the
interior point its multipliers and barrier.

`engine = vidal` runs every mode on the canonical-form brick TEBD
(`vidal.py`, truncMethod eigh), whose exact Hessian steps its rows through
a snake twin; long chains take their boundary states from DMRG.

`solve_ip_host` is the host-mode solve alone, on a problem already built
(`common.build_problem`); `ip_on_host` says whether `run` takes it.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import io
from ..backends import engine_for
from ..config import parse_input_file
from ..engine import regularization
from ..optimize import (cold_duals, minimize_interior_point,
                        minimize_interior_point_host, minimize_lbfgs,
                        minimize_lbfgs_batch, minimize_newton)
from ..optimize.penalty import bound_penalty
from ..precision import enforce_matmul_precision
from ..streaming import infidelity_cost
from ..vidal import VidalState
from .common import build_problem, populations, print_banner, time_axis

__all__ = ["run", "main", "solve_ip_host", "ip_on_host"]


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


def _penalty_and_grad(basis, C):
    """bound_penalty of u(C) and its gradient in C, for (M,) or (B, M)."""
    with torch.enable_grad():
        C = C.detach().requires_grad_(True)
        P = bound_penalty(basis.convert_control(C))
        (gP,) = torch.autograd.grad(P.sum(), C)
    return P.detach(), gP


class _SolverSettings(NamedTuple):
    """The optimizer's keys of an InputFile, with the driver's defaults."""
    opt_tol: float
    max_iter: int
    obj_scaling: float
    max_cpu_s: float
    mu_strategy: str


def _solver_settings(cfg) -> _SolverSettings:
    return _SolverSettings(
        opt_tol=cfg.get_real("optTol", 1e-7),
        max_iter=cfg.get_int("maxIter", 200),
        obj_scaling=cfg.get_real("ObjScaling", 1.0),
        max_cpu_s=cfg.get_real("maxCPUHours", 24.0) * 3600.0,
        mu_strategy=cfg.get_string("muStrategy", "monotone"))


def _scaled_cost(p, basis, obj_scaling):
    """c -> obj_scaling * J(u(c)) on the problem's engine."""
    eng = engine_for(p.stepper)
    return lambda c: obj_scaling * eng.cost(
        p.stepper, p.psi_i, p.psi_f, basis.convert_control(c), p.gamma)


def _fidelity_cost(ov, u, gamma, dt):
    return infidelity_cost(ov) + regularization(u, gamma, dt)


def _lane(a, b):
    """Lane b of a batched result: a tensor, or a Vidal state stack."""
    if isinstance(a, VidalState):
        return VidalState(a.B[b], a.lam[b])
    return a[b]


def _duals_list(duals):
    return [v.cpu().numpy().tolist() for v in duals]


def run(cfg_path: str, seed: int = 1, out_prefix: str = "") -> dict:
    enforce_matmul_precision()
    cfg = parse_input_file(cfg_path)
    resume = cfg.get_yesno("resume", False)
    # resumable runs cache the boundary states, so a restart skips them
    state_cache = (out_prefix + "states.npz"
                   if resume or cfg.get_yesno("stateCache", False) else None)
    p = build_problem(cfg, seed=seed, engine=cfg.get_string("engine", "auto"),
                      state_cache=state_cache)
    opt_tol, max_iter, obj_scaling, max_cpu_s, mu_strategy = \
        _solver_settings(cfg)
    use_bfgs = cfg.get_yesno("useBFGS", False)
    use_grape = cfg.get_yesno("useGRAPE", False)
    cache = cfg.get_yesno("cacheProgress", False)
    multistart = cfg.get_int("multistart", 1)
    checkpoint_every = cfg.get_int("checkpointEvery", 0)

    print_banner(p, {"Use BFGS approximation": use_bfgs,
                     "GRAPE (no parameterization)": use_grape,
                     "Optimization tolerance": opt_tol,
                     "MaxIter": max_iter,
                     "Multistart batch": multistart})

    st, psi_i, psi_f, basis, gamma = (p.stepper, p.psi_i, p.psi_f, p.basis,
                                      p.gamma)
    eng = engine_for(st)
    real = basis.f.dtype
    dev = p.device
    path_kw = dict(B=basis.jacobian(), u0=basis.u0)
    if use_grape:
        basis = _IdentityBasis()
        # the variable is u itself: the path bounds become its box
        path_kw = dict(x_lb=2.0, x_ub=100.0, B=None)

    cheap = _scaled_cost(p, basis, obj_scaling)

    def cheap_batch(C):
        if p.kind == "sector":
            return torch.func.vmap(cheap)(C)
        return cheap(C)

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

    def fgh(c):
        """(M,) -> (J, g, H) with the engine's exact Hessian."""
        u = basis.convert_control(c)
        if exact_grad:
            g, J = torch.func.grad_and_value(cheap)(c)
            H = eng.hessian(st, psi_i, psi_f, u, gamma)
            return J, g, obj_scaling * basis.convert_hessian(H)
        g_u, aux = eng.gradient(st, psi_i, psi_f, u, gamma)
        J = _fidelity_cost(aux[3], u, gamma, st.dt)
        H = (eng.hessian(st, psi_i, psi_f, u, gamma) if p.kind == "sector"
             else eng.hessian(st, psi_i, psi_f, u, gamma, aux=aux))
        return (obj_scaling * J, obj_scaling * basis.convert_gradient(g_u),
                obj_scaling * basis.convert_hessian(H))

    def fgh_batch(C):
        """(B, M) -> (J, G, H (B, M, M)): the sector objective vmapped;
        on the MPS engine one batched gradient, then each lane's Hessian
        (whose rows are already one batch)."""
        if p.kind == "sector":
            return torch.func.vmap(fgh)(C)
        U = basis.convert_control(C)
        g_u, aux = eng.gradient(st, psi_i, psi_f, U, gamma)
        J = _fidelity_cost(aux[3], U, gamma, st.dt)
        H = torch.stack([basis.convert_hessian(eng.hessian(
            st, psi_i, psi_f, U[b], gamma,
            aux=tuple(_lane(a, b) for a in aux)))
            for b in range(C.shape[0])])
        return (obj_scaling * J,
                obj_scaling * basis.convert_gradient(g_u.T).T,
                obj_scaling * H)

    def with_penalty(f):
        def fg_pen(c):
            J, g = f(c)
            P, gP = _penalty_and_grad(basis, c)
            return J + P, g + gP
        return fg_pen

    progress_path = out_prefix + "ProgressCache.txt"
    per_iter_cache = cache and multistart <= 1
    history = []   # (iteration, unscaled f) of every one-ramp iteration

    def progress_cb(offset, exact_hessian):
        """The per-iteration ProgressCache writer; the iteration column
        counts on across chunks (offset + the in-chunk iteration)."""
        def cb(it, f, _err, ls_trials):
            history.append((offset + int(it), float(f) / obj_scaling))
            if per_iter_cache:
                io.append_progress(progress_path, offset + int(it),
                                   float(f) / obj_scaling, p.T,
                                   io.nprop_per_iteration(
                                       p.n_steps, ls_trials=int(ls_trials),
                                       exact_hessian=exact_hessian))
        return cb

    dim = p.n_steps if use_grape else p.M
    c0 = p.u0 if use_grape else np.zeros(dim)
    c0 = torch.as_tensor(c0, dtype=real, device=dev)
    ck_path = out_prefix + "checkpoint.json"
    ck_extra = None
    if resume:
        try:
            c_ck, ck_extra = io.load_checkpoint(ck_path)
            c0 = torch.as_tensor(c_ck, dtype=real, device=dev)
            print(f"Resumed from {ck_path} (cost {ck_extra.get('cost')})")
        except FileNotFoundError:
            print("No checkpoint found; cold start")

    def multistart_starts():
        rng = np.random.default_rng(123456789 * seed + 1)
        c0_np = c0.cpu().numpy()
        cs = c0_np[None] + rng.normal(0.0, 0.5, (multistart, dim)).astype(
            c0_np.dtype)
        cs[0] = c0_np
        return torch.as_tensor(cs, device=dev)

    ip = {}   # the interior point's final primal-dual state, for the files
    t0 = time.time()
    if use_bfgs:
        if multistart > 1:
            res = minimize_lbfgs_batch(with_penalty(fg_batch),
                                       multistart_starts(),
                                       max_iter=max_iter, tol=opt_tol)
            fs = res.f.cpu().numpy()
            k = int(np.argmin(fs))
            c_opt = res.x[k]
            status = {"f": float(fs[k]), "iterations": int(res.iterations[k]),
                      "converged": bool(res.converged[k]),
                      "n_evals": int(res.n_evals[k]),
                      "batch_costs": fs.tolist()}
        else:
            # checkpointEvery: chunks of L-BFGS, a checkpoint after each
            chunk = checkpoint_every if checkpoint_every > 0 else max_iter
            c_opt, done_iters, done_evals = c0, 0, 0
            while done_iters < max_iter:
                res = minimize_lbfgs(
                    with_penalty(fg), c_opt,
                    max_iter=min(chunk, max_iter - done_iters), tol=opt_tol,
                    callback=progress_cb(done_iters, False))
                c_opt = res.x
                done_iters += int(res.iterations)
                done_evals += int(res.n_evals)
                if checkpoint_every > 0:
                    io.save_checkpoint(ck_path, c_opt.cpu().numpy(), extra={
                        "cost": float(res.f) / obj_scaling,
                        "iters": done_iters})
                if (checkpoint_every <= 0 or bool(res.converged)
                        or int(res.iterations) < 1):
                    break
                if time.time() - t0 > max_cpu_s:
                    print("maxCPUHours reached; stopping")
                    break
            status = {"f": float(res.f), "iterations": done_iters,
                      "converged": bool(res.converged),
                      "n_evals": done_evals}

        # Newton polish on the sector engine: the exact gradient of the
        # computed cost and the exact Hessian reach optTol where the
        # adjoint's O(dt^2) bias would floor ||g||
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
        # the reference's accounting: N(2 iterations + extra line-search
        # evals)
        n_iters = max(1, status["iterations"])
        ls_total = max(0, status.get("n_evals", n_iters) - n_iters)
        nprop = p.n_steps * (2 * n_iters + ls_total)
    else:
        duals, mu_cur = None, 0.1
        if ck_extra is not None and "duals" in ck_extra:
            duals = tuple(torch.as_tensor(v, dtype=real, device=dev)
                          for v in ck_extra["duals"])
            mu_cur = float(ck_extra.get("mu", mu_cur))
        if duals is not None:
            ip["resumed_from"] = {"x": c0.cpu().numpy().tolist(),
                                  "mu": mu_cur, "duals": _duals_list(duals)}
        if ip_on_host(cfg, p, multistart):
            res = solve_ip_host(cfg, p, c0, duals=duals, mu0=mu_cur,
                                ck_path=ck_path,
                                callback=progress_cb(0, True), basis=basis,
                                path_kw=path_kw)
            c_opt, mu_fin = res.x, float(res.mu)
            done_iters = int(res.iterations)
        elif multistart > 1:
            res = minimize_interior_point(
                fgh_batch, multistart_starts(), tol=opt_tol,
                max_iter=max_iter, fun=cheap_batch, fun_grad=fg_batch,
                mu_strategy=mu_strategy, **path_kw)
            fs = res.f.cpu().numpy()
            k = int(np.argmin(fs))
            ip["batch_costs"] = fs.tolist()
            res = type(res)(*(v[k] for v in res))
            c_opt, mu_fin = res.x, float(res.mu)
            done_iters = int(res.iterations)
        else:
            # one ramp in chunks of ipChunk iterations, the multipliers and
            # the barrier carried over, a checkpoint after each chunk
            chunk_iters = max(1, min(max_iter, cfg.get_int("ipChunk", 25)))
            c_opt = c0
            if duals is None:
                duals = cold_duals(c_opt, mu_cur, **path_kw)
            done_iters = 0
            while done_iters < max_iter:
                res = minimize_interior_point(
                    fgh, c_opt, tol=opt_tol, max_iter=chunk_iters, fun=cheap,
                    fun_grad=fg, callback=progress_cb(done_iters, True),
                    mu0=mu_cur, mu_strategy=mu_strategy, duals0=duals,
                    **path_kw)
                c_opt = res.x
                duals = (res.z_lo, res.z_hi, res.w_lo, res.w_hi)
                done_iters += max(1, int(res.iterations))
                mu_cur = max(float(res.mu), opt_tol / 11.0)
                io.save_checkpoint(ck_path, c_opt.cpu().numpy(), extra={
                    "cost": float(res.f) / obj_scaling, "iters": done_iters,
                    "kkt": float(res.kkt_error), "mu": mu_cur,
                    "duals": _duals_list(duals)})
                if bool(res.converged):
                    break
                if time.time() - t0 > max_cpu_s:
                    print("maxCPUHours reached; stopping")
                    break
            mu_fin = mu_cur
        status = {"f": float(res.f), "iterations": done_iters,
                  "converged": bool(res.converged),
                  "kkt_error": float(res.kkt_error)}
        if "batch_costs" in ip:
            status["batch_costs"] = ip.pop("batch_costs")
        ip.update({"mu": mu_fin, "duals": _duals_list(
            (res.z_lo, res.z_hi, res.w_lo, res.w_hi))})
        nprop = io.nprop_per_iteration(p.n_steps, ls_trials=0,
                                       exact_hessian=True) \
            * max(1, status["iterations"])
    wall = time.time() - t0
    status["f"] = status["f"] / obj_scaling
    if "batch_costs" in status:
        status["batch_costs"] = [v / obj_scaling
                                 for v in status["batch_costs"]]
    if multistart <= 1:
        status["history"] = history
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

    expn = populations(p, u_final)
    io.write_expectation_file(out_prefix + "ExpectationN.txt", times,
                              expn.cpu().numpy())

    # the final checkpoint: the cost unscaled, and after the interior
    # point its primal-dual state, so an extended run resumes warm
    c_opt_np = c_opt.cpu().numpy()
    extra = {"cost": status["f"], "seed": seed, "config": dict(cfg.values)}
    if "duals" in ip:
        extra.update({"duals": ip["duals"], "mu": ip["mu"],
                      "iters": status["iterations"],
                      "kkt": status["kkt_error"]})
    io.save_checkpoint(ck_path, c_opt_np, extra=extra)
    out = {"c_opt": c_opt_np, "u_final": u_final_np, "status": status,
           "infidelity": float(1.0 - fid_final_np[-1])}
    if "resumed_from" in ip:
        out["resumed_from"] = ip["resumed_from"]
    return out


def ip_on_host(cfg, p, multistart: int = 1) -> bool:
    """Whether `useBFGS = no` takes the host-loop interior point: one ramp
    on the MPS or Vidal engine (the sector engine's states are small
    vectors), with ipMode = host, or auto when chi >= 64 or N_t > 256."""
    ip_mode = cfg.get_string("ipMode", "auto")
    return (p.kind != "sector" and multistart <= 1
            and (ip_mode == "host"
                 or (ip_mode == "auto"
                     and (p.chi >= 64 or p.n_steps > 256))))


def solve_ip_host(cfg, p, c0, duals=None, mu0: float = 0.1, ck_path=None,
                  callback=None, basis=None, path_kw=None, observe=None):
    """ipMode = host: the host-loop interior point on the problem p (MPS or
    Vidal engine) from c0, with the segmented gradient, the streaming
    Hessian, the config's `_solver_settings`, hessianRowBlock and
    hessianProgress.

    duals, mu0: the multipliers and the barrier to start from (duals None:
    a cold start). basis: the decision variable's map to u, and path_kw
    the solver's bounds (None: p.basis, GROUP, with its path constraint).
    ck_path: the checkpoint written after every iteration (None: none).
    callback: minimize_interior_point_host's. observe(c, J, g, H), when
    given, sees every (J, g, H) the solver receives. Returns its
    IPResult."""
    st, psi_i, psi_f, gamma = p.stepper, p.psi_i, p.psi_f, p.gamma
    eng = engine_for(st)
    basis = p.basis if basis is None else basis
    if path_kw is None:
        path_kw = dict(B=basis.jacobian(), u0=basis.u0)
    opts = _solver_settings(cfg)
    obj_scaling = opts.obj_scaling
    row_block = cfg.get_int("hessianRowBlock", 64)
    verbose = cfg.get_yesno("hessianProgress", True)

    def fg_aux(c):
        u = basis.convert_control(c)
        g_u, aux = eng.gradient_segmented(st, psi_i, psi_f, u, gamma)
        return u, _fidelity_cost(aux[2], u, gamma, st.dt), g_u, aux

    def fgh_host(c):
        t_h = time.time()
        u, J, g_u, aux = fg_aux(c)
        prog = ((lambda c_, s_: print(
            f"    hessian block i0={c_} j0={s_} "
            f"({time.time() - t_h:.0f}s)", flush=True)) if verbose else None)
        H = eng.hessian_streaming(st, psi_i, psi_f, u, gamma, aux=aux,
                                  row_block=row_block, progress=prog)
        g_c = basis.convert_gradient(g_u)
        print(f"  fgh: J={float(J):.6e} |g|={float(g_c.abs().max()):.3e} "
              f"wall {time.time() - t_h:.1f}s", flush=True)
        out = (obj_scaling * J, obj_scaling * g_c,
               obj_scaling * basis.convert_hessian(H))
        if observe is not None:
            observe(c, *out)
        return out

    def fg_host(c):
        _, J, g_u, _ = fg_aux(c)
        return obj_scaling * J, obj_scaling * basis.convert_gradient(g_u)

    def ck_cb(it, sd, f, kkt):
        io.save_checkpoint(ck_path, sd["x"], extra={
            "cost": f / obj_scaling, "iters": it, "kkt": kkt,
            "mu": float(sd["mu"]),
            "duals": [sd[k].tolist() for k in
                      ("z_lo", "z_hi", "w_lo", "w_hi")]})

    return minimize_interior_point_host(
        fgh_host, c0, tol=opts.opt_tol, max_iter=opts.max_iter,
        fun=_scaled_cost(p, basis, obj_scaling), fun_grad=fg_host,
        callback=callback, checkpoint_cb=None if ck_path is None else ck_cb,
        mu0=mu0, mu_strategy=opts.mu_strategy, duals0=duals,
        max_seconds=opts.max_cpu_s, **path_kw)


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
