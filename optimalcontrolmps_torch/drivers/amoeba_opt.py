"""Derivative-free GROUP optimization: the reference's AmoebaOpt driver.

Counterpart of optimalcontrolmps_tpu/drivers/amoeba_opt.py. Nelder-Mead
from the zero GROUP coefficients on the control cost plus the quadratic
bound penalty on the converted control (the reference's OCWrapper: uMin=2,
uMax=100, gammaBound=100):

    python -m optimalcontrolmps_torch.drivers.amoeba_opt InputFile [seed]

Config keys: those of optimize_ramp's problem (engine, precision, backend,
...), gammaBound, maxIter (default 5000), cacheProgress, and multistart: a
lockstep batch of simplices, lane 0 from zero and the others from normal
(sigma 0.5) coefficients. Writes BHrampInitialFinal.txt and, with
cacheProgress, ProgressCache.txt (best cost and propagations per iteration).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import io
from ..backends import engine_for
from ..config import parse_input_file
from ..optimize import make_penalized_cost, minimize_nelder_mead
from ..precision import enforce_matmul_precision
from .common import build_problem, print_banner, time_axis

__all__ = ["run", "main"]


def run(cfg_path: str, seed: int = 1, out_prefix: str = "") -> dict:
    enforce_matmul_precision()
    cfg = parse_input_file(cfg_path)
    p = build_problem(cfg, seed=seed, engine=cfg.get_string("engine", "auto"))
    gamma_bound = cfg.get_real("gammaBound", 100.0)
    max_iter = cfg.get_int("maxIter", 5000)
    cache = cfg.get_yesno("cacheProgress", False)
    multistart = cfg.get_int("multistart", 1)

    print_banner(p, {"gammaBound (penalty)": gamma_bound,
                     "MaxIter (Amoeba)": max_iter,
                     "Multistart batch": multistart})

    st, psi_i, psi_f, basis = p.stepper, p.psi_i, p.psi_f, p.basis
    eng = engine_for(st)

    def cost(C):
        """(k, M) -> (k,): the MPS engine takes the control batch itself;
        the sector engine's one-lane cost is vmapped over it."""
        U = basis.convert_control(C)
        if p.kind == "sector":
            return torch.func.vmap(
                lambda u: eng.cost(st, psi_i, psi_f, u, p.gamma))(U)
        return eng.cost(st, psi_i, psi_f, U, p.gamma)

    f = make_penalized_cost(cost, convert_control=basis.convert_control,
                            gamma_bound=gamma_bound)
    real = basis.f.dtype
    c0 = torch.zeros(p.M, dtype=real, device=p.device)
    t0 = time.time()
    if multistart > 1:
        rng = np.random.default_rng(123456789 * seed + 1)
        cs = np.zeros((multistart, p.M))
        cs[1:] = rng.normal(0.0, 0.5, (multistart - 1, p.M))
        batch = minimize_nelder_mead(
            f, torch.as_tensor(cs, dtype=real, device=p.device),
            max_iter=max_iter)
        k = int(torch.argmin(batch.f))
        res = type(batch)(*(t[k] for t in batch))
    else:
        res = minimize_nelder_mead(f, c0, max_iter=max_iter)
    wall = time.time() - t0
    print(f"Amoeba finished: f = {float(res.f):.6e}, "
          f"{int(res.iterations)} iterations, {int(res.n_evals)} evals "
          f"({wall:.1f}s)")

    if cache:
        hist_f = res.cost_history.cpu().numpy()
        hist_e = res.evals_history.cpu().numpy()
        for it in range(1, int(res.iterations) + 1):
            io.append_progress(out_prefix + "ProgressCache.txt", it,
                               float(hist_f[it]), p.T,
                               int(hist_e[it]) * p.n_steps)

    def fids(c):
        return eng.fidelities(st, psi_i, psi_f,
                              basis.convert_control(c)).cpu().numpy()

    io.write_ramp_file(out_prefix + "BHrampInitialFinal.txt", time_axis(p),
                       basis.convert_control(c0).cpu().numpy(), fids(c0),
                       basis.convert_control(res.x).cpu().numpy(),
                       fids(res.x))
    return {"c_opt": res.x.cpu().numpy(), "f": float(res.f),
            "n_evals": int(res.n_evals), "iterations": int(res.iterations)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print(f"Usage: {sys.argv[0]} InputFile_BHcontrol [seed]")
        return 0
    run(argv[0], seed=int(argv[1]) if len(argv) > 1 else 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
