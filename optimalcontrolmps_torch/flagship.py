"""The flagship multistart solve: the port's main path.

Counterpart of bench.py:44-107,153-311 in the JAX package. The problem is
the reference's flagship: L=5 sites, Npart=5, d=4, T=2.0, dt=0.01 (201
steps), GROUP basis M=10, gamma=1e-6, on the fixed-N sector engine
(121 states, padded to 128). Two phases, on one device, in one process:

1. the chip phase: a lockstep batch L-BFGS (float32 / complex64) over B
   seeds, whose objective runs the fused sector chain (`chain_final`: the
   CUDA kernels on a GPU, the plain twins on the CPU);
2. the polish: the best lane in float64 / complex128, L-BFGS with an
   autograd gradient through `sector.cost` to optTol=1e-8, then
   exact-Hessian Newton (`sector.hessian`).

Entry point: `solve_flagship(B, device)`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import control, sector, seeds
from .device import resolve_device
from .engine import regularization
from .ops.sector_chain import chain_constants, chain_final
from .optimize import minimize_lbfgs, minimize_lbfgs_batch, minimize_newton
from .optimize.penalty import bound_penalty
from .precision import enforce_matmul_precision

__all__ = ["Problem", "make_problem", "multistart_coeffs", "batch_objective",
           "chip_phase", "polish", "solve_flagship"]

T, DT, M, L, D, NPART, GAMMA = 2.0, 0.01, 10, 5, 4, 5, 1e-6
U_I, U_F = 2.5, 50.0   # initial / target interaction strengths
BASIS_SEED = 123456789


@dataclasses.dataclass(frozen=True)
class Problem:
    st: sector.SectorStepper
    psi_i: torch.Tensor
    psi_f: torch.Tensor
    basis: control.ControlBasis
    gamma: float


def make_problem(device=None, f64: bool = False, T: float = T,
                 M: int = M) -> Problem:
    """bench.py:_problem: complex64/float32 unless f64. The basis' seed
    ramp comes from numpy rng BASIS_SEED. device=None means the card."""
    device = resolve_device(device)
    N = int(round(T / DT)) + 1
    cdtype = torch.complex128 if f64 else torch.complex64
    rdtype = torch.float64 if f64 else torch.float32
    st = sector.make_sector_stepper(L, D, NPART, 1.0, DT, dtype=cdtype,
                                    device=device)
    psi_i = sector.sector_ground_state(L, D, NPART, 1.0, U_I, dtype=cdtype,
                                       device=device)
    psi_f = sector.sector_ground_state(L, D, NPART, 1.0, U_F, dtype=cdtype,
                                       device=device)
    u0 = seeds.linsigmoid_seed(U_I, U_F, N,
                               rng=np.random.default_rng(BASIS_SEED))
    basis = control.chopped_sine_basis(u0, DT, T, M, dtype=rdtype,
                                       device=device)
    return Problem(st, psi_i, psi_f, basis, GAMMA)


def multistart_coeffs(B: int, M: int = M, seed: int = 7) -> np.ndarray:
    """(B, M) float32 starts: lane 0 zero, the others N(0, 0.5) from
    numpy rng `seed` (bench.py:205-207)."""
    rng = np.random.default_rng(seed)
    cs = np.zeros((B, M), dtype=np.float32)
    cs[1:] = rng.normal(0.0, 0.5, (B - 1, M)).astype(np.float32)
    return cs


def batch_objective(prob: Problem):
    """fg(C (B, M)) -> (J (B,), dJ/dC (B, M)) through the fused chain
    (bench.py:186-198). It syncs nothing with the host and its shapes do not
    depend on values, so it declares itself `capture_safe`: on the card
    `minimize_lbfgs_batch` replays its trials as CUDA graphs."""
    st, basis, gamma = prob.st, prob.basis, prob.gamma
    psi_f_conj = prob.psi_f.conj()
    consts = chain_constants(st, prob.psi_i)

    def fg(C):
        with torch.enable_grad():
            C = C.detach().requires_grad_(True)
            U = basis.convert_control(C)
            psiT = chain_final(st, U, prob.psi_i, consts)
            ov = psiT @ psi_f_conj
            fid = (ov * ov.conj()).real
            J = (0.5 * (1.0 - fid) + regularization(U, gamma, st.dt)
                 + bound_penalty(U))
            (G,) = torch.autograd.grad(J.sum(), C)
        return J.detach(), G

    fg.capture_safe = True
    return fg


def chip_phase(prob: Problem, cs: np.ndarray, max_iter: int = 150,
               tol: float = 1e-5):
    """Lockstep batch L-BFGS from the (B, M) starts `cs`."""
    X0 = torch.as_tensor(cs, dtype=prob.basis.f.dtype,
                         device=prob.basis.f.device)
    return minimize_lbfgs_batch(batch_objective(prob), X0,
                                max_iter=max_iter, tol=tol)


def polish(prob64: Problem, c0: np.ndarray, tol: float = 1e-8) -> dict:
    """f64 polish of one coefficient vector (bench.py:75-107): L-BFGS with
    the autograd gradient, then exact-Hessian Newton."""
    st, psi_i, psi_f, basis, gamma = (prob64.st, prob64.psi_i, prob64.psi_f,
                                      prob64.basis, prob64.gamma)

    def Jpen(c):
        u = basis.convert_control(c)
        return sector.cost(st, psi_i, psi_f, u, gamma) + bound_penalty(u)

    def fg(c):
        with torch.enable_grad():
            c = c.detach().requires_grad_(True)
            J = Jpen(c)
            (g,) = torch.autograd.grad(J, c)
        return J.detach(), g

    def fgh(c):
        J, g = fg(c)
        H = basis.convert_hessian(sector.hessian(
            st, psi_i, psi_f, basis.convert_control(c), gamma))
        return J, g, H

    x0 = torch.as_tensor(c0, dtype=torch.float64, device=basis.f.device)
    res = minimize_lbfgs(fg, x0, max_iter=200, tol=tol)
    nres = minimize_newton(fgh, res.x, fun=Jpen, tol=tol, max_iter=20)
    best = nres if nres.f <= res.f else res
    fid = float(sector.fidelities(st, psi_i, psi_f,
                                  basis.convert_control(best.x))[-1])
    return {"best_cost_f64": float(best.f),
            "grad_norm_f64": float(best.grad_norm),
            "converged": bool(best.converged),
            "best_infidelity": 1.0 - fid,
            "lbfgs_iters": int(res.iterations),
            "newton_iters": int(nres.iterations)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def solve_flagship(B: int, device=None, max_iter: int = 150,
                   tol: float = 1e-5, seed: int = 7) -> dict:
    """The flagship multistart solve on `device` (None: the card); returns
    bench.py's keys plus the phase wall times and the best lane's
    chip-phase coefficients (`c0`)."""
    enforce_matmul_precision()
    device = resolve_device(device)
    prob = make_problem(device)
    cs = multistart_coeffs(B, prob.basis.M, seed)

    _sync(device)
    t0 = time.perf_counter()
    res = chip_phase(prob, cs, max_iter=max_iter, tol=tol)
    fs = res.f.cpu().numpy()
    chip_s = time.perf_counter() - t0
    its = res.iterations.cpu().numpy()
    k = int(np.argmin(fs))
    c0 = res.x[k].cpu().numpy().astype(np.float64)

    t0 = time.perf_counter()
    pol = polish(make_problem(device, f64=True), c0)
    _sync(device)
    polish_s = time.perf_counter() - t0
    return {
        "batch": B,
        "best_cost_c64": float(fs[k]),
        "median_cost_c64": float(np.median(fs)),
        "all_costs_finite": bool(np.isfinite(fs).all()),
        "iters_min_med_max": [int(its.min()), int(np.median(its)),
                              int(its.max())],
        "max_n_evals": int(res.n_evals.max()),
        **pol,
        "chip_phase_s": chip_s,
        "polish_s": polish_s,
        "c0": c0.tolist(),
    }
