"""Damped-Newton polish with the exact Hessian.

Counterpart of optimalcontrolmps_tpu/optimize/newton.py: L-BFGS finds the
basin, then a few Newton steps with the engine's exact Hessian drive
||g||_inf below optTol quadratically. H is Levenberg-shifted to positive
definite (smallest eigenvalue from `torch.linalg.eigvalsh`), the step comes
from `torch.linalg.solve`, and an Armijo backtracking search on f guards it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["NewtonResult", "minimize_newton"]


class NewtonResult(NamedTuple):
    x: torch.Tensor
    f: float
    grad_norm: float
    iterations: int
    converged: bool


def minimize_newton(fun_grad_hess: Callable, x0, *, fun: Callable,
                    tol: float = 1e-8, max_iter: int = 30,
                    max_ls: int = 25) -> NewtonResult:
    """Minimize f via damped Newton. fun_grad_hess(x) -> (f, g, H);
    fun(x) -> f, the cheap objective of the backtracking search.

    Stops when ||g||_inf < tol or a backtracking search finds no decrease.
    Each iterate's (f, g, H) is evaluated once and carried into the next
    iteration."""
    eye = torch.eye(x0.shape[0], dtype=x0.dtype, device=x0.device)
    x = x0
    fv, g, H = fun_grad_hess(x0)
    f = float(fv)
    it = 0
    done = False
    while not done and it < max_iter:
        H = 0.5 * (H + H.T)
        wmin = float(torch.linalg.eigvalsh(H)[0])
        lam = max(0.0, 1e-12 - wmin) + 1e-14
        dx = torch.linalg.solve(H + lam * eye, -g)
        if not float(torch.dot(dx, g)) < 0:
            dx = -g  # steepest descent when the solve is not a descent
        dphi = float(torch.dot(g, dx))

        # first step of 1, 1/2, 1/4, ... that satisfies Armijo
        a, found = 1.0, False
        for _ in range(max_ls):
            if float(fun(x + a * dx)) <= f + 1e-4 * a * dphi:
                found = True
                break
            a *= 0.5

        it += 1
        if not found:
            done = True
            break
        x = x + a * dx
        fv, g, H = fun_grad_hess(x)
        f = float(fv)
        done = float(torch.max(torch.abs(g))) < tol

    gnorm = float(torch.max(torch.abs(g)))
    return NewtonResult(x=x, f=f, grad_norm=gnorm, iterations=it,
                        converged=gnorm < tol)
