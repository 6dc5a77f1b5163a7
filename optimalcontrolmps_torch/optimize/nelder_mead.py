"""Nelder-Mead simplex: the reference's Amoeba, one problem or a lockstep
batch.

Counterpart of optimalcontrolmps_tpu/optimize/nelder_mead.py, with the
reference's constants: reflection rho = 1, expansion chi = 2, contraction
psi = 0.5, shrink sigma = 0.5 toward the second-best vertex; the simplex
starts at x0 and x0 with coordinate i scaled by 1 + usual_delta (0.05), or
set to zero_term_delta (2.5e-4) where it is 0; the search stops after
max_iter iterations or max_fun evaluations, or when every vertex's value is
within tol_fun (1e-6) of the best.

A batch of simplices steps in lockstep; finished lanes are frozen. Each
iteration evaluates the trial points each lane's decision tree needs, one
batched objective call per kind of trial (reflection, expansion, outer and
inner contraction, shrink), where the JAX package evaluates all of them for
every lane. The counts and the results are the same.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["NelderMeadResult", "minimize_nelder_mead"]


class NelderMeadResult(NamedTuple):
    """Tensors of one problem, or with a leading lane axis for a batch."""
    x: torch.Tensor
    f: torch.Tensor
    iterations: torch.Tensor
    n_evals: torch.Tensor
    converged: torch.Tensor
    cost_history: torch.Tensor    # (max_iter+1,): best f; tail = final
    evals_history: torch.Tensor   # (max_iter+1,): evaluations so far


def _sort(v, f):
    order = torch.argsort(f, dim=1, stable=True)
    return (torch.gather(v, 1, order[..., None].expand_as(v)),
            torch.gather(f, 1, order))


def _eval_where(fun, mask, X, fill):
    """fun on the rows of X (k, n) where mask (k,), `fill` elsewhere."""
    out = torch.full(mask.shape, fill, dtype=X.dtype, device=X.device)
    idx = torch.nonzero(mask).flatten()
    if idx.numel():
        out[idx] = fun(X[idx])
    return out


def minimize_nelder_mead(fun: Callable, x0, max_iter: int = 5000,
                         max_fun: int = 5000, tol_fun: float = 1e-6,
                         usual_delta: float = 0.05,
                         zero_term_delta: float = 2.5e-4
                         ) -> NelderMeadResult:
    """Minimize from x0 (n,) or a lockstep batch x0 (B, n). fun is batched:
    (k, n) -> (k,)."""
    single = x0.dim() == 1
    X0 = x0[None] if single else x0
    B, n = X0.shape
    dev, dtype = X0.device, X0.dtype
    rho, chi, psi, sigma = 1.0, 2.0, 0.5, 0.5
    ar = torch.arange(n, device=dev)

    # the initial simplex: x0, then x0 with one coordinate moved
    xi = torch.where(X0 != 0, (1.0 + usual_delta) * X0,
                     torch.full_like(X0, zero_term_delta))
    moved = X0[:, None, :].repeat(1, n, 1)
    moved[:, ar, ar] = xi
    v = torch.cat([X0[:, None, :], moved], dim=1)
    f = fun(v.reshape(B * (n + 1), n)).reshape(B, n + 1)
    v, f = _sort(v, f)

    i64 = dict(dtype=torch.int64, device=dev)
    hist_f = torch.zeros((B, max_iter + 1), dtype=dtype, device=dev)
    hist_f[:, 0] = f[:, 0]
    hist_f[:, 1] = f[:, 0]
    hist_e = torch.zeros((B, max_iter + 1), **i64)
    hist_e[:, 1] = n + 1
    s = {"v": v, "f": f, "it": torch.ones(B, **i64),
         "evals": torch.full((B,), n + 1, **i64),
         "done": torch.zeros(B, dtype=torch.bool, device=dev),
         "hist_f": hist_f, "hist_e": hist_e}

    while True:
        idx = torch.nonzero(~s["done"]).flatten()
        if idx.numel() == 0:
            break
        v, f = s["v"][idx], s["f"][idx]
        worst = v[:, -1]
        xbar = torch.mean(v[:, :-1], dim=1)
        xr = (1.0 + rho) * xbar - rho * worst
        fxr = fun(xr)
        evals = s["evals"][idx] + 1

        expand = fxr < f[:, 0]
        xe = (1.0 + rho * chi) * xbar - rho * chi * worst
        fxe = _eval_where(fun, expand, xe, float("nan"))
        use_e = expand & (fxe < fxr)

        reflect_mid = ~expand & (fxr < f[:, -2])
        contract_out = ~expand & ~reflect_mid & (fxr < f[:, -1])
        xc = (1.0 + psi * rho) * xbar - psi * rho * worst
        fxc = _eval_where(fun, contract_out, xc, float("nan"))
        use_co = contract_out & (fxc <= fxr)

        contract_in = ~expand & ~reflect_mid & ~contract_out
        xcc = (1.0 - psi) * xbar + psi * worst
        fxcc = _eval_where(fun, contract_in, xcc, float("nan"))
        use_ci = contract_in & (fxcc < f[:, -1])
        evals = evals + expand.long() + contract_out.long() \
            + contract_in.long()

        # replace the worst vertex
        c = lambda m: m[:, None]
        new_x = torch.where(c(use_e), xe, torch.where(
            c(expand | reflect_mid), xr, torch.where(
                c(use_co), xc, torch.where(c(use_ci), xcc, worst))))
        new_f = torch.where(use_e, fxe, torch.where(
            expand | reflect_mid, fxr, torch.where(
                use_co, fxc, torch.where(use_ci, fxcc, f[:, -1]))))
        v1 = torch.cat([v[:, :-1], new_x[:, None]], dim=1)
        f1 = torch.cat([f[:, :-1], new_f[:, None]], dim=1)

        # shrink toward vertex 1 (the reference's v.at(1)); vertex 0 stays
        shrink = (contract_out & ~use_co) | (contract_in & ~use_ci)
        sv = v[:, 1:2] + sigma * (v - v[:, 1:2])
        sv = torch.cat([v[:, :1], sv[:, 1:]], dim=1)
        sf = f.clone()
        ks = torch.nonzero(shrink).flatten()
        if ks.numel():
            sf[ks, 1:] = fun(sv[ks, 1:].reshape(-1, n)).reshape(-1, n)
        evals = evals + n * shrink.long()

        v2 = torch.where(shrink[:, None, None], sv, v1)
        f2 = torch.where(shrink[:, None], sf, f1)
        v2, f2 = _sort(v2, f2)

        it = s["it"][idx] + 1
        spread = torch.amax(torch.abs(f2[:, :1] - f2[:, 1:]), dim=1)
        done = (spread <= tol_fun) | (it >= max_iter) | (evals >= max_fun)
        hf, he = s["hist_f"][idx], s["hist_e"][idx]
        rows = torch.nonzero(it <= max_iter).flatten()  # max_iter = 1 overruns
        hf[rows, it[rows]] = f2[rows, 0]
        he[rows, it[rows]] = evals[rows]
        for key, val in (("v", v2), ("f", f2), ("it", it), ("evals", evals),
                         ("done", done), ("hist_f", hf), ("hist_e", he)):
            s[key] = s[key].clone()
            s[key][idx] = val

    f = s["f"]
    spread = torch.amax(torch.abs(f[:, :1] - f[:, 1:]), dim=1)
    tail = torch.arange(max_iter + 1, device=dev)[None, :] > s["it"][:, None]
    res = NelderMeadResult(
        x=s["v"][:, 0], f=f[:, 0], iterations=s["it"], n_evals=s["evals"],
        converged=spread <= tol_fun,
        cost_history=torch.where(tail, f[:, :1], s["hist_f"]),
        evals_history=torch.where(tail, s["evals"][:, None], s["hist_e"]))
    return NelderMeadResult(*(t[0] for t in res)) if single else res
