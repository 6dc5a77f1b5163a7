"""Primal-dual interior point for the control NLP: the reference's IPOPT run.

Counterpart of optimalcontrolmps_tpu/optimize/interior_point.py, with the
same iteration arithmetic. It minimizes J(x) subject to

    box bounds       x in [x_lb, x_ub]^M
    path constraint  u(x) = u0 + B x in [g_lb, g_ub]^N  (B constant)

with bound multipliers (z, w) as independent variables, Newton steps on the
reduced KKT system

    [H + Z_lo/S_lo + Z_hi/S_hi + B^T (W_lo/T_lo + W_hi/T_hi) B] dx = rhs

(H Levenberg-shifted to positive definite, then a three-level trust-region
solve), fraction-to-boundary step limits, Armijo backtracking on the
barrier merit, and a monotone or adaptive barrier schedule.

Two drivers over the same `_IPCore`:

* `minimize_interior_point` solves one problem, x0 (M,), or B problems in
  lockstep, x0 (B, M). The objective sees the batch of live lanes once per
  iteration and once per line-search trial; finished lanes are frozen, so
  lane b walks the iterates the JAX package's vmapped lane b walks. The
  line search stops once every live lane has its step (the JAX package
  always evaluates 20 halvings and keeps the first success: the accepted
  step is the same).
* `minimize_interior_point_host` solves one problem whose f/g/H is an
  arbitrary host-driven composite (the streaming exact Hessian), with an
  early-exit line search, per-iteration checkpoints and a wall-clock limit.

Linear algebra is `torch.linalg.eigvalsh` and `torch.linalg.solve`, batched
over lanes (the JAX package's LAPACK route on CPU and GPU).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["IPResult", "minimize_interior_point",
           "minimize_interior_point_host", "cold_duals"]


def cold_duals(x0, mu0=0.1, x_lb=-20.0, x_ub=20.0, B=None, u0=None,
               g_lb=2.0, g_ub=100.0):
    """The solver's cold-start multipliers (z, w) = mu/s for x0 ((M,) or
    (B, M)), as a (z_lo, z_hi, w_lo, w_hi) tuple for `duals0=`."""
    margin = 1e-2 * (x_ub - x_lb)
    x = torch.clamp(x0, x_lb + margin, x_ub - margin)
    if B is None:
        u = torch.full((*x0.shape[:-1], 1), 0.5 * (g_lb + g_ub),
                       dtype=x0.dtype, device=x0.device)
    else:
        B = torch.as_tensor(B, dtype=x0.dtype, device=x0.device)
        u = torch.as_tensor(u0, dtype=x0.dtype, device=x0.device) + x @ B.T
    return (mu0 / (x - x_lb), mu0 / (x_ub - x),
            mu0 / (u - g_lb), mu0 / (g_ub - u))


class IPResult(NamedTuple):
    """Tensors of one problem, or (B,)-leading tensors of a batch. mu and
    the multipliers are the final primal-dual state: pass them back as
    mu0= and duals0= to continue a chunked or checkpointed solve."""
    x: torch.Tensor
    f: torch.Tensor
    kkt_error: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    mu: torch.Tensor
    z_lo: torch.Tensor
    z_hi: torch.Tensor
    w_lo: torch.Tensor
    w_hi: torch.Tensor


def _col(v):
    """(B,) -> (B, 1) for per-lane scalars against (B, n) vectors."""
    return v[:, None]


def _amax(v):
    return torch.amax(v, dim=-1)


def _amin(v):
    return torch.amin(v, dim=-1)


class _IPCore:
    """The iteration math of both drivers, on lane batches: every state
    entry carries a leading lane axis (x (B, M), mu (B,), ...)."""

    def __init__(self, fun, n, dtype, device, B, u0, have_path, npath,
                 x_lb, x_ub, g_lb, g_ub, tol, frac_to_boundary, kappa_mu,
                 theta_mu, mu_strategy, trust_min, trust_max):
        self.fun = fun
        self.n, self.dtype, self.device = n, dtype, device
        self.B, self.u0 = B, u0
        self.have_path, self.npath = have_path, npath
        self.x_lb, self.x_ub = x_lb, x_ub
        self.g_lb, self.g_ub = g_lb, g_ub
        self.tol = tol
        self.ftb = frac_to_boundary
        self.kappa_mu, self.theta_mu = kappa_mu, theta_mu
        self.mu_strategy = mu_strategy
        self.trust_min, self.trust_max = trust_min, trust_max
        self.eye = torch.eye(n, dtype=dtype, device=device)
        # slack floor at the dtype's rounding scale: a fraction-to-boundary
        # step can land within rounding of a bound in float32, and a zero
        # slack turns mu/s and the dual steps into inf/NaN
        self.eps = 1e-7 if dtype == torch.float32 else 1e-14

    def bt(self, w):
        """B^T w per lane: (B, npath) -> (B, M)."""
        return w @ self.B

    def slacks(self, x):
        u = self.u0 + x @ self.B.T
        eps = self.eps
        return (torch.clamp(x - self.x_lb, min=eps),
                torch.clamp(self.x_ub - x, min=eps),
                torch.clamp(u - self.g_lb, min=eps),
                torch.clamp(self.g_ub - u, min=eps))

    def kkt_error(self, x, z_lo, z_hi, w_lo, w_hi, g, mu):
        """IPOPT's scaled KKT error; mu is a float or (B,)."""
        s_lo, s_hi, t_lo, t_hi = self.slacks(x)
        r_d = g - z_lo + z_hi - self.bt(w_lo) + self.bt(w_hi)
        zsum = (torch.sum(torch.abs(z_lo), -1) + torch.sum(torch.abs(z_hi), -1)
                + torch.sum(torch.abs(w_lo), -1)
                + torch.sum(torch.abs(w_hi), -1))
        nd = 2 * self.n + 2 * self.npath
        sd = torch.clamp(zsum / nd, min=100.0) / 100.0
        e_d = _amax(torch.abs(r_d)) / sd
        m = mu[:, None] if torch.is_tensor(mu) else mu
        e_c = torch.maximum(_amax(torch.abs(s_lo * z_lo - m)),
                            _amax(torch.abs(s_hi * z_hi - m)))
        e_c = torch.maximum(e_c, _amax(torch.abs(t_lo * w_lo - m)))
        e_c = torch.maximum(e_c, _amax(torch.abs(t_hi * w_hi - m)))
        return torch.maximum(e_d, e_c / sd)

    def init_state(self, x0, duals0, trust_radius, mu0):
        """Lane state from x0 (B, M). The start is pushed 1% into the box,
        also when duals0 is given (as the JAX package does). duals0 warm
        starts the multipliers, clipped strictly positive."""
        nb = x0.shape[0]
        kw = dict(dtype=self.dtype, device=self.device)
        margin = 1e-2 * (self.x_ub - self.x_lb)
        x = torch.clamp(x0, self.x_lb + margin, self.x_ub - margin)
        mu = torch.as_tensor(mu0, **kw).expand(nb).clone()
        if duals0 is not None:
            z_lo, z_hi, w_lo, w_hi = (
                torch.clamp(torch.as_tensor(v, **kw), min=1e-12)
                .expand(nb, -1).clone() for v in duals0)
        else:
            s0 = self.slacks(x)
            z_lo, z_hi, w_lo, w_hi = (_col(mu) / s for s in s0)
        return {
            "x": x, "z_lo": z_lo, "z_hi": z_hi, "w_lo": w_lo, "w_hi": w_hi,
            "mu": mu, "mu0": mu.clone(),
            "f": torch.zeros(nb, **kw),
            "it": torch.zeros(nb, dtype=torch.int64, device=self.device),
            "err0": torch.full((nb,), float("inf"), **kw),
            "done": torch.zeros(nb, dtype=torch.bool, device=self.device),
            "tr": torch.full((nb,), float(trust_radius), **kw),
        }

    def iter_prep(self, s, f, g, H):
        """Everything before the line search: convergence test at mu = 0,
        barrier update, reduced KKT solve with the Levenberg trust region,
        dual steps, fraction-to-boundary limits, merit slope."""
        x, mu = s["x"], s["mu"]
        z_lo, z_hi, w_lo, w_hi = s["z_lo"], s["z_hi"], s["w_lo"], s["w_hi"]
        s_lo, s_hi, t_lo, t_hi = self.slacks(x)

        err0 = self.kkt_error(x, z_lo, z_hi, w_lo, w_hi, g, 0.0)
        converged = err0 <= self.tol

        if self.mu_strategy == "adaptive":
            # centering from the complementarity spread; with no path
            # constraint its dummy row is left out
            parts = [s_lo * z_lo, s_hi * z_hi]
            if self.have_path:
                parts += [t_lo * w_lo, t_hi * w_hi]
            compl = torch.cat(parts, dim=-1)
            c_avg = torch.mean(compl, -1)
            c_min = torch.amin(compl, -1)
            sigma = torch.clamp((c_min / torch.clamp(c_avg, min=1e-30)) ** 3,
                                1e-3, 0.8)
            mu_next = torch.minimum(
                torch.clamp(sigma * c_avg, min=self.tol / 11.0), s["mu0"])
        else:
            # monotone Fiacco-McCormick: tighten once the barrier problem
            # is solved to ~10 mu
            err_mu = self.kkt_error(x, z_lo, z_hi, w_lo, w_hi, g, mu)
            mu_next = torch.where(
                err_mu <= 10.0 * mu,
                torch.clamp(torch.minimum(self.kappa_mu * mu,
                                          mu ** self.theta_mu),
                            min=self.tol / 11.0),
                mu)
        mn = _col(mu_next)

        r_d = g - z_lo + z_hi - self.bt(w_lo) + self.bt(w_hi)
        Sigma_x = z_lo / s_lo + z_hi / s_hi
        Sigma_u = w_lo / t_lo + w_hi / t_hi
        M = (H + torch.diag_embed(Sigma_x)
             + (self.B.T[None] * Sigma_u[:, None, :]) @ self.B)
        # Levenberg shift to positive definite
        wmin = torch.linalg.eigvalsh(M)[..., 0]
        lam = torch.clamp(1e-10 - wmin, min=0.0) + 1e-12
        rhs = (-r_d + (mn / s_lo - z_lo) - (mn / s_hi - z_hi)
               + self.bt(mn / t_lo - w_lo) - self.bt(mn / t_hi - w_hi))

        def solve(shift):
            A = M + shift[:, None, None] * self.eye
            return torch.linalg.solve(A, rhs[..., None])[..., 0]

        # trust region over three damping levels: the Newton step, the
        # step guaranteed inside the radius (lam3 = |rhs| / tr) and their
        # geometric mean; the least damped step inside the radius wins
        dx = solve(lam)
        tr = s["tr"]
        ndx1 = torch.linalg.vector_norm(dx, dim=-1)
        lam3 = torch.maximum(lam, torch.linalg.vector_norm(rhs, dim=-1) / tr)
        lam2 = torch.sqrt(torch.clamp(lam, min=1e-12) * lam3)
        dx2 = solve(lam2)
        dx3 = solve(lam3)
        use2 = torch.linalg.vector_norm(dx2, dim=-1) <= tr
        dx = torch.where(_col(ndx1 <= tr), dx,
                         torch.where(_col(use2), dx2, dx3))
        ndx = torch.linalg.vector_norm(dx, dim=-1)

        dz_lo = mn / s_lo - z_lo - (z_lo / s_lo) * dx
        dz_hi = mn / s_hi - z_hi + (z_hi / s_hi) * dx
        Bdx = dx @ self.B.T
        dw_lo = mn / t_lo - w_lo - (w_lo / t_lo) * Bdx
        dw_hi = mn / t_hi - w_hi + (w_hi / t_hi) * Bdx

        tau = _col(torch.clamp(1.0 - mu_next, min=self.ftb))
        inf = torch.tensor(float("inf"), dtype=self.dtype, device=self.device)

        def max_step(v, dv):
            r = torch.where(dv < 0, -tau * v / dv, inf)
            return torch.clamp(_amin(r), max=1.0)

        a_p = torch.minimum(torch.minimum(max_step(s_lo, dx),
                                          max_step(s_hi, -dx)),
                            torch.minimum(max_step(t_lo, Bdx),
                                          max_step(t_hi, -Bdx)))
        a_d = torch.minimum(torch.minimum(max_step(z_lo, dz_lo),
                                          max_step(z_hi, dz_hi)),
                            torch.minimum(max_step(w_lo, dw_lo),
                                          max_step(w_hi, dw_hi)))
        dphi = torch.sum((g - mn / s_lo + mn / s_hi - self.bt(mn / t_lo)
                          + self.bt(mn / t_hi)) * dx, -1)
        return {"f": f, "err0": err0, "converged": converged,
                "mu_next": mu_next, "dx": dx, "ndx": ndx,
                "dz_lo": dz_lo, "dz_hi": dz_hi, "dw_lo": dw_lo,
                "dw_hi": dw_hi, "a_p": a_p, "a_d": a_d, "dphi": dphi}

    def barrier(self, x):
        sl, sh, tl, th = self.slacks(x)
        return (torch.sum(torch.log(sl), -1) + torch.sum(torch.log(sh), -1)
                + torch.sum(torch.log(tl), -1) + torch.sum(torch.log(th), -1))

    def phi_at(self, x, dx, a, mu_next):
        """Barrier merit phi(x + a dx) per lane; one call of `fun`."""
        xx = x + _col(a) * dx
        return self.fun(xx) - mu_next * self.barrier(xx)

    def iter_apply(self, s, P, a_use):
        """Accepted primal and dual step, the kappa-sigma safeguard and the
        boundary-aware trust radius; lanes that converged keep x, the
        multipliers and the radius."""
        x, tr = s["x"], s["tr"]
        conv = P["converged"]
        mu_next, a_d = P["mu_next"], _col(P["a_d"])
        mn = _col(mu_next)
        x_n = x + _col(a_use) * P["dx"]
        z_lo_n = s["z_lo"] + a_d * P["dz_lo"]
        z_hi_n = s["z_hi"] + a_d * P["dz_hi"]
        w_lo_n = s["w_lo"] + a_d * P["dw_lo"]
        w_hi_n = s["w_hi"] + a_d * P["dw_hi"]

        # IPOPT's kappa-sigma safeguard: duals within a factor of mu/s
        sl, sh, tl, th = self.slacks(x_n)
        ks = 1e10

        def clip(v, sv):
            return torch.minimum(torch.maximum(v, mn / (ks * sv)),
                                 ks * mn / sv)

        z_lo_n, z_hi_n = clip(z_lo_n, sl), clip(z_hi_n, sh)
        w_lo_n, w_hi_n = clip(w_lo_n, tl), clip(w_hi_n, th)

        # grow the radius only when a (near-)full step ran against it;
        # shrink toward what the search accepted; collapse on failure
        found, ndx = P["found"], P["ndx"]
        tr_next = torch.where(
            ~found, torch.clamp(0.25 * tr, min=self.trust_min),
            torch.where((a_use >= 0.5) & (ndx >= 0.9 * tr),
                        torch.clamp(2.0 * tr, max=self.trust_max),
                        torch.where(
                            a_use < 0.5,
                            torch.clamp(torch.maximum(2.0 * a_use * ndx,
                                                      0.25 * tr),
                                        self.trust_min, self.trust_max),
                            tr)))
        c = _col(conv)
        return {
            "x": torch.where(c, x, x_n),
            "z_lo": torch.where(c, s["z_lo"], z_lo_n),
            "z_hi": torch.where(c, s["z_hi"], z_hi_n),
            "w_lo": torch.where(c, s["w_lo"], w_lo_n),
            "w_hi": torch.where(c, s["w_hi"], w_hi_n),
            "mu": mu_next, "mu0": s["mu0"],
            "f": P["f"],
            "it": s["it"] + 1,
            "err0": P["err0"],
            "done": conv,
            "tr": torch.where(conv, tr, tr_next),
        }


def _make_core(x0, x_lb, x_ub, B, u0, g_lb, g_ub, tol, frac_to_boundary,
               kappa_mu, theta_mu, fun, trust_min, trust_max, mu_strategy):
    n = x0.shape[-1]
    kw = dict(dtype=x0.dtype, device=x0.device)
    have_path = B is not None
    if have_path:
        B = torch.as_tensor(B, **kw)
        u0 = torch.as_tensor(u0, **kw)
        npath = B.shape[0]
    else:
        B = torch.zeros((1, n), **kw)
        u0 = torch.full((1,), 0.5 * (g_lb + g_ub), **kw)
        npath = 1
    return _IPCore(fun, n, x0.dtype, x0.device, B, u0, have_path, npath,
                   x_lb, x_ub, g_lb, g_ub, tol, frac_to_boundary, kappa_mu,
                   theta_mu, mu_strategy, trust_min, trust_max)


def _take(s: dict, idx) -> dict:
    return {k: v[idx] for k, v in s.items()}


def _put(s: dict, idx, part: dict) -> dict:
    out = {}
    for k, v in s.items():
        v = v.clone()
        v[idx] = part[k]
        out[k] = v
    return out


def _one_lane(fn):
    """A one-problem callable as a batch-of-one callable."""
    if fn is None:
        return None

    def batched(X):
        out = fn(X[0])
        if isinstance(out, tuple):
            return tuple(torch.as_tensor(o, dtype=X.dtype,
                                         device=X.device)[None] for o in out)
        return torch.as_tensor(out, dtype=X.dtype, device=X.device)[None]
    return batched


def minimize_interior_point(
        fun_grad_hess: Callable, x0,
        x_lb: float = -20.0, x_ub: float = 20.0,
        B=None, u0=None, g_lb: float = 2.0, g_ub: float = 100.0,
        mu0=0.1, tol: float = 1e-8,
        max_iter: int = 300, frac_to_boundary: float = 0.995,
        kappa_mu: float = 0.2, theta_mu: float = 1.5, fun: Callable = None,
        fun_grad: Callable = None, callback: Callable = None,
        trust_radius: float = 5.0, trust_min: float = 1e-3,
        trust_max: float = 100.0, mu_strategy: str = "monotone",
        duals0=None) -> IPResult:
    """Minimize f(x) with box and linear path constraints.

    x0 (M,): fun_grad_hess(x) -> (f, g (M,), H (M, M)); fun(x) -> f.
    x0 (B, M): the lockstep batch; the callables take and return the
    batch of live lanes, (k, M) -> (f (k,), g (k, M), H (k, M, M)) and
    (k, M) -> (k,). `fun` is the cheap merit objective of the line search
    (default: fun_grad_hess's f); `fun_grad` -> (f, g) serves the final KKT
    check (default: fun_grad_hess). B (N, M), u0 (N,): the path u = u0 + B x
    (None disables it). mu0: float, or (B,) per lane. duals0: (z_lo, z_hi,
    w_lo, w_hi) warm-start multipliers, (M,)/(N,) or per lane.

    callback(it, f, kkt_err0, ls_trials), one problem only: called every
    iteration, the analogue of IPOPT's intermediate_callback.
    mu_strategy: "monotone" (Fiacco-McCormick) or "adaptive" (centering
    from the current complementarity, the reference's IPOPT setting).
    """
    single = x0.dim() == 1
    if single:
        fun_grad_hess, fun, fun_grad = (_one_lane(fn) for fn in
                                        (fun_grad_hess, fun, fun_grad))
        x0 = x0[None]
        if duals0 is not None:
            duals0 = tuple(torch.as_tensor(v)[None] if torch.as_tensor(
                v).dim() == 1 else v for v in duals0)
    elif callback is not None:
        raise ValueError("callback: one problem only (x0 of shape (M,))")
    if fun is None:
        fun = lambda X: fun_grad_hess(X)[0]
    if fun_grad is None:
        fun_grad = lambda X: fun_grad_hess(X)[:2]
    core = _make_core(x0, x_lb, x_ub, B, u0, g_lb, g_ub, tol,
                      frac_to_boundary, kappa_mu, theta_mu, fun, trust_min,
                      trust_max, mu_strategy)
    s = core.init_state(x0, duals0, trust_radius, mu0)
    zero = torch.zeros((), dtype=x0.dtype, device=x0.device)

    while True:
        live = (~s["done"]) & (s["it"] < max_iter)
        idx = torch.nonzero(live).flatten()
        if idx.numel() == 0:
            break
        sl = _take(s, idx)
        f, g, H = fun_grad_hess(sl["x"])
        P = core.iter_prep(sl, f, g, H)
        x, dx, mu_next, dphi = sl["x"], P["dx"], P["mu_next"], P["dphi"]
        phi0 = core.phi_at(x, dx, zero.expand(len(idx)), mu_next)

        # Armijo backtracking on the barrier merit, halving from a_p; the
        # first success is kept, and the search stops once every lane has
        # one
        a = P["a_p"].clone()
        best = torch.zeros_like(a)
        found = torch.zeros_like(live[idx])
        trials = torch.zeros(len(idx), dtype=torch.int64, device=x.device)
        for _ in range(20):     # 20 halvings reach ~1e-6 a_p
            open_ = torch.nonzero(~found).flatten()
            if open_.numel() == 0:
                break
            ok = torch.zeros_like(found)
            ok[open_] = (core.phi_at(x[open_], dx[open_], a[open_],
                                     mu_next[open_])
                         <= phi0[open_] + 1e-4 * a[open_] * dphi[open_])
            best = torch.where(ok & ~found, a, best)
            trials = trials + (~found).long()
            found = found | ok
            a = a * 0.5
        # a failed search (merit non-descent from the dual-driven rhs)
        # falls back to a small safeguarded step
        a_use = torch.where(found, best, 1e-3 * P["a_p"])
        if callback is not None:
            callback(int(sl["it"][0]) + 1, float(f[0]), float(P["err0"][0]),
                     int(trials[0]))
        s = _put(s, idx, core.iter_apply(sl, {**P, "found": found}, a_use))

    f_fin, g_fin = fun_grad(s["x"])
    err_fin = core.kkt_error(s["x"], s["z_lo"], s["z_hi"], s["w_lo"],
                             s["w_hi"], g_fin, 0.0)
    res = IPResult(x=s["x"], f=f_fin, kkt_error=err_fin,
                   iterations=s["it"], converged=err_fin <= tol,
                   mu=s["mu"], z_lo=s["z_lo"], z_hi=s["z_hi"],
                   w_lo=s["w_lo"], w_hi=s["w_hi"])
    return IPResult(*(v[0] for v in res)) if single else res


def minimize_interior_point_host(
        fun_grad_hess: Callable, x0,
        x_lb: float = -20.0, x_ub: float = 20.0,
        B=None, u0=None, g_lb: float = 2.0, g_ub: float = 100.0,
        mu0: float = 0.1, tol: float = 1e-8,
        max_iter: int = 300, frac_to_boundary: float = 0.995,
        kappa_mu: float = 0.2, theta_mu: float = 1.5, fun: Callable = None,
        fun_grad: Callable = None,
        callback: Callable = None, checkpoint_cb: Callable = None,
        trust_radius: float = 5.0,
        trust_min: float = 1e-3, trust_max: float = 100.0,
        mu_strategy: str = "monotone", duals0=None, max_ls: int = 20,
        max_seconds: float = None) -> IPResult:
    """The same iteration for one problem x0 (M,) whose fun_grad_hess is
    an arbitrary host-driven composite (e.g. the streaming exact Hessian,
    minutes per call at scale).

    The line search stops at the first Armijo success; the barrier of the
    merit is evaluated in float64 numpy and its phi0 takes fun_grad_hess's
    f, as in the JAX package. checkpoint_cb(it, state (numpy dict), f, kkt)
    fires after every iteration; max_seconds stops the loop after the
    iteration that crosses it. fun_grad -> (f, g) serves the final KKT
    check in place of one more Hessian. callback matches
    minimize_interior_point's.
    """
    t_start = time.time()
    dtype, dev = x0.dtype, x0.device
    if fun is None:
        fun = lambda xx: fun_grad_hess(xx)[0]
    core = _make_core(x0[None], x_lb, x_ub, B, u0, g_lb, g_ub, tol,
                      frac_to_boundary, kappa_mu, theta_mu, None, trust_min,
                      trust_max, mu_strategy)
    B_h = core.B.cpu().numpy().astype(np.float64)
    u0_h = core.u0.cpu().numpy().astype(np.float64)
    eps_sl = core.eps

    def barrier_h(x_np):
        u = u0_h + B_h @ x_np
        sl = np.concatenate([x_np - x_lb, x_ub - x_np, u - g_lb, g_ub - u])
        if np.any(sl <= -eps_sl):
            return -np.inf   # an infeasible trial: phi = +inf
        return float(np.sum(np.log(np.maximum(sl, eps_sl))))

    def phi_h(x_np, mu):
        bar = barrier_h(x_np)
        if bar == -np.inf:
            return np.inf
        return float(fun(torch.as_tensor(x_np, dtype=dtype,
                                         device=dev))) - mu * bar

    def tens(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    if duals0 is not None:
        duals0 = tuple(tens(v)[None] for v in duals0)
    s = core.init_state(x0[None], duals0, trust_radius, mu0)
    it = 0
    converged = False
    f = g = None
    while it < max_iter:
        f, g, H = fun_grad_hess(s["x"][0])
        f, g, H = tens(f), tens(g), tens(H)
        P = core.iter_prep(s, f[None], g[None], H[None])
        err0 = float(P["err0"][0])
        if err0 <= tol:
            converged = True
            s["err0"], s["f"] = P["err0"], f[None]
            break
        a_p = float(P["a_p"][0])
        mu_next = float(P["mu_next"][0])
        x_np = s["x"][0].cpu().numpy().astype(np.float64)
        dx_np = P["dx"][0].cpu().numpy().astype(np.float64)
        phi0 = float(f) - mu_next * barrier_h(x_np)
        dphi = float(P["dphi"][0])
        a, found, trials = a_p, False, 0
        for _ in range(max_ls):
            trials += 1
            if phi_h(x_np + a * dx_np, mu_next) <= phi0 + 1e-4 * a * dphi:
                found = True
                break
            a *= 0.5
        a_use = a if found else 1e-3 * a_p
        if callback is not None:
            callback(it + 1, float(f), err0, trials)
        P = {**P, "found": torch.tensor([found], device=dev)}
        s = core.iter_apply(s, P, tens([a_use]))
        it += 1
        if checkpoint_cb is not None:
            checkpoint_cb(it, {k: v[0].cpu().numpy() for k, v in s.items()},
                          float(f), err0)
        if max_seconds is not None and time.time() - t_start > max_seconds:
            print("minimize_interior_point_host: max_seconds reached; "
                  "stopping", flush=True)
            break

    if converged:
        f_fin, g_fin = f, g
    elif fun_grad is not None:
        f_fin, g_fin = fun_grad(s["x"][0])
    else:
        f_fin, g_fin, _ = fun_grad_hess(s["x"][0])
    err_fin = core.kkt_error(s["x"], s["z_lo"], s["z_hi"], s["w_lo"],
                             s["w_hi"], tens(g_fin)[None], 0.0)[0]
    return IPResult(x=s["x"][0], f=tens(f_fin), kkt_error=err_fin,
                    iterations=torch.tensor(it), converged=err_fin <= tol,
                    mu=s["mu"][0], z_lo=s["z_lo"][0], z_hi=s["z_hi"][0],
                    w_lo=s["w_lo"][0], w_hi=s["w_hi"][0])
