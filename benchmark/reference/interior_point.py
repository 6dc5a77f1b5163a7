"""Plain reference of one iteration of the host interior point, from a cold
start: what the driver's interior point does with the (J, g, H) it
receives, written out in float64 numpy. It imports nothing of the program.

The problem is IPOPT's for the control NLP: minimize J(x) subject to the
box x in [x_lb, x_ub]^M and the path constraint u = u0 + B x in
[g_lb, g_ub]^N_t, with slacks s_lo = x - x_lb, s_hi = x_ub - x,
t_lo = u - g_lb, t_hi = g_ub - u and their multipliers z_lo, z_hi, w_lo,
w_hi. One iteration from x0:

- the start is pushed 1% of the box inside it, and the multipliers start
  at mu0 / slack (complementarity exactly mu0);
- IPOPT's scaled KKT error at mu = 0 decides convergence, and at mu the
  monotone barrier update: mu <- max(min(0.2 mu, mu^1.5), tol / 11) once
  the error is at most 10 mu;
- the reduced Newton system [H + Z/S + B^T (W/T) B] dx = rhs, H shifted
  to positive definite (1e-10 above its least eigenvalue, plus 1e-12),
  its step held inside a trust radius of 5 by the least of three shifts
  (the Newton shift, |rhs| / 5, their geometric mean) whose step fits;
- the fraction-to-the-boundary rule, max(1 - mu, 0.995), for the primal
  and the dual step lengths;
- Armijo backtracking on the barrier merit J - mu sum log(slacks), from
  the longest primal step, halving at most 20 times, with the factor 1e-4
  on the merit's slope; no success takes 1e-3 of the longest step;
- the dual step, then IPOPT's kappa-sigma safeguard (each multiplier
  within a factor 1e10 of mu / its slack at the new point).
"""

from __future__ import annotations

import numpy as np

MU0 = 0.1
KAPPA_MU, THETA_MU = 0.2, 1.5
TAU_MIN = 0.995
TRUST_RADIUS = 5.0
ETA_ARMIJO = 1e-4
MAX_HALVINGS = 20
KAPPA_SIGMA = 1e10
SLACK_FLOOR = 1e-14


def _slacks(x, B, u0, bounds):
    x_lb, x_ub, g_lb, g_ub = bounds
    u = u0 + B @ x
    return [np.maximum(v, SLACK_FLOOR)
            for v in (x - x_lb, x_ub - x, u - g_lb, g_ub - u)]


def _kkt_error(g, B, sl, duals, mu):
    """IPOPT's scaled KKT error (dual infeasibility and complementarity,
    both over s_d = max(mean |multiplier|, 100) / 100)."""
    z_lo, z_hi, w_lo, w_hi = duals
    r_d = g - z_lo + z_hi - B.T @ w_lo + B.T @ w_hi
    n_all = sum(v.size for v in duals)
    s_d = max(sum(np.abs(v).sum() for v in duals) / n_all, 100.0) / 100.0
    e_c = max(np.abs(s * z - mu).max() for s, z in zip(sl, duals))
    return max(np.abs(r_d).max() / s_d, e_c / s_d)


def _barrier(x, B, u0, bounds):
    x_lb, x_ub, g_lb, g_ub = bounds
    u = u0 + B @ x
    sl = np.concatenate([x - x_lb, x_ub - x, u - g_lb, g_ub - u])
    if np.any(sl <= -SLACK_FLOOR):
        return None                 # outside the box: the merit is +inf
    return float(np.sum(np.log(np.maximum(sl, SLACK_FLOOR))))


def _max_step(v, dv, tau):
    neg = dv < 0
    if not neg.any():
        return 1.0
    return min(1.0, float((-tau * v[neg] / dv[neg]).min()))


def first_step(cost, J0, g, H, x0, B, u0, tol, bounds):
    """One interior-point iteration from x0 with cold multipliers.

    cost: x -> J(x), the objective the line search evaluates; (J0, g, H)
    the objective, its gradient and Hessian at the pushed start; B (N_t,
    M), u0 (N_t,): the path constraint; bounds (x_lb, x_ub, g_lb, g_ub).
    Returns {"x", "z_lo", "z_hi", "w_lo", "w_hi", "mu", "alpha",
    "trials"}: the new iterate, its multipliers, the barrier for the next
    iteration, the accepted step length and the merit evaluations."""
    g, H, B, u0 = (np.asarray(v, dtype=np.float64) for v in (g, H, B, u0))
    x_lb, x_ub = bounds[0], bounds[1]
    margin = 1e-2 * (x_ub - x_lb)
    x = np.clip(np.asarray(x0, dtype=np.float64), x_lb + margin,
                x_ub - margin)
    mu = MU0
    sl = _slacks(x, B, u0, bounds)
    duals = [mu / s for s in sl]
    if _kkt_error(g, B, sl, duals, 0.0) <= tol:
        return {"x": x, "z_lo": duals[0], "z_hi": duals[1],
                "w_lo": duals[2], "w_hi": duals[3], "mu": mu, "alpha": 0.0,
                "trials": 0}
    if _kkt_error(g, B, sl, duals, mu) <= 10.0 * mu:
        mu_n = max(min(KAPPA_MU * mu, mu ** THETA_MU), tol / 11.0)
    else:
        mu_n = mu
    s_lo, s_hi, t_lo, t_hi = sl
    z_lo, z_hi, w_lo, w_hi = duals

    r_d = g - z_lo + z_hi - B.T @ w_lo + B.T @ w_hi
    K = (H + np.diag(z_lo / s_lo + z_hi / s_hi)
         + B.T @ np.diag(w_lo / t_lo + w_hi / t_hi) @ B)
    shift = max(1e-10 - np.linalg.eigvalsh(K)[0], 0.0) + 1e-12
    rhs = (-r_d + (mu_n / s_lo - z_lo) - (mu_n / s_hi - z_hi)
           + B.T @ (mu_n / t_lo - w_lo) - B.T @ (mu_n / t_hi - w_hi))
    eye = np.eye(len(x))
    dx = np.linalg.solve(K + shift * eye, rhs)
    if np.linalg.norm(dx) > TRUST_RADIUS:
        lam3 = max(shift, np.linalg.norm(rhs) / TRUST_RADIUS)
        lam2 = np.sqrt(max(shift, 1e-12) * lam3)
        dx = np.linalg.solve(K + lam2 * eye, rhs)
        if np.linalg.norm(dx) > TRUST_RADIUS:
            dx = np.linalg.solve(K + lam3 * eye, rhs)

    Bdx = B @ dx
    dz_lo = mu_n / s_lo - z_lo - (z_lo / s_lo) * dx
    dz_hi = mu_n / s_hi - z_hi + (z_hi / s_hi) * dx
    dw_lo = mu_n / t_lo - w_lo - (w_lo / t_lo) * Bdx
    dw_hi = mu_n / t_hi - w_hi + (w_hi / t_hi) * Bdx
    tau = max(1.0 - mu_n, TAU_MIN)
    a_p = min(_max_step(s_lo, dx, tau), _max_step(s_hi, -dx, tau),
              _max_step(t_lo, Bdx, tau), _max_step(t_hi, -Bdx, tau))
    a_d = min(_max_step(z_lo, dz_lo, tau), _max_step(z_hi, dz_hi, tau),
              _max_step(w_lo, dw_lo, tau), _max_step(w_hi, dw_hi, tau))

    slope = float(np.dot(g - mu_n / s_lo + mu_n / s_hi - B.T @ (mu_n / t_lo)
                         + B.T @ (mu_n / t_hi), dx))
    phi0 = float(J0) - mu_n * _barrier(x, B, u0, bounds)
    a, found, trials = a_p, False, 0
    for _ in range(MAX_HALVINGS):
        trials += 1
        bar = _barrier(x + a * dx, B, u0, bounds)
        if bar is not None and (float(cost(x + a * dx)) - mu_n * bar
                                <= phi0 + ETA_ARMIJO * a * slope):
            found = True
            break
        a *= 0.5
    a = a if found else 1e-3 * a_p

    x_n = x + a * dx
    new = [v + a_d * dv for v, dv in zip((z_lo, z_hi, w_lo, w_hi),
                                         (dz_lo, dz_hi, dw_lo, dw_hi))]
    sl_n = _slacks(x_n, B, u0, bounds)
    new = [np.minimum(np.maximum(v, mu_n / (KAPPA_SIGMA * s)),
                      KAPPA_SIGMA * mu_n / s) for v, s in zip(new, sl_n)]
    return {"x": x_n, "z_lo": new[0], "z_hi": new[1], "w_lo": new[2],
            "w_hi": new[3], "mu": mu_n, "alpha": a, "trials": trials}
