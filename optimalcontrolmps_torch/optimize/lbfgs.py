"""L-BFGS with a strong-Wolfe line search: one problem, or a lockstep batch.

Counterpart of optimalcontrolmps_tpu/optimize/lbfgs.py, with the same two
state machines and two-loop recursions; the `while_loop`s are Python loops.

* `minimize_lbfgs` solves one problem. Its scalars are Python floats, so
  each branch of the JAX state machine is a plain `if`.
* `minimize_lbfgs_batch` solves B problems in lockstep: the objective sees
  the whole (B, n) batch once per line-search trial, and finished lanes are
  frozen by masks. This is what lets one fused chain-kernel launch serve
  the whole multistart batch.

History is a rolling (m, n) buffer; a failed Wolfe search accepts the best
improving trial (if any), drops the history, and the solve stops only after
`max_fails` consecutive searches without improvement.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["LBFGSResult", "minimize_lbfgs", "minimize_lbfgs_batch"]


class LBFGSResult(NamedTuple):
    """Python scalars from `minimize_lbfgs`; (B,) tensors from
    `minimize_lbfgs_batch`."""
    x: torch.Tensor
    f: object
    grad_norm: object
    iterations: object
    converged: object
    n_evals: object


# ---------------------------------------------------------------------------
# one problem
# ---------------------------------------------------------------------------

def _dot(a, b) -> float:
    return float(torch.dot(a, b))


def _two_loop(g, S, Y, rho, head, count, m):
    """Two-loop recursion over the rolling buffer S/Y (m, n)."""
    q = g
    alphas = [0.0] * m
    for i in range(count):  # newest -> oldest
        idx = (head - 1 - i) % m
        a = rho[idx] * _dot(S[idx], q)
        q = q - a * Y[idx]
        alphas[idx] = a
    newest = (head - 1) % m
    sy = _dot(S[newest], Y[newest])
    yy = _dot(Y[newest], Y[newest])
    r = (sy / yy if count > 0 and yy > 1e-30 else 1.0) * q
    for i in range(count):  # oldest -> newest
        idx = (head - count + i) % m
        b = rho[idx] * _dot(Y[idx], r)
        r = r + (alphas[idx] - b) * S[idx]
    return r


def _wolfe_search(fg, x, f0, g0, p, max_ls: int, c1=1e-4, c2=0.9, a0=1.0):
    """Strong-Wolfe bracketing + bisection zoom. fg(x) -> (f, g).

    Returns (alpha, f, g, n_evals, ok, best_a, best_f, best_g): `ok` means
    the strong-Wolfe conditions hold at alpha; best_* is the lowest-f point
    evaluated (starting at (0, f0, g0)), the salvage for stall recovery."""
    d0 = _dot(g0, p)
    zoom = False
    a_lo, f_lo, a_hi = 0.0, f0, 1e10
    a = a0
    k = 0
    done = ok = False
    xf, xg, alpha = f0, g0, 0.0
    bf, bg, ba = f0, g0, 0.0
    while not done and k < max_ls:
        fv, g = fg(x + a * p)
        f = float(fv)
        d = _dot(g, p)
        k += 1
        if f < bf:
            bf, bg, ba = f, g, a
        curv_ok = abs(d) <= -c2 * d0
        armijo_fail = f > f0 + c1 * a * d0
        if not zoom:
            if armijo_fail or (f >= f_lo and k > 1):
                zoom, a_hi = True, a
            elif curv_ok:
                done = ok = True
                xf, xg, alpha = f, g, a
            elif d >= 0:
                zoom, a_hi = True, a_lo
                a_lo, f_lo = a, f
            else:
                a_lo, f_lo = a, f
                a = 2.0 * a
        else:
            if armijo_fail or f >= f_lo:
                a_hi = a
            elif curv_ok:
                done = ok = True
                xf, xg, alpha = f, g, a
            elif d * (a_hi - a_lo) >= 0:
                a_hi = a_lo
                a_lo, f_lo = a, f
            else:
                a_lo, f_lo = a, f
        if not done and zoom:
            a = 0.5 * (a_lo + a_hi)
    return alpha, xf, xg, k, ok, ba, bf, bg


def minimize_lbfgs(fun_and_grad: Callable, x0, max_iter: int = 100,
                   tol: float = 1e-8, history: int = 10, max_ls: int = 20,
                   max_fails: int = 3,
                   callback: Callable | None = None) -> LBFGSResult:
    """Minimize f from x0 (n,). fun_and_grad(x) -> (f, g). Converged when
    ||g||_inf < tol. `callback(it, f, gnorm, ls_evals)`, if given, runs
    after every iteration (the reference's intermediate_callback)."""
    n = x0.shape[0]
    m = history
    S = torch.zeros((m, n), dtype=x0.dtype, device=x0.device)
    Y = torch.zeros_like(S)
    rho = [0.0] * m
    head = count = it = fails = 0
    evals = 1
    done = converged = False

    x = x0
    fv, g = fun_and_grad(x0)
    f = float(fv)
    while not done and it < max_iter:
        p = -_two_loop(g, S, Y, rho, head, count, m)
        if not _dot(p, g) < 0:
            p = -g
        gnorm0 = float(torch.max(torch.abs(g)))
        a0 = 1.0 if count > 0 else min(1.0, 1.0 / max(gnorm0, 1e-12))

        alpha, f_w, g_w, k, ok, ba, bf, bg = _wolfe_search(
            fun_and_grad, x, f, g, p, max_ls, a0=a0)

        accept = ok or bf < f
        a_use, f_new, g_new = (alpha, f_w, g_w) if ok else (ba, bf, bg)
        x_new = x + a_use * p
        sk = x_new - x
        yk = g_new - g
        sy = _dot(sk, yk)
        # only Wolfe-certified pairs enter the history
        if ok and sy > (1e-12 * float(torch.linalg.vector_norm(sk))
                        * float(torch.linalg.vector_norm(yk))):
            S[head] = sk
            Y[head] = yk
            rho[head] = 1.0 / (sy if sy != 0 else 1.0)
            head = (head + 1) % m
            count = min(count + 1, m)
        if not ok:
            count = 0  # steepest-descent restart
        fails = 0 if accept else fails + 1
        if accept:
            x, f, g = x_new, f_new, g_new
        gnorm = float(torch.max(torch.abs(g)))
        converged = gnorm < tol
        it += 1
        evals += k
        if callback is not None:
            callback(it, f, gnorm, k)
        done = converged or fails >= max_fails

    return LBFGSResult(x=x, f=f, grad_norm=float(torch.max(torch.abs(g))),
                       iterations=it, converged=converged, n_evals=evals)


# ---------------------------------------------------------------------------
# lockstep batch
# ---------------------------------------------------------------------------

def _bdot(a, b):
    return torch.sum(a * b, dim=-1)


def _btake(A, idx):
    """A: (B, m, ...), idx: (B,) -> (B, ...) per-lane gather along axis 1."""
    shape = (A.shape[0], 1) + tuple(A.shape[2:])
    ix = idx.view(-1, *([1] * (A.dim() - 1))).expand(shape)
    return torch.gather(A, 1, ix).squeeze(1)


def _merge(cond, s_true: dict, s_false: dict) -> dict:
    """Per-lane select between two states; entries that are the same
    object on both sides are kept without a select."""
    out = {}
    for key, t in s_true.items():
        fl = s_false[key]
        if t is fl:
            out[key] = t
        else:
            out[key] = torch.where(
                cond.view(-1, *([1] * (t.dim() - 1))), t, fl)
    return out


def _two_loop_batch(g, S, Y, rho, head, count, m):
    """Batched two-loop recursion; S/Y: (B, m, n), head/count: (B,)."""
    B = g.shape[0]
    q = g
    alphas = torch.zeros((B, m), dtype=g.dtype, device=g.device)
    slots = torch.arange(m, device=g.device)[None, :]
    for i in range(m):
        idx = torch.remainder(head - 1 - i, m)
        valid = i < count
        a = _btake(rho, idx) * _bdot(_btake(S, idx), q)
        a = torch.where(valid, a, torch.zeros_like(a))
        q = q - a[:, None] * _btake(Y, idx)
        alphas = torch.where((slots == idx[:, None]) & valid[:, None],
                             a[:, None], alphas)

    newest = torch.remainder(head - 1, m)
    Sn = _btake(S, newest)
    Yn = _btake(Y, newest)
    sy = _bdot(Sn, Yn)
    yy = _bdot(Yn, Yn)
    gamma = torch.where((count > 0) & (yy > 1e-30), sy / yy,
                        torch.ones_like(sy))
    r = gamma[:, None] * q
    for i in range(m):
        idx = torch.remainder(head - count + i, m)
        valid = i < count
        b = _btake(rho, idx) * _bdot(_btake(Y, idx), r)
        b = torch.where(valid, b, torch.zeros_like(b))
        coef = torch.where(valid, _btake(alphas, idx) - b,
                           torch.zeros_like(b))
        r = r + coef[:, None] * _btake(S, idx)
    return r


def _wolfe_search_batch(fg, x, f0, g0, p, max_ls: int, c1=1e-4, c2=0.9,
                        a0=None, active0=None):
    """Batched strong-Wolfe search. x/p: (B, n); f0: (B,). Lanes with
    active0=False are frozen (their objective values are ignored). Same
    state machine as `_wolfe_search`, with per-lane phase flags."""
    B = x.shape[0]
    dev = x.device
    d0 = _bdot(g0, p)
    zero = torch.zeros(B, dtype=f0.dtype, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    true = torch.ones(B, dtype=torch.bool, device=dev)
    one_i = torch.ones(B, dtype=torch.int32, device=dev)
    s = {
        "phase": torch.zeros(B, dtype=torch.int32, device=dev),
        "a_lo": zero, "f_lo": f0, "a_hi": zero + 1e10,
        "a": torch.ones_like(zero) if a0 is None else a0.to(f0.dtype),
        "k": torch.zeros(B, dtype=torch.int32, device=dev),
        "done": false, "ok": false, "xf": f0, "xg": g0, "alpha": zero,
        "bf": f0, "bg": g0, "ba": zero,
        "act": true if active0 is None else active0,
    }
    while bool(torch.any((~s["done"]) & (s["k"] < max_ls) & s["act"])):
        a = s["a"]
        f, g = fg(x + a[:, None] * p)
        d = _bdot(g, p)
        live = (~s["done"]) & s["act"]
        s = {**s, "k": torch.where(live, s["k"] + 1, s["k"])}

        better = live & (f < s["bf"])
        s = {**s,
             "bf": torch.where(better, f, s["bf"]),
             "bg": torch.where(better[:, None], g, s["bg"]),
             "ba": torch.where(better, a, s["ba"])}

        curv_ok = torch.abs(d) <= -c2 * d0
        armijo_fail = f > f0 + c1 * a * d0

        # bracketing phase
        failb = armijo_fail | ((f >= s["f_lo"]) & (s["k"] > 1))
        b1 = {**s, "phase": one_i, "a_hi": a}
        b2 = {**s, "done": true, "ok": true, "xf": f, "xg": g, "alpha": a}
        b3 = {**s, "phase": one_i, "a_hi": s["a_lo"], "a_lo": a, "f_lo": f}
        b4 = {**s, "a_lo": a, "f_lo": f, "a": 2.0 * a}
        sb = _merge(failb, b1, _merge(curv_ok, b2, _merge(d >= 0, b3, b4)))

        # zoom phase
        failz = armijo_fail | (f >= s["f_lo"])
        z1 = {**s, "a_hi": a}
        flip = d * (s["a_hi"] - s["a_lo"]) >= 0
        z3a = {**s, "a_hi": s["a_lo"], "a_lo": a, "f_lo": f}
        z3b = {**s, "a_lo": a, "f_lo": f}
        sz = _merge(failz, z1, _merge(curv_ok, b2, _merge(flip, z3a, z3b)))

        s_new = _merge(s["phase"] == 1, sz, sb)
        a_next = torch.where(s_new["phase"] == 1,
                             0.5 * (s_new["a_lo"] + s_new["a_hi"]),
                             s_new["a"])
        s_new = {**s_new,
                 "a": torch.where(s_new["done"], s_new["a"], a_next)}
        # frozen lanes keep their old state entirely
        s = _merge(live, s_new, s)
    return (s["alpha"], s["xf"], s["xg"], s["k"], s["ok"], s["ba"], s["bf"],
            s["bg"])


def minimize_lbfgs_batch(fun_and_grad: Callable, X0, max_iter: int = 100,
                         tol: float = 1e-8, history: int = 10,
                         max_ls: int = 20, max_fails: int = 3
                         ) -> LBFGSResult:
    """Lockstep batch L-BFGS: fun_and_grad(X (B, n)) -> (f (B,), G (B, n)),
    called once per line-search trial for the whole batch. Same semantics
    lane by lane as the JAX package's batch solver. Returns (B,) tensors."""
    B, n = X0.shape
    m = history
    dev = X0.device
    dtype = X0.dtype
    i32 = dict(dtype=torch.int32, device=dev)

    f0, g0 = fun_and_grad(X0)
    s = {
        "x": X0, "f": f0, "g": g0,
        "S": torch.zeros((B, m, n), dtype=dtype, device=dev),
        "Y": torch.zeros((B, m, n), dtype=dtype, device=dev),
        "rho": torch.zeros((B, m), dtype=dtype, device=dev),
        "head": torch.zeros(B, **i32), "count": torch.zeros(B, **i32),
        "it": torch.zeros(B, **i32), "evals": torch.ones(B, **i32),
        "fails": torch.zeros(B, **i32),
        "done": torch.zeros(B, dtype=torch.bool, device=dev),
        "converged": torch.zeros(B, dtype=torch.bool, device=dev),
    }
    slots = torch.arange(m, device=dev)[None, :]

    while bool(torch.any((~s["done"]) & (s["it"] < max_iter))):
        live = (~s["done"]) & (s["it"] < max_iter)
        p = -_two_loop_batch(s["g"], s["S"], s["Y"], s["rho"], s["head"],
                             s["count"], m)
        descent = _bdot(p, s["g"]) < 0
        p = torch.where(descent[:, None], p, -s["g"])

        gnorm0 = torch.max(torch.abs(s["g"]), dim=-1).values
        a0 = torch.where(s["count"] > 0, torch.ones_like(gnorm0),
                         torch.clamp(1.0 / torch.clamp(gnorm0, min=1e-12),
                                     max=1.0)).to(dtype)

        alpha, f_w, g_w, k, ok, ba, bf, bg = _wolfe_search_batch(
            fun_and_grad, s["x"], s["f"], s["g"], p, max_ls, a0=a0,
            active0=live)

        improved = bf < s["f"]
        accept = live & (ok | improved)
        a_use = torch.where(ok, alpha, ba)
        f_new = torch.where(ok, f_w, bf)
        g_new = torch.where(ok[:, None], g_w, bg)
        x_new = s["x"] + a_use[:, None] * p

        sk = x_new - s["x"]
        yk = g_new - s["g"]
        sy = _bdot(sk, yk)
        good_pair = live & ok & (
            sy > 1e-12 * torch.linalg.vector_norm(sk, dim=-1)
            * torch.linalg.vector_norm(yk, dim=-1))

        head = s["head"]
        slot = (slots == head[:, None]) & good_pair[:, None]
        S = torch.where(slot[..., None], sk[:, None, :], s["S"])
        Y = torch.where(slot[..., None], yk[:, None, :], s["Y"])
        rho = torch.where(
            slot, (1.0 / torch.where(sy != 0, sy, torch.ones_like(sy)))[:, None],
            s["rho"])
        head = torch.where(good_pair, torch.remainder(head + 1, m), head)
        count = torch.where(good_pair, torch.clamp(s["count"] + 1, max=m),
                            s["count"])
        count = torch.where(live & ~ok, torch.zeros_like(count), count)

        fails = torch.where(accept, torch.zeros_like(s["fails"]),
                            torch.where(live, s["fails"] + 1, s["fails"]))

        g_eff = torch.where(accept[:, None], g_new, s["g"])
        gnorm = torch.max(torch.abs(g_eff), dim=-1).values
        converged = live & (gnorm < tol)
        stalled = live & (fails >= max_fails)

        s = {
            "x": torch.where(accept[:, None], x_new, s["x"]),
            "f": torch.where(accept, f_new, s["f"]),
            "g": g_eff,
            "S": S, "Y": Y, "rho": rho, "head": head, "count": count,
            "it": torch.where(live, s["it"] + 1, s["it"]),
            "evals": torch.where(live, s["evals"] + k, s["evals"]),
            "fails": fails,
            "done": s["done"] | converged | stalled,
            "converged": s["converged"] | converged,
        }

    return LBFGSResult(x=s["x"], f=s["f"],
                       grad_norm=torch.max(torch.abs(s["g"]), dim=-1).values,
                       iterations=s["it"], converged=s["converged"],
                       n_evals=s["evals"])
