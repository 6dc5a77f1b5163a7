"""L-BFGS with a strong-Wolfe line search: one problem, or a lockstep batch.

Counterpart of optimalcontrolmps_tpu/optimize/lbfgs.py, with the same two
state machines and two-loop recursions; the `while_loop`s are Python loops.

* `minimize_lbfgs` solves one problem. Its scalars are Python floats, so
  each branch of the JAX state machine is a plain `if`.
* `minimize_lbfgs_batch` solves B problems in lockstep: the objective sees
  the whole (B, n) batch once per line-search trial, and finished lanes are
  frozen by masks. This is what lets one fused chain-kernel launch serve
  the whole multistart batch. Its two bodies, a trial and the rest of an
  iteration, each end in one read of the loop's flags. On the card, for an
  objective that declares itself capture-safe (`capture_safe = True` on
  the function: no host sync, no shape or branch that depends on values),
  each body runs eagerly once and is then replayed as a CUDA graph.

History is a rolling (m, n) buffer; a failed Wolfe search accepts the best
improving trial (if any), drops the history, and the solve stops only after
`max_fails` consecutive searches without improvement.

Counters of the lockstep solver, reset by `reset_counts`: `trials_eager`
(objective calls run eagerly: a solve's start, then its warm-up trial when
graphed, else every trial), `trials_replayed` (trials replayed from a
graph) and `graphs_captured`. The two trial counts add up to the
objective's evaluations, which `ops.sector_chain.fwd_launches` also counts
for the flagship objective.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops import sector_chain

__all__ = ["LBFGSResult", "minimize_lbfgs", "minimize_lbfgs_batch",
           "reset_counts", "trials_eager", "trials_replayed",
           "graphs_captured"]

trials_eager = 0
trials_replayed = 0
graphs_captured = 0


def reset_counts() -> None:
    global trials_eager, trials_replayed, graphs_captured
    trials_eager = 0
    trials_replayed = 0
    graphs_captured = 0


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


def _search_start(state, live, a0) -> dict:
    """The Wolfe search's state before its first trial, at step a0; lanes
    that are not `live` stay frozen through the search."""
    f0, g0 = state["f"], state["g"]
    zero = torch.zeros_like(f0)
    false = torch.zeros_like(live)
    return {
        "phase": torch.zeros_like(state["it"]),
        "a_lo": zero, "f_lo": f0, "a_hi": zero + 1e10, "a": a0,
        "k": torch.zeros_like(state["it"]),
        "done": false, "ok": false, "xf": f0, "xg": g0, "alpha": zero,
        "bf": f0, "bg": g0, "ba": zero, "act": live,
    }


def _searching(s, max_ls: int):
    """(B,) lanes whose search takes another trial."""
    return (~s["done"]) & (s["k"] < max_ls) & s["act"]


def _trial(fg, state, d, s, c1=1e-4, c2=0.9) -> dict:
    """One lockstep trial of the batched strong-Wolfe search from
    state["x"] along d["p"]: the objective at x + a p, then the search's
    next state. Same state machine as `_wolfe_search`, with per-lane phase
    flags; frozen lanes keep their state whatever the objective says."""
    x, f0, p, d0 = state["x"], state["f"], d["p"], d["d0"]
    one_i = torch.ones_like(s["k"])
    true = torch.ones_like(s["done"])
    a = s["a"]
    f, g = fg(x + a[:, None] * p)
    dg = _bdot(g, p)
    live = (~s["done"]) & s["act"]
    s = {**s, "k": torch.where(live, s["k"] + 1, s["k"])}

    better = live & (f < s["bf"])
    s = {**s,
         "bf": torch.where(better, f, s["bf"]),
         "bg": torch.where(better[:, None], g, s["bg"]),
         "ba": torch.where(better, a, s["ba"])}

    curv_ok = torch.abs(dg) <= -c2 * d0
    armijo_fail = f > f0 + c1 * a * d0

    # bracketing phase
    failb = armijo_fail | ((f >= s["f_lo"]) & (s["k"] > 1))
    b1 = {**s, "phase": one_i, "a_hi": a}
    b2 = {**s, "done": true, "ok": true, "xf": f, "xg": g, "alpha": a}
    b3 = {**s, "phase": one_i, "a_hi": s["a_lo"], "a_lo": a, "f_lo": f}
    b4 = {**s, "a_lo": a, "f_lo": f, "a": 2.0 * a}
    sb = _merge(failb, b1, _merge(curv_ok, b2, _merge(dg >= 0, b3, b4)))

    # zoom phase
    failz = armijo_fail | (f >= s["f_lo"])
    z1 = {**s, "a_hi": a}
    flip = dg * (s["a_hi"] - s["a_lo"]) >= 0
    z3a = {**s, "a_hi": s["a_lo"], "a_lo": a, "f_lo": f}
    z3b = {**s, "a_lo": a, "f_lo": f}
    sz = _merge(failz, z1, _merge(curv_ok, b2, _merge(flip, z3a, z3b)))

    s_new = _merge(s["phase"] == 1, sz, sb)
    a_next = torch.where(s_new["phase"] == 1,
                         0.5 * (s_new["a_lo"] + s_new["a_hi"]), s_new["a"])
    s_new = {**s_new, "a": torch.where(s_new["done"], s_new["a"], a_next)}
    # frozen lanes keep their old state entirely
    return _merge(live, s_new, s)


def _begin(state, m: int, max_iter: int):
    """An iteration's start: its live lanes, the two-loop direction (the
    gradient's where that is no descent), the first step, and the search's
    state. Returns (d, s): d holds p, d0 = g.p and live."""
    g = state["g"]
    live = (~state["done"]) & (state["it"] < max_iter)
    p = -_two_loop_batch(g, state["S"], state["Y"], state["rho"],
                         state["head"], state["count"], m)
    descent = _bdot(p, g) < 0
    p = torch.where(descent[:, None], p, -g)

    gnorm0 = torch.max(torch.abs(g), dim=-1).values
    a0 = torch.where(state["count"] > 0, torch.ones_like(gnorm0),
                     torch.clamp(1.0 / torch.clamp(gnorm0, min=1e-12),
                                 max=1.0)).to(g.dtype)
    d = {"p": p, "d0": _bdot(g, p), "live": live}
    return d, _search_start(state, live, a0)


def _finish(state, d, s, m: int, tol: float, max_fails: int) -> dict:
    """An iteration's end after its search: the accepted point, the history
    pair, the restart and stall bookkeeping, convergence."""
    live, p = d["live"], d["p"]
    ok, bf = s["ok"], s["bf"]
    improved = bf < state["f"]
    accept = live & (ok | improved)
    a_use = torch.where(ok, s["alpha"], s["ba"])
    f_new = torch.where(ok, s["xf"], bf)
    g_new = torch.where(ok[:, None], s["xg"], s["bg"])
    x_new = state["x"] + a_use[:, None] * p

    sk = x_new - state["x"]
    yk = g_new - state["g"]
    sy = _bdot(sk, yk)
    good_pair = live & ok & (
        sy > 1e-12 * torch.linalg.vector_norm(sk, dim=-1)
        * torch.linalg.vector_norm(yk, dim=-1))

    head = state["head"]
    slots = torch.arange(m, device=head.device)[None, :]
    slot = (slots == head[:, None]) & good_pair[:, None]
    S = torch.where(slot[..., None], sk[:, None, :], state["S"])
    Y = torch.where(slot[..., None], yk[:, None, :], state["Y"])
    rho = torch.where(
        slot, (1.0 / torch.where(sy != 0, sy, torch.ones_like(sy)))[:, None],
        state["rho"])
    head = torch.where(good_pair, torch.remainder(head + 1, m), head)
    count = torch.where(good_pair, torch.clamp(state["count"] + 1, max=m),
                        state["count"])
    count = torch.where(live & ~ok, torch.zeros_like(count), count)

    fails = torch.where(accept, torch.zeros_like(state["fails"]),
                        torch.where(live, state["fails"] + 1, state["fails"]))

    g_eff = torch.where(accept[:, None], g_new, state["g"])
    gnorm = torch.max(torch.abs(g_eff), dim=-1).values
    converged = live & (gnorm < tol)
    stalled = live & (fails >= max_fails)
    return {
        "x": torch.where(accept[:, None], x_new, state["x"]),
        "f": torch.where(accept, f_new, state["f"]),
        "g": g_eff,
        "S": S, "Y": Y, "rho": rho, "head": head, "count": count,
        "it": torch.where(live, state["it"] + 1, state["it"]),
        "evals": torch.where(live, state["evals"] + s["k"], state["evals"]),
        "fails": fails,
        "done": state["done"] | converged | stalled,
        "converged": state["converged"] | converged,
    }


def _more(state, max_iter: int):
    """Whether any lane takes another iteration (a 0-dim tensor)."""
    return torch.any((~state["done"]) & (state["it"] < max_iter))


def _store(dst: dict, new: dict) -> None:
    """Copy `new` into the buffers of `dst` in place. No entry of `new` is
    another key's buffer of `dst`: the bodies select between branches, and
    a branch that keeps an entry keeps it under its own key."""
    for k, t in new.items():
        if t is not dst[k]:
            dst[k].copy_(t)


class _Step:
    """One body of the lockstep solver (a line-search trial, or the rest of
    an iteration), run until the solver returns. `body()` computes the next
    state from the solver's state dicts, stores it in their buffers in
    place (`_store`) and returns the loop's flags as a (k,) bool tensor; a
    call returns them as a list, with one read from the device.

    Eager, every call runs the body. Graphed, the buffers are static: the
    first call runs the body eagerly (the warm-up), the second captures it
    as a CUDA graph and replays it, later calls replay it. What the body
    looks up (the two-loop recursion, the kernels) is looked up at the
    capture. The capture runs no kernel, so it counts no sector-chain
    launch; each replay counts the ones it runs."""

    def __init__(self, body, graphed: bool, trial: bool):
        self.body, self.graphed, self.trial = body, graphed, trial
        self.warm = False
        self.graph = self.flags = None
        self.launches = (0, 0)

    def __call__(self) -> list:
        global trials_eager, trials_replayed
        if not self.warm:
            self.warm = self.graphed
            flags = self.body()
            trials_eager += self.trial
            return flags.tolist()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        sector_chain.count_launches(*self.launches)
        trials_replayed += self.trial
        return self.flags.tolist()

    def _capture(self) -> None:
        global graphs_captured
        n0 = (sector_chain.fwd_launches, sector_chain.bwd_launches)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            self.flags = self.body()
        finally:
            graph.capture_end()
        self.graph = graph
        self.launches = (sector_chain.fwd_launches - n0[0],
                         sector_chain.bwd_launches - n0[1])
        sector_chain.count_launches(-self.launches[0], -self.launches[1])
        graphs_captured += 1

    def release(self) -> None:
        """Free the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.flags = None


_streams: dict = {}


def _stream(device) -> torch.cuda.Stream:
    """The stream that graphed solves run on, one per device and kept
    across calls: cuBLAS keeps a workspace for each stream it has run on."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _solve(fg, X0, max_iter, tol, m, max_ls, max_fails, graphed):
    global trials_eager
    B, n = X0.shape
    dev, dtype = X0.device, X0.dtype
    i32 = dict(dtype=torch.int32, device=dev)

    f0, g0 = fg(X0)
    trials_eager += 1
    state = {
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
    d, s = _begin(state, m, max_iter)
    # every entry a buffer of its own, which the steps update in place; X0
    # is left as it is
    state, d, s = ({k: t.clone() for k, t in z.items()} for z in (state, d, s))

    def trial():
        _store(s, _trial(fg, state, d, s))
        return torch.any(_searching(s, max_ls)).reshape(1)

    def iteration():
        _store(state, _finish(state, d, s, m, tol, max_fails))
        d_next, s_next = _begin(state, m, max_iter)
        _store(d, d_next)
        _store(s, s_next)
        return torch.stack([_more(state, max_iter),
                            torch.any(_searching(s, max_ls))])

    steps = (_Step(trial, graphed, True), _Step(iteration, graphed, False))
    run_trial, run_iteration = steps
    more, searching = torch.stack(
        [_more(state, max_iter), torch.any(_searching(s, max_ls))]).tolist()
    try:
        while more:
            while searching:
                (searching,) = run_trial()
            more, searching = run_iteration()
    finally:
        for step in steps:
            step.release()
    return LBFGSResult(x=state["x"], f=state["f"],
                       grad_norm=torch.max(torch.abs(state["g"]),
                                           dim=-1).values,
                       iterations=state["it"], converged=state["converged"],
                       n_evals=state["evals"])


def minimize_lbfgs_batch(fun_and_grad: Callable, X0, max_iter: int = 100,
                         tol: float = 1e-8, history: int = 10,
                         max_ls: int = 20, max_fails: int = 3
                         ) -> LBFGSResult:
    """Lockstep batch L-BFGS: fun_and_grad(X (B, n)) -> (f (B,), G (B, n)),
    called once per line-search trial for the whole batch. Same semantics
    lane by lane as the JAX package's batch solver. Returns (B,) tensors.

    With X0 on the card and `fun_and_grad.capture_safe` true, the trials
    and iterations after the first are CUDA-graph replays (`_Step`), on a
    side stream; otherwise every step runs eagerly."""
    graphed = X0.is_cuda and bool(getattr(fun_and_grad, "capture_safe",
                                          False))
    args = (fun_and_grad, X0, max_iter, tol, history, max_ls, max_fails)
    if not graphed:
        return _solve(*args, graphed=False)
    caller = torch.cuda.current_stream(X0.device)
    side = _stream(X0.device)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        res = _solve(*args, graphed=True)
    caller.wait_stream(side)
    for t in res:
        t.record_stream(caller)
    return res
