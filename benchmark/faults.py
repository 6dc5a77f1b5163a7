"""Faults planted in the program under a run, to see each cell's check come
out not correct: a step that returns its state unchanged; half of the batch
left out (its other half copied in); an answer altered where it is
produced; and, for the multistart cell, the optimizer stopped early, its
convergence test loosened, or its quasi-Newton update dropped. No cell
spans chips, so none can drop an exchange.

`planted(cell, fault)` is a context manager that puts one fault in place
and takes it out again. `benchmark/tests/test_bench_faults.py` runs each at
a small size on the CPU; `benchmark/control.py --fault` reads one at the
cell's own size on the card.
"""

from __future__ import annotations

import contextlib

import torch


# -- multistart: the sector chain --------------------------------------------

def chain_unchanged(old):
    def f(dt, Wr, Wi, nn1, u, h0r, h0i):
        B = u.shape[0]
        return (h0r.expand(B, -1).contiguous(), h0i.expand(B, -1).contiguous())
    return f


def chain_half(old):
    def f(dt, Wr, Wi, nn1, u, h0r, h0i):
        h = u.shape[0] // 2
        hr, hi = old(dt, Wr, Wi, nn1, u[:h].contiguous(), h0r, h0i)
        return torch.cat([hr, hr]), torch.cat([hi, hi])
    return f


def chain_altered(old):
    def f(*a):
        hr, hi = old(*a)
        return hr + 1e-3, hi
    return f


# -- multistart: the lockstep L-BFGS ------------------------------------------

def lbfgs_early_stop(old):
    """The batch stops after a fifth of its iterations."""
    def f(fg, X0, max_iter=100, tol=1e-8, **k):
        return old(fg, X0, max_iter=max(1, max_iter // 5), tol=tol, **k)
    return f


def lbfgs_loose_tol(old):
    """A lane counts as converged at a hundred times the tolerance."""
    def f(fg, X0, max_iter=100, tol=1e-8, **k):
        return old(fg, X0, max_iter=max_iter, tol=100.0 * tol, **k)
    return f


def two_loop_dropped(old):
    """The quasi-Newton update left out: every direction is the gradient's."""
    return lambda g, S, Y, rho, head, count, m: g


# -- mps gradient: the TEBD engine --------------------------------------------

def tebd_unchanged(old):
    return lambda st, A, u_from, u_to, forward=True: A


def gradient_half(old):
    def f(st, psi0, psi_t, u, gamma):
        h = u.shape[0] // 2
        g, aux = old(st, psi0, psi_t, u[:h], gamma)
        ov = torch.cat([aux[3], aux[3]])
        return torch.cat([g, g]), (None, None, None, ov)
    return f


def cost_and_gradient_altered(old):
    def f(*a):
        J, g = old(*a)
        g = g.clone()
        g[..., 3] += 1e-3 * g.abs().max()
        return J, g
    return f


# -- vidal gradient -----------------------------------------------------------

def vidal_unchanged(old):
    return lambda st, state, u_from, u_to, forward=True, **k: state


def bond_update_half(old):
    def f(Bi, Bj, lam_left, gate, chi):
        h = max(1, Bi.shape[0] // 2)
        Bi2, Bj2, lam2, disc2 = old(Bi[:h], Bj[:h], lam_left[:h], gate, chi)
        return (torch.cat([Bi2, Bi[h:]]), torch.cat([Bj2, Bj[h:]]),
                torch.cat([lam2, lam_left[h:]]),
                torch.cat([disc2, disc2.new_zeros(Bi.shape[0] - h)]))
    return f


# (module, attribute, replacement) per fault of each cell; the modules are
# named, and imported only when a fault is planted
FAULTS = {
    "bh_L5.multistart": {
        "unchanged": [("ops.sector_chain", "chain_fwd", chain_unchanged)],
        "half_batch": [("ops.sector_chain", "chain_fwd", chain_half)],
        "altered": [("ops.sector_chain", "chain_fwd", chain_altered)],
        "early_stop": [("flagship", "minimize_lbfgs_batch",
                        lbfgs_early_stop)],
        "loose_tol": [("flagship", "minimize_lbfgs_batch", lbfgs_loose_tol)],
        "no_update": [("optimize.lbfgs", "_two_loop_batch",
                       two_loop_dropped)],
    },
    "bh_L5.mps_gradient": {
        "unchanged": [("engine", "tebd_step", tebd_unchanged)],
        "half_batch": [("engine", "gradient", gradient_half)],
        "altered": [("engine", "cost_and_gradient",
                     cost_and_gradient_altered)],
    },
    "bh_N20.vidal_gradient": {
        "unchanged": [("vidal", "vidal_step", vidal_unchanged)],
        "half_batch": [("vidal", "_bond_update", bond_update_half)],
        "altered": [("vidal", "cost_and_gradient",
                     cost_and_gradient_altered)],
    },
}


@contextlib.contextmanager
def planted(cell: str, fault: str | None):
    """The program with `fault` in place (None: unbroken) while the block
    runs."""
    import importlib
    with contextlib.ExitStack() as stack:
        for mod, name, new in (FAULTS[cell][fault] if fault else ()):
            obj = importlib.import_module("optimalcontrolmps_torch." + mod)
            old = getattr(obj, name)
            stack.callback(setattr, obj, name, old)
            setattr(obj, name, new(old))
        yield
