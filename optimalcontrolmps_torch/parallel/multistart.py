"""Sharded multistart optimization: the port's scale-out layer.

Counterpart of optimalcontrolmps_tpu/parallel/multistart.py. The reference
optimizes one ramp per process; the JAX package solves a (B, M) batch of
GROUP coefficient vectors in lockstep, sharded over a device mesh, with a
best-of-batch argmin across devices. Here each rank of a `mesh.Mesh` solves
its slice of the batch (`mesh.batch_shard`) with the lockstep batch L-BFGS
(`optimize.lbfgs.minimize_lbfgs_batch`, lane by lane the JAX package's
vmapped `minimize_lbfgs`), and the ranks then gather the costs, take the
global argmin and broadcast the winner (`comm.py`).

The batch objective (`_group_cost_and_grad`) is J = 0.5 (1 - F) + reg, with
no bound penalty, and dJ/dc for every lane:
* a sector stepper (exact=True): the fused chain (`ops.sector_chain.
  chain_final`, both sector kernels on the card) with autograd through it,
  the same J and dJ/du as `sector.cost_and_gradient_exact`. The kernels
  take a complex64 stepper; a complex128 one runs the chain's twin on the
  CPU and is refused on the card. The sector's batch objective has no
  adjoint-gradient route, so exact=False raises for it;
* a TEBD stepper (snake or Vidal): the engine's lane-batched adjoint
  gradient, whose bond updates are bond-theta launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import sector
from ..backends import engine_for
from ..engine import regularization
from ..ops.sector_chain import chain_constants, chain_final
from ..optimize.lbfgs import minimize_lbfgs_batch
from .comm import all_gather_cat, argmin, argmin_global, broadcast_from
from .mesh import batch_shard

__all__ = ["MultistartResult", "multistart_lbfgs", "make_train_step"]


class MultistartResult(NamedTuple):
    """best_c (M,), best_cost, all_costs (B,) and converged (B,) of the
    whole batch, the same on every rank."""
    best_c: torch.Tensor
    best_cost: torch.Tensor
    all_costs: torch.Tensor
    converged: torch.Tensor


def _group_cost_and_grad(st, psi_i, psi_f, basis, gamma, C,
                         exact: bool = False, consts=None):
    """(J (B,), dJ/dC (B, M)) of a coefficient batch C (B, M). consts:
    `chain_constants` of the sector path, made here when omitted."""
    if engine_for(st) is sector:
        if not exact:
            raise ValueError("the sector engine's batch objective is the "
                             "exact gradient through the fused chain: pass "
                             "exact=True")
        return _chain_cost_and_grad(st, psi_i, psi_f, basis, gamma, C,
                                    consts)
    eng = engine_for(st)
    U = basis.convert_control(C)
    g_u, (_, _, _, ov) = eng.gradient(st, psi_i, psi_f, U, gamma)
    fid = (ov * ov.conj()).real
    J = 0.5 * (1.0 - fid) + regularization(U, gamma, st.dt)
    return J, g_u @ basis.jacobian()


def _chain_cost_and_grad(st, psi_i, psi_f, basis, gamma, C, consts=None):
    if consts is None:
        consts = chain_constants(st, psi_i, real=st.nn1.dtype)
    with torch.enable_grad():
        C = C.detach().requires_grad_(True)
        U = basis.convert_control(C)
        psiT = chain_final(st, U, psi_i, consts)
        ov = psiT @ psi_f.conj().to(psiT.dtype)
        fid = (ov * ov.conj()).real
        J = 0.5 * (1.0 - fid) + regularization(U, gamma, st.dt)
        (G,) = torch.autograd.grad(J.sum(), C)
    return J.detach(), G


def _objective(st, psi_i, psi_f, basis, gamma, exact):
    consts = None
    if exact and engine_for(st) is sector:
        consts = chain_constants(st, psi_i, real=st.nn1.dtype)
    return lambda C: _group_cost_and_grad(st, psi_i, psi_f, basis, gamma, C,
                                          exact=exact, consts=consts)


def _best(x_local, f_local, mesh):
    """(k, all_costs, best row of x) over the mesh, or locally."""
    if mesh is None:
        k = argmin(f_local)
        return k, f_local, x_local[k]
    costs = all_gather_cat(f_local, mesh.group)
    am = argmin_global(f_local, mesh.group)
    mine = x_local[am.local_index] if mesh.rank == am.owner \
        else torch.zeros_like(x_local[0])
    return am.index, costs, broadcast_from(mine, am.owner, mesh.group)


def _coefficients(basis, cs) -> torch.Tensor:
    return torch.as_tensor(cs, device=basis.f.device).to(basis.f.dtype)


def multistart_lbfgs(st, psi_i, psi_f, basis, c0_batch, gamma=0.0,
                     max_iter=100, tol=1e-7, mesh=None, exact=False):
    """Optimize a batch of seeds in lockstep; returns best-of-batch.

    c0_batch: the whole (B, M) batch (numpy or a tensor) on every rank. If
    `mesh` is given each rank solves its slice (B must divide over the
    mesh), and every rank returns the same MultistartResult of the whole
    batch; without it the one process solves all B. Any stepper (MPS snake
    or Vidal, or the fixed-N sector); `exact=True` takes the sector's
    exact gradient through the fused chain (see the module docstring)."""
    C0 = _coefficients(basis, c0_batch)
    if mesh is not None:
        C0 = C0[batch_shard(mesh, C0.shape[0])]
    res = minimize_lbfgs_batch(
        _objective(st, psi_i, psi_f, basis, gamma, exact), C0,
        max_iter=max_iter, tol=tol)
    k, costs, best_c = _best(res.x, res.f, mesh)
    converged = res.converged if mesh is None else \
        all_gather_cat(res.converged, mesh.group)
    return MultistartResult(best_c=best_c, best_cost=costs[k],
                            all_costs=costs, converged=converged)


def make_train_step(st, psi_i, psi_f, basis, gamma=1e-6, lr=50.0, mesh=None,
                    with_hessian=False):
    """One multistart optimization step:

      1. the batched cost and gradient of this rank's lanes;
      2. a gradient update of every ramp;
      3. the best-of-batch cost by a global argmin over the mesh;
      4. optionally the exact Hessian of the best ramp, its time rows split
         over the mesh's "rows" axis (`engine.hessian(row_shard=mesh)`).

    Returns (step, shard). step(cs) -> (cs_next, costs, best_cost[,
    hess_diag]): cs is this rank's shard (B_local, M) of the batch, and
    cs_next is the updated shard; costs (B,) covers the whole batch,
    best_cost and hess_diag (N_t,) are global, the same on every rank.
    shard(cs) takes the whole (B, M) batch (numpy or a tensor) to this
    rank's shard on the compute device. Without a mesh, step takes and
    returns the whole batch, and shard is None."""
    eng = engine_for(st)
    fg = _objective(st, psi_i, psi_f, basis, gamma, exact=False)

    def step(cs):
        J, g = fg(cs)
        cs_next = cs - lr * g
        k, costs, c_best = _best(cs, J, mesh)
        out = (cs_next, costs, costs[k])
        if with_hessian:
            H = eng.hessian(st, psi_i, psi_f, basis.convert_control(c_best),
                            gamma, row_shard=mesh)
            out = out + (torch.diagonal(H),)
        return out

    if mesh is None:
        return step, None

    def shard(cs):
        C = _coefficients(basis, cs)
        return C[batch_shard(mesh, C.shape[0])]

    return step, shard
