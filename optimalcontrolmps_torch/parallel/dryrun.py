"""The multi-device paths of the port, once each, at tiny shapes.

Counterpart of `dryrun_multichip` in the JAX package's __graft_entry__.py,
at its shapes and precision (complex64 / float32), on a `mesh.Mesh`:

  1. the MPS multistart train step with the row-sharded exact Hessian
     (L=3, d=2, Npart=3, chi=6, T=0.08 so N_t=9, M=4, B=2 per rank; the
     brick sweep with range splits, as the JAX dry run);
  2. the sector multistart L-BFGS with the bound penalty (lane by lane
     autograd through `sector.cost`), then the global argmin;
  3. the lockstep interior point on the sector's exact Hessian with the
     path constraint u in [2, 100];
  4. the tensor-parallel Vidal rollout (L=5, d=2, chi=6, 5 controls).

`dryrun_multidevice(mesh)` runs them on the mesh's compute device and
returns what each produced (shapes, finiteness, costs), the same on every
rank for the global values.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import control, groundstate, sector, seeds, tebd, vidal
from ..optimize import minimize_interior_point, minimize_lbfgs_batch
from ..optimize.penalty import bound_penalty
from .comm import all_gather_cat, argmin_global
from .mesh import batch_shard
from .multistart import make_train_step

__all__ = ["dryrun_multidevice"]

GAMMA = 1e-6
DT = 0.01


def _mps_pieces(device, T=0.08, chi=6, M=4, L=3, d=2, npart=3):
    N = int(round(T / DT)) + 1
    c64 = torch.complex64
    # the JAX dry run's stepper: brick sweep, exact range splits (chi = 6
    # is above the exact rank bound 3)
    st = tebd.make_stepper(L, d, 1.0, DT, chi, dtype=c64, sweep="brick",
                           trunc_method="range", device=device)
    psi_i = groundstate.initialize_state(L, d, npart, 1.0, 2.5, chi,
                                         dtype=c64, device=device)
    psi_f = groundstate.initialize_state(L, d, npart, 1.0, 50.0, chi,
                                         dtype=c64, device=device)
    basis = control.chopped_sine_basis(seeds.adiabatic_seed(2.5, 50.0, N),
                                       DT, T, M, dtype=torch.float32,
                                       device=device)
    return st, psi_i, psi_f, basis


def _sector_pieces(device, T=0.08, M=4, L=3, d=2, npart=3):
    N = int(round(T / DT)) + 1
    c64 = torch.complex64
    st = sector.make_sector_stepper(L, d, npart, 1.0, DT, dtype=c64,
                                    device=device)
    psi_i = sector.sector_ground_state(L, d, npart, 1.0, 2.5, dtype=c64,
                                       device=device)
    psi_f = sector.sector_ground_state(L, d, npart, 1.0, 50.0, dtype=c64,
                                       device=device)
    basis = control.chopped_sine_basis(seeds.adiabatic_seed(2.5, 50.0, N),
                                       DT, T, M, dtype=torch.float32,
                                       device=device)
    return st, psi_i, psi_f, basis


def _lanes(fn):
    """fn(c (M,)) -> tuple of tensors, over the rows of C, stacked."""
    def batched(C):
        outs = [fn(c) for c in C]
        return tuple(torch.stack(x) for x in zip(*outs))
    return batched


def dryrun_multidevice(mesh) -> dict:
    """Run the four paths on `mesh` (every rank of it calls this)."""
    dev = mesh.device
    n = mesh.size
    B = 2 * n
    out = {"mesh": list(mesh.shape)}

    # 1. MPS train step, DP batch and row-sharded Hessian
    st, psi_i, psi_f, basis = _mps_pieces(dev)
    step, shard = make_train_step(st, psi_i, psi_f, basis, gamma=GAMMA,
                                  lr=10.0, mesh=mesh, with_hessian=True)
    cs = (np.zeros((B, basis.M), dtype=np.float32)
          + 0.01 * np.arange(B, dtype=np.float32)[:, None])
    cs_next, costs, best, hdiag = step(shard(cs))
    out["train_step"] = {
        "cs_next": list(cs_next.shape), "costs": list(costs.shape),
        "hdiag": list(hdiag.shape), "best_cost": float(best),
        "finite": bool(torch.isfinite(costs).all()
                       and torch.isfinite(hdiag).all())}

    # 2. sector multistart L-BFGS with the bound penalty + global argmin
    st2, pi2, pf2, basis2 = _sector_pieces(dev)

    def fg_one(c):
        with torch.enable_grad():
            c = c.detach().requires_grad_(True)
            u = basis2.convert_control(c)
            J = sector.cost(st2, pi2, pf2, u, GAMMA) + bound_penalty(u)
            (g,) = torch.autograd.grad(J, c)
        return J.detach(), g

    rng = np.random.default_rng(0)
    cs2 = torch.as_tensor(rng.normal(0, 0.1, (B, basis2.M))
                          .astype(np.float32), device=dev)
    cs2 = cs2[batch_shard(mesh, B)]
    res = minimize_lbfgs_batch(_lanes(fg_one), cs2, max_iter=8, tol=1e-5)
    all_f = all_gather_cat(res.f, mesh.group)
    am = argmin_global(res.f, mesh.group)
    out["sector_lbfgs"] = {"all_costs": all_f.cpu().tolist(),
                           "argmin": am.index, "best_cost": am.value,
                           "finite": bool(torch.isfinite(all_f).all())}

    # 3. lockstep interior point on the sector's exact Hessian
    def fgh_one(c):
        with torch.enable_grad():
            c = c.detach().requires_grad_(True)
            J = sector.cost(st2, pi2, pf2, basis2.convert_control(c), GAMMA)
            (g,) = torch.autograd.grad(J, c)
        H = basis2.convert_hessian(sector.hessian(
            st2, pi2, pf2, basis2.convert_control(c.detach()), GAMMA))
        return J.detach(), g, H

    ip = minimize_interior_point(_lanes(fgh_one), cs2, B=basis2.jacobian(),
                                 u0=basis2.u0, tol=1e-5, max_iter=5)
    ip_f = all_gather_cat(ip.f, mesh.group)
    out["interior_point"] = {"all_f": ip_f.cpu().tolist(),
                             "finite": bool(torch.isfinite(ip_f).all())}

    # 4. tensor-parallel Vidal rollout
    L3, d3, chi3 = 5, 2, 6
    c64 = torch.complex64
    st3 = tebd.make_stepper(L3, d3, 1.0, DT, chi3, dtype=c64, sweep="vidal",
                            device=dev)
    p0 = vidal.from_mps(groundstate.initialize_state(
        L3, d3, L3, 1.0, 2.5, chi3, dtype=c64, device=dev), device=dev)
    u3 = torch.as_tensor(np.linspace(2.5, 50.0, 5, dtype=np.float32),
                         device=dev)
    psiT = vidal.rollout_final_tp(st3, p0, u3, mesh)
    out["tp_rollout"] = {"B": list(psiT.B.shape),
                         "lam": vidal.schmidt_values(psiT).tolist(),
                         "finite": bool(torch.isfinite(psiT.lam).all())}
    return out
