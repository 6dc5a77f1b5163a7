"""The rank function of tests/test_torch_parallel.py, in a module of its own
so that the spawned ranks import torch and the port only (not JAX, not the
test module). Also the port's problem pieces, built the same way in the
ranks and in the test process.

Shapes: the multistart and train-step pieces of tests/test_parallel.py
(L=4, d=3, Npart=4, chi=16, T=0.1, M=4, complex128); the sector pieces of
tests/test_multistart.py (L=5, d=4, Npart=5, T=0.5, M=8); the Vidal chain
of test_parallel.py's tensor-parallel test (L=6, d=3, chi=12).
"""

import numpy as np
import torch

from optimalcontrolmps_torch import (control, groundstate, sector, seeds,
                                     tebd, vidal)

L, D, NPART = 4, 3, 4
T, TSTEP, M, CHI = 0.1, 1e-2, 4, 16
N = int(T / TSTEP + 1)
GAMMA = 1e-6
MS_ITERS = 5

SEC = dict(T=0.5, dt=0.01, M=8, L=5, d=4, npart=5)
SEC_ITERS = 8
SEC_TOL = 1e-6

TP = dict(L=6, d=3, npart=6, chi=12, n_u=9)


def c0_batch():
    """test_parallel.py's 8 seeds."""
    return np.random.default_rng(0).normal(0, 0.3, (8, M))


def sector_seeds():
    """test_multistart.py's _seed_batch(8, M)."""
    return np.random.default_rng(7).uniform(-0.3, 0.3,
                                            size=(8, SEC["M"]))


def sector_u0():
    n = int(round(SEC["T"] / SEC["dt"])) + 1
    return seeds.linsigmoid_seed(2.5, 50.0, n,
                                 rng=np.random.default_rng(123456789))


def tp_controls():
    return seeds.linspace(2.5, 50.0, TP["n_u"])


def mps_pieces(device="cpu"):
    st = tebd.make_stepper(L, D, 1.0, TSTEP, CHI, device=device)
    psi_i = groundstate.initialize_state(L, D, NPART, 1.0, 2.5, CHI,
                                         device=device)
    psi_f = groundstate.initialize_state(L, D, NPART, 1.0, 50.0, CHI,
                                         device=device)
    basis = control.chopped_sine_basis(seeds.linspace(2.5, 50.0, N), TSTEP,
                                       T, M, device=device)
    return st, psi_i, psi_f, basis


def sector_pieces(device="cpu"):
    s = SEC
    st = sector.make_sector_stepper(s["L"], s["d"], s["npart"], 1.0,
                                    s["dt"], device=device)
    psi_i = sector.sector_ground_state(s["L"], s["d"], s["npart"], 1.0, 2.5,
                                       device=device)
    psi_f = sector.sector_ground_state(s["L"], s["d"], s["npart"], 1.0,
                                       50.0, device=device)
    basis = control.chopped_sine_basis(sector_u0(), s["dt"], s["T"], s["M"],
                                       device=device)
    return st, psi_i, psi_f, basis


def tp_pieces(device="cpu"):
    p = TP
    st = tebd.make_stepper(p["L"], p["d"], 1.0, 0.01, p["chi"],
                           sweep="vidal", device=device)
    A = groundstate.initialize_state(p["L"], p["d"], p["npart"], 1.0, 2.5,
                                     p["chi"], device=device)
    return st, vidal.from_mps(A, device=device)


def _np(t):
    return t.detach().cpu().numpy()


def rank_work(rank, world):
    """Every sharded function of the port once, on a world of `world`
    gloo ranks on the CPU; returns host arrays."""
    from optimalcontrolmps_torch.drivers import scaling_bench
    from optimalcontrolmps_torch.parallel import comm, dryrun
    from optimalcontrolmps_torch.parallel.mesh import make_mesh
    from optimalcontrolmps_torch.parallel.multistart import (
        make_train_step, multistart_lbfgs)

    m_batch = make_mesh(world)             # (world, 1): data parallel
    m_rows = make_mesh(world, rows=world)  # (1, world): rows / bonds
    out = {"rank": rank, "mesh_batch": m_batch.shape,
           "mesh_rows": m_rows.shape}

    # jnp.argmin semantics across ranks: ties to the first, NaN first
    vals = {0: [3.0, 1.0, 1.0], 1: [1.0, 0.5, 0.5]}
    nans = {0: [3.0, 1.0, 2.0], 1: [0.0, float("nan"), float("nan")]}
    for name, v in (("argmin_ties", vals), ("argmin_nan", nans)):
        a = comm.argmin_global(torch.tensor(v[rank % 2]), m_batch.group)
        out[name] = (a.index, a.owner, a.local_index)

    st, psi_i, psi_f, basis = mps_pieces()
    res = multistart_lbfgs(st, psi_i, psi_f, basis, c0_batch(), gamma=GAMMA,
                           max_iter=MS_ITERS, mesh=m_batch)
    out["ms"] = {k: _np(getattr(res, k)) for k in res._fields}

    step, shard = make_train_step(st, psi_i, psi_f, basis, gamma=GAMMA,
                                  lr=10.0, mesh=m_rows, with_hessian=True)
    cs = shard(np.zeros((16, M)))
    cs2, costs, best, hdiag = step(cs)
    out["train"] = {"cs_next": _np(cs2), "costs": _np(costs),
                    "best": float(best), "hdiag": _np(hdiag)}

    st_s, pi_s, pf_s, basis_s = sector_pieces()
    res_s = multistart_lbfgs(st_s, pi_s, pf_s, basis_s, sector_seeds(),
                             gamma=GAMMA, max_iter=SEC_ITERS, tol=SEC_TOL,
                             mesh=m_batch, exact=True)
    out["sector"] = {k: _np(getattr(res_s, k)) for k in res_s._fields}

    st_v, psi0 = tp_pieces()
    u = torch.as_tensor(tp_controls())
    tp = vidal.rollout_final_tp(st_v, psi0, u, m_rows)
    out["tp"] = {"B": _np(tp.B), "schmidt": vidal.schmidt_values(tp)}

    out["scaling"] = scaling_bench.run(per_device_batch=4, steps=1)
    out["dryrun"] = dryrun.dryrun_multidevice(m_batch)
    return out
