"""The port's multi-device layer (optimalcontrolmps_torch/parallel) against
the unsharded port and the JAX package, on the CPU.

One module-scoped world of 2 gloo ranks (`parallel.spawn.run_world`, rank
function in tests/torch_parallel_world.py) runs every sharded function
once; the comparisons use the JAX package's UNSHARDED calls (mesh=None,
engine.hessian, vidal.rollout_final), at tests/test_parallel.py's and
tests/test_multistart.py's shapes and tolerances:
* sharded multistart L-BFGS (float64): all_costs = unsharded (port and
  JAX) to 1e-10, best = min;
* the sector multistart with exact=True (the fused chain's twin, float64):
  all_costs = JAX's exact=True to rtol 1e-6, in 8 iterations instead of 40;
* the train step on a (1, 2) mesh (rows split over the ranks): the Hessian
  diagonal = engine.hessian to 1e-10;
* the tensor-parallel Vidal rollout (bonds split over 2 ranks): |<tp|ref>|
  to 1e-10 of 1, Schmidt values to 1e-6, against the port's and JAX's
  rollout_final;
* scaling_bench at world 2 gives rows [1, 2]; the four dry-run paths run;
* mesh shapes as the JAX make_mesh; argmin as jnp.argmin (ties, NaN);
  init_distributed raises when the backend cannot start; run_world kills
  a world that outlives its deadline.
"""

import multiprocessing
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import torch_parallel_world as W
from optimalcontrolmps_tpu import control as jcontrol
from optimalcontrolmps_tpu import engine as jengine
from optimalcontrolmps_tpu import groundstate as jgs
from optimalcontrolmps_tpu import mps as jmps
from optimalcontrolmps_tpu import sector as jsector
from optimalcontrolmps_tpu import tebd as jtebd
from optimalcontrolmps_tpu import vidal as jvidal
from optimalcontrolmps_tpu.parallel import make_mesh as jmake_mesh
from optimalcontrolmps_tpu.parallel import multistart_lbfgs as jmultistart
from optimalcontrolmps_torch import engine, mps, vidal
from optimalcontrolmps_torch.parallel import comm, mesh, spawn
from optimalcontrolmps_torch.parallel.multistart import multistart_lbfgs
from optimalcontrolmps_torch.parallel.spawn import run_world

WORLD = 2


@pytest.fixture(scope="module")
def ranks():
    return run_world(W.rank_work, WORLD, "gloo", "cpu", threads=2)


@pytest.fixture(scope="module")
def jax_pieces():
    st = jtebd.make_stepper(W.L, W.D, 1.0, W.TSTEP, W.CHI)
    psi_i = jgs.initialize_state(W.L, W.D, W.NPART, 1.0, 2.5, W.CHI)
    psi_f = jgs.initialize_state(W.L, W.D, W.NPART, 1.0, 50.0, W.CHI)
    basis = jcontrol.chopped_sine_basis(np.linspace(2.5, 50.0, W.N),
                                        W.TSTEP, W.T, W.M)
    return st, psi_i, psi_f, basis


@pytest.fixture(scope="module")
def port_unsharded():
    st, psi_i, psi_f, basis = W.mps_pieces()
    return multistart_lbfgs(st, psi_i, psi_f, basis, W.c0_batch(),
                            gamma=W.GAMMA, max_iter=W.MS_ITERS)


# ---------------------------------------------------------------------------
# pure functions: mesh shapes, shards, argmin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_matches_jax_make_mesh(n):
    assert mesh._factor(n) == jmake_mesh(n).devices.shape
    assert mesh.mesh_shape(n) == jmake_mesh(n).devices.shape


def test_mesh_shape_with_rows_and_shards():
    assert mesh.mesh_shape(4, rows=2) == jmake_mesh(4, rows=2).devices.shape
    with pytest.raises(ValueError):
        mesh.mesh_shape(4, rows=3)
    m = mesh.Mesh(shape=(2, 2), rank=3, device=torch.device("cpu"),
                  group=None, rows_group=None)
    assert (m.size, m.n_rows, m.row_rank) == (4, 2, 1)
    assert list(range(16))[mesh.batch_shard(m, 16)] == [12, 13, 14, 15]
    assert list(range(9))[mesh.row_shard(m, 9)] == [1, 3, 5, 7]
    with pytest.raises(ValueError, match="divide"):
        mesh.batch_shard(m, 6)


@pytest.mark.parametrize("x", [[3.0, 1.0, 1.0, 2.0], [2.0, np.nan, 0.0,
                                                      np.nan], [5.0]])
def test_argmin_follows_jnp(x):
    assert comm.argmin(torch.tensor(x)) == int(jnp.argmin(jnp.array(x)))


def test_argmin_global_follows_jnp(ranks):
    parts = {"argmin_ties": ([3.0, 1.0, 1.0], [1.0, 0.5, 0.5]),
             "argmin_nan": ([3.0, 1.0, 2.0], [0.0, np.nan, np.nan])}
    for name, (a, b) in parts.items():
        k = int(jnp.argmin(jnp.array(a + b)))
        for r in ranks:
            assert r[name] == (k, k // 3, k % 3), name


def test_make_mesh_in_the_world(ranks):
    for r in ranks:
        assert tuple(r["mesh_batch"]) == (2, 1)
        assert tuple(r["mesh_rows"]) == (1, 2)


def test_run_world_kills_a_world_past_its_deadline(monkeypatch):
    """Ranks that sleep past TIMEOUT: RuntimeError names them within a
    few seconds of the deadline, and no rank process is left alive."""
    monkeypatch.setattr(spawn, "TIMEOUT", 3.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match=r"rank\(s\) \[0, 1\] did not report"):
        run_world(W.sleep_past_deadline, WORLD, "gloo", "cpu",
                  args=(300.0,), threads=1)
    assert time.monotonic() - t0 < 3.0 + 10.0
    assert multiprocessing.active_children() == []


def test_init_distributed_raises_when_the_backend_cannot_start():
    with pytest.raises((AssertionError, ValueError, RuntimeError)):
        mesh.init_distributed(backend="no_such_backend", device="cpu")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# sharded multistart
# ---------------------------------------------------------------------------

def test_sharded_multistart_matches_unsharded(ranks, port_unsharded):
    ref = port_unsharded.all_costs.numpy()
    for r in ranks:
        ms = r["ms"]
        np.testing.assert_allclose(ms["all_costs"], ref, atol=1e-10)
        assert float(ms["best_cost"]) == float(ms["all_costs"].min())
        np.testing.assert_array_equal(ms["converged"],
                                      port_unsharded.converged.numpy())
    k = int(np.argmin(ref))
    np.testing.assert_allclose(ranks[0]["ms"]["best_c"],
                               port_unsharded.best_c.numpy(), atol=1e-10)
    np.testing.assert_array_equal(ranks[0]["ms"]["best_c"],
                                  ranks[1]["ms"]["best_c"])
    assert k == int(np.argmin(ranks[0]["ms"]["all_costs"]))


def test_multistart_matches_jax(ranks, jax_pieces):
    st, psi_i, psi_f, basis = jax_pieces
    res = jmultistart(st, psi_i, psi_f, basis, jnp.asarray(W.c0_batch()),
                      gamma=W.GAMMA, max_iter=W.MS_ITERS, mesh=None)
    np.testing.assert_allclose(ranks[0]["ms"]["all_costs"],
                               np.asarray(res.all_costs), atol=1e-10)
    assert abs(float(ranks[1]["ms"]["best_cost"])
               - float(res.best_cost)) < 1e-10


def test_sector_exact_multistart_matches_jax(ranks):
    s = W.SEC
    st = jsector.make_sector_stepper(s["L"], s["d"], s["npart"], 1.0,
                                     s["dt"])
    psi_i = jsector.sector_ground_state(s["L"], s["d"], s["npart"], 1.0, 2.5)
    psi_f = jsector.sector_ground_state(s["L"], s["d"], s["npart"], 1.0,
                                        50.0)
    basis = jcontrol.chopped_sine_basis(W.sector_u0(), s["dt"], s["T"],
                                        s["M"])
    res = jmultistart(st, psi_i, psi_f, basis, W.sector_seeds(),
                      gamma=W.GAMMA, max_iter=W.SEC_ITERS, tol=W.SEC_TOL,
                      exact=True)
    for r in ranks:
        np.testing.assert_allclose(r["sector"]["all_costs"],
                                   np.asarray(res.all_costs), rtol=1e-6)
        assert float(r["sector"]["best_cost"]) == \
            float(r["sector"]["all_costs"].min())
    J0 = float(jsector.cost(st, psi_i, psi_f,
                            basis.convert_control(jnp.zeros(s["M"])),
                            W.GAMMA))
    assert float(ranks[0]["sector"]["best_cost"]) < J0


# ---------------------------------------------------------------------------
# the train step: batch over the ranks, Hessian rows split over them
# ---------------------------------------------------------------------------

def test_train_step_row_sharded_hessian_matches_jax(ranks, jax_pieces):
    st, psi_i, psi_f, basis = jax_pieces
    u0 = basis.convert_control(jnp.zeros(W.M))
    H = np.asarray(jengine.hessian(st, psi_i, psi_f, u0, W.GAMMA))
    for r in ranks:
        assert r["train"]["hdiag"].shape == (W.N,)
        np.testing.assert_allclose(r["train"]["hdiag"], np.diagonal(H),
                                   atol=1e-10)
        assert r["train"]["costs"].shape == (16,)
        assert r["train"]["cs_next"].shape == (8, W.M)


def test_train_step_matches_unsharded_port(ranks):
    from optimalcontrolmps_torch.parallel.multistart import make_train_step
    st, psi_i, psi_f, basis = W.mps_pieces()
    step, shard = make_train_step(st, psi_i, psi_f, basis, gamma=W.GAMMA,
                                  lr=10.0, with_hessian=True)
    assert shard is None
    cs2, costs, best, hdiag = step(torch.zeros(16, W.M,
                                               dtype=torch.float64))
    np.testing.assert_allclose(ranks[0]["train"]["hdiag"], hdiag.numpy(),
                               atol=1e-10)
    np.testing.assert_allclose(ranks[1]["train"]["costs"], costs.numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(np.concatenate(
        [r["train"]["cs_next"] for r in ranks]), cs2.numpy(), atol=1e-12)
    H = engine.hessian(st, psi_i, psi_f,
                       basis.convert_control(torch.zeros(W.M,
                                                         dtype=torch.float64)),
                       W.GAMMA)
    np.testing.assert_allclose(ranks[1]["train"]["hdiag"],
                               torch.diagonal(H).numpy(), atol=1e-10)


# ---------------------------------------------------------------------------
# tensor-parallel Vidal rollout
# ---------------------------------------------------------------------------

def _overlap(a, b):
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def test_tp_rollout_matches_port_rollout(ranks):
    st, psi0 = W.tp_pieces()
    ref = vidal.rollout_final(st, psi0, torch.as_tensor(W.tp_controls()))
    v_ref = mps.to_statevector(ref.B[None])[0].numpy()
    for r in ranks:
        v_tp = mps.to_statevector(torch.as_tensor(r["tp"]["B"])[None])[0]
        assert abs(_overlap(v_ref, v_tp.numpy()) - 1.0) < 1e-10
        np.testing.assert_allclose(r["tp"]["schmidt"],
                                   vidal.schmidt_values(ref), atol=1e-6)
    np.testing.assert_array_equal(ranks[0]["tp"]["B"], ranks[1]["tp"]["B"])


def test_tp_rollout_matches_jax_rollout(ranks):
    p = W.TP
    st = jtebd.make_stepper(p["L"], p["d"], 1.0, 0.01, p["chi"],
                            sweep="vidal")
    psi0 = jvidal.from_mps(jgs.initialize_state(p["L"], p["d"], p["npart"],
                                                1.0, 2.5, p["chi"]))
    ref = jvidal.rollout_final(st, psi0, jnp.asarray(W.tp_controls()))
    v_ref = np.asarray(jmps.to_statevector(ref.B))
    for r in ranks:
        v_tp = mps.to_statevector(torch.as_tensor(r["tp"]["B"])[None])[0]
        assert abs(_overlap(v_ref, v_tp.numpy()) - 1.0) < 1e-10
        np.testing.assert_allclose(r["tp"]["schmidt"],
                                   jvidal.schmidt_values(ref), atol=1e-6)


# ---------------------------------------------------------------------------
# the harness and the dry run
# ---------------------------------------------------------------------------

def test_scaling_bench_at_world_two(ranks):
    for r in ranks:
        rows = r["scaling"]["rows"]
        assert [x["devices"] for x in rows] == [1, 2]
        assert [x["batch"] for x in rows] == [4, 8]
        for x in rows:
            assert x["ramps_per_s"] > 0
            assert np.isfinite(x["efficiency"])
    assert ranks[0]["scaling"]["rows"] == ranks[1]["scaling"]["rows"]


def test_dryrun_multidevice_at_world_two(ranks):
    for r in ranks:
        d = r["dryrun"]
        assert d["mesh"] == [2, 1]
        assert d["train_step"]["cs_next"] == [2, 4]
        assert d["train_step"]["costs"] == [4]
        assert d["train_step"]["hdiag"] == [9]     # N_t rows
        assert len(d["sector_lbfgs"]["all_costs"]) == 4
        assert d["sector_lbfgs"]["best_cost"] == \
            min(d["sector_lbfgs"]["all_costs"])
        assert len(d["interior_point"]["all_f"]) == 4
        assert d["tp_rollout"]["B"] == [5, 6, 3, 6]
        for path in ("train_step", "sector_lbfgs", "interior_point",
                     "tp_rollout"):
            assert d[path]["finite"], path
    assert ranks[0]["dryrun"] == ranks[1]["dryrun"]
