"""Parity of the port's Vidal engine with the JAX package's.

Both packages run on the CPU in complex128 on the same inputs (numpy seeds),
at the JAX tests' own tolerances (tests/test_vidal.py):
* `from_mps` round trip and Schmidt spectra: 1e-10 (:41-50);
* forward and backward steps against the dense propagator (`exact.py`):
  1e-9, Schmidt spectra 1e-6 (:53-87);
* the Vidal engine against the snake engine without truncation (cost,
  gradient, fidelities): 1e-8; `gradient_lowmem` against `gradient`:
  1e-10 (:90-117);
* the truncating regime (L=6, d=2, chi=4): infidelity < 5e-3 and within 5x
  the snake's, norm and Schmidt norms to 1e-10 (:120-149);
* the guards (:184-193); the Hessian against finite differences (5e-3 of
  its scale, :196-233) and against the snake engine's without truncation
  (1e-6, :236-249).
Each result is also held against the JAX vidal function on the same inputs.
Only determined quantities are compared (states up to a phase, spectra,
costs, gradients): the eigh split resolves small Schmidt values to ~sqrt(eps)
only, so site tensors differ by gauge.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu import groundstate as jgs
from optimalcontrolmps_tpu import mps as jmps
from optimalcontrolmps_tpu import tebd as jtebd
from optimalcontrolmps_tpu import vidal as jvidal
from optimalcontrolmps_torch import (backends, engine, exact, groundstate,
                                     mps, seeds, tebd, vidal)


L, D, NPART, J, DT, CHI = 5, 4, 5, 1.0, 0.01, 30
# the engine comparisons: the exact rank bound of L=4, d=3 is chi=16
LE, DE, CHIE, N = 4, 3, 16, 11


def _sv(state):
    """Dense (p**L,) vector of one Vidal (or plain MPS) state."""
    B = state.B if isinstance(state, vidal.VidalState) else state
    return mps.to_statevector(B[None])[0].numpy()


def _same_up_to_phase(a, b, tol):
    ph = np.vdot(a, b)
    assert abs(abs(ph) - 1.0) < tol
    np.testing.assert_allclose(a * ph / abs(ph), b, atol=tol)


def _exact_schmidt(vec, p, bond, chi):
    s = np.linalg.svd(np.asarray(vec).reshape(p ** (bond + 1), -1),
                      compute_uv=False)
    out = np.zeros(chi)
    k = min(chi, s.size)
    out[:k] = s[:k]
    return out / np.linalg.norm(out)


@pytest.fixture(scope="module")
def setup():
    vec = groundstate.ground_statevector(L, D, NPART, J, 2.0)
    A = mps.from_statevector(vec, L, D + 1, CHI)
    return (tebd.make_stepper(L, D, J, DT, CHI, sweep="vidal", device="cpu"),
            exact.make_exact_stepper(L, D, J, DT, device="cpu"), vec,
            vidal.from_mps(A, device="cpu"), A)


@pytest.fixture(scope="module")
def jax_setup(setup):
    """JAX's Vidal stepper and JAX's from_mps of setup's MPS."""
    return (jtebd.make_stepper(L, D, J, DT, CHI, sweep="vidal"),
            jvidal.from_mps(setup[4]))


def test_from_mps_roundtrip_matches_jax(setup, jax_setup):
    _, _, vec, state, A = setup
    np.testing.assert_allclose(_sv(state), vec, atol=1e-10)
    for b in range(L - 1):
        np.testing.assert_allclose(vidal.schmidt_values(state)[b],
                                   _exact_schmidt(vec, D + 1, b, CHI),
                                   atol=1e-10)
    js = jax_setup[1]
    np.testing.assert_allclose(state.lam.numpy(), np.asarray(js.lam),
                               atol=1e-10)
    np.testing.assert_allclose(_sv(state),
                               np.asarray(jmps.to_statevector(js.B)),
                               atol=1e-10)
    assert state.B.dtype == torch.complex128
    assert state.lam.dtype == torch.float64
    s64 = vidal.from_mps(A.astype(np.complex64), device="cpu")
    assert s64.B.dtype == torch.complex64 and s64.lam.dtype == torch.float32


# JAX_STEPS: the JAX comparison runs the ramp's first steps (JAX's CPU
# eigh of the (2, 150, 150) stage batch is ~0.1 s a call)
JAX_STEPS = 5


@pytest.mark.parametrize("forward", [True, False])
def test_vidal_step_matches_statevector_and_jax(setup, jax_setup, forward):
    """20 forward steps 2 -> 50 or 10 backward steps 50 -> 2 against the
    dense propagator, Schmidt spectra after them; the state after the
    first JAX_STEPS steps against JAX's vidal_step."""
    st, est, vec, state, _ = setup
    u = np.linspace(2.0, 50.0, 21) if forward else np.linspace(50.0, 2.0,
                                                                 11)
    s = vidal.VidalState(state.B[None], state.lam[None])
    psi = torch.as_tensor(vec)
    for i in range(len(u) - 1):
        s = vidal.vidal_step(st, s, u[i], u[i + 1], forward)
        psi = exact.exact_step(est, psi, u[i], u[i + 1], forward)
        if i + 1 == JAX_STEPS:
            s_prefix = vidal.VidalState(s.B[0], s.lam[0])
    s = vidal.VidalState(s.B[0], s.lam[0])
    pv = psi.numpy()
    _same_up_to_phase(_sv(s), pv, 1e-9)
    # canonical form: lam is the exact Schmidt spectrum (the floor is the
    # jitter's ~1e-12 tr(rho)/m shift of the zero tail, sqrt ~1e-7)
    for b in range(L - 1):
        np.testing.assert_allclose(vidal.schmidt_values(s)[b],
                                   _exact_schmidt(pv, D + 1, b, CHI),
                                   atol=1e-6)
    jst, js0 = jax_setup

    def jroll(js, uu):
        pairs = jnp.stack([uu[:-1], uu[1:]], axis=1)
        return jax.lax.scan(lambda x, pr: (jvidal.vidal_step(
            jst, x, pr[0], pr[1], forward), None), js, pairs)[0]
    js = jax.jit(jroll)(js0, jnp.asarray(u[:JAX_STEPS + 1]))
    _same_up_to_phase(_sv(s_prefix), np.asarray(jmps.to_statevector(js.B)),
                      1e-9)
    np.testing.assert_allclose(vidal.schmidt_values(s_prefix),
                               jvidal.schmidt_values(js), atol=1e-6)


@pytest.fixture(scope="module")
def engines():
    """The exact-rank problem in both engines of the port and in JAX's
    Vidal engine, with a control from the adiabatic seed and one lane of
    numpy noise."""
    u = seeds.adiabatic_seed(2.5, 50.0, N)
    us = np.stack([u, u + np.random.default_rng(5).normal(0.0, 2.0, N)])
    st_v = tebd.make_stepper(LE, DE, J, DT, CHIE, sweep="vidal",
                             device="cpu")
    st_s = tebd.make_stepper(LE, DE, J, DT, CHIE, device="cpu")
    psi_i = groundstate.initialize_state(LE, DE, LE, J, 2.5, CHIE,
                                         device="cpu")
    psi_f = groundstate.initialize_state(LE, DE, LE, J, 50.0, CHIE,
                                         device="cpu")
    vi = vidal.from_mps(psi_i, device="cpu")
    vf = vidal.from_mps(psi_f, device="cpu")
    jst = jtebd.make_stepper(LE, DE, J, DT, CHIE, sweep="vidal")
    jvi = jvidal.from_mps(jgs.initialize_state(LE, DE, LE, J, 2.5, CHIE))
    jvf = jvidal.from_mps(jgs.initialize_state(LE, DE, LE, J, 50.0, CHIE))

    @jax.jit
    def jall(uu):
        g, (_, _, divT, ov) = jvidal.gradient(jst, jvi, jvf, uu, 1e-6)
        return (jvidal.cost(jst, jvi, jvf, uu, 1e-6), g, divT, ov,
                jvidal.fidelities(jst, jvi, jvf, uu),
                jvidal.hessian(jst, jvi, jvf, uu, 1e-6))
    jres = [tuple(np.asarray(x) for x in jall(jnp.asarray(uu)))
            for uu in us]
    return (st_v, st_s, psi_i, psi_f, vi, vf, torch.as_tensor(us)), jres


def test_vidal_engine_matches_snake_and_jax(engines):
    (st_v, st_s, psi_i, psi_f, vi, vf, us), jres = engines
    u = us[0]
    jc, jg, _, jov, jfid, _ = jres[0]
    Jv = float(vidal.cost(st_v, vi, vf, u, 1e-6))
    Js = float(engine.cost(st_s, psi_i, psi_f, u, 1e-6))
    assert abs(Jv - Js) < 1e-8 and abs(Jv - float(jc)) < 1e-8
    gv, (_, _, divT, ov) = vidal.gradient(st_v, vi, vf, u, 1e-6)
    gs, _ = engine.gradient(st_s, psi_i, psi_f, u, 1e-6)
    np.testing.assert_allclose(gv.numpy(), gs.numpy(), atol=1e-8)
    np.testing.assert_allclose(gv.numpy(), jg, atol=1e-8)
    assert abs(complex(ov) - complex(jov)) < 1e-8
    gl, (_, xi_none, divT_l, _) = vidal.gradient_lowmem(st_v, vi, vf, u,
                                                        1e-6)
    assert xi_none is None
    np.testing.assert_allclose(gl.numpy(), gv.numpy(), atol=1e-10)
    np.testing.assert_allclose(divT_l.numpy(), divT.numpy(), atol=1e-10)
    fv = vidal.fidelities(st_v, vi, vf, u)
    fs = engine.fidelities(st_s, psi_i, psi_f, u)
    np.testing.assert_allclose(fv.numpy(), fs.numpy(), atol=1e-8)
    np.testing.assert_allclose(fv.numpy(), jfid, atol=1e-8)
    J2, g2 = vidal.cost_and_gradient(st_v, vi, vf, u, 1e-6)
    assert abs(float(J2) - Jv) < 1e-12
    np.testing.assert_allclose(g2.numpy(), gv.numpy(), atol=1e-14)


def test_control_batch_matches_lanes_and_jax(engines):
    """A (2, N_t) control batch steps both lanes together; each lane equals
    its one-control call and JAX's."""
    (st_v, _, _, _, vi, vf, us), jres = engines
    gb, (psi_t, xi_t, _, ovb) = vidal.gradient(st_v, vi, vf, us, 1e-6)
    Jb = vidal.cost(st_v, vi, vf, us, 1e-6)
    assert psi_t.B.shape == (2, N, LE, CHIE, DE + 1, CHIE)
    assert xi_t.lam.shape == (2, N, LE - 1, CHIE)
    for b in range(2):
        g1, _ = vidal.gradient(st_v, vi, vf, us[b], 1e-6)
        np.testing.assert_allclose(gb[b].numpy(), g1.numpy(), atol=1e-13)
        np.testing.assert_allclose(gb[b].numpy(), jres[b][1], atol=1e-8)
        assert abs(float(Jb[b]) - float(jres[b][0])) < 1e-8
    final = vidal.rollout_final(st_v, vi, us)
    np.testing.assert_allclose(final.B.numpy(), psi_t.B[:, -1].numpy(),
                               atol=1e-13)
    xi0 = vidal.costate_rollout(st_v, vf, us[1])
    np.testing.assert_allclose(xi0.B.numpy(), xi_t.B[1].numpy(),
                               atol=1e-13)


def test_vidal_truncating_tracks_snake_and_jax():
    """Real truncation (chi=4 < rank bound 27): the Vidal channel's error
    against the dense propagator is the snake sweep's order."""
    Lt, dt_, chi_t = 6, 2, 4
    st_v = tebd.make_stepper(Lt, dt_, J, DT, chi_t, sweep="vidal",
                             device="cpu")
    st_s = tebd.make_stepper(Lt, dt_, J, DT, chi_t, device="cpu")
    est = exact.make_exact_stepper(Lt, dt_, J, DT, device="cpu")
    vec = groundstate.ground_statevector(Lt, dt_, Lt, J, 2.0)
    A = mps.from_statevector(vec, Lt, dt_ + 1, chi_t)   # truncated start
    sv = vidal.from_mps(A, device="cpu")
    sv = vidal.VidalState(sv.B[None], sv.lam[None])
    ss = torch.as_tensor(A)[None]
    psi = torch.as_tensor(vec)
    u = np.linspace(2.0, 12.0, 31)
    for i in range(30):
        sv = vidal.vidal_step(st_v, sv, u[i], u[i + 1])
        ss = tebd.tebd_step(st_s, ss, u[i], u[i + 1])
        psi = exact.exact_step(est, psi, u[i], u[i + 1])
    pv = psi.numpy()
    f_v = abs(np.vdot(mps.to_statevector(sv.B)[0].numpy(), pv))
    f_s = abs(np.vdot(mps.to_statevector(ss)[0].numpy(), pv))
    assert 1.0 - f_v < 5e-3
    assert (1.0 - f_v) < 5.0 * (1.0 - f_s) + 1e-6
    assert abs(float(mps.norm(sv.B)[0]) - 1.0) < 1e-10
    np.testing.assert_allclose(torch.linalg.vector_norm(sv.lam[0],
                                                        dim=-1).numpy(),
                               1.0, atol=1e-10)
    jst = jtebd.make_stepper(Lt, dt_, J, DT, chi_t, sweep="vidal")
    js = jax.jit(lambda s, uu: jvidal.rollout_final(jst, s, uu))(
        jvidal.from_mps(A), jnp.asarray(u))
    f_j = abs(np.vdot(np.asarray(jmps.to_statevector(js.B)), pv))
    assert abs(f_v - f_j) < 1e-8


def test_vidal_stepper_guards():
    with pytest.raises(ValueError, match="eigh"):
        tebd.make_stepper(L, D, J, DT, CHI, sweep="vidal",
                          trunc_method="rsvd", device="cpu")
    with pytest.raises(NotImplementedError, match="eigh"):
        tebd.make_stepper(L, D, J, DT, CHI, sweep="vidal",
                          trunc_method="nssub", device="cpu")
    st = tebd.make_stepper(L, D, J, DT, CHI, sweep="vidal", device="cpu")
    assert st.sweep == "vidal" and st.trunc_method == "eigh"
    with pytest.raises(TypeError, match="vidal_step"):
        tebd.tebd_step(st, torch.zeros((1, L, CHI, D + 1, CHI),
                                       dtype=torch.complex128), 2.0, 3.0)
    assert backends.engine_for(st) is vidal


def test_entry_points_run_on_the_card_unless_asked(setup, monkeypatch):
    """device=None means the card: without CUDA the constructors raise."""
    A = setup[4]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vidal.from_mps(A)
    with pytest.raises(RuntimeError, match="CUDA"):
        tebd.make_stepper(L, D, J, DT, CHI, sweep="vidal")


def test_bond_update_hands_the_kernel_resolved_sites(setup):
    """V^H leaves the bond update as memory, not as a lazy conjugate view:
    the next stage's bond theta (which refuses such views on every device)
    reads it, so a step of a state whose right sites came from a previous
    update must run, and every site is a plain contiguous tensor."""
    st, _, _, state, _ = setup
    s = vidal.VidalState(state.B[None], state.lam[None])
    for _ in range(2):
        s = vidal.vidal_step(st, s, 3.0, 4.0)
    for i in range(L):
        assert not s.B[:, i].is_conj() and s.B.is_contiguous()


def test_hessian_vs_fd_and_jax_truncating():
    """Truncating regime (L=4, d=2, chi=4 < rank bound 9): the Vidal
    Hessian (Vidal trajectories, snake rows) is symmetric and matches the
    forward-difference Hessian of the Vidal gradient to 5e-3 of its scale
    (HessianTests.cpp:178-184), and JAX's vidal.hessian."""
    Lt, dt_, chi_t = 4, 2, 4
    st_v = tebd.make_stepper(Lt, dt_, J, DT, chi_t, sweep="vidal",
                             device="cpu")
    vi = vidal.from_mps(groundstate.initialize_state(
        Lt, dt_, Lt, J, 2.5, chi_t, device="cpu"), device="cpu")
    vf = vidal.from_mps(groundstate.initialize_state(
        Lt, dt_, Lt, J, 50.0, chi_t, device="cpu"), device="cpu")
    u = torch.as_tensor(seeds.adiabatic_seed(2.5, 50.0, N)
                        + np.random.default_rng(3).uniform(-0.5, 0.5, N))
    H = vidal.hessian(st_v, vi, vf, u, 0.0).numpy()
    assert np.abs(H - H.T).max() < 1e-10
    eps = 1e-3
    g0, _ = vidal.gradient(st_v, vi, vf, u, 0.0)
    fd = np.zeros((N, N))
    for j in range(1, N - 1):
        uj = u.clone()
        uj[j] += eps
        gj, _ = vidal.gradient(st_v, vi, vf, uj, 0.0)
        fd[:, j] = (gj - g0).numpy() / eps
    fd = 0.5 * (fd + fd.T)
    Hi, Fi = H[1:-1, 1:-1], fd[1:-1, 1:-1]
    assert np.abs(Hi - Fi).max() / np.abs(Fi).max() < 5e-3
    jst = jtebd.make_stepper(Lt, dt_, J, DT, chi_t, sweep="vidal")
    jvi = jvidal.from_mps(jgs.initialize_state(Lt, dt_, Lt, J, 2.5, chi_t))
    jvf = jvidal.from_mps(jgs.initialize_state(Lt, dt_, Lt, J, 50.0,
                                               chi_t))
    Hj = np.asarray(jax.jit(lambda uu: jvidal.hessian(
        jst, jvi, jvf, uu, 0.0))(jnp.asarray(u.numpy())))
    assert np.abs(H - Hj).max() / np.abs(Hj).max() < 1e-6


def test_hessian_matches_snake_and_jax_exact_regime(engines):
    """No truncation: vidal.hessian == engine.hessian (1e-6) == JAX's."""
    (st_v, st_s, psi_i, psi_f, vi, vf, us), jres = engines
    u = us[0]
    Hv = vidal.hessian(st_v, vi, vf, u, 1e-6).numpy()
    Hs = engine.hessian(st_s, psi_i, psi_f, u, 1e-6).numpy()
    np.testing.assert_allclose(Hv, Hs, atol=1e-6)
    np.testing.assert_allclose(Hv, jres[0][5], atol=1e-6)
    # the row channel is a snake twin of the Vidal stepper
    twin = vidal._snake_twin(st_v)
    assert (twin.sweep, twin.trunc_method, twin.gauge_method) == (
        "snake", "eigh", "qr")
    assert dataclasses.replace(twin, sweep="vidal") == st_v
