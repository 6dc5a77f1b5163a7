"""Parity of the port's streaming gradient and Hessian with the JAX package.

* `engine.gradient_segmented` = the stacked `engine.gradient` = JAX's
  gradient (tests/test_streaming.py:60: L=4, d=3, chi=16, N_t=31; g and
  divT to 1e-11, the overlap to 1e-12), for the default and two given
  segment lengths.
* `engine.hessian_streaming` = the dense `engine.hessian` = JAX's dense
  Hessian at atol 1e-14 (tests/test_streaming_hessian.py:33: L=3, d=2,
  chi=4, T=0.2, 4 row blocks of R=5), with its progress hook called once
  per (row block, time block).
* The Vidal engine's streaming paths (tests/test_streaming.py:75-121, L=4,
  d=3, chi=16, N_t=31): `vidal.fidelities_streaming` = the stacked
  fidelities (1e-12), `vidal.gradient_segmented` = the stacked gradient
  (1e-11), `vidal.rollout_diagnostics` (fidelities 1e-12, discarded
  weights, Renyi-2 entropies, final state), each also against JAX's; and
  `vidal.hessian_streaming` = the dense `vidal.hessian` = JAX's at atol
  1e-14 (tests/test_streaming_hessian.py:42-48).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu import engine as jengine
from optimalcontrolmps_tpu import groundstate as jgs
from optimalcontrolmps_tpu import seeds as jseeds
from optimalcontrolmps_tpu import streaming as jstreaming
from optimalcontrolmps_tpu import tebd as jtebd
from optimalcontrolmps_tpu import vidal as jvidal
from optimalcontrolmps_torch import (engine, groundstate, seeds, streaming,
                                     tebd, vidal)

torch.set_num_threads(2)


def test_pick_segment_and_row_block_match_jax():
    for n in (1, 7, 30, 50, 200, 1000):
        for target in (None, 3, 6, 16, 64):
            assert streaming.pick_segment(n, target) == \
                jstreaming.pick_segment(n, target)
            if target is not None:
                assert streaming.pick_row_block(n, target) == \
                    jstreaming.pick_row_block(n, target)
    assert streaming.pick_segment(30) == 5
    assert streaming.pick_row_block(50, 16) == 10


@pytest.fixture(scope="module")
def grad_problem():
    L, D, NPART, J, DT, N, CHI = 4, 3, 4, 1.0, 0.01, 31, 16
    u = seeds.linspace(2.5, 50.0, N)
    st = tebd.make_stepper(L, D, J, DT, CHI, device="cpu")
    psi_i = groundstate.initialize_state(L, D, NPART, J, 2.5, CHI,
                                         device="cpu")
    psi_f = groundstate.initialize_state(L, D, NPART, J, 50.0, CHI,
                                         device="cpu")
    jst = jtebd.make_stepper(L, D, J, DT, CHI)
    jg, jaux = jax.jit(lambda uu: jengine.gradient(
        jst, jgs.initialize_state(L, D, NPART, J, 2.5, CHI),
        jgs.initialize_state(L, D, NPART, J, 50.0, CHI), uu, 1e-6))(
            jnp.asarray(u))
    return (st, psi_i, psi_f, torch.as_tensor(u)), (
        np.asarray(jg), np.asarray(jaux[2]), complex(jaux[3]))


@pytest.mark.parametrize("seg", [None, 3, 10])
def test_gradient_segmented_matches_stacked_and_jax(grad_problem, seg):
    (st, psi_i, psi_f, u), (jg, jdiv, jov) = grad_problem
    g_ref, (_, _, div_ref, ov_ref) = engine.gradient(st, psi_i, psi_f, u,
                                                     1e-6)
    g, (psiT, divT, ov) = engine.gradient_segmented(st, psi_i, psi_f, u,
                                                    1e-6, seg=seg)
    assert psiT.shape == psi_i.shape
    for got, want in ((g, g_ref.numpy()), (g, jg), (divT, div_ref.numpy()),
                      (divT, jdiv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-11)
    assert abs(complex(ov) - complex(ov_ref)) < 1e-12
    assert abs(complex(ov) - jov) < 1e-12


def test_gradient_segmented_batch_matches_single(grad_problem):
    (st, psi_i, psi_f, u), _ = grad_problem
    U = torch.stack([u, u + 0.5 * torch.sin(torch.arange(u.shape[0]) * 0.3)])
    gb, (_, divb, ovb) = engine.gradient_segmented(st, psi_i, psi_f, U, 1e-6)
    for b in range(2):
        g, (_, div, ov) = engine.gradient_segmented(st, psi_i, psi_f, U[b],
                                                    1e-6)
        np.testing.assert_allclose(gb[b].numpy(), g.numpy(), atol=1e-13)
        assert abs(complex(ovb[b]) - complex(ov)) < 1e-13


def test_hessian_streaming_matches_dense_and_jax():
    L, d, npart, J, chi, T, dt = 3, 2, 3, 1.0, 4, 0.2, 0.01
    n = int(T / dt) + 1
    u = np.asarray(jseeds.linsigmoid_seed(2.5, 50.0, n,
                                          rng=np.random.default_rng(0)))
    jst = jtebd.make_stepper(L, d, J, dt, chi, dtype=jnp.complex128)
    jpi = jgs.initialize_state(L, d, npart, J, u[0], chi)
    jpf = jgs.initialize_state(L, d, npart, J, u[-1], chi)
    H_jax = np.asarray(jax.jit(lambda uu: jengine.hessian(
        jst, jpi, jpf, uu, 1e-6))(jnp.asarray(u)))

    st = tebd.make_stepper(L, d, J, dt, chi, device="cpu")
    psi_i = groundstate.initialize_state(L, d, npart, J, u[0], chi,
                                         device="cpu")
    psi_f = groundstate.initialize_state(L, d, npart, J, u[-1], chi,
                                         device="cpu")
    ut = torch.as_tensor(u)
    H_dense = engine.hessian(st, psi_i, psi_f, ut, 1e-6).numpy()
    blocks = []
    # R=5 divides N_t - 1 = 20: 4 row blocks, 10 (row, time) block pairs
    H = engine.hessian_streaming(st, psi_i, psi_f, ut, 1e-6, row_block=5,
                                 progress=lambda c, s: blocks.append((c, s)))
    assert H.dtype == torch.float64 and H.shape == (n, n)
    assert blocks == [(c, s) for c in range(4) for s in range(c, 4)]
    np.testing.assert_allclose(H.numpy(), H_dense, atol=1e-14)
    np.testing.assert_allclose(H.numpy(), H_jax, atol=1e-14)
    # aux from gradient_segmented is reused as is
    _, aux = engine.gradient_segmented(st, psi_i, psi_f, ut, 1e-6)
    H2 = engine.hessian_streaming(st, psi_i, psi_f, ut, 1e-6, aux=aux,
                                  row_block=20)
    np.testing.assert_allclose(H2.numpy(), H_dense, atol=1e-14)


def test_block_hessian_refuses_a_row_block_that_does_not_divide():
    with pytest.raises(ValueError, match="divide"):
        streaming.BlockHessian(21, 3, None, None, None, None, None)


# ---------------------------------------------------------------------------
# the Vidal engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vidal_problem():
    L, D, NPART, J, DT, N, CHI = 4, 3, 4, 1.0, 0.01, 31, 16
    u = seeds.linspace(2.5, 50.0, N)
    st = tebd.make_stepper(L, D, J, DT, CHI, sweep="vidal", device="cpu")
    psi_i, psi_f = (vidal.from_mps(groundstate.initialize_state(
        L, D, NPART, J, U, CHI, device="cpu"), device="cpu")
        for U in (2.5, 50.0))
    jst = jtebd.make_stepper(L, D, J, DT, CHI, sweep="vidal")
    jpi, jpf = (jvidal.from_mps(jgs.initialize_state(L, D, NPART, J, U, CHI))
                for U in (2.5, 50.0))

    @jax.jit
    def jall(uu):
        _, diag = jvidal.rollout_diagnostics(jst, jpi, uu, psi_target=jpf)
        g, _ = jvidal.gradient_segmented(jst, jpi, jpf, uu, 1e-6, seg=5)
        return jvidal.fidelities_streaming(jst, jpi, jpf, uu), g, diag
    jfid, jg, jdiag = jall(jnp.asarray(u))
    return (st, psi_i, psi_f, torch.as_tensor(u)), (
        np.asarray(jfid), np.asarray(jg),
        {k: np.asarray(v) for k, v in jdiag.items()})


def test_vidal_fidelities_streaming_matches_stacked_and_jax(vidal_problem):
    (st, psi_i, psi_f, u), (jfid, _, _) = vidal_problem
    full = vidal.fidelities(st, psi_i, psi_f, u).numpy()
    stream = vidal.fidelities_streaming(st, psi_i, psi_f, u).numpy()
    assert stream.shape == (u.shape[0],)
    np.testing.assert_allclose(stream, full, rtol=0, atol=1e-12)
    np.testing.assert_allclose(stream, jfid, rtol=0, atol=1e-12)


def test_vidal_gradient_segmented_matches_stacked_and_jax(vidal_problem):
    (st, psi_i, psi_f, u), (_, jg, _) = vidal_problem
    g_ref, (_, _, div_ref, ov_ref) = vidal.gradient(st, psi_i, psi_f, u,
                                                    1e-6)
    g, (psiT, divT, ov) = vidal.gradient_segmented(st, psi_i, psi_f, u,
                                                   1e-6, seg=5)
    assert isinstance(psiT, vidal.VidalState)
    assert psiT.B.shape == psi_i.B.shape
    for got, want in ((g, g_ref.numpy()), (g, jg), (divT, div_ref.numpy())):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-11)
    assert abs(complex(ov) - complex(ov_ref)) < 1e-12


def test_vidal_rollout_diagnostics_matches_jax(vidal_problem):
    (st, psi_i, psi_f, u), (_, _, jdiag) = vidal_problem
    n, Lm1 = u.shape[0], st.L - 1
    sT, diag = vidal.rollout_diagnostics(st, psi_i, u, psi_target=psi_f)
    fid_ref = vidal.fidelities(st, psi_i, psi_f, u).numpy()
    np.testing.assert_allclose(diag["fid"].numpy(), fid_ref, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(diag["fid"].numpy(), jdiag["fid"], rtol=0,
                               atol=1e-12)
    disc, s2 = diag["disc"].numpy(), diag["s2"].numpy()
    assert disc.shape == (n, Lm1) and s2.shape == (n, Lm1)
    assert (disc[0] == 0).all()
    assert (disc >= 0).all() and disc.max() < 1e-3   # near-exact regime
    np.testing.assert_allclose(disc, jdiag["disc"], rtol=0, atol=1e-10)
    assert np.isfinite(s2).all() and (s2 >= -1e-9).all()
    np.testing.assert_allclose(s2, jdiag["s2"], rtol=0, atol=1e-8)
    psiT = vidal.rollout_final(st, psi_i, u)
    np.testing.assert_allclose(sT.B.numpy(), psiT.B.numpy(), atol=1e-12)
    # the entropies from the Schmidt carrier against the exact spectrum
    lam = vidal.schmidt_values(psi_i)[0]
    w = lam * lam / np.sum(lam * lam)
    s2_0 = float(vidal.bond_renyi2(psi_i)[0])
    assert abs(s2_0 - (-np.log(np.sum(w * w)))) < 1e-8
    wp = w[w > 1e-14]
    vn_0 = float(vidal.bond_vn_entropy(psi_i)[0])
    assert abs(vn_0 - (-np.sum(wp * np.log(wp)))) < 1e-10
    jpi = jvidal.VidalState(psi_i.B.numpy(), psi_i.lam.numpy())
    np.testing.assert_allclose(vidal.bond_vn_entropy(psi_i).numpy(),
                               np.asarray(jvidal.bond_vn_entropy(jpi)),
                               atol=1e-12)


def test_vidal_hessian_streaming_matches_dense_and_jax():
    L, d, npart, J, chi, T, dt = 3, 2, 3, 1.0, 4, 0.2, 0.01
    n = int(T / dt) + 1
    u = np.asarray(jseeds.linsigmoid_seed(2.5, 50.0, n,
                                          rng=np.random.default_rng(0)))
    jst = jtebd.make_stepper(L, d, J, dt, chi, dtype=jnp.complex128,
                             sweep="vidal")
    jpi, jpf = (jvidal.from_mps(jgs.initialize_state(L, d, npart, J, U, chi))
                for U in (u[0], u[-1]))
    H_jax = np.asarray(jax.jit(lambda uu: jvidal.hessian(
        jst, jpi, jpf, uu, 1e-6))(jnp.asarray(u)))

    st = tebd.make_stepper(L, d, J, dt, chi, sweep="vidal", device="cpu")
    psi_i, psi_f = (vidal.from_mps(groundstate.initialize_state(
        L, d, npart, J, U, chi, device="cpu"), device="cpu")
        for U in (u[0], u[-1]))
    ut = torch.as_tensor(u)
    H_dense = vidal.hessian(st, psi_i, psi_f, ut, 1e-6).numpy()
    blocks = []
    H = vidal.hessian_streaming(st, psi_i, psi_f, ut, 1e-6, row_block=5,
                                progress=lambda c, s: blocks.append((c, s)))
    assert H.dtype == torch.float64 and H.shape == (n, n)
    assert blocks == [(c, s) for c in range(4) for s in range(c, 4)]
    np.testing.assert_allclose(H.numpy(), H_dense, atol=1e-14)
    np.testing.assert_allclose(H.numpy(), H_jax, atol=1e-14)
