"""The port's fused sector chain (ops/sector_chain.py) against the JAX one.

On the CPU the chain runs its plain PyTorch twins; they are held to the JAX
package's scan references `_chain_final_scan` / `_scan_bwd` (the algebra of
the Pallas kernels) at the tolerances of tests/test_pallas_sector.py. The
CUDA kernels are held to the twins in tests/test_torch_cuda_kernels.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu import sector as jsector
from optimalcontrolmps_tpu import seeds as jseeds
from optimalcontrolmps_tpu.ops import pallas_sector as jps
from optimalcontrolmps_torch import sector
from optimalcontrolmps_torch.engine import regularization
from optimalcontrolmps_torch.ops import sector_chain as sc

torch.set_num_threads(2)

T, DT, L, D, NPART, GAMMA = 0.5, 0.01, 5, 4, 5, 1e-6
N = int(round(T / DT)) + 1


@pytest.fixture(scope="module")
def prob():
    st_j = jsector.make_sector_stepper(L, D, NPART, 1.0, DT,
                                       dtype=jnp.complex64)
    fields = {k: np.asarray(v) for k, v in dataclasses.asdict(st_j).items()}
    st_t = sector.stepper_from_numpy(fields, "cpu")
    psi_i = jsector.sector_ground_state(L, D, NPART, 1.0, 2.5,
                                        dtype=np.complex64)
    psi_f = jsector.sector_ground_state(L, D, NPART, 1.0, 50.0,
                                        dtype=np.complex64)
    rng = np.random.default_rng(5)
    u_bt = np.asarray(
        [jseeds.adiabatic_seed(2.5, 50.0, N) + rng.normal(0, 0.3, N)
         for _ in range(4)], dtype=np.float32)
    consts = [np.asarray(c) for c in sc.chain_constants(st_t,
                                                        torch.as_tensor(psi_i))]
    g_rng = np.random.default_rng(9)
    gT = g_rng.normal(size=(2, 4, st_t.ns_p)).astype(np.float32)
    return st_j, st_t, psi_i, psi_f, u_bt, consts, gT


def _t(a):
    return torch.as_tensor(np.array(a))


def test_chain_constants_match_jax(prob):
    st_j, _, psi_i, _, _, consts, _ = prob
    Wr, Wi, nn1, h0r, h0i = consts
    np.testing.assert_array_equal(Wr, np.real(st_j.WJ_fwd_p))
    np.testing.assert_array_equal(Wi, np.imag(st_j.WJ_fwd_p))
    np.testing.assert_array_equal(nn1, st_j.nn1_p)
    np.testing.assert_array_equal(h0r[:st_j.ns], psi_i.real)
    np.testing.assert_array_equal(h0i[:st_j.ns], psi_i.imag)
    assert not h0r[st_j.ns:].any() and not h0i[st_j.ns:].any()


def test_twin_fwd_matches_jax_scan(prob):
    st_j, _, _, _, u_bt, consts, _ = prob
    Wr, Wi, nn1, h0r, h0i = consts
    hr, hi = sc.chain_final_scan(DT, *map(_t, (Wr, Wi, nn1, u_bt, h0r, h0i)))
    hr_j, hi_j = jps._chain_final_scan(DT, *map(jnp.asarray,
                                                (Wr, Wi, nn1, u_bt, h0r, h0i)))
    np.testing.assert_allclose(hr.numpy(), np.asarray(hr_j), atol=2e-5)
    np.testing.assert_allclose(hi.numpy(), np.asarray(hi_j), atol=2e-5)


def test_twin_bwd_matches_jax_scan(prob):
    _, _, _, _, u_bt, consts, gT = prob
    Wr, Wi, nn1, h0r, h0i = consts
    hT = jps._chain_final_scan(DT, *map(jnp.asarray,
                                        (Wr, Wi, nn1, u_bt, h0r, h0i)))
    args = (Wr, Wi, nn1, u_bt, hT[0], hT[1], gT[0], gT[1])
    du = sc.scan_bwd(DT, *map(_t, args)).numpy()
    du_j = np.asarray(jps._scan_bwd(DT, *map(jnp.asarray, args)))
    assert du.shape == (4, N)
    np.testing.assert_allclose(
        du, du_j, atol=3e-5 * max(np.max(np.abs(du_j)), 1.0))


def test_chain_final_matches_jax(prob):
    st_j, st_t, psi_i, _, u_bt, _, _ = prob
    out = sc.chain_final(st_t, _t(u_bt), _t(psi_i)).numpy()
    ref = np.asarray(jps.chain_final(st_j, u_bt, psi_i))
    assert out.shape == (4, 121)
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_chain_final_matches_rollout_final(prob):
    _, st_t, psi_i, _, u_bt, _, _ = prob
    out = sc.chain_final(st_t, _t(u_bt), _t(psi_i))
    for b in range(u_bt.shape[0]):
        ref = sector.rollout_final(st_t, _t(psi_i), _t(u_bt[b]))
        np.testing.assert_allclose(out[b].numpy(), ref.numpy(), atol=2e-5)


def test_chain_gradient_matches_autograd(prob):
    """The autograd.Function backward (reversible twin) equals torch
    autograd through the port's own sector.cost, lane by lane."""
    _, st_t, psi_i, psi_f, u_bt, _, _ = prob
    pi, pfc = _t(psi_i), _t(np.conj(psi_f))
    u = _t(u_bt).requires_grad_(True)
    psiT = sc.chain_final(st_t, u, pi)
    ov = psiT @ pfc
    J = 0.5 * (1.0 - (ov * ov.conj()).real) + regularization(u, GAMMA, DT)
    (g,) = torch.autograd.grad(J.sum(), u)
    for b in range(2):
        _, g_ref = sector.cost_and_gradient_exact(
            st_t, pi, _t(psi_f), _t(u_bt[b]), GAMMA)
        scale = float(torch.max(torch.abs(g_ref)))
        np.testing.assert_allclose(g[b].numpy(), g_ref.numpy(),
                                   atol=3e-5 * max(scale, 1.0))


def test_chain_gradient_matches_jax_custom_vjp(prob):
    st_j, st_t, psi_i, psi_f, u_bt, _, _ = prob
    pfc = np.conj(psi_f)

    def jcost(u):
        ov = jps.chain_final(st_j, u, psi_i) @ jnp.asarray(pfc)
        return jnp.sum(0.5 * (1.0 - (ov * ov.conj()).real))

    g_j = np.asarray(jax.grad(jcost)(jnp.asarray(u_bt)))
    u = _t(u_bt).requires_grad_(True)
    ov = sc.chain_final(st_t, u, _t(psi_i)) @ _t(pfc)
    (g,) = torch.autograd.grad(torch.sum(0.5 * (1.0 - (ov * ov.conj()).real)),
                               u)
    np.testing.assert_allclose(g.numpy(), g_j,
                               atol=3e-5 * max(np.max(np.abs(g_j)), 1.0))


def test_cpu_tensors_take_the_twin_and_count_no_launch(prob):
    _, st_t, psi_i, _, u_bt, _, _ = prob
    sc.reset_counts()
    u = _t(u_bt).requires_grad_(True)
    sc.chain_final(st_t, u, _t(psi_i)).abs().sum().backward()
    assert (sc.fwd_launches, sc.bwd_launches) == (0, 0)


def test_kernel_wrappers_reject_cpu_tensors(prob):
    _, _, _, _, u_bt, consts, _ = prob
    with pytest.raises(ValueError, match="CUDA"):
        sc._launch_fwd(DT, *map(_t, consts[:3]), _t(u_bt),
                       *map(_t, consts[3:]))

