"""The port's fused sector chain (ops/sector_chain.py) against the JAX one.

On the CPU the chain runs its plain PyTorch twins; they are held to the JAX
package's scan references `_chain_final_scan` / `_scan_bwd` (the algebra of
the Pallas kernels) at the tolerances of tests/test_pallas_sector.py. The
CUDA kernels are held to the twins in tests/test_torch_cuda_kernels.py.

The kernels run the chain's products on the tensor cores in 3xTF32: each
operand split into big = tf32(x) and small = tf32(x - big), a product
small*big + big*small + big*big accumulated in fp32. The parity tests at the
end hold that arithmetic, emulated here, to the same tolerances at the
flagship's widths, and show that single-pass TF32 misses them.
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


T, DT, L, D, NPART, GAMMA = 0.5, 0.01, 5, 4, 5, 1e-6
N = int(round(T / DT)) + 1
FWD_TOL = 2e-5   # tests/test_pallas_sector.py:51
BWD_TOL = 3e-5   # times max(max|du|, 1), tests/test_pallas_sector.py:75


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



# ---------------------------------------------------------------------------
# 3xTF32 parity: the kernels' arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

def _tf32(x):
    """float32 -> TF32 (10 mantissa bits) as float32: round to nearest on
    the bit pattern, ties away from zero (cvt.rna.tf32.f32), for finite x."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(x, w):
    """x @ w with both operands split big + small in TF32: three products
    (small terms first), each exact in fp32, accumulated in fp32."""
    xb, wb = _tf32(x), _tf32(w)
    xs, ws = _tf32(x - xb), _tf32(w - wb)
    return (xs @ wb + xb @ ws) + xb @ wb


def _mm_tf32(x, w):
    return _tf32(x) @ _tf32(w)


def _chain_with(mm, dt, Wr, Wi, nn1, u_bt, h0r, h0i):
    """chain_final_scan with its products taken by mm."""
    ph0 = (-0.25 * dt) * torch.outer(u_bt[:, 0], nn1)
    c0, s0 = torch.cos(ph0), torch.sin(ph0)
    hr = c0 * h0r[None, :] - s0 * h0i[None, :]
    hi = c0 * h0i[None, :] + s0 * h0r[None, :]
    WrT, WiT = Wr.T, Wi.T
    for i in range(1, u_bt.shape[1]):
        ar = mm(hr, WrT) - mm(hi, WiT)
        ai = mm(hr, WiT) + mm(hi, WrT)
        ph = (-0.5 * dt) * torch.outer(u_bt[:, i], nn1)
        c, s = torch.cos(ph), torch.sin(ph)
        hr, hi = c * ar - s * ai, c * ai + s * ar
    return hr, hi


def _bwd_with(mm, dt, Wr, Wi, nn1, u_bt, hr, hi, gr, gi):
    """scan_bwd with its products taken by mm."""
    n_t = u_bt.shape[1]
    du = [None] * n_t
    for i in range(n_t - 1, 0, -1):
        du[i] = (-0.5 * dt) * torch.sum(nn1[None, :] * (gi * hr - gr * hi),
                                        dim=1)
        ph = (-0.5 * dt) * torch.outer(u_bt[:, i], nn1)
        c, s = torch.cos(ph), torch.sin(ph)
        ar, ai = c * hr + s * hi, c * hi - s * hr
        br, bi = c * gr + s * gi, c * gi - s * gr
        hr, hi = mm(ar, Wr) + mm(ai, Wi), mm(ai, Wr) - mm(ar, Wi)
        gr, gi = mm(br, Wr) + mm(bi, Wi), mm(bi, Wr) - mm(br, Wi)
    du[0] = (-0.25 * dt) * torch.sum(nn1[None, :] * (gi * hr - gr * hi),
                                     dim=1)
    return torch.stack(du, dim=1)


@pytest.fixture(scope="module")
def flagship_chain(prob):
    """The flagship's widths: its W (the fixture's stepper: L=5, d=4,
    Npart=5, dt=0.01), B=64 lanes, N_t=201, numpy seed 11; the fp32 twins'
    outputs and JAX's scans at float64 on the same inputs."""
    consts = [_t(c) for c in prob[5]]
    n_t = 201
    rng = np.random.default_rng(11)
    u = (jseeds.adiabatic_seed(2.5, 50.0, n_t)[None]
         + rng.normal(0.0, 0.3, (64, n_t))).astype(np.float32)
    gT = rng.normal(size=(2, 64, 128)).astype(np.float32)
    u_t = _t(u)
    hT = sc.chain_final_scan(DT, *consts[:3], u_t, *consts[3:])
    bwd_args = (*consts[:3], u_t, *hT, _t(gT[0]), _t(gT[1]))
    du = sc.scan_bwd(DT, *bwd_args)
    f64 = [jnp.asarray(np.asarray(a, np.float64)) for a in bwd_args]
    hT_j = jps._chain_final_scan(DT, *f64[:4], *[jnp.asarray(
        np.asarray(c, np.float64)) for c in prob[5][3:]])
    du_j = jps._scan_bwd(DT, *f64)
    return consts, u_t, bwd_args, hT, du, [np.asarray(a) for a in hT_j], \
        np.asarray(du_j)


def _max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                   - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


def test_tf32_rounding_is_to_nearest():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -11), 0.1],
                     dtype=torch.float32)
    # a tie rounds away from zero; above it, up; below it, down
    want = [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -9),
            0.0999755859375]
    assert _tf32(x).tolist() == want
    bits = _tf32(torch.randn(1000)).view(torch.int32)
    assert not torch.any(bits & 0x1FFF)


def test_3xtf32_chain_holds_the_fwd_gate(flagship_chain):
    consts, u_t, _, hT, _, hT_j, _ = flagship_chain
    h3 = _chain_with(_mm_3xtf32, DT, *consts[:3], u_t, *consts[3:])
    assert _max_diff(h3, hT) <= FWD_TOL
    assert _max_diff(h3, hT_j) <= FWD_TOL


def test_3xtf32_backward_holds_the_bwd_gate(flagship_chain):
    _, _, bwd_args, _, du, _, du_j = flagship_chain
    du3 = _bwd_with(_mm_3xtf32, DT, *bwd_args)
    assert du3.shape == (64, 201)
    scale = max(float(np.max(np.abs(du_j))), 1.0)
    assert _max_diff([du3], [du]) <= BWD_TOL * scale
    assert _max_diff([du3], [du_j]) <= BWD_TOL * scale


def test_single_pass_tf32_misses_the_fwd_gate(flagship_chain):
    """Why the kernels split: one TF32 pass is ~1e-2 off after 201 steps."""
    consts, u_t, _, _, _, hT_j, _ = flagship_chain
    h1 = _chain_with(_mm_tf32, DT, *consts[:3], u_t, *consts[3:])
    assert _max_diff(h1, hT_j) > 100 * FWD_TOL
