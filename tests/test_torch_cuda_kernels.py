"""The port's hand-written CUDA kernels against their plain PyTorch twins.

Every test here needs an NVIDIA GPU with nvcc, is marked `cuda`, and skips
without a card. The file imports neither JAX nor the JAX package, so it runs
on a GPU machine that has PyTorch only; `--noconftest` keeps pytest from
loading tests/conftest.py, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the sector-chain kernels those of tests/test_pallas_sector.py
(the kernels and the twins do the same float32 arithmetic in another
order); the bond-theta kernel max|d|/max|twin| < 1e-5 in complex64
(tests/test_pallas_kernels.py:22) and < 1e-12 in complex128.
"""

import numpy as np
import pytest
import torch

from optimalcontrolmps_torch import (dmrg, flagship, groundstate, mps, tebd,
                                     vidal)
from optimalcontrolmps_torch.ops import bond_theta as bt
from optimalcontrolmps_torch.ops import sector_chain as sc
from optimalcontrolmps_torch.ops import trunc
from optimalcontrolmps_torch.seeds import adiabatic_seed

FWD_TOL = 2e-5   # tests/test_pallas_sector.py:51
BWD_TOL = 3e-5   # times max(max|du|, 1), tests/test_pallas_sector.py:75
N_T = 201        # the flagship's T=2.0, dt=0.01
THETA_TOL = {torch.complex64: 1e-5, torch.complex128: 1e-12}

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def prob(dev):
    return flagship.make_problem(dev)


def _controls(B, seed, n_t=N_T):
    rng = np.random.default_rng(seed)
    base = adiabatic_seed(2.5, 50.0, n_t) if n_t > 1 else np.asarray([2.5])
    return (base[None] + rng.normal(0.0, 0.3, (B, n_t))).astype(np.float32)


# The kernels tile a block's rows by the batch: 8 rows up to B = 1056, 16
# up to 2112, then 32 (on 132 SMs). B=250 leaves a ragged last tile; 4096 is
# the flagship batch; B=1 a single row; B=1000 is no multiple of the 8-row
# tile; 2048 is a rank's share in two-rank multistart and 1500 a ragged
# batch, both on 16-row tiles; N_t = 1 (no step) and 2 (one step)
@pytest.mark.parametrize("B, n_t", [(250, N_T), (4096, N_T), (1, N_T),
                                    (1000, N_T), (2048, N_T), (1500, N_T),
                                    (4096, 1), (4096, 2), (37, 2)])
def test_kernels_match_twins(dev, prob, B, n_t):
    consts = sc.chain_constants(prob.st, prob.psi_i)
    u = torch.as_tensor(_controls(B, 0, n_t), device=dev)
    dt = prob.st.dt
    ref = sc.chain_final_scan(dt, *consts[:3], u, *consts[3:])
    out = sc.chain_fwd(dt, *consts[:3], u, *consts[3:])
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert float(torch.max(torch.abs(a - b))) <= FWD_TOL

    rng = np.random.default_rng(1)
    gT = [torch.as_tensor(rng.normal(size=(B, 128)).astype(np.float32),
                          device=dev) for _ in range(2)]
    du = sc.chain_bwd(dt, *consts[:3], u, *ref, *gT)
    du_ref = sc.scan_bwd(dt, *consts[:3], u, *ref, *gT)
    torch.cuda.synchronize()
    assert du.shape == (B, n_t)
    scale = max(float(torch.max(torch.abs(du_ref))), 1.0)
    assert float(torch.max(torch.abs(du - du_ref))) <= BWD_TOL * scale


def test_kernels_match_twins_without_a_phase_table(dev, prob):
    """128 distinct nn1 values: more than the kernels' phase table holds,
    so the phase is taken per element."""
    Wr, Wi, _, h0r, h0i = sc.chain_constants(prob.st, prob.psi_i)
    nn1 = torch.as_tensor(np.random.default_rng(3).uniform(
        0.0, 12.0, 128).astype(np.float32), device=dev)
    u = torch.as_tensor(_controls(256, 4, 51), device=dev)
    dt = prob.st.dt
    ref = sc.chain_final_scan(dt, Wr, Wi, nn1, u, h0r, h0i)
    out = sc.chain_fwd(dt, Wr, Wi, nn1, u, h0r, h0i)
    for a, b in zip(out, ref):
        assert float(torch.max(torch.abs(a - b))) <= FWD_TOL
    rng = np.random.default_rng(5)
    gT = [torch.as_tensor(rng.normal(size=(256, 128)).astype(np.float32),
                          device=dev) for _ in range(2)]
    du = sc.chain_bwd(dt, Wr, Wi, nn1, u, *ref, *gT)
    du_ref = sc.scan_bwd(dt, Wr, Wi, nn1, u, *ref, *gT)
    torch.cuda.synchronize()
    scale = max(float(torch.max(torch.abs(du_ref))), 1.0)
    assert float(torch.max(torch.abs(du - du_ref))) <= BWD_TOL * scale


def test_chain_final_and_gradient_match_cpu(dev, prob):
    """chain_final with its autograd.Function on the card (both kernels)
    against the same call on the CPU (both twins), and one launch of each
    kernel per forward and backward."""
    prob_cpu = flagship.make_problem("cpu")
    u_np = _controls(8, 2)
    outs = []
    sc.reset_counts()
    for p, device in ((prob, dev), (prob_cpu, "cpu")):
        u = torch.as_tensor(u_np, device=device).requires_grad_(True)
        psiT = sc.chain_final(p.st, u, p.psi_i)
        ov = psiT @ p.psi_f.conj()
        J = torch.sum(0.5 * (1.0 - (ov * ov.conj()).real))
        (g,) = torch.autograd.grad(J, u)
        outs.append((psiT.detach().cpu(), g.cpu()))
    assert (sc.fwd_launches, sc.bwd_launches) == (1, 1)
    (psi_k, g_k), (psi_p, g_p) = outs
    assert float(torch.max(torch.abs(psi_k - psi_p))) <= FWD_TOL
    scale = max(float(torch.max(torch.abs(g_p))), 1.0)
    assert float(torch.max(torch.abs(g_k - g_p))) <= BWD_TOL * scale


def test_wrappers_reject_what_the_kernels_do_not_take(dev, prob):
    Wr, Wi, nn1, h0r, h0i = sc.chain_constants(prob.st, prob.psi_i)
    u = torch.as_tensor(_controls(4, 3), device=dev)
    dt = prob.st.dt
    with pytest.raises(TypeError, match="float32"):
        sc.chain_fwd(dt, Wr, Wi, nn1, u.double(), h0r, h0i)
    with pytest.raises(ValueError, match="contiguous"):
        sc.chain_fwd(dt, Wr.T, Wi, nn1, u, h0r, h0i)
    with pytest.raises(ValueError, match="shape"):
        sc.chain_fwd(dt, Wr[:64, :64].contiguous(), Wi, nn1, u, h0r, h0i)


def _theta_inputs(B, chi, p, dtype, seed, device):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return torch.as_tensor(rng.standard_normal(s)
                               + 1j * rng.standard_normal(s),
                               dtype=dtype, device=device)
    return mk(B, chi, p, chi), mk(B, chi, p, chi), mk(p * p, p * p)


# the MPS slice's bond (chi=25, p=5), the reference-scale bond (chi=128,
# p=8), the reference's DMRG scale (chi=200, d=7) and chi=128 in complex128,
# the largest p (10), chi=1, and small ragged ones
@pytest.mark.parametrize("B,chi,p,dtype", [
    (4, 25, 5, torch.complex128), (4, 25, 5, torch.complex64),
    (2, 128, 8, torch.complex64), (3, 7, 3, torch.complex128),
    (1, 200, 8, torch.complex128), (2, 128, 8, torch.complex128),
    (2, 24, 10, torch.complex128), (3, 1, 2, torch.complex64),
    (2, 13, 3, torch.complex64)])
def test_bond_theta_kernel_matches_twin(dev, B, chi, p, dtype):
    Ai, Aj, G = _theta_inputs(B, chi, p, dtype, 0, dev)
    bt.reset_counts()
    out = bt.bond_theta(Ai, Aj, G)
    assert bt.bond_theta_launches == 1
    ref = bt.bond_theta_reference(Ai, Aj, G)
    torch.cuda.synchronize()
    assert out.shape == (B, chi * p, p * chi) and out.dtype == dtype
    rel = float(torch.max(torch.abs(out - ref)) / torch.max(torch.abs(ref)))
    assert rel < THETA_TOL[dtype]


@pytest.mark.parametrize("B,chi,p,dtype", [
    (4, 25, 5, torch.complex128), (2, 13, 3, torch.complex64)])
def test_bond_theta_kernel_takes_unbind_views(dev, B, chi, p, dtype):
    """Sites of an MPS batch (B, L, chi, p, chi) as `unbind` gives them
    (batch stride L*chi*p*chi), and a batch slice with a storage offset."""
    rng = np.random.default_rng(2)
    shape = (B, 4, chi, p, chi)
    A = torch.as_tensor(rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape), dtype=dtype,
                        device=dev)
    G = _theta_inputs(1, 1, p, dtype, 3, dev)[2]
    sites = A.unbind(1)
    bt.reset_counts()
    for Ai, Aj in ((sites[0], sites[1]), (sites[2], sites[3]),
                   (sites[1][1:], sites[2][1:])):
        out = bt.bond_theta(Ai, Aj, G)
        ref = bt.bond_theta_reference(Ai.contiguous(), Aj.contiguous(), G)
        rel = float(torch.max(torch.abs(out - ref))
                    / torch.max(torch.abs(ref)))
        assert rel < THETA_TOL[dtype]
    assert bt.bond_theta_launches == 3


def test_bond_theta_wrapper_rejects_what_the_kernel_does_not_take(dev):
    Ai, Aj, G = _theta_inputs(2, 6, 3, torch.complex128, 1, dev)
    with pytest.raises(TypeError, match="complex64 or complex128"):
        bt.bond_theta(Ai, Aj.to(torch.complex64), G)
    with pytest.raises(ValueError, match="contiguous"):
        bt.bond_theta(Ai, Aj.transpose(1, 3), G)
    with pytest.raises(ValueError, match="shape"):
        bt.bond_theta(Ai, Aj, G[:4, :4].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        bt.bond_theta(Ai, Aj.cpu(), G)
    with pytest.raises(RuntimeError, match="no backward"):
        bt.bond_theta(Ai.requires_grad_(True), Aj, G)


def test_bond_theta_wrapper_rejects_a_strided_inner_layout(dev):
    """A view whose inner dimensions are not contiguous (every other r of
    a wider site) raises, as do lazy conjugate and negative views."""
    Ai, Aj, G = _theta_inputs(2, 6, 3, torch.complex128, 4, dev)
    wide = _theta_inputs(2, 6, 3, torch.complex128, 5, dev)[0].repeat(
        1, 1, 1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        bt.bond_theta(Ai, wide[..., ::2], G)
    with pytest.raises(ValueError, match="conjugate"):
        bt.bond_theta(Ai, Aj.conj(), G)
    with pytest.raises(ValueError, match="negative"):
        bt.bond_theta(Ai, torch._neg_view(Aj), G)


def test_tebd_step_on_the_card_matches_the_cpu(dev):
    """A few forward, then backward, snake steps of a 4-site chain on the
    card (the kernel) and on the CPU (the twin), compared as a
    gauge-invariant overlap."""
    L, d, chi = 4, 2, 9
    out = []
    bt.reset_counts()
    for device in (dev, "cpu"):
        st = tebd.make_stepper(L, d, 1.0, 0.01, chi, device=device)
        A = groundstate.initialize_state(L, d, L, 1.0, 2.5, chi,
                                         device=device)[None]
        u = torch.linspace(2.5, 10.0, 6, dtype=torch.float64)
        for i in range(5):
            A = tebd.tebd_step(st, A, u[i], u[i + 1])
        for i in range(5, 0, -1):
            A = tebd.tebd_step(st, A, u[i], u[i - 1], forward=False)
        out.append(A.cpu())
    assert bt.bond_theta_launches == 10 * (L - 1)
    ov = mps.overlap(*out)
    assert abs(abs(complex(ov[0])) - 1.0) < 1e-12


def test_gauge_moves_survive_zero_columns_on_the_card(dev):
    """A batch of 13 sites (chi=36, p=6, complex64: test_runtimes' exact
    Hessian rows) whose last element has 27 columns that are exactly zero
    or rounding noise of 1e-17 entries (the kinds cuBLAS's batched geqrf
    turned into NaN), or of 1e-20 or 1e-30 entries (their squares
    underflow): both gauge moves stay finite and keep the two-site
    product."""
    rng = np.random.default_rng(9)

    def mk(*s):
        return rng.standard_normal(s) + 1j * rng.standard_normal(s)
    A = mk(13, 216, 9) @ mk(9, 36)
    Aj = torch.as_tensor(mk(13, 36, 6, 36), dtype=torch.complex64,
                         device=dev)
    for size in (0.0, 1e-17, 1e-20, 1e-30):
        A[12, :, 9:] = size * mk(216, 27)
        Ai = torch.as_tensor(A.reshape(13, 36, 6, 36),
                             dtype=torch.complex64, device=dev)
        two = torch.einsum('bapx,bxqc->bapqc', Ai, Aj)
        scale = float(two.abs().max())
        for move in (mps.move_right, mps.move_left):
            Bi, Bj = move(Ai, Aj)
            after = torch.einsum('bapx,bxqc->bapqc', Bi, Bj)
            assert bool(torch.isfinite(Bi).all() and torch.isfinite(Bj).all())
            assert float((after - two).abs().max()) < 1e-5 * scale
        Bi, Bj = mps.move_left(Aj, Ai.conj().transpose(1, 3).resolve_conj()
                               .contiguous())
        assert bool(torch.isfinite(Bi).all() and torch.isfinite(Bj).all())


@pytest.mark.parametrize("method", ["rsvd", "range"])
def test_sketch_splits_survive_zero_thetas_on_the_card(dev, method):
    """The rsvd and range splits take a thin QR of a sketch (cuBLAS's
    batched geqrf at this batch and height): a batch of rank-12 thetas
    (48 x 48, complex64) with one zero member and one of 1e-25 entries,
    whose sketches' columns are zero or underflow, splits into finite
    factors that reproduce every theta (to 1e-4 of the largest entry: the
    complex64 range split reads 1e-5 on the CPU's LAPACK)."""
    rng = np.random.default_rng(11)

    def mk(*s):
        return rng.standard_normal(s) + 1j * rng.standard_normal(s)
    th = mk(8, 48, 12) @ mk(8, 12, 48)
    th[3] = 0
    th[5] *= 1e-25
    theta = torch.as_tensor(th, dtype=torch.complex64, device=dev)
    scale = float(theta.abs().max())
    for keep_left in (True, False):
        left, right = trunc.split_truncate(theta, 12, keep_left, method)
        assert bool(torch.isfinite(left).all() and torch.isfinite(right).all())
        assert float((left @ right - theta).abs().max()) < 1e-4 * scale


# the Vidal stages' stacked inputs: the shipped L=5 problem's two even (and
# two odd) bonds at one lane and at 4 multistart lanes, complex128; the
# reference scale's 10 even and 9 odd bonds (L=20, chi=128, d=7), complex64
@pytest.mark.parametrize("B,chi,p,dtype", [
    (2, 25, 5, torch.complex128), (8, 25, 5, torch.complex128),
    (10, 128, 8, torch.complex64), (9, 128, 8, torch.complex64)])
def test_bond_theta_kernel_at_the_vidal_stage_shapes(dev, B, chi, p, dtype):
    Ai, Aj, G = _theta_inputs(B, chi, p, dtype, 6, dev)
    bt.reset_counts()
    out = bt.bond_theta(Ai, Aj, G)
    assert bt.bond_theta_launches == 1
    ref = bt.bond_theta_reference(Ai, Aj, G)
    torch.cuda.synchronize()
    rel = float(torch.max(torch.abs(out - ref)) / torch.max(torch.abs(ref)))
    assert rel < THETA_TOL[dtype]


def test_vidal_step_on_the_card_matches_the_cpu(dev):
    """Five forward, then five backward, Vidal steps of the shipped L=5
    chain (chi = 25, no truncation) on the card (the kernel in every stage)
    and on the CPU: the states agree as a gauge-invariant overlap, the
    Schmidt values to the eigh split's resolution."""
    L, d, chi = 5, 4, 25
    vec = groundstate.ground_statevector(L, d, L, 1.0, 2.5)
    A = mps.from_statevector(vec, L, d + 1, chi)
    out = []
    bt.reset_counts()
    for device in (dev, "cpu"):
        st = tebd.make_stepper(L, d, 1.0, 0.01, chi, sweep="vidal",
                               device=device)
        s = vidal.from_mps(A, device=device)
        s = vidal.VidalState(s.B[None], s.lam[None])
        u = torch.linspace(2.5, 10.0, 6, dtype=torch.float64)
        for i in range(5):
            s = vidal.vidal_step(st, s, u[i], u[i + 1])
        for i in range(5, 0, -1):
            s = vidal.vidal_step(st, s, u[i], u[i - 1], forward=False)
        out.append(vidal.VidalState(s.B.cpu(), s.lam.cpu()))
    assert bt.bond_theta_launches == 10 * 2
    ov = mps.overlap(out[0].B, out[1].B)
    assert abs(abs(complex(ov[0])) - 1.0) < 1e-12
    np.testing.assert_allclose(out[0].lam.numpy(), out[1].lam.numpy(),
                               atol=1e-7)


def test_dmrg_on_the_card_matches_exact(dev):
    """dmrg_ground_state on the card (complex128, L=5, d=4, chi=25): the
    exact sector ground state's energy to 1e-9, overlap to 1e-8
    (tests/test_dmrg.py:20-27)."""
    L, d, npart = 5, 4, 5
    E0 = np.linalg.eigvalsh(
        groundstate.sector_hamiltonian(L, d, npart, 1.0, 2.5))[0]
    A, e = dmrg.dmrg_ground_state(L, d, npart, 1.0, 2.5, chi=25,
                                  device=dev)
    assert A.is_cuda and abs(e - E0) < 1e-9
    vec = groundstate.ground_statevector(L, d, npart, 1.0, 2.5)
    ov = abs(np.vdot(mps.to_statevector(A[None])[0].cpu().numpy(), vec))
    assert abs(ov - 1.0) < 1e-8
