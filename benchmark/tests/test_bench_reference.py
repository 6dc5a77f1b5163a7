"""The plain references agree with the program at small sizes (float64 on
the CPU), and the copied counts reproduce chip_smoke.py's bounds."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from optimalcontrolmps_torch import control, groundstate, sector, seeds
from optimalcontrolmps_torch import tebd, vidal

from benchmark import harness, peaks
from benchmark.reference import chain, dmrg
from benchmark.reference import sector as ref

L, D, NPART, J, DT, GAMMA = 5, 4, 5, 1.0, 0.01, 1e-6


@pytest.fixture(scope="module")
def both():
    T = 0.2
    n = int(round(T / DT)) + 1
    st = sector.make_sector_stepper(L, D, NPART, J, DT, device="cpu")
    pi = sector.sector_ground_state(L, D, NPART, J, 2.5, device="cpu")
    pf = sector.sector_ground_state(L, D, NPART, J, 50.0, device="cpu")
    ch = ref.make_chain(L, D, NPART, J, DT, 2.5, 50.0)
    u = torch.as_tensor(np.linspace(2.5, 50.0, n)
                        + np.random.default_rng(4).normal(0, 1, n))
    return st, pi, pf, ch, u


def test_sector_cost_gradient(both):
    st, pi, pf, ch, u = both
    assert abs(float(sector.cost(st, pi, pf, u, GAMMA))
               - float(ref.cost(ch, u[None], GAMMA)[0])) < 1e-13
    g, _ = sector.gradient(st, pi, pf, u, GAMMA)
    _, g_ref = ref.adjoint_gradient(ch, u[None], GAMMA)
    assert float((g - g_ref[0]).abs().max() / g_ref.abs().max()) < 1e-12


def test_seed_ramp_and_basis():
    n, T = 41, 0.4
    u0 = seeds.linsigmoid_seed(2.5, 50.0, n,
                               rng=np.random.default_rng(123456789))
    assert np.array_equal(u0, ref.linsigmoid_ramp(
        2.5, 50.0, n, np.random.default_rng(123456789)))
    b = control.chopped_sine_basis(u0, DT, T, 10, device="cpu")
    S, f = ref.sine_basis(n, DT, T, 10)
    assert np.array_equal(b.S.numpy(), S) and np.array_equal(b.f.numpy(), f)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12)], dtype=torch.float32)
    assert ref.tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0,
                                    1.0 + 2.0 ** -9, -1.0]


def test_mps_at_exact_rank_is_the_sector_propagation(both):
    _, _, _, ch, u = both
    from optimalcontrolmps_torch import engine
    chi = tebd.exact_rank_bound(L, D + 1)
    st = tebd.make_stepper(L, D, J, DT, chi, device="cpu")
    psi = [groundstate.initialize_state(L, D, NPART, J, U, chi, device="cpu")
           for U in (2.5, 50.0)]
    Jm, gm = engine.cost_and_gradient(st, *psi, u, GAMMA)
    Jr, gr = ref.adjoint_gradient(ch, u[None], GAMMA)
    assert abs(float(Jm) - float(Jr[0])) < 1e-11
    assert float((gm - gr[0]).abs().max() / gr.abs().max()) < 1e-7


def test_vidal_reference_and_dmrg():
    Lc, d, npart, chi, dt = 6, 3, 6, 6, 0.005
    states = [dmrg.ground_state(Lc, d, npart, J, U, chi)[0]
              for U in (2.5, 50.0)]
    e_dmrg = dmrg.ground_state(Lc, d, npart, J, 2.5, 20)[1]
    e_exact = np.linalg.eigvalsh(ref.hamiltonian(Lc, d, npart, J, 2.5))[0]
    assert abs(e_dmrg - e_exact) < 1e-8 * abs(e_exact)
    st = tebd.make_stepper(Lc, d, J, dt, chi, sweep="vidal", device="cpu")
    psi = [vidal.from_mps(A, device="cpu") for A in states]
    u = torch.as_tensor(np.linspace(2.5, 50.0, 6))
    Jp, gp = vidal.cost_and_gradient(st, *psi, u, GAMMA)
    rs = chain.Stepper(d, J, dt, chi, 1e-12)
    canon = [tuple(torch.as_tensor(x) for x in chain.canonical_form(A))
             for A in states]
    Jr, gr = chain.cost_and_gradient(rs, *canon, u.numpy(), GAMMA)
    assert abs(float(Jp) - Jr) < 1e-12
    assert np.abs(gp.numpy() - gr).max() < 1e-12 * np.abs(gr).max() + 1e-15


def test_counts_reproduce_chip_smoke_bounds():
    sys.path.insert(0, harness.ROOT)
    import chip_smoke
    # chip_smoke.py's printed bounds at (4096, 201), 121 states: the
    # tensor-core route (PERF.md, PR 8)
    assert round(peaks.sector_chain_ms("fwd", 4096, 201, 121), 4) == 0.5815
    assert round(peaks.sector_chain_ms("bwd", 4096, 201, 121), 4) == 1.1630
    ns, steps, B = 121, 200, 4096
    ops = 2 * 4 * ns * ns * steps * B
    nbytes = 4 * (2 * ns * ns + 3 * ns + B * 201 + 2 * B * ns)
    smoke = min(chip_smoke.bound(ops, nbytes, chip_smoke.PEAK_FLOPS[
        torch.float32])[0], chip_smoke.bound(
        ops, nbytes, chip_smoke.PEAK_TF32 / chip_smoke.TF32_PASSES)[0])
    assert peaks.sector_chain_ms("fwd", B, 201, ns) == pytest.approx(smoke)
    for shape, c128 in (((10, 128, 8), False), ((9, 128, 8), False),
                        ((4, 25, 5), True)):
        dtype = torch.complex128 if c128 else torch.complex64
        assert peaks.bond_theta_ms(*shape, c128) == pytest.approx(
            chip_smoke.theta_bound(*shape, dtype)[0])
