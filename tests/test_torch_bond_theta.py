"""The port's bond-theta twin against the JAX package's Pallas kernel.

`bond_theta_reference` (the plain PyTorch twin of csrc/bond_theta.cu) is
held against `fused_bond_theta(interpret=True)` in complex64 at the JAX
test's tolerance (rel 1e-5, tests/test_pallas_kernels.py:22; the Pallas
kernel accumulates in float32), and against `fused_bond_theta_reference` in
complex128 at 1e-12. Inputs come from numpy seeds. The kernel itself runs
only on the card (tests/test_torch_cuda_kernels.py); here its tile plan is
checked against shared memory and for covering theta, and the TEBD bond
update against the layouts the kernel takes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu.ops.pallas_kernels import (
    fused_bond_theta, fused_bond_theta_reference)
from optimalcontrolmps_torch import tebd
from optimalcontrolmps_torch.ops import bond_theta as bt
from optimalcontrolmps_torch.ops.gates import j_gate


# (B, chi, p); (2, 13, 4) is ragged for both of the kernel's tiles
SHAPES = [(4, 16, 3), (3, 25, 5), (2, 13, 4)]


def _inputs(B, chi, p, dtype, seed):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (rng.standard_normal(s)
                + 1j * rng.standard_normal(s)).astype(dtype)
    return mk(B, chi, p, chi), mk(B, chi, p, chi), mk(p * p, p * p)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("B,chi,p", SHAPES)
def test_twin_matches_pallas_interpret_complex64(B, chi, p):
    Ai, Aj, G = _inputs(B, chi, p, np.complex64, 0)
    want = np.asarray(fused_bond_theta(jnp.asarray(Ai), jnp.asarray(Aj),
                                       jnp.asarray(G), interpret=True))
    got = bt.bond_theta_reference(*(torch.as_tensor(a) for a in (Ai, Aj, G)))
    assert got.dtype == torch.complex64
    assert got.shape == (B, chi * p, p * chi)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("B,chi,p", SHAPES)
def test_twin_matches_jax_reference_complex128(B, chi, p):
    Ai, Aj, G = _inputs(B, chi, p, np.complex128, 1)
    want = np.asarray(fused_bond_theta_reference(
        jnp.asarray(Ai), jnp.asarray(Aj), jnp.asarray(G)))
    got = bt.bond_theta(*(torch.as_tensor(a) for a in (Ai, Aj, G)))
    assert _rel(got.numpy(), want) < 1e-12


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    Ai, Aj, G = (torch.as_tensor(a)
                 for a in _inputs(2, 6, 3, np.complex128, 2))
    bt.reset_counts()
    out = bt.bond_theta(Ai, Aj, G)
    assert bt.bond_theta_launches == 0
    assert torch.equal(out, bt.bond_theta_reference(Ai, Aj, G))


def test_a_call_that_needs_a_gradient_raises():
    Ai, Aj, G = (torch.as_tensor(a)
                 for a in _inputs(2, 6, 3, np.complex128, 3))
    with pytest.raises(RuntimeError, match="no backward"):
        bt.bond_theta(Ai.requires_grad_(True), Aj, G)
    with torch.no_grad():
        bt.bond_theta(Ai, Aj, G)


def test_kernel_wrapper_rejects_cpu_tensors():
    Ai, Aj, G = (torch.as_tensor(a)
                 for a in _inputs(2, 6, 3, np.complex128, 4))
    with pytest.raises(ValueError, match="CUDA"):
        bt._launch(Ai, Aj, G)


def test_lazy_conjugate_views_are_refused_on_every_device():
    """The kernel reads memory as stored; a conj view of a contiguous gate
    (as gate.conj() is) would give it the unconjugated numbers."""
    Ai, Aj, G = (torch.as_tensor(a)
                 for a in _inputs(2, 6, 3, np.complex128, 5))
    with pytest.raises(ValueError, match="conjugate"):
        bt.bond_theta(Ai, Aj, G.conj())
    out = bt.bond_theta(Ai, Aj, G.conj().resolve_conj())
    want = np.asarray(fused_bond_theta_reference(
        jnp.asarray(Ai.numpy()), jnp.asarray(Aj.numpy()),
        jnp.asarray(G.numpy().conj())))
    assert _rel(out.numpy(), want) < 1e-12


def test_cpu_twin_refuses_a_layout_the_kernel_refuses():
    """Inner dimensions that are not contiguous raise on the CPU too, so a
    CPU run catches a path that would hand the card such a view; a batch
    stride (an unbind view) does not."""
    Ai, Aj, G = (torch.as_tensor(a)
                 for a in _inputs(2, 6, 3, np.complex128, 6))
    with pytest.raises(ValueError, match="contiguous"):
        bt.bond_theta(Ai, Aj.transpose(1, 3), G)
    with pytest.raises(ValueError, match="contiguous"):
        bt.bond_theta(Ai.repeat(1, 1, 1, 2)[..., ::2], Aj, G)
    stacked = torch.stack([Ai, Aj], dim=1)
    assert torch.equal(bt.bond_theta(*stacked.unbind(1), G),
                       bt.bond_theta_reference(Ai, Aj, G))


@pytest.mark.parametrize("keep_left,method", [(True, "eigh"), (False, "eigh"),
                                              (False, "svd")])
def test_apply_bond_takes_unbind_views_as_they_are(keep_left, method):
    """`tebd._apply_bond` on the `unbind` views of an MPS batch gives
    bitwise what it gives on contiguous copies, and hands the next bond a
    center with contiguous inner dimensions."""
    B, L, chi, d = 2, 3, 13, 3
    rng = np.random.default_rng(7)
    shape = (B, L, chi, d + 1, chi)
    A = torch.as_tensor(rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape))
    G = torch.as_tensor(j_gate(1.0, d, 0.01), dtype=torch.complex128)
    T = A.unbind(1)
    assert not T[0].is_contiguous()
    views = tebd._apply_bond(T[0], T[1], G, chi, keep_left, method)
    copies = tebd._apply_bond(T[0].contiguous(), T[1].contiguous(), G, chi,
                              keep_left, method)
    for a, b in zip(views, copies):
        assert torch.equal(a, b)
    center = views[1] if keep_left else views[0]
    assert center.is_contiguous()


@pytest.mark.parametrize("itemsize", [8, 16])
def test_tile_plan_fits_shared_memory_and_covers_theta_once(itemsize):
    """For chi in 1..512 and p in 2..10: the plan's block fits the 232,448
    B of shared memory (by the kernel's own layout), its stage-1 tile fits
    the tile, and the grid's (l, r) tiles cover every output exactly once
    (a block writes all P, Q of its l and r)."""
    for p in range(2, 11):
        for chi in range(1, 513):
            tile, lt, rt, blocks, smem = bt._plan(3, chi, p, itemsize)
            assert smem == bt._smem_bytes(tile, p, lt, rt, itemsize)
            assert smem <= 232448
            assert tile in (64, 32) and lt * p <= tile and rt * p <= tile
            nlt, nrt = -(-chi // lt), -(-chi // rt)
            assert blocks == 3 * nlt * nrt
            for t, n in ((lt, nlt), (rt, nrt)):
                idx = (np.arange(n)[:, None] * t + np.arange(t)[None]).ravel()
                hits = np.bincount(idx[idx < chi], minlength=chi)
                assert (hits == 1).all(), (chi, p, t)
