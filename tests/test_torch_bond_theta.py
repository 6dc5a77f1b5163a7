"""The port's bond-theta twin against the JAX package's Pallas kernel.

`bond_theta_reference` (the plain PyTorch twin of csrc/bond_theta.cu) is
held against `fused_bond_theta(interpret=True)` in complex64 at the JAX
test's tolerance (rel 1e-5, tests/test_pallas_kernels.py:22; the Pallas
kernel accumulates in float32), and against `fused_bond_theta_reference` in
complex128 at 1e-12. Inputs come from numpy seeds. The kernel itself runs
only on the card (tests/test_torch_cuda_kernels.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu.ops.pallas_kernels import (
    fused_bond_theta, fused_bond_theta_reference)
from optimalcontrolmps_torch.ops import bond_theta as bt

torch.set_num_threads(2)

SHAPES = [(4, 16, 3), (3, 25, 5)]   # (B, chi, p)


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
