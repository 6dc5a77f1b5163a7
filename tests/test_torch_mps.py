"""Parity of the port's MPS functions and truncations with the JAX package.

Both packages get the same numpy-seeded states (L=4, p=3, chi=9, complex128)
on the CPU. MPS tensors may differ by a gauge (eigh/QR bases differ between
LAPACK builds), so only gauge-invariant quantities are compared: dense
statevectors, overlaps, norms, expectation values, entropies, and the
products left @ right of the truncations, at 1e-10.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from optimalcontrolmps_tpu import mps as jmps
from optimalcontrolmps_tpu.ops import trunc as jtrunc
from optimalcontrolmps_tpu.sites import nn1_diag, op
from optimalcontrolmps_torch import mps
from optimalcontrolmps_torch.ops import trunc


L, P, CHI = 4, 3, 9
TOL = 1e-10


def _random_mps(seed, chi=CHI):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(P ** L) + 1j * rng.standard_normal(P ** L)
    return mps.from_statevector(v / np.linalg.norm(v), L, P, chi)


@pytest.fixture(scope="module")
def states():
    return _random_mps(0), _random_mps(1)


def _t(A):
    return torch.as_tensor(np.asarray(A))[None]


def _np(x):
    return x.resolve_conj().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


def test_host_constructors_equal():
    rng = np.random.default_rng(2)
    v = rng.standard_normal(P ** L) + 1j * rng.standard_normal(P ** L)
    np.testing.assert_array_equal(mps.from_statevector(v, L, P, CHI),
                                  jmps.from_statevector(v, L, P, CHI))
    np.testing.assert_array_equal(mps.product_state([1, 0, 2, 1], P, CHI),
                                  jmps.product_state([1, 0, 2, 1], P, CHI))
    A = mps.from_statevector(v, L, P, CHI)
    np.testing.assert_array_equal(mps.pad_chi(A, 12), jmps.pad_chi(A, 12))


def test_statevector_overlap_norm(states):
    a, b = states
    _close(mps.to_statevector(_t(a))[0], jmps.to_statevector(jnp.asarray(a)))
    _close(mps.overlap(_t(a), _t(b))[0],
           jmps.overlap(jnp.asarray(a), jnp.asarray(b)))
    scaled = 1.7 * a
    _close(mps.norm(_t(scaled))[0], jmps.norm(jnp.asarray(scaled)))
    _close(mps.to_statevector(mps.normalize(_t(scaled)))[0],
           jmps.to_statevector(jmps.normalize(jnp.asarray(scaled))))


def test_sandwich_and_expectation_values(states):
    a, b = states
    half = 0.5 * nn1_diag(P - 1)
    _close(mps.sandwich_site_sum(_t(a), _t(b), half)[0],
           jmps.sandwich_site_sum(jnp.asarray(a), jnp.asarray(b), half))
    n_op = op("N", P - 1)
    _close(mps.expectation_values(_t(a), n_op)[0],
           jmps.expectation_values(jnp.asarray(a), n_op))


def test_batch_axis_is_independent_lanes(states):
    a, b = states
    AB = torch.cat([_t(a), _t(b)])
    BA = torch.cat([_t(b), _t(a)])
    ov = mps.overlap(AB, BA)
    _close(ov[0], mps.overlap(_t(a), _t(b))[0], 1e-14)
    _close(ov[1], mps.overlap(_t(b), _t(a))[0], 1e-14)


@pytest.mark.parametrize("method", ["qr", "cholesky"])
def test_gauge_moves_keep_the_state(states, method):
    a, _ = states
    A = _t(a)
    v0 = mps.to_statevector(A)
    T = list(A.unbind(1))
    T[0], T[1] = mps.move_right(T[0], T[1], method=method)
    T[1], T[2] = mps.move_right(T[1], T[2], method=method)
    moved = torch.stack(T, dim=1)
    tol = 1e-10 if method == "qr" else 1e-8
    _close(mps.to_statevector(moved), v0, tol)
    # left isometry on site 0 (CholeskyQR's ridge leaves it 1e-6 off)
    m = T[0].reshape(CHI * P, CHI)
    _close((m.conj().T @ m)[:P, :P], torch.eye(P, dtype=m.dtype),
           tol if method == "qr" else 1e-6)
    T[1], T[2] = mps.move_left(T[1], T[2], method=method)
    _close(mps.to_statevector(torch.stack(T, dim=1)), v0, tol)
    ja, jb = jmps.move_left(jnp.asarray(a[1]), jnp.asarray(a[2]),
                            method=method)
    ta, tb = mps.move_left(_t(a[1]), _t(a[2]), method=method)
    _close(torch.einsum('apb,bqc->apqc', ta[0], tb[0]),
           jnp.einsum('apb,bqc->apqc', ja, jb), tol)


def test_zero_columns_are_filled_and_nothing_else():
    """Before cuBLAS's batched QR (gauge moves, sketch splits) every column
    at most eps of its matrix's longest (and at least 100 sqrt(tiny)) is
    filled: that QR returned NaN for exactly-zero columns and for columns
    far below eps of the longest. Exact zeros, columns of 1e-20 and 1e-200
    of the rest and, in complex64, of 1e-10 (kept in complex128), and an
    all-zero matrix are replaced by the cut times a fixed Gaussian, every
    other column is kept bit for bit, and the QR of the filled batch is
    finite and reproduces the input. Only a CUDA batch at least
    max(2, n // 16) deep with n <= 256 takes that QR; a CPU tensor is not
    filled, only its columns at most 100 sqrt(tiny) long are set to zero
    (`test_underflowing_columns_are_zeroed_before_other_qrs`)."""
    rng = np.random.default_rng(5)
    m0 = torch.as_tensor(rng.standard_normal((4, 40, 12))
                         + 1j * rng.standard_normal((4, 40, 12)))
    m0[0, :, [1, 5, 11]] = 0
    m0[2, :, 0] = 0
    m0[2, 7, 2], m0[2, :, 2] = 0, 0
    m0[2, 3, 2] = 1.0                # a unit column, as a Fock state has
    m0[1, :, 3] *= 1e-20
    m0[1, :, 8] *= 1e-200
    m0[1, :, 6] *= 1e-10
    m0[3] = 0
    for dtype, tol in ((torch.complex128, 1e-14), (torch.complex64, 1e-5)):
        m = m0.to(dtype)
        short = torch.zeros((4, 12, 1), dtype=torch.bool)
        short[0, [1, 5, 11]] = short[2, 0] = short[1, 3] = True
        short[1, 8] = short[3] = True
        short[1, 6] = dtype == torch.complex64
        norms = torch.linalg.vector_norm(m, dim=-2)
        cut = (torch.finfo(norms.dtype).eps * norms.amax(-1)).clamp(
            min=trunc._qr_floor(dtype))
        assert float(cut[3]) == trunc._qr_floor(dtype)
        f = trunc._fill_short_columns(m)
        ft, mt = f.transpose(-2, -1), m.transpose(-2, -1)
        assert torch.equal(ft[~short[..., 0]], mt[~short[..., 0]])
        g = trunc._fixed_gaussian(40, 12, dtype, m.device).T
        want = (cut[:, None, None] * g).to(dtype)
        assert torch.equal(ft[short[..., 0]], want.expand(4, 12, 40)[
            short[..., 0]])
        q, r = torch.linalg.qr(f, mode="reduced")
        assert bool(torch.isfinite(q).all() and torch.isfinite(r).all())
        _close(q @ r, m, tol)
        _close(q.conj().transpose(-2, -1) @ q,
               torch.eye(12, dtype=q.dtype).expand(4, 12, 12), tol)
        q0, r0 = trunc.householder_qr(m)
        qc, rc = torch.linalg.qr(trunc._zero_underflowing_columns(m),
                                 mode="reduced")
        assert torch.equal(q0, qc) and torch.equal(r0, rc)
    assert 1e-152 < trunc._qr_floor(torch.complex128) < 2e-152
    assert 1e-17 < trunc._qr_floor(torch.complex64) < 2e-17
    # which shapes take the batched QR on the card (a stand-in with the
    # CUDA flag), and that a CPU batch never does
    cuda_like = type("CudaLike", (), {"is_cuda": True})
    for shape, batched in (((13, 216, 36), True), ((12, 216, 36), False),
                           ((2, 40, 12), True), ((1, 40, 12), False),
                           ((40, 12), False), ((4, 2, 40, 12), True),
                           ((300, 257, 36), False), ((6, 125, 25), False),
                           ((7, 125, 25), True)):
        t = cuda_like()
        t.shape = shape
        assert trunc._takes_batched_geqrf(t) == batched
    assert not trunc._takes_batched_geqrf(m0)


def test_underflowing_columns_are_zeroed_before_other_qrs():
    """Outside cuBLAS's batched QR, the columns at most 100 sqrt(tiny) long
    (1.1e-17 in complex64, 1.5e-152 in complex128) are set to exact zero
    and every other column is kept bit for bit. LAPACK's complex64 QR
    returned NaN for a rank-one matrix whose columns lie between 1e-22 and
    1e-17 (the gauge move of `apply_site_sum_diag` in a complex64 snake
    Hessian at L=3, d=2, chi=6): `householder_qr` factors it, finite, with
    Q unitary to 1e-6 and Q R within the floor of the input."""
    rng = np.random.default_rng(11)
    m0 = torch.as_tensor(rng.standard_normal((3, 20, 6))
                         + 1j * rng.standard_normal((3, 20, 6)))
    m0[0, :, 1] *= 1e-20
    m0[1, :, 4] *= 1e-200
    m0[2, :, 0] = 0
    for dtype in (torch.complex64, torch.complex128):
        m = m0.to(dtype)
        short = torch.linalg.vector_norm(m, dim=-2) <= trunc._qr_floor(dtype)
        want = torch.zeros((3, 6), dtype=torch.bool)
        want[1, 4] = want[2, 0] = True
        want[0, 1] = dtype == torch.complex64
        assert torch.equal(short, want)
        z = trunc._zero_underflowing_columns(m).transpose(-2, -1)
        assert not bool(z[short].any())
        assert torch.equal(z[~short], m.transpose(-2, -1)[~short])
    m = torch.zeros((4, 4), dtype=torch.complex64)
    m[3] = torch.tensor([-1.19e-17 - 3.28e-18j, -2.33e-18 + 3.98e-18j,
                         9.75e-23 + 7.02e-23j, -4.76e-22 + 1.01e-23j])
    q, r = trunc.householder_qr(m)
    assert bool(torch.isfinite(q).all() and torch.isfinite(r).all())
    assert float((q @ r - m).abs().max()) <= trunc._qr_floor(m.dtype)
    _close(q.conj().T @ q, torch.eye(4, dtype=q.dtype), 1e-6)


def test_apply_site_sum_diag(states):
    a, _ = states
    half = 0.5 * nn1_diag(P - 1)
    C, nrm = mps.apply_site_sum_diag(_t(a), half)
    jC, jn = jmps.apply_site_sum_diag(jnp.asarray(a), half)
    _close(nrm[0], jn)
    _close(mps.to_statevector(C)[0] * nrm[0],
           np.asarray(jmps.to_statevector(jC)) * float(jn))


def test_apply_site_sum_diag_leaves_the_centre_on_site_0():
    """dH|psi>, truncated (chi 4 of the exact 8), comes back with sites 1
    to L-1 right isometries and its unit norm on site 0: the centre is
    where a snake step takes it to be, so a Hessian row's first step
    truncates in the canonical gauge."""
    C, _ = mps.apply_site_sum_diag(_t(_random_mps(3, chi=4)),
                                   0.5 * nn1_diag(P - 1))
    for k in range(1, L):
        m = C[0, k].reshape(4, -1)
        _close(m @ m.conj().T, np.eye(4))
    _close(torch.linalg.vector_norm(C[0, 0]), 1.0)
    _close(mps.norm(C)[0], 1.0)


def test_entanglement_entropies(states):
    a, _ = states
    _close(mps.entanglement_entropies(_t(a))[0],
           jmps.entanglement_entropies(jnp.asarray(a)))


@pytest.mark.parametrize("method", ["eigh", "svd", "rsvd", "rsvd1", "range"])
@pytest.mark.parametrize("keep_left", [True, False])
def test_split_truncate_exact_rank(method, keep_left):
    """rank(theta) = 5 <= chi = 8: every method splits exactly, and the
    isometric factor is orthonormal on its support."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((12, 5)) + 1j * rng.standard_normal((12, 5))
    y = rng.standard_normal((5, 10)) + 1j * rng.standard_normal((5, 10))
    theta = x @ y
    left, right = trunc.split_truncate(torch.as_tensor(theta)[None], 8,
                                       keep_left, method=method)
    jl, jr = jtrunc.split_truncate(jnp.asarray(theta), 8, keep_left,
                                   method=method)
    assert left.shape == (1, 12, 8) and right.shape == (1, 8, 10)
    _close((left @ right)[0], np.asarray(jl) @ np.asarray(jr), 1e-9)
    _close((left @ right)[0], theta, 1e-9)
    iso = left[0] if keep_left else right[0].conj().T
    gram = iso.conj().T @ iso
    support = torch.diagonal(gram).real > 0.5
    assert int(support.sum()) >= 5
    _close(gram[support][:, support],
           torch.eye(int(support.sum()), dtype=gram.dtype), 1e-9)


@pytest.mark.parametrize("method", ["eigh", "svd", "rsvd"])
def test_split_truncate_keeps_the_top_subspace(method):
    """Real truncation with a gap between the 4th and 5th singular values:
    the kept subspace is unique, so the product equals JAX's."""
    rng = np.random.default_rng(4)
    u, _ = np.linalg.qr(rng.standard_normal((10, 10))
                        + 1j * rng.standard_normal((10, 10)))
    v, _ = np.linalg.qr(rng.standard_normal((10, 10))
                        + 1j * rng.standard_normal((10, 10)))
    s = np.array([3.0, 2.0, 1.5, 1.0, 0.1, 0.05, 0.02, 0.01, 0.005, 0.001])
    theta = (u * s) @ v.conj().T
    left, right = trunc.split_truncate(torch.as_tensor(theta)[None], 4, True,
                                       method=method)
    jl, jr = jtrunc.split_truncate(jnp.asarray(theta), 4, True,
                                   method="svd")
    _close((left @ right)[0], np.asarray(jl) @ np.asarray(jr), 1e-9)


def test_jitter_and_cholesky_orthonormalize():
    rng = np.random.default_rng(5)
    B = rng.standard_normal((7, 4)) + 1j * rng.standard_normal((7, 4))
    rho = B @ B.conj().T
    _close(trunc.jitter(torch.as_tensor(rho)[None])[0],
           jtrunc._jitter(jnp.asarray(rho)), 1e-12)
    q, Lc = trunc.cholesky_orthonormalize(torch.as_tensor(B)[None])
    jq, jL = jtrunc.cholesky_orthonormalize(jnp.asarray(B))
    _close(q[0], jq, 1e-10)
    _close(Lc[0], jL, 1e-10)


def test_nssub_is_refused():
    with pytest.raises(ValueError, match="eigh"):
        trunc.split_truncate(torch.zeros((1, 4, 4), dtype=torch.complex128),
                             2, True, method="nssub")


def test_eigh_solves_single_precision_in_double():
    """ops.trunc.eigh: a complex64 batch is solved in complex128 and cast
    back (cuSOLVER's complex64 eigh fails to converge on chain-end density
    matrices at chi=128); a complex128 batch is torch.linalg.eigh's."""
    rng = np.random.default_rng(4)
    m = rng.normal(size=(2, 12, 12)) + 1j * rng.normal(size=(2, 12, 12))
    rho64 = torch.as_tensor(m @ m.conj().transpose(0, 2, 1))
    w, v = trunc.eigh(rho64.to(torch.complex64))
    assert w.dtype == torch.float32 and v.dtype == torch.complex64
    w_ref, v_ref = torch.linalg.eigh(rho64.to(torch.complex64).to(
        torch.complex128))
    np.testing.assert_array_equal(w.numpy(), w_ref.to(torch.float32).numpy())
    np.testing.assert_array_equal(v.numpy(),
                                  v_ref.to(torch.complex64).numpy())
    w2, _ = trunc.eigh(rho64)
    np.testing.assert_array_equal(w2.numpy(),
                                  torch.linalg.eigh(rho64)[0].numpy())
