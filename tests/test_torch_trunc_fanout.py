"""The bond update's eigensolver fan-out (`ops/trunc.eigh` on the card) on
the CPU: the share plan (`_fanout_width`, `shares`), that the CPU path
stays one `torch.linalg.eigh` call, and the pool path itself
(`_eigh_fanout`) run on CPU tensors with stand-ins for the CUDA stream and
event calls: its shares' results put back together are the one-call
eigenvalues and eigenvectors bitwise, in order, and a worker's error
reaches the caller with its type. The card's own comparison is
tests/test_torch_cuda_kernels.py::test_eigh_fanout_matches_one_call."""

import contextlib
from types import SimpleNamespace

import pytest
import torch

from optimalcontrolmps_torch.ops import trunc

W = trunc._FANOUT_WIDTH


def _hermitian(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(shape, generator=g, dtype=dtype)
    return a + a.mH


def _batch(rho_shape, cuda=True):
    return SimpleNamespace(shape=torch.Size(rho_shape), is_cuda=cuda)


@pytest.mark.parametrize("shape, cuda, width", [
    ((10, 560, 560), True, min(10, W)),   # a Vidal stage, even bonds
    ((9, 560, 560), True, min(9, W)),     # odd bonds
    ((12, 560, 560), True, min(12, W)),   # the widest row batch
    ((4, 125, 125), True, min(4, W)),     # the MPS cell's lanes
    ((2, 3, 80, 80), True, min(6, W)),    # two batch axes: 6
    ((1, 560, 560), True, 1),             # one matrix: one call
    ((560, 560), True, 1),
    ((5, trunc._ONE_CALL_MAX_N, trunc._ONE_CALL_MAX_N), True, 1),
    ((5, trunc._ONE_CALL_MAX_N + 1, trunc._ONE_CALL_MAX_N + 1), True,
     min(5, W)),
    ((10, 560, 560), False, 1),           # the CPU: one call
    ((1, 560, 560), False, 1),
])
def test_fanout_width_is_the_plan(shape, cuda, width):
    assert trunc._fanout_width(_batch(shape, cuda)) == width


@pytest.mark.parametrize("batch", range(1, 13))
def test_shares_cover_the_batch_in_order(batch):
    for width in range(1, batch + 1):
        shares = trunc.shares(batch, width)
        assert len(shares) == width
        assert shares[0][0] == 0 and shares[-1][1] == batch
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
        sizes = [hi - lo for lo, hi in shares]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("shape, dtype", [
    ((10, 40, 40), torch.complex128), ((1, 40, 40), torch.complex128),
    ((4, 25, 25), torch.complex64), ((3, 12, 12), torch.float64)])
def test_cpu_eigh_is_one_call(shape, dtype):
    """On the CPU `eigh` never fans out: `eigh_fanout` stays empty and the
    result is torch.linalg.eigh's, bitwise."""
    rho = _hermitian(shape, dtype)
    trunc.reset_counts()
    w, v = trunc.eigh(rho)
    assert trunc.eigh_calls == {shape[-1]: 1} and trunc.eigh_fanout == {}
    wide = rho if dtype in trunc._DOUBLE else rho.to(
        torch.complex128 if rho.is_complex() else torch.float64)
    w_ref, v_ref = torch.linalg.eigh(wide)
    assert torch.equal(w, w_ref.to(w.dtype)) and torch.equal(
        v, v_ref.to(v.dtype))


class _Stream:
    def wait_event(self, event):
        pass


class _Event:
    def record(self, stream=None):
        pass


@pytest.fixture
def cpu_streams(monkeypatch):
    """Stand-ins for the CUDA calls of the pool path, so that it runs on
    CPU tensors: streams and events that order nothing (the CPU is
    synchronous)."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: None)


@pytest.mark.parametrize("shape, dtype", [
    ((10, 48, 48), torch.complex128), ((9, 48, 48), torch.complex128),
    ((4, 25, 25), torch.complex128), ((12, 20, 20), torch.float64),
    ((2, 3, 16, 16), torch.complex128)])
def test_fanned_out_shares_gather_to_the_one_call_result(cpu_streams, shape,
                                                         dtype):
    rho = _hermitian(shape, dtype, seed=1)
    w_ref, v_ref = torch.linalg.eigh(rho)
    batch = rho.numel() // (shape[-1] ** 2)
    for width in sorted({1, 2, min(batch, W), batch}):
        trunc.reset_counts()
        w, v = trunc._eigh_fanout(rho, width)
        assert trunc.eigh_fanout == {shape[-1]: batch}
        assert torch.equal(w, w_ref) and torch.equal(v, v_ref)
        assert w.shape == w_ref.shape and v.stride() == v_ref.stride()


def test_gather_puts_the_shares_back_in_order():
    rho = _hermitian((7, 10, 10), torch.complex128, seed=2)
    parts = [torch.linalg.eigh(rho[lo:hi]) for lo, hi in trunc.shares(7, 3)]
    w, v = trunc._gather(parts, 10)
    w_ref, v_ref = torch.linalg.eigh(rho)
    assert torch.equal(w, w_ref) and torch.equal(v, v_ref)


def test_a_workers_error_reaches_the_caller(cpu_streams):
    """A share that LAPACK cannot solve raises its LinAlgError in the
    caller, as one call does, after every share has ended."""
    rho = _hermitian((6, 12, 12), torch.complex128, seed=3)
    rho[4, 2, 2] = float("nan")
    with pytest.raises(torch.linalg.LinAlgError) as one:
        torch.linalg.eigh(rho)
    with pytest.raises(torch.linalg.LinAlgError) as fanned:
        trunc._eigh_fanout(rho, 3)
    assert type(fanned.value) is type(one.value)
