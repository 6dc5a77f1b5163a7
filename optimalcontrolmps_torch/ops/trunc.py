"""Fixed-rank bond truncation, batched.

Counterpart of optimalcontrolmps_tpu/ops/trunc.py. Every function takes a
leading batch axis: theta is (B, m, n). The kept rank is always exactly
`chi` (zero-padded when the true rank is smaller), so every MPS keeps its
static (chi, p, chi) site shape.

Methods of `split_truncate`:
  * "eigh" (default): eigh of the density matrix theta theta^H (or
    theta^H theta), the reference's denmatDecomp (`eigh`: in double
    precision for a single-precision theta);
  * "svd": `torch.linalg.svd` (on the card with the cuSOLVER driver the
    caller names);
  * "rsvd" / "rsvdK": subspace iteration on the density matrix with K
    Householder-QR iterations (3 by default) and a small Rayleigh-Ritz eigh;
  * "range": one Gaussian sketch and a thin QR, exact when rank(theta) <=
    chi; directions whose co-factor norm is ~0 are masked.

The JAX package's "nssub" route and the matmul-free QR exist only for a TPU
backend without factorizations; they are not ported.
"""

from __future__ import annotations

import math
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from functools import lru_cache

import torch

from .. import profiling

__all__ = ["split_truncate", "cholesky_orthonormalize", "eigh",
           "householder_qr", "jitter", "shares", "eigh_calls", "eigh_fanout",
           "svd_calls", "reset_counts"]

# calls of `eigh` by matrix size (a call solves a batch of matrices)
eigh_calls: dict = {}
# matrices of each size that `eigh` solved in concurrent shares on the card
eigh_fanout: dict = {}
# calls of `split_truncate`'s "svd" method by matrix shape (m, n) (a call
# factors a batch of matrices)
svd_calls: dict = {}


def reset_counts() -> None:
    eigh_calls.clear()
    eigh_fanout.clear()
    svd_calls.clear()

_RSVD_ITERS = 3
_RSVD_OVERSAMPLE = 8
_DOUBLE = (torch.complex128, torch.float64)


def _eye(m, like):
    return torch.eye(m, dtype=like.dtype, device=like.device)


def _h(x):
    """Conjugate transpose of the last two axes."""
    return x.conj().transpose(-2, -1)


def jitter(rho):
    """rho + delta * mean(diag) * I for a batch of PSD matrices (..., m, m).
    Shifts the spectrum only, so the eigenvectors (the kept subspace) are
    unchanged; delta is 1e-12 in double precision, 1e-6 in single."""
    m = rho.shape[-1]
    delta = 1e-12 if rho.dtype in _DOUBLE else 1e-6
    scale = torch.diagonal(rho, dim1=-2, dim2=-1).real.sum(-1) / m + 1e-30
    return rho + (delta * scale)[..., None, None].to(rho.dtype) * _eye(m, rho)


def cholesky_orthonormalize(B, eps_rel: float = 1e-6):
    """CholeskyQR of the columns of B (..., m, k): Q = B L^{-H} with
    L = chol(B^H B + eps I). Spans range(B) exactly. Returns (Q, L) with
    B = Q L^H."""
    k = B.shape[-1]
    G = _h(B) @ B
    scale = torch.diagonal(G, dim1=-2, dim2=-1).real.sum(-1) / k + 1e-30
    Gr = G + (eps_rel * scale)[..., None, None].to(G.dtype) * _eye(k, G)
    Lc = torch.linalg.cholesky(Gr)
    Q = _h(torch.linalg.solve_triangular(Lc, _h(B), upper=False))
    return Q.resolve_conj(), Lc


@lru_cache(maxsize=64)
def _fixed_gaussian_cpu(m: int, k: int, dtype: torch.dtype) -> torch.Tensor:
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    gen = torch.Generator(device="cpu").manual_seed(17)
    g = torch.randn((m, 2 * k), generator=gen, dtype=real)
    return torch.complex(g[:, :k], g[:, k:]).to(dtype)


@lru_cache(maxsize=64)
def _fixed_gaussian(m: int, k: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """Deterministic (m, k) complex Gaussian test matrix from a CPU
    generator seeded 17, cached per (m, k, dtype, device). Its numbers
    differ from the JAX package's PRNGKey(17) draw; both only need a generic
    sketch."""
    return _fixed_gaussian_cpu(m, k, dtype).to(device)


def _real(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype in _DOUBLE else torch.float32


def _qr_floor(dtype: torch.dtype) -> float:
    """100 sqrt(tiny) of dtype's real type (1.1e-17 in single, 1.5e-152 in
    double precision): a column at most this long has a squared norm near
    or below the underflow."""
    return 100 * torch.finfo(_real(dtype)).tiny ** 0.5


def _fill_short_columns(m):
    """m (..., n, r) with every short column replaced by a generic one:
    each matrix's cut is eps times its longest column norm (eps of the
    precision), and at least `_qr_floor`; a column at most that long
    (exact zeros, the rounding noise of an unused bond index, entries
    whose squares underflow) becomes the cut times a fixed Gaussian
    column, a direction never in the span of the other columns of a tall
    matrix. Every other column is kept as it is."""
    norms = torch.linalg.vector_norm(m, dim=-2, keepdim=True)
    cut = (torch.finfo(_real(m.dtype)).eps * norms.amax(-1, keepdim=True)
           ).clamp(min=_qr_floor(m.dtype))
    g = _fixed_gaussian(m.shape[-2], m.shape[-1], m.dtype, m.device)
    return torch.where(norms <= cut, cut * g, m)


def _zero_underflowing_columns(m):
    """m (..., n, r) with every column at most `_qr_floor` long set to
    exact zero: LAPACK's complex64 geqrf returned NaN for a matrix with
    columns near 1e-22 (squares below float32's range) beside unit ones,
    and factors exact zero columns. Q R then differs from the input by at
    most the floor in those columns; every other column is kept as it
    is."""
    norms = torch.linalg.vector_norm(m, dim=-2, keepdim=True)
    return torch.where(norms <= _qr_floor(m.dtype), torch.zeros_like(m), m)


def _takes_batched_geqrf(m) -> bool:
    """Whether PyTorch factors m (..., n, r) by cuBLAS's batched geqrf: on
    the card, for n <= 256 and a batch of at least max(2, n // 16)
    matrices (ATen's geqrf dispatch); otherwise cuSOLVER's geqrf, one
    matrix at a time."""
    n = m.shape[-2]
    return (m.is_cuda and n <= 256
            and math.prod(m.shape[:-2]) >= max(2, n // 16))


def householder_qr(m):
    """Thin Householder QR (Q, R) of a batch of matrices (..., n, r).
    cuBLAS's batched geqrf (`_takes_batched_geqrf`) returned NaN for a
    batch of exact-Hessian row states of test_runtimes (complex64): for a
    member with exactly-zero columns, and, when those had come out of
    cuSOLVER's one-matrix QR as rounding noise instead, for a member whose
    shortest columns lay far below eps of its longest; LAPACK's and
    cuSOLVER's geqrf factor both. So before that QR the short columns are
    filled (`_fill_short_columns`), and Q R differs from the input in
    those columns only, by about sqrt(2 n) cuts (setting their columns of
    R to 0 afterwards, to keep the input exactly, let the next eigh fail
    on the card). Every other QR only has its underflowing columns set to
    zero (`_zero_underflowing_columns`; a no-op in complex128 but for
    columns below 1.5e-152), so the single-lane paths, the card-vs-CPU
    witnesses among them, factor what the CPU factors."""
    if _takes_batched_geqrf(m):
        m = _fill_short_columns(m)
    else:
        m = _zero_underflowing_columns(m)
    return torch.linalg.qr(m, mode="reduced")


def _thin_qr_q(m):
    return householder_qr(m)[0]


def _top_eigenspace_rsvd(rho, chi: int, iters: int = _RSVD_ITERS):
    """Orthonormal basis (..., m, chi) of the top-chi eigenspace of a batch
    of PSD matrices by subspace iteration, ordered by a small Rayleigh-Ritz
    eigh."""
    m = rho.shape[-1]
    k = min(m, chi + _RSVD_OVERSAMPLE)
    q = _fixed_gaussian(m, k, rho.dtype, rho.device)
    # Householder QR, not CholeskyQR: the iterate's Gram matrix has
    # cond(rho)^4 and a ridge would wipe out mid-spectrum directions
    for _ in range(iters):
        q = _thin_qr_q(rho @ q)
    small = _h(q) @ (rho @ q)
    small = 0.5 * (small + _h(small))
    _, v = eigh(small)
    return q @ v.flip(-1)[..., :chi]


# The fan-out of a batch over concurrent shares on the card (`eigh`): at
# most _FANOUT_WIDTH shares, for matrices larger than _ONE_CALL_MAX_N
# (PERF.md §6: tools/probe_eigh_fanout.py's table on an H100)
_FANOUT_WIDTH = 8
_ONE_CALL_MAX_N = 64

_pool = None
_pool_lock = threading.Lock()
_worker = threading.local()


def _fanout_width(rho) -> int:
    """The number of concurrent shares `eigh` solves the batch rho (..., n,
    n) in: min(batch, _FANOUT_WIDTH) on the card for n > _ONE_CALL_MAX_N;
    1, one call, for a single matrix and on the CPU. (At n <= 32 PyTorch
    takes cuSOLVER's batched Jacobi solver; up to 64, four matrices solved
    one after another took less time than in shares.)"""
    batch = math.prod(rho.shape[:-2])
    if not rho.is_cuda or batch < 2 or rho.shape[-1] <= _ONE_CALL_MAX_N:
        return 1
    return min(batch, _FANOUT_WIDTH)


def shares(batch: int, width: int) -> list:
    """[(lo, hi), ...]: `width` contiguous shares covering range(batch) in
    order, the first ones taking one more (10 over 4 -> 3/3/2/2; empty
    ones when width > batch). Also the split of a Vidal stage's bonds over
    the ranks of a mesh (`parallel.mesh.Mesh.bond_shares`)."""
    out, lo = [], 0
    for r in range(width):
        hi = lo + batch // width + (1 if r < batch % width else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _gather(parts: list, n: int):
    """The shares' (w, v) put back in order into one (w (B, n), v (B, n,
    n)), v in the shares' matrix layout (cuSOLVER's column-major, as one
    call returns it)."""
    w = torch.cat([p[0] for p in parts])
    v0 = parts[0][1]
    v = torch.empty_strided((w.shape[0], n, n), (n * n, *v0.stride()[1:]),
                            dtype=v0.dtype, device=v0.device)
    lo = 0
    for _, vs in parts:
        v[lo:lo + vs.shape[0]].copy_(vs)
        lo += vs.shape[0]
    return w, v


def _solve_share(x, ready):
    """A pool thread's part of `_eigh_fanout`: eigh of the share x on this
    thread's own stream, after the caller's event `ready`. Returns (w, v,
    the event that follows them)."""
    streams = _worker.__dict__.setdefault("streams", {})
    stream = streams.get(x.device)
    if stream is None:
        stream = streams[x.device] = torch.cuda.Stream(x.device)
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        x.record_stream(stream)
        w, v = torch.linalg.eigh(x)
        done = torch.cuda.Event()
        done.record(stream)
    return w, v, done


def _eigh_fanout(x, width: int):
    """torch.linalg.eigh of the batch x (..., n, n) on the card in `width`
    contiguous shares solved at the same time, each by a thread of a
    persistent pool on its own stream: cuSOLVER's one-matrix syevd, which
    PyTorch loops over a batch of n > 32, waits on the host between its
    phases, so one share's waits overlap the others' kernels. Every matrix
    is solved by the same syevd on the same input as in one call. A
    worker's exception is raised here."""
    global _pool
    n = x.shape[-1]
    flat = x.reshape(-1, n, n)
    eigh_fanout[n] = eigh_fanout.get(n, 0) + flat.shape[0]
    with _pool_lock:
        if _pool is None:
            # PyTorch loads its CUDA linear-algebra library at the first
            # such call in a process, and two threads making that call at
            # once fail ("lazy wrapper should be called at most once"):
            # load it here, on the caller's thread
            torch.linalg.eigh(torch.eye(2, dtype=x.dtype, device=x.device))
            _pool = ThreadPoolExecutor(_FANOUT_WIDTH,
                                       thread_name_prefix="trunc.eigh")
    with profiling.annotate("trunc.eigh_fanout"):
        caller = torch.cuda.current_stream(x.device)
        ready = torch.cuda.Event()
        ready.record(caller)
        futures = [_pool.submit(_solve_share, flat[lo:hi], ready)
                   for lo, hi in shares(flat.shape[0], width)]
        wait(futures)
        parts = [f.result() for f in futures]
        for w, v, done in parts:
            caller.wait_event(done)
            w.record_stream(caller)
            v.record_stream(caller)
        w, v = _gather([(w, v) for w, v, _ in parts], n)
    return w.reshape(x.shape[:-1]), v.reshape(x.shape)


def eigh(rho):
    """torch.linalg.eigh of a batch of Hermitian matrices; a single-precision
    batch is solved in double precision and cast back. cuSOLVER's complex64
    eigh failed to converge on the density matrix of a chain-end bond of a
    reference-scale state (chi=128, p=8: rank 8 of 1024 after the jitter)
    where complex128 converged, at +25-35% of the time
    (tools/probe_scaled_linalg.py); the same on every device. On the card a
    batch is solved in concurrent shares (`_fanout_width`,
    `_eigh_fanout`), each matrix by the syevd one call gives it. Each call
    adds one to `eigh_calls[m]`, m the matrices' size."""
    m = rho.shape[-1]
    eigh_calls[m] = eigh_calls.get(m, 0) + 1
    x = rho
    if rho.dtype not in _DOUBLE:
        x = rho.to(torch.complex128 if rho.is_complex() else torch.float64)
    width = _fanout_width(x)
    w, v = torch.linalg.eigh(x) if width == 1 else _eigh_fanout(x, width)
    if rho.dtype in _DOUBLE:
        return w, v
    return w.to(rho.real.dtype), v.to(rho.dtype)


def _eigh_desc(rho, chi: int):
    """Top-`chi` eigenpairs of a batch of Hermitian matrices, descending."""
    w, v = eigh(rho)
    return w.flip(-1)[..., :chi], v.flip(-1)[..., :chi]


def split_truncate(theta, chi: int, keep_left: bool, method: str = "eigh",
                   svd_driver: str | None = None):
    """Split a batch of matrices theta (B, m, n) into (left (B, m, chi),
    right (B, chi, n)) with theta ~= left @ right.

    keep_left=True: left is an isometry, right carries the center.
    keep_left=False: right is an isometry, left carries the center.
    Requires m >= chi and n >= chi. svd_driver: the cuSOLVER driver of the
    "svd" method on a CUDA tensor (None: PyTorch's choice); ignored on the
    CPU, whose LAPACK has one.
    """
    if method.startswith("rsvd") and method != "rsvd":
        iters = int(method[4:])
        method = "rsvd"
    else:
        iters = _RSVD_ITERS
    if method in ("eigh", "rsvd"):
        if keep_left:
            rho = jitter(theta @ _h(theta))
        else:
            rho = jitter(_h(theta) @ theta)
        if method == "eigh":
            _, u = _eigh_desc(rho, chi)
        else:
            u = _top_eigenspace_rsvd(rho, chi, iters)
        if keep_left:
            return u, _h(u) @ theta
        return theta @ u, _h(u).resolve_conj()
    if method == "range":
        eps = 1e-12 if theta.dtype in _DOUBLE else 1e-5
        if keep_left:
            om = _fixed_gaussian(theta.shape[-1], chi, theta.dtype,
                                 theta.device)
            q = _thin_qr_q(theta @ om)
            right = _h(q) @ theta
            rn = torch.linalg.vector_norm(right, dim=-1)
            keep = (rn > eps * rn.amax(-1, keepdim=True)).to(q.dtype)
            return q * keep[..., None, :], right * keep[..., :, None]
        om = _fixed_gaussian(theta.shape[-2], chi, theta.dtype, theta.device)
        v = _thin_qr_q(_h(theta) @ om.conj())
        left = theta @ v
        ln = torch.linalg.vector_norm(left, dim=-2)
        keep = (ln > eps * ln.amax(-1, keepdim=True)).to(v.dtype)
        return left * keep[..., None, :], (_h(v) * keep[..., :, None]
                                           ).resolve_conj()
    if method == "svd":
        shape = tuple(theta.shape[-2:])
        svd_calls[shape] = svd_calls.get(shape, 0) + 1
        u, s, vh = torch.linalg.svd(
            theta, full_matrices=False,
            driver=svd_driver if theta.is_cuda else None)
        u, s, vh = u[..., :chi], s[..., :chi].to(theta.dtype), vh[..., :chi, :]
        if keep_left:
            return u, s[..., :, None] * vh
        return u * s[..., None, :], vh
    if method == "nssub":
        raise ValueError("trunc_method 'nssub' is the JAX package's matmul-"
                         "only route for a TPU without factorizations; the "
                         "port truncates with 'eigh' (or 'svd', 'rsvd', "
                         "'range')")
    raise ValueError(f"Unknown truncation method {method!r}")
