"""Two-site theta of a TEBD bond update: CUDA kernel and plain twin.

Counterpart of optimalcontrolmps_tpu/ops/pallas_kernels.py. For a batch of
bond pairs Ai, Aj (B, chi, p, chi) and the (p^2, p^2) bond gate,

    theta[b, l*p+P, Q*chi+r] = sum_{p'q} G[P*p+Q, p'*p+q]
                               * sum_m Ai[b,l,p',m] Aj[b,m,q,r]

returned as a contiguous (B, chi*p, p*chi) matrix ready for truncation.

* `bond_theta_reference` is the plain PyTorch twin: the two einsums of
  `tebd._apply_bond`, batched. The CPU path and the kernel's check use it.
* `_launch` runs the hand-written Hopper kernel of `csrc/bond_theta.cu`
  (complex64 or complex128) with the tile plan of `_plan`, and counts its
  launches (`bond_theta_launches`).
* `bond_theta` is the public entry. It looks at the tensor's device only: a
  CUDA tensor launches the kernel (or raises), a CPU tensor takes the twin.

Ai and Aj may have any batch stride, so `A.unbind(1)` of an MPS batch
(B, L, chi, p, chi) goes in as it is; their three inner dimensions must be
contiguous, on every device, so that a CPU run refuses a layout the kernel
would refuse. The operation has no backward: the MPS engine differentiates
with the analytic adjoint, and reverse-mode autodiff through the truncating
rollout is NaN anyway (eigh of the padded spectrum). A call that would need
a gradient raises.
"""

from __future__ import annotations

from functools import lru_cache

import torch

__all__ = ["bond_theta", "bond_theta_reference", "reset_counts",
           "bond_theta_launches"]

bond_theta_launches = 0

SMEM_LIMIT = 232448   # bytes of shared memory a block can have on Hopper
_KC = 16              # the kernel's K chunk (csrc/bond_theta.cu KC)
_TILES = (64, 32)     # stage-1 tile BM = BN: 256 and 64 threads
_SMS = 132            # streaming multiprocessors of an H100 SXM
_ITEMSIZE = {torch.complex64: 8, torch.complex128: 16}
_ENTRIES: dict = {}   # dtype -> C entry point, filled at the first launch


def reset_counts() -> None:
    global bond_theta_launches
    bond_theta_launches = 0


def bond_theta_reference(Ai, Aj, gate):
    """Plain twin: Ai (B, l, p, m), Aj (B, m, q, r), gate (p*q, p*q) ->
    (B, l*p, q*r)."""
    theta = torch.einsum('bapc,bcqd->bapqd', Ai, Aj)
    B, l, p, q, r = theta.shape
    theta = torch.einsum('PQ,baQc->baPc', gate,
                         theta.reshape(B, l, p * q, r))
    return theta.reshape(B, l * p, q * r)


def _smem_bytes(tile: int, p: int, lt: int, rt: int, itemsize: int) -> int:
    """Shared memory of one block (csrc/bond_theta.cu Layout::elems): two
    A chunk buffers, then the larger of two B chunk buffers and stage 2's T
    (p^2 rows rounded up to whole K chunks), which overlays them."""
    n2s = -(-lt * rt // tile) * tile
    m2r = -(-p * p // _KC) * _KC
    return itemsize * (2 * tile * (_KC + 1) + max(2 * _KC * tile, m2r * n2s))


@lru_cache(maxsize=1024)
def _plan(B: int, chi: int, p: int, itemsize: int):
    """(tile, lt, rt, blocks, smem bytes): a block owns lt left and rt right
    indices of one batch element with all of p and q, a stage-1 tile of
    (lt*p) x (p*rt) <= tile x tile; lt is the least that needs no more
    blocks than the largest lt whose block fits in shared memory. The wide
    tile (64) unless its grid leaves SMs idle and the narrow one (32) fits.
    Refuses only a p whose tile does not fit, whatever chi is."""
    fits = []
    for tile in _TILES:
        for most in range(min(tile // p, chi), 0, -1):
            n = -(-chi // most)   # tiles along l (and r)
            lt = -(-chi // n)
            smem = _smem_bytes(tile, p, lt, lt, itemsize)
            if smem <= SMEM_LIMIT:
                fits.append((tile, lt, lt, B * n * n, smem))
                break
    if not fits:
        raise ValueError(
            f"bond_theta: p={p} does not fit a block: the narrowest tile "
            f"needs more than the {SMEM_LIMIT} B of shared memory a block "
            f"can have (complex of {itemsize} B)")
    if fits[0][0] == _TILES[0] and fits[0][3] < _SMS and len(fits) > 1:
        return fits[1]
    return fits[0]


def _inner_contiguous(t) -> bool:
    """The three inner dimensions of a (B, l, p, r) tensor are contiguous
    (the stride of a dimension of size 1 does not matter)."""
    _, l, p, r = t.shape
    _, sl, sp, sr = t.stride()
    return (sr == 1 or r == 1) and (sp == r or p == 1) \
        and (sl == p * r or l == 1)


def _launch(Ai, Aj, gate):
    # the checks cost host time on every call of the TEBD loop, so they
    # read each attribute once and compare plain Python values
    global bond_theta_launches
    shape = Ai.shape
    if len(shape) != 4 or shape[1] != shape[3]:
        raise ValueError(f"Ai: expected shape (B, chi, p, chi), got "
                         f"{tuple(shape)}")
    B, chi, p, _ = shape
    dev = Ai.get_device()
    if not Ai.is_cuda or Aj.get_device() != dev or gate.get_device() != dev:
        raise ValueError(f"expected CUDA tensors on one device, got "
                         f"{Ai.device}, {Aj.device}, {gate.device}")
    dtype = Ai.dtype
    if Aj.dtype is not dtype or gate.dtype is not dtype \
            or dtype not in _ITEMSIZE:
        raise TypeError(f"expected complex64 or complex128 tensors of one "
                        f"type, got {Ai.dtype}, {Aj.dtype}, {gate.dtype}")
    if Aj.shape != shape or gate.shape != (p * p, p * p):
        raise ValueError(f"expected shapes {tuple(shape)}, {tuple(shape)}, "
                         f"{(p * p, p * p)}, got {tuple(Aj.shape)} and "
                         f"{tuple(gate.shape)}")
    inner = (p * chi, chi, 1)
    sa, sj = Ai.stride(), Aj.stride()
    if (sa[1:] != inner and not _inner_contiguous(Ai)) \
            or (sj[1:] != inner and not _inner_contiguous(Aj)) \
            or not gate.is_contiguous():
        raise ValueError("Ai, Aj: expected contiguous inner dimensions "
                         "(any batch stride); gate: a contiguous tensor")
    if B < 1:
        raise ValueError("empty bond batch")
    fn = _ENTRIES.get(dtype)
    if fn is None:
        from ._build import load_bond_theta
        lib = load_bond_theta()
        fn = _ENTRIES.setdefault(dtype, lib.bond_theta_c64
                                 if dtype == torch.complex64
                                 else lib.bond_theta_c128)
    tile, lt, rt, _, _ = _plan(B, chi, p, _ITEMSIZE[dtype])
    theta = torch.empty((B, chi * p, p * chi), dtype=dtype, device=Ai.device)
    rc = fn(Ai.data_ptr(), Aj.data_ptr(), gate.data_ptr(), theta.data_ptr(),
            B, chi, p, sa[0], sj[0], tile, lt, rt,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"bond_theta (B={B}, chi={chi}, p={p}, {dtype}, "
                           f"tile {tile}): CUDA error {rc}")
    bond_theta_launches += 1
    return theta


def bond_theta(Ai, Aj, gate):
    """Kernel on CUDA tensors, twin on CPU tensors. Ai, Aj (B, chi, p, chi)
    with contiguous inner dimensions, gate (p^2, p^2) -> (B, chi*p, p*chi).
    Raises where a gradient would be needed, and on either device on a lazy
    conjugate or negative view or another inner layout."""
    if torch.is_grad_enabled() and (Ai.requires_grad or Aj.requires_grad
                                    or gate.requires_grad):
        raise RuntimeError("bond_theta has no backward; differentiate the "
                           "MPS engine with its analytic adjoint")
    if Ai.is_conj() or Aj.is_conj() or gate.is_conj() or Ai.is_neg() \
            or Aj.is_neg() or gate.is_neg():
        # the kernel reads memory as stored, and so does the check on the
        # CPU, so that a path that would hand the card a lazy view fails here
        raise ValueError("bond_theta: a conjugate or negative view; call "
                         "resolve_conj() / resolve_neg() first")
    if Ai.is_cuda:
        return _launch(Ai, Aj, gate)
    if Aj.is_cuda or gate.is_cuda:
        raise ValueError("bond_theta: Ai is on the CPU but Aj or the gate "
                         "is on a CUDA device")
    if Ai.dim() == 4 and Aj.dim() == 4 and not (
            _inner_contiguous(Ai) and _inner_contiguous(Aj)):
        raise ValueError("bond_theta: Ai, Aj need contiguous inner "
                         "dimensions (any batch stride), as the kernel does")
    return bond_theta_reference(Ai, Aj, gate)
