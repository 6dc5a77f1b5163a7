"""Fixed-rank matrix-product states, batched.

Counterpart of optimalcontrolmps_tpu/mps.py. A batch of MPS is one tensor
of shape (B, L, chi, p, chi): B states, L sites, local dimension p = d+1,
bond dimension chi. Boundary bonds are zero-padded (site 0 uses left index
0 only, site L-1 right index 0 only), so no masking is ever needed. Where
the JAX package vmaps over states, these functions take the leading batch
axis; per-site tensors are (B, chi, p, chi).

`product_state`, `from_statevector` and `pad_chi` stay host numpy, like the
JAX package's; the caller moves their result to a device.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.trunc import (cholesky_orthonormalize, householder_qr,
                        split_truncate)

__all__ = [
    "product_state", "from_statevector", "pad_chi", "to_statevector",
    "overlap", "norm", "normalize", "sandwich_site_sum",
    "expectation_values", "apply_site_sum_diag", "move_right", "move_left",
    "entanglement_entropies",
]


# ---------------------------------------------------------------------------
# construction (host numpy)
# ---------------------------------------------------------------------------

def product_state(occupations, p: int, chi: int, dtype=np.complex128):
    """Padded (L, chi, p, chi) MPS of the product Fock state |n_0, n_1, ...>."""
    L = len(occupations)
    A = np.zeros((L, chi, p, chi), dtype=np.complex128)
    for i, n in enumerate(occupations):
        A[i, 0, int(n), 0] = 1.0
    return A.astype(np.dtype(dtype))


def from_statevector(vec, L: int, p: int, chi: int, dtype=np.complex128):
    """Exact (L, chi, p, chi) MPS, padded to chi, from a dense p**L vector
    by successive SVDs (truncating where chi is below a bond's rank)."""
    vec = np.asarray(vec, dtype=np.complex128).reshape(-1)
    assert vec.size == p ** L
    A = np.zeros((L, chi, p, chi), dtype=np.complex128)
    m = vec.reshape(1, -1)
    rank = 1
    for i in range(L - 1):
        m = m.reshape(rank * p, -1)
        u, s, vh = np.linalg.svd(m, full_matrices=False)
        keep = min(chi, (s > 1e-14).sum() or 1)
        u, s, vh = u[:, :keep], s[:keep], vh[:keep, :]
        A[i, :rank, :, :keep] = u.reshape(rank, p, keep)
        m = s[:, None] * vh
        rank = keep
    A[L - 1, :rank, :, 0] = m.reshape(rank, p)
    return A.astype(np.dtype(dtype))


def pad_chi(A, chi_new: int):
    """Zero-pad an (L, chi, p, chi) MPS to a larger bond dimension (an exact
    embedding)."""
    A = np.asarray(A)
    L, chi, p, _ = A.shape
    if chi_new == chi:
        return A
    if chi_new < chi:
        raise ValueError(f"pad_chi cannot shrink chi {chi} -> {chi_new}")
    out = np.zeros((L, chi_new, p, chi_new), A.dtype)
    out[:, :chi, :, :chi] = A
    return out


# ---------------------------------------------------------------------------
# contractions
# ---------------------------------------------------------------------------

def to_statevector(A):
    """(B, L, chi, p, chi) -> (B, p**L) dense vectors (small L only)."""
    B, L = A.shape[:2]
    psi = A[:, 0, 0]                                   # (B, p, chi)
    for i in range(1, L):
        psi = torch.einsum('bxa,bapc->bxpc', psi, A[:, i])
        psi = psi.reshape(B, -1, A.shape[-1])
    return psi[..., 0]


def _env_step(env, phi_i, psi_i):
    """env (B, a, c) -> sum_{a c p} env[a c] conj(phi_i[a p b]) psi_i[c p d]."""
    t = torch.einsum('bac,bcpd->bapd', env, psi_i)
    return torch.einsum('bapx,bapd->bxd', phi_i.conj(), t)


def _env_step_right(env, phi_i, psi_i):
    """env (B, b, d) -> sum_{b d p} conj(phi_i[a p b]) psi_i[c p d] env[b d]."""
    t = torch.einsum('bcpd,bxd->bcpx', psi_i, env)
    return torch.einsum('bapx,bcpx->bac', phi_i.conj(), t)


def overlap(phi, psi):
    """<phi|psi> (phi conjugated) for each of the B pairs; (B,)."""
    L = phi.shape[1]
    B, chi = psi.shape[0], psi.shape[2]
    env = torch.eye(chi, dtype=psi.dtype, device=psi.device).expand(
        B, chi, chi)
    for i in range(L):
        env = _env_step(env, phi[:, i], psi[:, i])
    return torch.diagonal(env, dim1=-2, dim2=-1).sum(-1)


def norm(psi):
    return torch.sqrt(torch.abs(overlap(psi, psi)))


def _inv_or_one(nrm):
    return torch.where(nrm > 1e-16, 1.0 / nrm, torch.ones_like(nrm))


def normalize(psi):
    """Scale site 0 of each state by 1/norm."""
    scale = _inv_or_one(norm(psi)).to(psi.dtype)
    out = psi.clone()
    out[:, 0] = psi[:, 0] * scale[:, None, None, None]
    return out


def _left_envs(phi, psi):
    """L_i: contraction of sites < i of <phi|psi>; list of (B, chi, chi)."""
    B, L, chi = psi.shape[:3]
    env = torch.eye(chi, dtype=psi.dtype, device=psi.device).expand(
        B, chi, chi)
    envs = [env]
    for i in range(L - 1):
        env = _env_step(env, phi[:, i], psi[:, i])
        envs.append(env)
    return envs


def _right_envs(phi, psi):
    """R_i: contraction of sites > i; list indexed by site."""
    B, L, chi = psi.shape[:3]
    env = torch.eye(chi, dtype=psi.dtype, device=psi.device).expand(
        B, chi, chi)
    envs = [None] * L
    envs[L - 1] = env
    for i in range(L - 1, 0, -1):
        env = _env_step_right(env, phi[:, i], psi[:, i])
        envs[i - 1] = env
    return envs


def _sandwich_sites(phi, psi, op):
    """Per-site <phi| O_i |psi> for a (p, p) operator, (B, L)."""
    L = phi.shape[1]
    lenvs = _left_envs(phi, psi)
    renvs = _right_envs(phi, psi)
    vals = []
    for i in range(L):
        opsi = torch.einsum('qp,bcpd->bcqd', op, psi[:, i])
        mid = _env_step(lenvs[i], phi[:, i], opsi)
        vals.append(torch.sum(mid * renvs[i], dim=(-2, -1)))
    return torch.stack(vals, dim=1)


def sandwich_site_sum(phi, psi, opdiag):
    """sum_i <phi| O_i |psi> for a diagonal single-site operator; (B,).
    With O = 0.5 n(n-1) this is <xi| dH/du |psi>."""
    o = torch.as_tensor(opdiag, dtype=psi.dtype, device=psi.device)
    return _sandwich_sites(phi, psi, torch.diag(o)).sum(-1)


def expectation_values(psi, opmat):
    """<psi| O_i |psi> for every site, for a dense (p, p) operator; (B, L).
    Assumes normalized states; any gauge."""
    o = torch.as_tensor(opmat, dtype=psi.dtype, device=psi.device)
    return _sandwich_sites(psi, psi, o)


# ---------------------------------------------------------------------------
# gauge moves
# ---------------------------------------------------------------------------

def move_right(Ai, Aj, method: str = "qr"):
    """Shift the orthogonality center from site i to j = i+1 for a batch of
    site pairs (B, l, p, r), (B, r, p, s): Ai becomes a left isometry and
    Aj the new center. method "qr" (Householder) or "cholesky"."""
    B, chi, p, r = Ai.shape
    m = Ai.reshape(B, chi * p, r)
    if method == "cholesky":
        q, Lc = cholesky_orthonormalize(m)
        rmat = Lc.conj().transpose(-2, -1)
    elif method == "qr":
        q, rmat = householder_qr(m)
    else:
        raise ValueError(f"gauge method {method!r}: the port has 'qr' and "
                         "'cholesky' ('mgs' is the JAX package's TPU route)")
    # row-major, as every site of a batch (Householder's Q is column-major):
    # the bond-theta kernel reads sites with contiguous inner dimensions
    return (q.reshape(B, chi, p, r).contiguous(),
            torch.einsum('bxy,bypc->bxpc', rmat, Aj))


def move_left(Ai, Aj, method: str = "qr"):
    """Shift the orthogonality center from site j = i+1 to i: Aj becomes a
    right isometry and Ai the new center."""
    B, l, p, chi = Aj.shape
    mh = Aj.reshape(B, l, p * chi).conj().transpose(-2, -1)
    if method == "cholesky":
        q, Lc = cholesky_orthonormalize(mh)   # m^H = q Lc^H
        rmat_h = Lc
    elif method == "qr":
        q, rT = householder_qr(mh)                    # m^H = q rT
        rmat_h = rT.conj().transpose(-2, -1)
    else:
        raise ValueError(f"gauge method {method!r}: the port has 'qr' and "
                         "'cholesky' ('mgs' is the JAX package's TPU route)")
    Aj_new = q.conj().transpose(-2, -1).reshape(B, l, p, chi)
    return torch.einsum('bapx,bxy->bapy', Ai, rmat_h), Aj_new


# ---------------------------------------------------------------------------
# operator application
# ---------------------------------------------------------------------------

def apply_site_sum_diag(psi, opdiag, method: str = "eigh"):
    """(sum_i O_i)|psi> for a diagonal single-site O, compressed back to chi:
    the bond-2 MPO is contracted exactly (bond 2 chi), right-canonicalized,
    then truncated left to right. Returns (normalized MPS batch, norms (B,))."""
    B, L, chi, p, _ = psi.shape
    o = torch.as_tensor(opdiag, dtype=psi.dtype, device=psi.device)
    blocks = []
    for i in range(L):
        a = psi[:, i]
        oa = a * o[None, None, :, None]
        if i == 0:
            t = torch.cat([a, oa], dim=3)
        elif i == L - 1:
            t = torch.cat([oa, a], dim=1)
        else:
            top = torch.cat([a, oa], dim=3)
            bot = torch.cat([torch.zeros_like(a), a], dim=3)
            t = torch.cat([top, bot], dim=1)
        blocks.append(t)

    for i in range(L - 1, 0, -1):
        blocks[i - 1], blocks[i] = move_left(blocks[i - 1], blocks[i])

    out = []
    for i in range(L - 1):
        l, r = blocks[i].shape[1], blocks[i].shape[3]
        left, right = split_truncate(blocks[i].reshape(B, l * p, r), chi,
                                     keep_left=True, method=method)
        out.append(left.reshape(B, l, p, chi))
        blocks[i + 1] = torch.einsum('bxy,bypc->bxpc', right, blocks[i + 1])
    out.append(blocks[-1])

    res = torch.stack(out, dim=1)
    nrm = norm(res)
    res[:, L - 1] = res[:, L - 1] * _inv_or_one(nrm).to(
        res.dtype)[:, None, None, None]
    return res, nrm


# ---------------------------------------------------------------------------
# entanglement
# ---------------------------------------------------------------------------

def entanglement_entropies(psi):
    """Von Neumann entropy at every bond; (B, L-1)."""
    B, L, chi, p, _ = psi.shape
    A = [psi[:, i] for i in range(L)]
    for i in range(L - 1, 0, -1):
        A[i - 1], A[i] = move_left(A[i - 1], A[i])
    ents = []
    for i in range(L - 1):
        theta = torch.einsum('bapx,bxqc->bapqc', A[i], A[i + 1])
        s = torch.linalg.svdvals(theta.reshape(B, chi * p, p * chi))
        p2 = s * s
        p2 = p2 / p2.sum(-1, keepdim=True)
        safe = torch.where(p2 > 1e-12, p2, torch.ones_like(p2))
        ents.append(-torch.sum(torch.where(p2 > 1e-12, p2 * torch.log(safe),
                                           torch.zeros_like(p2)), dim=-1))
        A[i], A[i + 1] = move_right(A[i], A[i + 1])
    return torch.stack(ents, dim=1)
