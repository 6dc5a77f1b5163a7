"""Plain two-site DMRG for the Bose-Hubbard ground states of the long chain.

A frozen copy of the method the program uses for its boundary states, so
that the benchmark makes those inputs itself and hands the same states to
the program and to the reference. It imports nothing of the program.

The MPO has bond dimension 5 (with a number penalty lam (N - npart)^2 that
gaps the neighbouring particle-number sectors away; the converged state
pays none of it). The search starts from the product state filled right to
left, climbs the bond dimension 10, 20, 50, 100, 200 (entries below the
target, then the target) with one sweep per stage, then sweeps at the
target until the energy moves by less than e_tol * max(1, |E|), at most
n_sweeps times. Each two-site problem is solved by fixed-depth Lanczos with
full reorthogonalization, the split by an SVD (cuSOLVER's gesvd on the
card). Everything runs in complex128.
"""

from __future__ import annotations

import numpy as np
import torch


def mpo(L: int, d: int, J: float, U: float, npart: int, penalty: float):
    p = d + 1
    n = np.arange(p, dtype=np.float64)
    a = np.diag(np.sqrt(n[1:]), k=1)
    num = np.diag(n)
    eye = np.eye(p)
    W = np.zeros((5, 5, p, p))
    W[0, 0] = eye
    W[3, 3] = eye
    W[3, 1] = a
    W[1, 0] = -J * a.T
    W[3, 2] = a.T
    W[2, 0] = -J * a
    W[3, 0] = 0.5 * U * np.diag(n * (n - 1.0)) + penalty * (
        num @ num - 2.0 * npart * num + (npart ** 2 / L) * eye)
    W[3, 4] = 2.0 * penalty * num
    W[4, 4] = eye
    W[4, 0] = num
    return W.astype(np.complex128)


def _lanczos(matvec, v0, k: int):
    shape = v0.shape
    v0 = v0.reshape(-1)
    V = torch.zeros((k, v0.numel()), dtype=v0.dtype, device=v0.device)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    alpha = torch.zeros(k, dtype=torch.float64, device=v0.device)
    beta = torch.zeros(k, dtype=torch.float64, device=v0.device)
    for i in range(k):
        w = matvec(V[i].reshape(shape)).reshape(-1)
        a = torch.vdot(V[i], w).real
        w = w - a * V[i]
        w = w - (V[:i + 1].conj() @ w) @ V[:i + 1]
        b = torch.linalg.vector_norm(w)
        if i + 1 < k:
            V[i + 1] = torch.where(b > 1e-12,
                                   w / torch.where(b > 0, b,
                                                   torch.ones_like(b)), w)
        alpha[i], beta[i] = a, b
    al, be = alpha.cpu().numpy(), beta.cpu().numpy()
    Tm = np.diag(al) + np.diag(be[:k - 1], 1) + np.diag(be[:k - 1], -1)
    w, vecs = np.linalg.eigh(Tm)
    g = torch.as_tensor(vecs[:, 0], device=V.device).to(V.dtype) @ V
    nrm = torch.linalg.vector_norm(g)
    g = g / torch.where(nrm > 1e-12, nrm, torch.ones_like(nrm))
    return float(w[0]), g.reshape(shape)


def _split(theta, chi: int, keep_left: bool):
    m = theta.shape[0] * theta.shape[1]
    mat = theta.reshape(m, -1)
    u, s, vh = torch.linalg.svd(mat, full_matrices=False,
                                driver="gesvd" if mat.is_cuda else None)
    u, s, vh = u[:, :chi], s[:chi].to(mat.dtype), vh[:chi]
    if keep_left:
        return u, s[:, None] * vh
    return u * s[None, :], vh


def _sweep(A, W, chi: int, krylov: int):
    L, _, p, _ = A.shape
    dev = A.device
    wd = W.shape[0]

    def boundary(k):
        e = torch.zeros((wd, chi, chi), dtype=A.dtype, device=dev)
        e[k, 0, 0] = 1.0
        return e

    def push_left(env, Ai):
        t = torch.einsum('wmn,nqr->wmqr', env, Ai)
        t = torch.einsum('wxpq,wmqr->xmpr', W, t)
        return torch.einsum('mpl,xmpr->xlr', Ai.conj(), t)

    def push_right(env, Ai):
        t = torch.einsum('xnN,rqN->xnrq', env, Ai)
        t = torch.einsum('wxpq,xnrq->wnrp', W, t)
        return torch.einsum('lpn,wnrp->wlr', Ai.conj(), t)

    def heff(Lenv, Renv):
        def mv(x):
            t = torch.einsum('wlm,mPQr->wlPQr', Lenv, x)
            t = torch.einsum('wxpP,wlPQr->xlpQr', W, t)
            t = torch.einsum('xyqQ,xlpQr->ylpqr', W, t)
            return torch.einsum('yRr,ylpqr->lpqR', Renv, t)
        return mv

    def unit(c):
        nrm = torch.linalg.vector_norm(c)
        return c / torch.where(nrm > 1e-12, nrm, torch.ones_like(nrm))

    T = list(A.unbind(0))
    R = [None] * L
    env = boundary(0)
    R[L - 1] = env
    for i in range(L - 1, 0, -1):
        env = push_right(env, T[i])
        R[i - 1] = env
    Lenv = [boundary(3)]
    e = None
    for b in range(L - 1):
        e, th = _lanczos(heff(Lenv[b], R[b + 1]),
                         torch.einsum('lpm,mqr->lpqr', T[b], T[b + 1]), krylov)
        lft, rgt = _split(th, chi, keep_left=True)
        T[b] = lft.reshape(chi, p, chi)
        T[b + 1] = unit(rgt.reshape(chi, p, chi))
        Lenv.append(push_left(Lenv[b], T[b]))
    Renv = boundary(0)
    for b in range(L - 2, -1, -1):
        e, th = _lanczos(heff(Lenv[b], Renv),
                         torch.einsum('lpm,mqr->lpqr', T[b], T[b + 1]), krylov)
        lft, rgt = _split(th, chi, keep_left=False)
        T[b + 1] = rgt.reshape(chi, p, chi)
        T[b] = unit(lft.reshape(chi, p, chi))
        Renv = push_right(Renv, T[b + 1])
    return torch.stack(T), e


def ground_state(L: int, d: int, npart: int, J: float, U: float, chi: int,
                 n_sweeps: int = 8, krylov: int = 25, penalty: float = 2.0,
                 e_tol: float = 1e-9, device="cpu"):
    """(MPS (L, chi, p, chi) complex128 numpy, energy)."""
    p = d + 1
    W = torch.as_tensor(mpo(L, d, J, U, npart, penalty), device=device)
    occ = [0] * L
    left = npart
    for i in range(L - 1, -1, -1):
        if left >= 1:
            occ[i] = 1
            left -= 1
    occ[0] += max(left, 0)
    schedule = [m for m in (10, 20, 50, 100, 200) if m < chi] + [chi]
    A = np.zeros((L, schedule[0], p, schedule[0]), np.complex128)
    for i, n in enumerate(occ):
        A[i, 0, n, 0] = 1.0
    A = torch.as_tensor(A, device=device)
    e = None
    for stage, c in enumerate(schedule):
        if A.shape[1] < c:
            big = torch.zeros((L, c, p, c), dtype=A.dtype, device=device)
            big[:, :A.shape[1], :, :A.shape[1]] = A
            A = big
        final = stage == len(schedule) - 1
        e = None
        for _ in range(n_sweeps if final else 1):
            e_prev = e
            A, e = _sweep(A, W, c, krylov)
            if (final and e_prev is not None
                    and abs(e_prev - e) < e_tol * max(1.0, abs(e))):
                break
    return A.cpu().numpy(), e
