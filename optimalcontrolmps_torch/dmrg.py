"""Two-site DMRG ground states of the Bose-Hubbard chain.

Counterpart of optimalcontrolmps_tpu/dmrg.py: the at-scale rebuild of the
reference's InitializeState (ITensor `dmrg` with the sweep schedule maxm =
10, 20, 50, 100, maxBondDim), for chains whose fixed-N sector is too large
for the exact diagonalization of `groundstate.py`:

* a bond-dimension-5 MPO of H = -J sum(a adag + adag a) + U/2 sum n(n-1),
  plus the particle-number penalty lam (N_tot - npart)^2, which keeps the
  dense (non-QN) search in the npart sector;
* fixed-depth Lanczos with full reorthogonalization for the two-site
  problem, its coefficients kept on the device (one host sync per bond,
  for the small tridiagonal eigenproblem);
* the SVD split back to chi after each bond (`ops.trunc.split_truncate`);
  on the card by cuSOLVER's QR-based `gesvd` (SVD_DRIVER): on a (1024,
  1024) complex64 theta of the reference scale it was 2.7-3.1x faster
  than PyTorch's default Jacobi route, which also resolved the kept
  singular values only to ~1e-4 (tools/probe_scaled_linalg.py).

A sweep is plain eager code: L-1 bond updates left to right, then right to
left. States are (L, chi, p, chi) tensors in the caller's dtype on the
caller's device (None: the card). The search itself runs in complex128
whatever dtype the caller asks for, and returns the state in that dtype: at
the reference scale (N=20, d=7, chi=128) a complex64 search's sweep energies
wandered by up to 8.6e-5 (3.7e-6 |E|) and fell 6e-5 below the complex128
search's converged chi=128 energy (its environment bases are isometries only
to ~1e-7, against MPO terms that reach 2 lam npart^2 = 1600), while the
complex128 sweeps fell monotonically to 5e-13, at 13% more time
(tools/probe_scaled_linalg.py --real, --real128).

Spans (`profiling.span`): `dmrg.search` around one `dmrg_ground_state`,
`dmrg.lanczos` and `dmrg.split` around each bond's two-site solve and its
SVD split. Counters (`reset_counts`): `sweeps`, `matvecs` (H_eff
applications) and `host_syncs` (one per Lanczos solve, for its
tridiagonal eigenproblem; at the fixed Krylov depth, matvecs / krylov).
"""

from __future__ import annotations

import numpy as np
import torch

from . import mps as mpslib
from .device import resolve_device
from .ops.trunc import split_truncate
from .profiling import span
from .sites import op

__all__ = ["bh_mpo", "ramp_schedule", "dmrg_ground_state",
           "initialize_state_dmrg", "sweeps", "matvecs", "host_syncs",
           "reset_counts"]

SVD_DRIVER = "gesvd"

# full sweeps (L->R then R->L) made by `dmrg_ground_state`
sweeps = 0
# H_eff applications of the two-site Lanczos solves
matvecs = 0
# host waits for the Lanczos coefficients, one per two-site solve (so
# matvecs / krylov: the depth is fixed)
host_syncs = 0


def reset_counts() -> None:
    global sweeps, matvecs, host_syncs
    sweeps = matvecs = host_syncs = 0


def bh_mpo(L: int, d: int, J: float, U: float, dtype=np.complex128,
           npart: int | None = None, number_penalty: float = 0.0):
    """Bose-Hubbard MPO tensors W[wl, wr, p, q], bond dim 5 (numpy).

    States: 0 = finished, 1 = "a placed", 2 = "adag placed",
    3 = initial, 4 = "n placed" (number-penalty ladder).
    Boundary vectors: vL = e_3, vR = e_0.

    number_penalty lam adds lam * (N_tot - npart)^2, expanded as the
    on-site lam (n^2 - 2 npart n + npart^2/L) plus the pair ladder
    2 lam n_i n_j. It gaps the neighbouring particle-number sectors away,
    which the dense tensors do not exclude by block structure (ITensor's
    QN conservation in the reference); the converged state pays zero
    penalty.
    """
    p = d + 1
    a = op("A", d)
    adag = op("Adag", d)
    nn1 = op("N(N-1)", d)
    nmat = op("N", d)
    eye = np.eye(p)
    W = np.zeros((5, 5, p, p))
    W[0, 0] = eye
    W[3, 3] = eye
    W[3, 1] = a
    W[1, 0] = -J * adag
    W[3, 2] = adag
    W[2, 0] = -J * a
    W[3, 0] = 0.5 * U * nn1
    if number_penalty > 0.0:
        lam = number_penalty
        assert npart is not None
        W[3, 0] += lam * (nmat @ nmat - 2.0 * npart * nmat
                          + (npart ** 2 / L) * eye)
        W[3, 4] = 2.0 * lam * nmat
        W[4, 4] = eye
        W[4, 0] = nmat
    return W.astype(dtype)


def _heff_matvec(Lenv, W, Renv, theta):
    """H_eff @ theta for the two-site problem. Indices:
    Lenv[w, l, l'], W1[w, x, p, p'], W2[x, y, q, q'], Renv[y, r, r'],
    theta[l', p', q', r'] -> out[l, p, q, r]."""
    t = torch.einsum('wlm,mPQr->wlPQr', Lenv, theta)
    t = torch.einsum('wxpP,wlPQr->xlpQr', W, t)
    t = torch.einsum('xyqQ,xlpQr->ylpqr', W, t)
    return torch.einsum('yRr,ylpqr->lpqR', Renv, t)


def _lanczos_ground(matvec, v0, k: int = 25):
    """(lowest Ritz value as a float, its vector in v0's shape) of a
    Hermitian operator by fixed-depth Lanczos with full
    reorthogonalization. The Krylov coefficients stay on the device (the
    b > 1e-12 guard is a torch.where); the k x k tridiagonal eigenproblem
    is solved on the host in float64, the one sync of the call."""
    global matvecs, host_syncs
    shape = v0.shape
    v0 = v0.reshape(-1)
    v0 = v0 / torch.linalg.vector_norm(v0)
    V = torch.zeros((k, v0.numel()), dtype=v0.dtype, device=v0.device)
    V[0] = v0
    real = v0.real.dtype
    alpha = torch.zeros(k, dtype=real, device=v0.device)
    beta = torch.zeros(k, dtype=real, device=v0.device)
    for i in range(k):
        v = V[i]
        w = matvec(v.reshape(shape)).reshape(-1)
        a = torch.vdot(v, w).real
        w = w - a * v
        # full reorthogonalization against every vector so far (the later
        # rows of V are still zero)
        w = w - (V[:i + 1].conj() @ w) @ V[:i + 1]
        b = torch.linalg.vector_norm(w)
        if i + 1 < k:
            V[i + 1] = torch.where(b > 1e-12,
                                   w / torch.where(b > 0, b,
                                                   torch.ones_like(b)), w)
        alpha[i] = a
        beta[i] = b
    matvecs += k
    host_syncs += 1
    al = alpha.double().cpu().numpy()
    be = beta.double().cpu().numpy()
    Tm = np.diag(al) + np.diag(be[:k - 1], 1) + np.diag(be[:k - 1], -1)
    w, vecs = np.linalg.eigh(Tm)
    c = torch.as_tensor(vecs[:, 0], device=V.device).to(V.dtype)
    ground = c @ V
    nrm = torch.linalg.vector_norm(ground)
    ground = ground / torch.where(nrm > 1e-12, nrm, torch.ones_like(nrm))
    return float(w[0]), ground.reshape(shape)


def ramp_schedule(chi: int, base=(10, 20, 50, 100, 200)):
    """The reference's DMRG bond-dimension ramp maxm = 10,20,50,100,200
    capped at the target chi: every base entry strictly below chi, then chi
    itself."""
    return [m for m in base if m < chi] + [chi]


def _sweep(A, W, chi: int, krylov: int):
    """One full DMRG sweep (L->R then R->L) of A (L, chi, p, chi) at fixed
    chi with the MPO W (of A's dtype). Returns (A', energy of the last bond
    update)."""
    global sweeps
    sweeps += 1
    L, _, p, _ = A.shape
    dtype, dev = A.dtype, A.device
    wdim = W.shape[0]

    def boundary(state):
        e = torch.zeros((wdim, chi, chi), dtype=dtype, device=dev)
        e[state, 0, 0] = 1.0
        return e

    def push_left_env(env, Ai):
        # env'[x, l, l'] = env[w, m, m'] conj(A)[m,p,l] W[w,x,p,p'] A[m',p',l']
        t = torch.einsum('wmn,nqr->wmqr', env, Ai)
        t = torch.einsum('wxpq,wmqr->xmpr', W, t)
        return torch.einsum('mpl,xmpr->xlr', Ai.conj(), t)

    def push_right_env(env, Ai):
        # env'[w, l, l'] = conj(A)[l,p,n] W[w,x,p,p'] A[l',p',n'] env[x,n,n']
        t = torch.einsum('xnN,rqN->xnrq', env, Ai)
        t = torch.einsum('wxpq,xnrq->wnrp', W, t)
        return torch.einsum('lpn,wnrp->wlr', Ai.conj(), t)

    def two_site(b):
        return torch.einsum('lpm,mqr->lpqr', T[b], T[b + 1])

    def normalized(c):
        nrm = torch.linalg.vector_norm(c)
        return c / torch.where(nrm > 1e-12, nrm, torch.ones_like(nrm))

    Renvs = [None] * L
    env = boundary(0)                  # vR = e_0
    Renvs[L - 1] = env
    for i in range(L - 1, 0, -1):
        env = push_right_env(env, A[i])
        Renvs[i - 1] = env

    T = list(A.unbind(0))
    Lenvs = [boundary(3)]              # vL = e_3
    energy = None
    for b in range(L - 1):             # left to right
        with span("dmrg.lanczos"):
            energy, theta = _lanczos_ground(
                lambda x: _heff_matvec(Lenvs[b], W, Renvs[b + 1], x),
                two_site(b), k=krylov)
        with span("dmrg.split"):
            lft, rgt = split_truncate(theta.reshape(1, chi * p, p * chi),
                                      chi, keep_left=True, method="svd",
                                      svd_driver=SVD_DRIVER)
        T[b] = lft.reshape(chi, p, chi)
        T[b + 1] = normalized(rgt.reshape(chi, p, chi))
        Lenvs.append(push_left_env(Lenvs[b], T[b]))

    Renv = boundary(0)
    for b in range(L - 2, -1, -1):     # right to left
        with span("dmrg.lanczos"):
            energy, theta = _lanczos_ground(
                lambda x: _heff_matvec(Lenvs[b], W, Renv, x), two_site(b),
                k=krylov)
        with span("dmrg.split"):
            lft, rgt = split_truncate(theta.reshape(1, chi * p, p * chi),
                                      chi, keep_left=False, method="svd",
                                      svd_driver=SVD_DRIVER)
        T[b + 1] = rgt.reshape(chi, p, chi)
        T[b] = normalized(lft.reshape(chi, p, chi))
        Renv = push_right_env(Renv, T[b + 1])
    return torch.stack(T), energy


@span("dmrg.search")
def dmrg_ground_state(L: int, d: int, npart: int, J: float, U: float,
                      chi: int, n_sweeps: int | None = None,
                      krylov: int = 25, dtype=torch.complex128,
                      number_penalty: float = 2.0, schedule=None,
                      e_tol: float = 1e-9, verbose: bool = False,
                      return_history: bool = False, device=None):
    """Ground-state MPS (L, chi, p, chi) in `dtype` by two-site DMRG on
    `device` (None: the card); the search runs in complex128. Returns (mps,
    energy), or (mps, energy, history) with return_history: one
    (chi_stage, sweep_energy) pair per sweep.

    Schedule (the reference's ramp): chi climbs 10 -> 20 -> 50 -> 100 ->
    200 -> target with one sweep per intermediate stage; at the target
    chi, sweeps continue until the energy changes by less than
    e_tol * max(1, |E|) between two sweeps of that stage, at most n_sweeps
    (default 12). Initial state: the product state filled right to left
    (InitializeState.hpp:28-38).
    """
    device = resolve_device(device)
    if n_sweeps is None:
        n_sweeps = 12
    if schedule is None:
        schedule = ramp_schedule(chi)
    p = d + 1
    # complex128 throughout, whatever `dtype` is (see the module's notes)
    W = torch.as_tensor(bh_mpo(L, d, J, U, npart=npart,
                               number_penalty=number_penalty),
                        device=device)

    occ = [0] * L
    left = npart
    for i in range(L - 1, -1, -1):
        if left >= 1:
            occ[i] = 1
            left -= 1
    occ[0] += left if left > 0 else 0   # npart > L: the rest on site 0
    A = mpslib.product_state(occ, p, schedule[0])

    e = None
    history = []
    for stage, chi_s in enumerate(schedule):
        if A.shape[1] < chi_s:
            A = mpslib.pad_chi(A.cpu().numpy() if isinstance(
                A, torch.Tensor) else A, chi_s)
        A = torch.as_tensor(A, device=device)
        final = stage == len(schedule) - 1
        # convergence compares sweeps within this stage only: the energy of
        # a smaller-chi stage would satisfy e_tol before the enlarged bond
        # space is used
        e = None
        for s in range(n_sweeps if final else 1):
            e_prev = e
            A, e = _sweep(A, W, chi_s, krylov)
            history.append((chi_s, e))
            if verbose:
                print(f"DMRG chi={chi_s} sweep {s + 1}: E = {e:.12f}",
                      flush=True)
            if (final and e_prev is not None
                    and abs(e_prev - e) < e_tol * max(1.0, abs(e))):
                break
    A = A.to(dtype)
    if return_history:
        return A, e, history
    return A, e


def initialize_state_dmrg(L, d, npart, J, U, chi, dtype=None, n_sweeps=8,
                          device=None):
    """`groundstate.initialize_state`'s signature, by DMRG."""
    A, _ = dmrg_ground_state(L, d, npart, J, U, chi, n_sweeps=n_sweeps,
                             dtype=torch.complex128 if dtype is None
                             else dtype, device=device)
    return A
