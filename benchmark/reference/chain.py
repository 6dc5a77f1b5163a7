"""Plain reference of the long chain in Vidal's canonical form: the
truncating Trotter step, the cost and its adjoint gradient.

Written from the method's definition in plain PyTorch and NumPy; it
imports nothing of the program. A state is (B, lam): right-canonical site
tensors B (L, chi, p, chi), whose product is the state, and the Schmidt
values lam (L-1, chi) of every bond. One Trotter step applies the on-site
phases D(u_from), the hopping gate exp(-i dt h) to all even bonds, then to
all odd bonds, and D(u_to); each bond update is Hastings' (J. Math. Phys.
50, 095207):

    th = gate (B_b B_{b+1}),  rho = (lam_{b-1} th)^H (lam_{b-1} th) + jitter,
    V = the top-chi eigenvectors of rho,
    B_b <- th V,  B_{b+1} <- V^H,  lam_b <- sqrt(top-chi eigenvalues), unit norm,

and the step ends with the state renormalized on site 0. `jitter` adds
delta * mean(diag rho) to rho's diagonal: delta is the configuration's
(1e-6 for a single-precision configuration), so the reference truncates the
same regularized matrix. Products run through `Prec.mm`, so the control's
TF32 rounding reaches them.
"""

from __future__ import annotations

import numpy as np
import torch

from .sector import F64, Prec, hop_gate, regularization, regularization_grad


class Stepper:
    def __init__(self, d: int, J: float, dt: float, chi: int, jitter: float,
                 prec: Prec = F64, device="cpu"):
        p = d + 1
        n = np.arange(p, dtype=np.float64)
        self.p, self.chi, self.dt, self.jitter, self.prec = \
            p, chi, float(dt), float(jitter), prec
        self.gate = torch.as_tensor(hop_gate(J, d, dt), dtype=prec.cdtype,
                                    device=device).reshape(p, p, p, p)
        self.nn1 = torch.as_tensor(n * (n - 1.0), dtype=prec.rdtype,
                                   device=device)


def canonical_form(A: np.ndarray, cutoff: float = 1e-12):
    """(B (L, chi, p, chi), lam (L-1, chi)) of one MPS A, complex128 numpy:
    right-canonicalize by SVDs, sweep left to right recording the Schmidt
    values, and set B_b = lam_{b-1}^-1 A_b lam_b, directions whose Schmidt
    value is below `cutoff` set to zero."""
    A = np.asarray(A, dtype=np.complex128)
    L, chi, p, _ = A.shape
    T = [A[i].copy() for i in range(L)]
    for i in range(L - 1, 0, -1):
        u, s, vh = np.linalg.svd(T[i].reshape(chi, p * chi),
                                 full_matrices=False)
        k = s.size
        Bi = np.zeros((chi, p * chi), np.complex128)
        Bi[:k] = vh
        T[i] = Bi.reshape(chi, p, chi)
        carry = np.zeros((chi, chi), np.complex128)
        carry[:, :k] = u * s
        T[i - 1] = np.einsum('apb,bc->apc', T[i - 1], carry, optimize=True)
    lam = np.zeros((L - 1, chi))
    Aform = [None] * L
    C = T[0]
    for b in range(L - 1):
        u, s, vh = np.linalg.svd(C.reshape(chi * p, chi), full_matrices=False)
        k = s.size
        s = s / (np.linalg.norm(s) or 1.0)
        lam[b, :k] = s
        Ab = np.zeros((chi * p, chi), np.complex128)
        Ab[:, :k] = u
        Aform[b] = Ab.reshape(chi, p, chi)
        sv = np.zeros((chi, chi), np.complex128)
        sv[:k] = s[:, None] * vh
        C = np.einsum('ac,cpd->apd', sv, T[b + 1], optimize=True)
    Aform[L - 1] = C
    B = np.zeros((L, chi, p, chi), np.complex128)
    for b in range(L):
        Ab = Aform[b]
        if b < L - 1:
            Ab = Ab * lam[b][None, None, :]
        if b > 0:
            prev = lam[b - 1]
            inv = np.where(prev > cutoff, 1.0 / np.maximum(prev, cutoff), 0.0)
            Ab = Ab * inv[:, None, None]
        B[b] = Ab
    return B, lam


def _bond(st: Stepper, Bi, Bj, lam_left, gate):
    """Hastings update of a stack of bonds (n, chi, p, chi)."""
    n, chi, p, _ = Bi.shape
    pair = st.prec.mm(Bi.reshape(n, chi * p, chi),
                      Bj.reshape(n, chi, p * chi)).reshape(n, chi, p, p, chi)
    g = gate.reshape(p * p, p * p)
    th = st.prec.mm(g, pair.permute(0, 2, 3, 1, 4).reshape(n, p * p,
                                                          chi * chi))
    th = th.reshape(n, p, p, chi, chi).permute(0, 3, 1, 2, 4)  # l P Q r
    th = th.reshape(n, chi * p, p * chi)
    m = th * lam_left.to(th.dtype).repeat_interleave(p, dim=1)[:, :, None]
    rho = st.prec.mm(m.conj().transpose(-2, -1), m)
    scale = torch.diagonal(rho, dim1=-2, dim2=-1).real.mean(-1)
    rho = rho + (st.jitter * scale)[:, None, None].to(rho.dtype) \
        * torch.eye(p * chi, dtype=rho.dtype, device=rho.device)
    w, v = torch.linalg.eigh(rho.to(torch.complex128))
    w = w.flip(-1)[:, :chi].to(st.prec.rdtype)
    V = v.flip(-1)[:, :, :chi].to(rho.dtype)
    lam = torch.sqrt(torch.clamp(w, min=0.0))
    lam = lam / torch.linalg.vector_norm(lam, dim=-1, keepdim=True)
    Bi2 = st.prec.mm(th, V).reshape(n, chi, p, chi)
    Bj2 = V.conj().transpose(-2, -1).reshape(n, chi, p, chi)
    return Bi2, Bj2, lam


def overlap(phi, psi):
    """<phi|psi> of two MPS (L, chi, p, chi)."""
    env = torch.eye(phi.shape[1], dtype=psi.dtype, device=psi.device)
    for i in range(phi.shape[0]):
        env = torch.einsum('ac,apb,cpd->bd', env, phi[i].conj(), psi[i])
    return torch.trace(env)


def sandwich(phi, psi, diag):
    """sum_i <phi| O_i |psi> for the diagonal on-site operator O."""
    L = phi.shape[0]
    eye = torch.eye(phi.shape[1], dtype=psi.dtype, device=psi.device)
    right = [None] * L
    env = eye
    for i in range(L - 1, -1, -1):
        right[i] = env
        env = torch.einsum('bd,apb,cpd->ac', env, phi[i].conj(), psi[i])
    total = torch.zeros((), dtype=psi.dtype, device=psi.device)
    env = eye
    o = diag.to(psi.dtype)
    for i in range(L):
        mid = torch.einsum('ac,apb,p,cpd->bd', env, phi[i].conj(), o, psi[i])
        total = total + torch.sum(mid * right[i])
        env = torch.einsum('ac,apb,cpd->bd', env, phi[i].conj(), psi[i])
    return total


def step(st: Stepper, B, lam, u_from: float, u_to: float,
         forward: bool = True):
    """One truncating Trotter step of (B, lam); backward: the controls
    negated and the gate conjugated."""
    L = B.shape[0]
    s = 1.0 if forward else -1.0
    gate = st.gate if forward else st.gate.conj()

    def ph(u):
        return torch.exp((-0.25j * st.dt * s * u) * st.nn1).to(B.dtype)

    T = list((B * ph(u_from)[None, None, :, None]).unbind(0))
    lam = list(lam.unbind(0))
    for parity in (0, 1):
        bonds = list(range(parity, L - 1, 2))
        Bi = torch.stack([T[b] for b in bonds])
        Bj = torch.stack([T[b + 1] for b in bonds])
        left = torch.stack([lam[b - 1] if b > 0 else torch.ones_like(lam[0])
                            for b in bonds])
        Bi2, Bj2, lam2 = _bond(st, Bi, Bj, left, gate)
        for k, b in enumerate(bonds):
            T[b], T[b + 1], lam[b] = Bi2[k], Bj2[k], lam2[k]
    A = torch.stack(T) * ph(u_to)[None, None, :, None]
    nrm = torch.sqrt(torch.abs(overlap(A, A)))
    A = A.clone()
    A[0] = A[0] / nrm.to(A.dtype)
    return A, torch.stack(lam)


def cost_and_gradient(st: Stepper, psi_i, psi_f, u, gamma):
    """(J, g (N_t,)) of one control u (N_t,) float64 on the host: the
    forward trajectory from psi_i and the costates from psi_f, both
    truncated, g_i = dt Re(1j <xi_i| dH/du |psi_i> <psi(T)|psi_f>) + the
    regularization's; psi_i, psi_f are (B, lam) pairs."""
    n = len(u)
    uu = [float(x) for x in u]
    traj = [psi_i]
    for i in range(n - 1):
        traj.append(step(st, *traj[-1], uu[i], uu[i + 1]))
    xi = [None] * n
    xi[n - 1] = psi_f
    for i in range(n - 1, 0, -1):
        xi[i - 1] = step(st, *xi[i], uu[i], uu[i - 1], forward=False)
    half = 0.5 * st.nn1
    divT = torch.stack([sandwich(xi[i][0], traj[i][0], half)
                        for i in range(n)]).to(torch.complex128)
    ov = overlap(traj[-1][0], psi_f[0]).to(torch.complex128)
    U = torch.as_tensor(np.asarray(u, dtype=np.float64))
    g = st.dt * (divT.cpu() * ov.cpu() * 1j).real \
        + regularization_grad(U, gamma, st.dt)
    J = 0.5 * (1.0 - float((ov * ov.conj()).real)) \
        + float(regularization(U, gamma, st.dt))
    return J, g.numpy()
