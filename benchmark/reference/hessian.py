"""Plain reference of the exact Hessian of the long chain's cost, written out
row by row: the reference's calcHessianRow (SURVEY.md section 3.4).

Written from the method's definition in plain PyTorch; it imports nothing
of the program. With psi_i the forward states, xi_i the costates from the
target, ov = <psi(T)|psi_f>, dH = dH/du = 0.5 sum_k n_k (n_k - 1) and
divT_i = <xi_i|dH|psi_i>:

    H_ij = dt^2 [Re(ov <dH xi_j| U(t_j <- t_i) |dH psi_i>)
                 - Re(divT_i conj(divT_j))],    1 <= i < j <= N_t - 2,
    H_ii = dt^2 [Re(ov <dH xi_i|dH psi_i>) - |divT_i|^2],   1 <= i <= N_t - 2,

plus the regularization's Hessian (gamma / dt times the second-difference
stencil on the interior times); the rows and columns of the two end times
are zero, as the reference's. In the GROUP basis the Hessian is
B^T H B, B = S f (`group`).

Row i is the state dH|psi_i>, compressed back to chi, stepped alone from
t_i to every later interior time through a plain snake MPS step (the
two-site gate, the top-chi eigenvectors of each bond's density matrix,
QR gauge moves); rows are stacked into a batch only to share the calls
(`rows`: how many at once), which changes no row's arithmetic.

Where this departs from ITensor's all-snake channel:
- psi and xi take the Vidal channel (`chain.step`), as the port's long
  chain does; ITensor steps them through the same snake TEBD as the rows;
- dH|psi> is compressed by one left-to-right sweep of the exact bond-2
  MPO product (right-canonicalized by QRs first), where ITensor fits it;
  its centre then goes back to site 0 by QRs, so a row's first snake step
  truncates in the canonical gauge, as ITensor's does after its centre
  moves to each bond;
- every bond is padded to chi, the chain's ends too.
So this reference and the port differ only at rounding.

Products run through the stepper's `Prec.mm`, so a complex64 stepper is
the control's one precision below; the eigensolver works in complex128.
"""

from __future__ import annotations

import numpy as np
import torch

from . import chain
from .sector import regularization, regularization_grad


def _full_precision_products() -> None:
    """float32 products in float32, never TF32 (the control's complex64)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _h(x):
    return x.conj().transpose(-2, -1)


def _normalized(x):
    """x (B, ...) with each state scaled to unit norm."""
    nrm = torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=-1)
    return x / nrm.to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))


def _split(st: chain.Stepper, theta, keep_left: bool):
    """theta (B, m, n) ~ left (B, m, chi) @ right (B, chi, n) by the top-chi
    eigenvectors of the density matrix of the kept side plus the jitter:
    theta theta^H (left an isometry) or theta^H theta (right one)."""
    mm = st.prec.mm
    rho = mm(theta, _h(theta)) if keep_left else mm(_h(theta), theta)
    m = rho.shape[-1]
    scale = torch.diagonal(rho, dim1=-2, dim2=-1).real.mean(-1)
    rho = rho + (st.jitter * scale)[:, None, None].to(rho.dtype) \
        * torch.eye(m, dtype=rho.dtype, device=rho.device)
    _, v = torch.linalg.eigh(rho.to(torch.complex128))
    V = v.flip(-1)[..., :st.chi].to(theta.dtype)
    if keep_left:
        return V, mm(_h(V), theta)
    return mm(theta, V), _h(V)


def _move_right(st, Ai, Aj):
    """The centre from Ai to Aj: Ai = Q, Aj <- R Aj."""
    B, l, p, m = Ai.shape
    q, r = torch.linalg.qr(Ai.reshape(B, l * p, m))
    Aj = st.prec.mm(r, Aj.reshape(B, m, -1)).reshape(B, -1, *Aj.shape[2:])
    return q.reshape(B, l, p, -1), Aj


def _move_left(st, Ai, Aj):
    """The centre from Aj to Ai: Aj^H = Q R, Aj <- Q^H, Ai <- Ai R^H."""
    B, m, q_, r_ = Aj.shape
    l, p = Ai.shape[1], Ai.shape[2]
    q, r = torch.linalg.qr(_h(Aj.reshape(B, m, q_ * r_)))
    Ai = st.prec.mm(Ai.reshape(B, l * p, m), _h(r)).reshape(B, l, p, -1)
    return Ai, _h(q).reshape(B, -1, q_, r_)


def _bond(st, Ai, Aj, gate, keep_left: bool):
    """The gate on sites (Ai, Aj), truncated back to chi; the centre goes
    to Aj (keep_left) or Ai and is renormalized."""
    B, l, p, m = Ai.shape
    r = Aj.shape[-1]
    mm = st.prec.mm
    pair = mm(Ai.reshape(B, l * p, m), Aj.reshape(B, m, p * r))
    pair = pair.reshape(B, l, p, p, r).permute(0, 2, 3, 1, 4)
    th = mm(gate.reshape(p * p, p * p), pair.reshape(B, p * p, l * r))
    th = th.reshape(B, p, p, l, r).permute(0, 3, 1, 2, 4)
    left, right = _split(st, th.reshape(B, l * p, p * r), keep_left)
    Ai2 = left.reshape(B, l, p, -1)
    Aj2 = right.reshape(B, -1, p, r)
    if keep_left:
        return Ai2, _normalized(Aj2)
    return _normalized(Ai2), Aj2


def snake_step(st: chain.Stepper, A, u_from: float, u_to: float):
    """One truncating Trotter step of a batch of MPS A (B, L, chi, p, chi)
    whose centre is on site 0: the phases D(u_from), the even bonds left
    to right (each leaving its right site the centre), the odd bonds right
    to left (each leaving its left site the centre), the centre back to
    site 0, the phases D(u_to), the state renormalized on site 0."""
    L = A.shape[1]

    def ph(u):
        return torch.exp((-0.25j * st.dt * u) * st.nn1).to(A.dtype)

    T = list((A * ph(u_from)[None, None, None, :, None]).unbind(1))
    pos = 0
    for b in range(0, L - 1, 2):
        while pos < b:
            T[pos], T[pos + 1] = _move_right(st, T[pos], T[pos + 1])
            pos += 1
        T[b], T[b + 1] = _bond(st, T[b], T[b + 1], st.gate, True)
        pos = b + 1
    for b in reversed(range(1, L - 1, 2)):
        while pos > b + 1:
            T[pos - 1], T[pos] = _move_left(st, T[pos - 1], T[pos])
            pos -= 1
        T[b], T[b + 1] = _bond(st, T[b], T[b + 1], st.gate, False)
        pos = b
    while pos > 0:
        T[pos - 1], T[pos] = _move_left(st, T[pos - 1], T[pos])
        pos -= 1
    T = [t * ph(u_to)[None, None, :, None] for t in T]
    T[0] = _normalized(T[0])
    return torch.stack(T, dim=1)


def apply_dh(st: chain.Stepper, A):
    """(dH|A_b>/norm, norm) for a batch of MPS A (B, L, chi, p, chi): the
    bond-2 MPO of sum_k O_k, O = 0.5 n (n - 1), applied exactly (bond
    2 chi), the result right-canonicalized, then split left to right at
    chi, its centre moved back to site 0 and the norm taken out there."""
    B, L, chi, p, _ = A.shape
    o = (0.5 * st.nn1).to(A.dtype)[None, None, :, None]
    blocks = []
    for k in range(L):
        a = A[:, k]
        if k == 0:
            blocks.append(torch.cat([a, a * o], dim=3))
        elif k == L - 1:
            blocks.append(torch.cat([a * o, a], dim=1))
        else:
            top = torch.cat([a, a * o], dim=3)
            bottom = torch.cat([torch.zeros_like(a), a], dim=3)
            blocks.append(torch.cat([top, bottom], dim=1))
    for k in range(L - 1, 0, -1):
        blocks[k - 1], blocks[k] = _move_left(st, blocks[k - 1], blocks[k])
    out = []
    for k in range(L - 1):
        l, r = blocks[k].shape[1], blocks[k].shape[3]
        left, right = _split(st, blocks[k].reshape(B, l * p, r), True)
        out.append(left.reshape(B, l, p, chi))
        nxt = blocks[k + 1]
        blocks[k + 1] = st.prec.mm(right, nxt.reshape(B, r, -1)).reshape(
            B, chi, *nxt.shape[2:])
    out.append(blocks[-1])
    for k in range(L - 1, 0, -1):
        out[k - 1], out[k] = _move_left(st, out[k - 1], out[k])
    res = torch.stack(out, dim=1)
    nrm = torch.sqrt(torch.abs(overlap(res, res)))
    res[:, 0] = res[:, 0] / nrm.to(res.dtype)[:, None, None, None]
    return res, nrm


def overlap(phi, psi):
    """<phi_b|psi_b> for batches of MPS (B, L, chi, p, chi)."""
    B, L, chi = psi.shape[:3]
    env = torch.eye(chi, dtype=psi.dtype, device=psi.device).expand(
        B, chi, chi)
    for k in range(L):
        env = torch.einsum('nac,napb,ncpd->nbd', env, phi[:, k].conj(),
                           psi[:, k])
    return torch.diagonal(env, dim1=-2, dim2=-1).sum(-1)


def regularization_hessian(n: int, gamma: float, dt: float):
    """gamma / dt times the second-difference stencil on the interior times
    (2 on the diagonal, -1 beside it), the end times' rows and columns
    zero."""
    H = torch.zeros((n, n), dtype=torch.float64)
    g = gamma / dt
    for i in range(1, n - 1):
        H[i, i] = 2.0 * g
    for i in range(1, n - 2):
        H[i, i + 1] = H[i + 1, i] = -g
    return H


def trajectories(st: chain.Stepper, psi_i, psi_f, u):
    """The Vidal channel: (psi_t, xi_t) lists of (B, lam) pairs, N_t each,
    xi_{N_t-1} = psi_f."""
    n = len(u)
    uu = [float(x) for x in u]
    psi = [psi_i]
    for i in range(n - 1):
        psi.append(chain.step(st, *psi[-1], uu[i], uu[i + 1]))
    xi = [None] * n
    xi[n - 1] = psi_f
    for i in range(n - 1, 0, -1):
        xi[i - 1] = chain.step(st, *xi[i], uu[i], uu[i - 1], forward=False)
    return psi, xi


def cost(st: chain.Stepper, psi_i, psi_f, u, gamma: float) -> float:
    """J(u) = 0.5 (1 - |<psi_f|psi(T)>|^2) + the regularization."""
    _full_precision_products()
    uu = [float(x) for x in u]
    s = psi_i
    for i in range(len(uu) - 1):
        s = chain.step(st, *s, uu[i], uu[i + 1])
    ov = complex(chain.overlap(s[0], psi_f[0]))
    U = torch.as_tensor(np.asarray(u, dtype=np.float64))
    return 0.5 * (1.0 - abs(ov) ** 2) + float(regularization(U, gamma,
                                                            st.dt))


def exact_hessian(st: chain.Stepper, psi_i, psi_f, u, gamma: float,
                  rows: int = 16):
    """(J, g (N_t,), H (N_t, N_t)) of one control u (N_t,) float64, on the
    host in float64; psi_i, psi_f are (B, lam) pairs. `rows` row states
    at most are stepped in one call."""
    _full_precision_products()
    n = len(u)
    uu = [float(x) for x in u]
    psi, xi = trajectories(st, psi_i, psi_f, u)
    half = 0.5 * st.nn1
    divT = torch.stack([chain.sandwich(xi[i][0], psi[i][0], half)
                        for i in range(n)]).to(torch.complex128).cpu()
    ov = complex(chain.overlap(psi[-1][0], psi_f[0]))
    U = torch.as_tensor(np.asarray(u, dtype=np.float64))
    J = 0.5 * (1.0 - abs(ov) ** 2) + float(regularization(U, gamma, st.dt))
    g = st.dt * (divT * ov * 1j).real + regularization_grad(U, gamma, st.dt)

    inner = list(range(1, n - 1))
    xiH, xn = apply_dh(st, torch.stack([xi[j][0] for j in inner]))
    psiH, pn = apply_dh(st, torch.stack([psi[i][0] for i in inner]))
    at = {t: k for k, t in enumerate(inner)}
    xn, pn = xn.cpu().double(), pn.cpu().double()
    H = torch.zeros((n, n), dtype=torch.float64)
    dg = overlap(xiH, psiH).cpu().to(torch.complex128)
    for i in inner:
        k = at[i]
        H[i, i] = (ov * dg[k] * xn[k] * pn[k]).real - abs(divT[i]) ** 2
    # row i from t_i to t_{n-2}: rows i0 .. i0 + rows - 1 share the calls
    starts = inner[:-1]
    for b0 in range(0, len(starts), rows):
        block = starts[b0:b0 + rows]
        state = psiH[[at[i] for i in block]]
        for t in range(block[0], n - 2):
            a = sum(1 for i in block if i <= t)     # rows already made
            state = torch.cat([snake_step(st, state[:a], uu[t], uu[t + 1]),
                               state[a:]])
            j = t + 1
            ovj = overlap(xiH[at[j]].expand(a, *xiH.shape[1:]),
                          state[:a]).cpu().to(torch.complex128)
            for r, i in enumerate(block[:a]):
                val = (ov * ovj[r] * xn[at[j]] * pn[at[i]]).real \
                    - (divT[i] * divT[j].conj()).real
                H[i, j] = H[j, i] = val
    H = H * st.dt * st.dt + regularization_hessian(n, gamma, st.dt)
    return J, g.numpy(), H.numpy()


def group(S, f, g_u, H_u):
    """The GROUP gradient B^T g and Hessian B^T H B, B = S f (N_t, M)."""
    B = np.asarray(S)[:, None] * np.asarray(f)
    return B.T @ g_u, B.T @ H_u @ B
