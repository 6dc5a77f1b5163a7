"""Plain reference of the Bose-Hubbard chain in its fixed particle-number
sector: basis, Hamiltonian, ground states, the Trotter step, the cost, its
adjoint and exact gradients.

Written from the problem's definition in plain PyTorch and NumPy; it
imports nothing of the program. One Trotter step is

    psi <- D(u_to) W D(u_from) psi,   D(u) = exp(-0.25j dt u sum_i n_i(n_i-1)),

W the product of the two-site hopping gates exp(-i dt h_b), all even bonds
first, then all odd bonds, each gate applied in the sector basis. The cost
is J(u) = 0.5 (1 - |<psi_f|psi(T)>|^2) + gamma/2 sum (u_{i+1} - u_i)^2 / dt.

Precision: `Prec` names a complex dtype and, for the control, TF32
rounding of every product's operands (`tf32`): the tensor cores' single
pass keeps 10 of float32's 23 mantissa bits and adds in float32.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

PI_REFERENCE = 3.14159265   # the C++ reference's PI in its sine basis


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round half to even); float32
    or complex64 in, the same dtype out."""
    if x.is_complex():
        return torch.view_as_complex(tf32(torch.view_as_real(x.resolve_conj())))
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


@dataclass(frozen=True)
class Prec:
    """A complex dtype for states and gates; tf32=True rounds the operands
    of every product to TF32 (complex64 only)."""
    cdtype: torch.dtype = torch.complex128
    tf32: bool = False

    @property
    def rdtype(self) -> torch.dtype:
        return self.cdtype.to_real()

    def mm(self, a, b):
        if self.tf32:
            return _TF32MM.apply(a, b)
        return a @ b


class _TF32MM(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, in the forward and the
    backward products alike (float32 accumulation)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (tf32(g) @ tf32(b).mH).sum_to_size(a.shape)
        gb = (tf32(a).mH @ tf32(g)).sum_to_size(b.shape)
        return ga, gb


F64 = Prec(torch.complex128)
F32 = Prec(torch.complex64)
TF32 = Prec(torch.complex64, tf32=True)


# ---------------------------------------------------------------------------
# the sector
# ---------------------------------------------------------------------------

def sector_states(L: int, d: int, npart: int) -> np.ndarray:
    """(ns, L) occupations with sum npart and each 0..d, lexicographic."""
    return np.array([s for s in itertools.product(range(d + 1), repeat=L)
                     if sum(s) == npart], dtype=np.int64)


def _index(states):
    return {tuple(int(x) for x in s): k for k, s in enumerate(states)}


def hamiltonian(L: int, d: int, npart: int, J: float, U: float) -> np.ndarray:
    """H = -J sum_b (a_b^+ a_{b+1} + h.c.) + U/2 sum_i n_i (n_i - 1) in the
    sector, dense float64."""
    states = sector_states(L, d, npart)
    idx = _index(states)
    H = np.diag(0.5 * U * np.sum(states * (states - 1.0), axis=1))
    for k, s in enumerate(states):
        for b in range(L - 1):
            for src, dst in ((b, b + 1), (b + 1, b)):
                if s[src] >= 1 and s[dst] < d:
                    t = s.copy()
                    t[src] -= 1
                    t[dst] += 1
                    H[idx[tuple(int(x) for x in t)], k] -= J * np.sqrt(
                        s[src] * (s[dst] + 1.0))
    return H


def ground_state(L: int, d: int, npart: int, J: float, U: float) -> np.ndarray:
    _, v = np.linalg.eigh(hamiltonian(L, d, npart, J, U))
    return v[:, 0].astype(np.complex128)


def hop_gate(J: float, d: int, dt: float) -> np.ndarray:
    """exp(-i dt h) of the two-site hop h = -J (a x a^+ + a^+ x a),
    (p^2, p^2), row index P*p + Q."""
    n = np.arange(d + 1, dtype=np.float64)
    a = np.diag(np.sqrt(n[1:]), k=1)
    h = -J * (np.kron(a, a.T) + np.kron(a.T, a))
    w, v = np.linalg.eigh(h)
    return (v * np.exp(-1j * dt * w)) @ v.T


def step_matrix(L: int, d: int, npart: int, J: float, dt: float) -> np.ndarray:
    """W: the even-bond gates, then the odd-bond gates, in the sector."""
    states = sector_states(L, d, npart)
    idx = _index(states)
    ns, p = len(states), d + 1
    g = hop_gate(J, d, dt)
    W = np.eye(ns, dtype=np.complex128)
    for parity in (0, 1):
        for b in range(parity, L - 1, 2):
            Wb = np.zeros((ns, ns), np.complex128)
            for k, s in enumerate(states):
                for P in range(p):
                    Q = s[b] + s[b + 1] - P
                    if 0 <= Q <= d:
                        t = s.copy()
                        t[b], t[b + 1] = P, Q
                        Wb[idx[tuple(int(x) for x in t)], k] += \
                            g[P * p + Q, s[b] * p + s[b + 1]]
            W = Wb @ W
    return W


@dataclass
class Chain:
    """The step's constants and the boundary states on one device."""
    W: torch.Tensor          # (ns, ns)
    nn1: torch.Tensor        # (ns,) sum_i n_i (n_i - 1)
    psi_i: torch.Tensor      # (ns,)
    psi_f: torch.Tensor
    dt: float
    prec: Prec


def make_chain(L, d, npart, J, dt, U_i, U_f, prec: Prec = F64,
               device="cpu") -> Chain:
    states = sector_states(L, d, npart)
    c = dict(dtype=prec.cdtype, device=device)
    return Chain(
        W=torch.as_tensor(step_matrix(L, d, npart, J, dt), **c),
        nn1=torch.as_tensor(np.sum(states * (states - 1.0), axis=1),
                            dtype=prec.rdtype, device=device),
        psi_i=torch.as_tensor(ground_state(L, d, npart, J, U_i), **c),
        psi_f=torch.as_tensor(ground_state(L, d, npart, J, U_f), **c),
        dt=float(dt), prec=prec)


def phase(ch: Chain, u):
    """D(u) for u (B,): (B, ns)."""
    return torch.exp((-0.25j * ch.dt) * u[:, None] * ch.nn1[None, :]).to(
        ch.prec.cdtype)


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).to(v.dtype)


def step(ch: Chain, psi, u_from, u_to, forward: bool = True):
    """One Trotter step of rows psi (B, ns); u_from, u_to (B,). Backward:
    the controls negated and the gates conjugated. Rows normalized."""
    s = 1.0 if forward else -1.0
    W = ch.W if forward else ch.W.conj()
    psi = psi * phase(ch, s * u_from)
    psi = ch.prec.mm(psi, W.T)
    return _normalize(psi * phase(ch, s * u_to))


def trajectory(ch: Chain, U):
    """psi_t for U (B, N_t): (B, N_t, ns)."""
    B = U.shape[0]
    psi = ch.psi_i.expand(B, -1)
    out = [psi]
    for i in range(U.shape[1] - 1):
        psi = step(ch, psi, U[:, i], U[:, i + 1])
        out.append(psi)
    return torch.stack(out, dim=1)


def costates(ch: Chain, U):
    """xi_t, stepped backward from psi_f: (B, N_t, ns)."""
    B, n = U.shape
    xi = ch.psi_f.expand(B, -1)
    out = [None] * n
    out[n - 1] = xi
    for i in range(n - 1, 0, -1):
        xi = step(ch, xi, U[:, i], U[:, i - 1], forward=False)
        out[i - 1] = xi
    return torch.stack(out, dim=1)


def regularization(U, gamma, dt):
    d = torch.diff(U, dim=-1)
    return 0.5 * gamma * torch.sum(d * d, dim=-1) / dt


def regularization_grad(U, gamma, dt):
    """The reference's stencils: central inside, one-sided at the ends."""
    g = torch.zeros_like(U)
    g[..., 1:-1] = -gamma * (U[..., 2:] + U[..., :-2] - 2.0 * U[..., 1:-1])
    g[..., 0] = -gamma * (-5.0 * U[..., 1] + 4.0 * U[..., 2] - U[..., 3]
                          + 2.0 * U[..., 0])
    g[..., -1] = -gamma * (-5.0 * U[..., -2] + 4.0 * U[..., -3]
                           - U[..., -4] + 2.0 * U[..., -1])
    return g / dt


def bound_penalty(U, u_min=2.0, u_max=100.0, weight=100.0):
    """weight * sum [(u - u_max)_+^2 + (u_min - u)_+^2]."""
    over = torch.clamp(U - u_max, min=0.0)
    under = torch.clamp(u_min - U, min=0.0)
    return weight * torch.sum(over * over + under * under, dim=-1)


def overlap_final(ch: Chain, U):
    """<psi_f|psi(T)> for U (B, N_t), without storing the trajectory."""
    B = U.shape[0]
    psi = ch.psi_i.expand(B, -1)
    for i in range(U.shape[1] - 1):
        psi = step(ch, psi, U[:, i], U[:, i + 1])
    return psi @ ch.psi_f.conj()


def cost(ch: Chain, U, gamma):
    ov = overlap_final(ch, U)
    return 0.5 * (1.0 - (ov * ov.conj()).real) + regularization(U, gamma,
                                                                ch.dt)


def adjoint_gradient(ch: Chain, U, gamma):
    """(J (B,), g (B, N_t)): the cost and the adjoint gradient
    g_i = dt Re(1j <xi_i| dH/du |psi_i> <psi(T)|psi_f>) + the
    regularization's, dH/du = 0.5 sum_i n_i (n_i - 1). It carries the
    Trotter splitting's O(dt^2) bias against the exact derivative."""
    psi = trajectory(ch, U)
    xi = costates(ch, U)
    half = (0.5 * ch.nn1).to(psi.dtype)
    divT = torch.sum(xi.conj() * half * psi, dim=-1)
    ov = torch.sum(psi[:, -1].conj() * ch.psi_f, dim=-1)
    g = ch.dt * (divT * ov[:, None] * 1j).real \
        + regularization_grad(U, gamma, ch.dt)
    J = 0.5 * (1.0 - (ov * ov.conj()).real) + regularization(U, gamma,
                                                             ch.dt)
    return J, g


# ---------------------------------------------------------------------------
# the control basis (GROUP): u = u0 + S * (f @ c)
# ---------------------------------------------------------------------------

def linspace(a: float, b: float, n: int) -> np.ndarray:
    """The C++ reference's linspace: accumulates x += (b - a) / (n - 1)
    while x <= b + 1e-7."""
    step_ = (b - a) / (n - 1)
    out, x = [], a
    while x <= b + 1e-7:
        out.append(x)
        x += step_
    return np.asarray(out, dtype=np.float64)


def linsigmoid_ramp(u_start: float, u_end: float, n: int,
                    rng: np.random.Generator) -> np.ndarray:
    """The reference's randomized seed ramp (linsigmoidSeed): a line plus a
    sigmoid, a ~ U(0.01, 0.15), c ~ U(0.06, 0.18), d ~ U(60, 80), blended
    into a fixed sigmoid (k 0.2, centre 40) near both ends."""
    x = linspace(0.0, 100.0, n)
    a = rng.uniform(0.01, 0.15)
    c = rng.uniform(0.06, 0.18)
    d_ = rng.uniform(60.0, 80.0)
    b = u_end - u_start - a * x[-1]
    S = 1.0 / (1.0 + np.exp(-0.7 * (x - 5.0)))
    S[n // 2:] = (1.0 / (1.0 + np.exp(0.9 * (x - 93.0))))[n // 2:]
    S[0] = S[-1] = 0.0
    ramp = a * x + b / (1.0 + np.exp(-c * (x - d_))) + u_start
    base = (u_end - u_start) / (1.0 + np.exp(-0.2 * (x - 40.0))) + u_start
    return S * ramp + (1.0 - S) * base


def sine_basis(N: int, tstep: float, T: float, M: int):
    """(S (N,), f (N, M)) float64: f_in = sin((n+1) PI tstep i / T), S a
    sigmoid over x = 0..100 rising (k 8, offset 1.1) stitched at N/2 to
    one falling (k -8, offset 98.9), both ends 0."""
    x = linspace(0.0, 100.0, N)
    S = 1.0 / (1.0 + np.exp(-8.0 * (x - 1.1)))
    S2 = 1.0 / (1.0 + np.exp(8.0 * (x - 98.9)))
    S[N // 2:] = S2[N // 2:]
    S[0] = S[-1] = 0.0
    i = np.arange(N, dtype=np.float64)[:, None]
    n = np.arange(M, dtype=np.float64)[None, :]
    return S, np.sin((n + 1.0) * PI_REFERENCE * tstep * i / T)


# ---------------------------------------------------------------------------
# the multistart problem in the GROUP basis, with the bound penalty
# ---------------------------------------------------------------------------

class GroupProblem:
    """J(c) + P(u(c)) for coefficient rows c (B, M): u = u0 + S (c f^T),
    u0 the reference's seed ramp from numpy rng `basis_seed`, P the
    quadratic bound penalty (u in [2, 100], weight 100)."""

    def __init__(self, cfg: dict, prec: Prec = F64, device="cpu"):
        N = int(round(cfg["T"] / cfg["tstep"])) + 1
        self.chain = make_chain(cfg["N"], cfg["d"], cfg["Npart"], cfg["J"],
                                cfg["tstep"], cfg["U_initial"],
                                cfg["U_final"], prec, device)
        u0 = linsigmoid_ramp(cfg["U_initial"], cfg["U_final"], N,
                             np.random.default_rng(cfg["basis_seed"]))
        S, f = sine_basis(N, cfg["tstep"], cfg["T"], cfg["M"])
        r = dict(dtype=prec.rdtype, device=device)
        self.u0, self.S, self.f = (torch.as_tensor(a, **r) for a in (u0, S, f))
        self.gamma = float(cfg["gamma"])
        self.prec, self.device = prec, device

    def controls(self, C):
        return self.u0 + self.S * (C @ self.f.T)

    def objective(self, C):
        U = self.controls(C)
        return cost(self.chain, U, self.gamma) + bound_penalty(U)

    def value_and_grad(self, C):
        """(J (B,), dJ/dC (B, M)) by reverse-mode autodiff."""
        with torch.enable_grad():
            C = torch.as_tensor(C, dtype=self.prec.rdtype,
                                device=self.device).detach()
            C.requires_grad_(True)
            J = self.objective(C)
            (G,) = torch.autograd.grad(J.sum(), C)
        return J.detach(), G

    def _newton_data(self, c, h):
        """(J, g, H) at c: H by central differences of the exact gradient,
        all 2M + 1 points in one batched call."""
        E = h * torch.eye(len(c), dtype=c.dtype, device=c.device)
        J, G = self.value_and_grad(torch.cat([c[None], c + E, c - E]))
        m = len(c)
        H = (G[1:m + 1] - G[m + 1:]).T / (2.0 * h)
        return J[0], G[0], 0.5 * (H + H.T)

    def polish(self, c0, max_iter: int = 30):
        """Damped Newton from c0 (the Hessian shifted to positive definite,
        Armijo backtracking) until |g|_inf is below the precision's floor
        or no step decreases J. Returns J*."""
        c = torch.as_tensor(np.asarray(c0), dtype=self.prec.rdtype,
                            device=self.device)
        double = self.prec.rdtype == torch.float64
        tol, h = (1e-11, 1e-4) if double else (1e-6, 1e-2)
        f, g, H = self._newton_data(c, h)
        eye = torch.eye(len(c), dtype=c.dtype, device=c.device)
        for _ in range(max_iter):
            if float(g.abs().max()) < tol:
                break
            w = torch.linalg.eigvalsh(H)
            shift = max(0.0, -1.5 * float(w[0])) + 1e-12 * float(w.abs().max())
            moved = False
            for dx in (torch.linalg.solve(H + shift * eye, -g),
                       -g / float(w.abs().max())):
                a = 1.0
                for _ in range(40):
                    fn = self.objective((c + a * dx)[None])[0]
                    if float(fn) <= float(f) + 1e-4 * a * float(dx @ g):
                        moved = True
                        break
                    a *= 0.5
                if moved:
                    break
            if not moved:
                break
            c = c + a * dx
            f, g, H = self._newton_data(c, h)
        return float(f)
