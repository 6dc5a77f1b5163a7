"""Vidal-form brick TEBD: every bond of a stage truncated at once.

Counterpart of optimalcontrolmps_tpu/vidal.py. The snake sweep of
`tebd.tebd_step` updates the L-1 bonds of a Trotter step one after another,
moving the orthogonality center along. The Vidal (canonical) form keeps the
Schmidt values of every bond in the state instead: right-canonical site
tensors B[i] and per-bond values lam[b] (Vidal, PRL 91, 147902). With them
the two-site wavefunction of ANY bond is theta_b = diag(lam[b-1]) B[b]
B[b+1], so the top-chi eigendecomposition of theta^H theta is the optimal
truncation of every bond independently, and one step is two dependent
stages (all even bonds, then all odd bonds), each ONE batched bond update
over the stacked bonds of every lane.

The update is Hastings' (J. Math. Phys. 50, 095207), which never divides by
a Schmidt value: with th = gate . (B[b] B[b+1]) from the bond-theta kernel
(`ops.bond_theta`) and V the top-chi right eigenvectors of theta^H theta,

    B[b]   <- th @ V,   B[b+1] <- V^H,   lam[b] <- sqrt(top-chi eigenvalues).

The gate product is `tebd.tebd_step`'s (control phases on all sites before
and after, even then odd bonds); with no truncation it equals the snake
sweep's.

States: `VidalState(B, lam)`. A batch has B (Bt, L, chi, p, chi) and lam
(Bt, L-1, chi) real; `B` alone is a plain MPS batch, so every `mps.py`
contraction applies. As in `engine.py`, the derivative functions take ONE
state psi0 / psi_target (B (L, chi, p, chi), lam (L-1, chi)) and a control
u (N_t,) or a batch (B, N_t); the lanes of a batch step together. The exact
Hessian propagates its row states through a snake-sweep twin of the stepper
(rows lose the Vidal form once dH is applied).

Tensor parallelism: `vidal_step(tp_mesh=)` and `rollout_final_tp` split
each stage's bonds over the ranks of a mesh's "rows" axis and all-gather
the updated sites (`parallel/`).

Not ported: the matrix carriers (`to_matrix_carriers`, the three
`_bond_update_matfree*`), the JAX package's route for a TPU without
factorizations.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import mps as mpslib
from .device import resolve_device
from .engine import (hessian as mps_hessian, regularization,
                     regularization_grad, regularization_hessian)
from .ops.bond_theta import bond_theta
from .ops.trunc import _jitter, eigh
from .parallel.comm import all_gather_cat
from .streaming import (BlockHessian, assemble_hessian, pick_row_block,
                        rollout_measure, segmented_adjoint_gradient)
from .tebd import TEBDStepper, _phase, tebd_step

__all__ = [
    "VidalState", "schmidt_values", "to_mps", "from_mps", "vidal_step",
    "rollout", "rollout_final", "rollout_final_tp", "costate_rollout",
    "cost", "fidelities", "fidelities_streaming", "gradient",
    "gradient_lowmem", "gradient_segmented", "cost_and_gradient", "hessian",
    "hessian_streaming", "bond_renyi2", "bond_vn_entropy",
    "rollout_diagnostics",
]


class VidalState(NamedTuple):
    """Canonical-form MPS: right-canonical tensors B (..., L, chi, p, chi),
    whose product is the state, and unit-2-norm Schmidt values lam
    (..., L-1, chi), real, per bond."""
    B: torch.Tensor
    lam: torch.Tensor


def schmidt_values(state: VidalState) -> np.ndarray:
    """(..., L-1, chi) Schmidt values, descending, on the host."""
    lam = state.lam.detach().cpu().numpy()
    return np.sort(lam, axis=-1)[..., ::-1]


def to_mps(state: VidalState) -> torch.Tensor:
    return state.B


def _pad_rows(m: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows, m.shape[1]), m.dtype)
    out[:m.shape[0]] = m
    return out


def from_mps(A, cutoff: float = 1e-12, device=None) -> VidalState:
    """Canonical form of one plain MPS (L, chi, p, chi), numpy or a tensor,
    computed on the host in complex128 (state preparation, not a hot path):
    right-canonicalize, then left-to-right SVDs recording the Schmidt
    values; B[b] = lam[b-1]^-1 A[b] lam[b] with Schmidt directions below
    `cutoff` masked to zero. B keeps A's dtype, lam is float64 for
    complex128 and float32 otherwise; both on `device` (None: the card)."""
    device = resolve_device(device)
    A = A.detach().cpu().numpy() if isinstance(A, torch.Tensor) \
        else np.asarray(A)
    L, chi, p, _ = A.shape
    work = np.complex128
    T = [A[i].astype(work) for i in range(L)]

    # sweep 1: right-canonicalize (the center ends at site 0)
    for i in range(L - 1, 0, -1):
        u, s, vh = np.linalg.svd(T[i].reshape(chi, p * chi),
                                 full_matrices=False)
        k = min(chi, s.size)
        Bi = np.zeros((chi, p * chi), work)
        Bi[:k] = vh[:k]
        T[i] = Bi.reshape(chi, p, chi)
        carry = np.zeros((chi, chi), work)
        carry[:, :k] = u[:, :k] * s[:k]
        T[i - 1] = np.einsum('apb,bc->apc', T[i - 1], carry, optimize=True)

    # sweep 2: left to right, recording the Schmidt values; A-form tensors
    lams = np.zeros((L - 1, chi))
    Aform = [None] * L
    C = T[0]
    for b in range(L - 1):
        u, s, vh = np.linalg.svd(C.reshape(chi * p, chi),
                                 full_matrices=False)
        k = min(chi, s.size)
        nrm = np.linalg.norm(s[:k]) or 1.0
        lams[b, :k] = s[:k] / nrm
        Ab = np.zeros((chi * p, chi), work)
        Ab[:, :k] = u[:, :k]
        Aform[b] = Ab.reshape(chi, p, chi)
        sv = np.zeros((chi, chi), work)
        sv[:k, :k] = np.diag(s[:k] / nrm)
        # two products: numpy's einsum of three operands loops over all
        # five indices (chi^4 p: minutes at chi = 128)
        C = np.einsum('ac,cpd->apd', sv @ _pad_rows(vh[:k], chi), T[b + 1],
                      optimize=True)
    Aform[L - 1] = C

    # B-form: B[b] = lam[b-1]^-1 A[b] lam[b] (masked inverse)
    B = np.zeros((L, chi, p, chi), work)
    lam_prev = None
    for b in range(L):
        Ab = Aform[b]
        if b < L - 1:
            Ab = Ab * lams[b][None, None, :]
        if lam_prev is not None:
            inv = np.where(lam_prev > cutoff,
                           1.0 / np.maximum(lam_prev, cutoff), 0.0)
            Ab = Ab * inv[:, None, None]
        B[b] = Ab
        lam_prev = lams[b] if b < L - 1 else None
    real = np.float64 if A.dtype == np.complex128 else np.float32
    return VidalState(
        B=torch.as_tensor(B.astype(A.dtype), device=device),
        lam=torch.as_tensor(lams.astype(real), device=device))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _bond_update(Bi, Bj, lam_left, gate, chi):
    """Hastings update of a batch of bonds (n, chi, p, chi) with their left
    Schmidt values (n, chi): (Bi', Bj', lam' (n, chi), disc (n,)), disc the
    relative discarded weight 1 - kept/total of each truncation."""
    n, _, p, _ = Bi.shape
    th = bond_theta(Bi, Bj, gate)                     # (n, chi p, p chi)
    theta = th.reshape(n, chi, p, p * chi) \
        * lam_left.to(th.dtype)[:, :, None, None]     # rows are l*p + P
    m = theta.reshape(n, chi * p, p * chi)
    rho = _jitter(m.conj().transpose(-2, -1) @ m)     # (n, p chi, p chi)
    w, v = eigh(rho)                                  # ascending
    w_all = w.clamp(min=0.0)
    w_top = w.flip(-1)[:, :chi]
    V = v.flip(-1)[:, :, :chi]                        # (n, p chi, chi)
    total = w_all.sum(-1)
    kept = w_all.flip(-1)[:, :chi].sum(-1)
    disc = (1.0 - kept / total.clamp(min=1e-30)).clamp(min=0.0)
    lam = w_top.clamp(min=0.0).sqrt()
    lam = lam / torch.linalg.vector_norm(lam, dim=-1,
                                         keepdim=True).clamp(min=1e-30)
    # V^H is a lazy conjugate view: resolve it, since the next stage hands
    # this site to the kernel, which reads memory as stored
    Bj_new = V.conj().transpose(-2, -1).resolve_conj().contiguous() \
        .reshape(n, chi, p, chi)
    Bi_new = (th @ V).reshape(n, chi, p, chi)
    return Bi_new, Bj_new, lam, disc


def _split(n: int, parts: int) -> list:
    """Contiguous shares of n items over `parts` ranks, the first ranks
    taking one more (10 -> 5/5, 9 -> 5/4)."""
    return [n // parts + (1 if r < n % parts else 0) for r in range(parts)]


def _stage(T, lam, bonds, gate, chi, disc=None, shard=None):
    """Update the DISJOINT `bonds` of every lane as one batched call: the
    (bond, lane) pairs are stacked bond-major. T: list of L sites (Bt, chi,
    p, chi); lam: list of L-1 bonds (Bt, chi). `disc`, when given, is a
    dict that receives each bond's discarded weight (Bt,).

    shard: a `parallel.mesh.Mesh` (tensor parallelism): the bonds are split
    into contiguous shares over its "rows" axis (`_split`), each rank
    updates its share in one call, and (Bi', Bj', lam'[, disc]) are
    all-gathered over the rows group, so every rank holds the whole chain
    for the next stage."""
    if not bonds:
        return
    Bt = T[0].shape[0]
    ones = torch.ones_like(lam[0])
    todo = bonds
    if shard is not None:
        shares = _split(len(bonds), shard.n_rows)
        lo = sum(shares[:shard.row_rank])
        todo = bonds[lo:lo + shares[shard.row_rank]]
    if todo:
        Bi = torch.cat([T[b] for b in todo])
        Bj = torch.cat([T[b + 1] for b in todo])
        Ll = torch.cat([lam[b - 1] if b > 0 else ones for b in todo])
        Bi2, Bj2, lam2, disc2 = _bond_update(Bi, Bj, Ll, gate, chi)
    else:
        Bi2 = T[0][:0]
        Bj2 = T[0][:0]
        lam2 = lam[0][:0]
        disc2 = lam[0][:0, 0]
    if shard is not None:
        sizes = [c * Bt for c in shares]
        g = shard.rows_group
        Bi2, Bj2, lam2 = (all_gather_cat(x, g, sizes)
                          for x in (Bi2, Bj2, lam2))
        if disc is not None:
            disc2 = all_gather_cat(disc2, g, sizes)
    for k, b in enumerate(bonds):
        sl = slice(k * Bt, (k + 1) * Bt)
        T[b], T[b + 1], lam[b] = Bi2[sl], Bj2[sl], lam2[sl]
        if disc is not None:
            disc[b] = disc2[sl]


def vidal_step(st: TEBDStepper, state: VidalState, u_from, u_to,
               forward: bool = True, diag: bool = False, tp_mesh=None):
    """One full Trotter step of a batch (B (Bt, L, chi, p, chi), lam (Bt,
    L-1, chi)); u_from, u_to scalars or (Bt,). Same operator product as
    `tebd.tebd_step`: phases D(u_from), even J-bonds, odd J-bonds,
    D(u_to); backward negates the controls and uses the conjugate gate.
    The single-site phases keep the canonical form, so they act on all
    sites at once; site 0 is renormalized at the end (truncation makes the
    step non-unitary).

    diag=True also returns the (Bt, L-1) discarded weight of each bond's
    truncation in this step: (state, disc).

    tp_mesh: a `parallel.mesh.Mesh`; each stage's bonds are then split over
    its "rows" axis (tensor parallelism, `_stage`), and every rank returns
    the whole stepped state."""
    L, chi = st.L, st.chi
    B = state.B
    Bt = B.shape[0]
    gate = st.gate_fwd if forward else st.gate_bwd
    sign = 1.0 if forward else -1.0
    ph_from = _phase(st, sign * torch.as_tensor(u_from), Bt, B.dtype)
    ph_to = _phase(st, sign * torch.as_tensor(u_to), Bt, B.dtype)

    T = list((B * ph_from[:, None, None, :, None]).unbind(1))
    lam = list(state.lam.unbind(1))
    disc = {} if diag else None
    _stage(T, lam, list(range(0, L - 1, 2)), gate, chi, disc, tp_mesh)
    _stage(T, lam, list(range(1, L - 1, 2)), gate, chi, disc, tp_mesh)
    A = torch.stack(T, dim=1) * ph_to[:, None, None, :, None]
    nrm = mpslib.norm(A)
    A[:, 0] = A[:, 0] * torch.where(nrm > 1e-16, 1.0 / nrm,
                                    torch.ones_like(nrm)).to(
        A.dtype)[:, None, None, None]
    out = VidalState(B=A, lam=torch.stack(lam, dim=1))
    if diag:
        return out, torch.stack([disc[b] for b in range(L - 1)], dim=1)
    return out


# ---------------------------------------------------------------------------
# batching helpers
# ---------------------------------------------------------------------------

def _lanes(psi: VidalState, u):
    """(one state, u (N,) or (B, N)) -> (a (B, ...) state batch, U (B, N),
    whether u was a batch)."""
    batched = u.dim() == 2
    U = u if batched else u[None]
    n = U.shape[0]
    return VidalState(psi.B[None].expand(n, *psi.B.shape),
                      psi.lam[None].expand(n, *psi.lam.shape)), U, batched


def _out(x, batched):
    if isinstance(x, VidalState):
        return x if batched else VidalState(x.B[0], x.lam[0])
    return x if batched else x[0]


def _overlap_with(target: VidalState, A):
    """<target|A_b> for one state `target` against an MPS batch A; (B,)."""
    return mpslib.overlap(target.B[None].expand(A.shape[0],
                                                *target.B.shape), A)


def _fwd(st):
    return lambda s, a, b: vidal_step(st, s, a, b, forward=True)


def _bwd(st):
    return lambda s, a, b: vidal_step(st, s, a, b, forward=False)


# ---------------------------------------------------------------------------
# rollouts
# ---------------------------------------------------------------------------

def _stack_time(states):
    """A list of state batches -> one state with a time axis after the
    lane axis: B (Bt, N, L, ...), lam (Bt, N, L-1, chi)."""
    return VidalState(torch.stack([s.B for s in states], dim=1),
                      torch.stack([s.lam for s in states], dim=1))


def _rollout_lanes(st, S, U):
    out = [S]
    for i in range(U.shape[1] - 1):
        S = vidal_step(st, S, U[:, i], U[:, i + 1], forward=True)
        out.append(S)
    return _stack_time(out)


def _costate_lanes(st, X, U):
    n = U.shape[1]
    out = [None] * n
    out[n - 1] = X
    for i in range(n - 1, 0, -1):
        X = vidal_step(st, X, U[:, i], U[:, i - 1], forward=False)
        out[i - 1] = X
    return _stack_time(out)


def _final_lanes(st, S, U):
    for i in range(U.shape[1] - 1):
        S = vidal_step(st, S, U[:, i], U[:, i + 1], forward=True)
    return S


def rollout(st: TEBDStepper, psi0: VidalState, u):
    """psi_t for all N_t times (calcPsi): a state with B (N_t, L, chi, p,
    chi), or (B, N_t, ...) for a control batch."""
    S, U, batched = _lanes(psi0, u)
    return _out(_rollout_lanes(st, S, U), batched)


def rollout_final(st: TEBDStepper, psi0: VidalState, u):
    """psi(T) only."""
    S, U, batched = _lanes(psi0, u)
    return _out(_final_lanes(st, S, U), batched)


def rollout_final_tp(st: TEBDStepper, psi0: VidalState, u, mesh):
    """rollout_final with tensor-parallel bond updates: each stage's bonds
    are split over the mesh's "rows" axis and all-gathered after it
    (vidal_step's tp_mesh). Every rank of the rows group calls it with the
    same state and controls and gets the same psi(T)."""
    S, U, batched = _lanes(psi0, u)
    for i in range(U.shape[1] - 1):
        S = vidal_step(st, S, U[:, i], U[:, i + 1], forward=True,
                       tp_mesh=mesh)
    return _out(S, batched)


def costate_rollout(st: TEBDStepper, psi_target: VidalState, u):
    """xi_t backward from the target, ordered by time (calcXi)."""
    X, U, batched = _lanes(psi_target, u)
    return _out(_costate_lanes(st, X, U), batched)


# ---------------------------------------------------------------------------
# cost / fidelities
# ---------------------------------------------------------------------------

def cost(st: TEBDStepper, psi0: VidalState, psi_target: VidalState, u,
         gamma):
    """J(u) (calcCost) on Vidal states."""
    S, U, batched = _lanes(psi0, u)
    ov = _overlap_with(psi_target, _final_lanes(st, S, U).B)
    fid = (ov * ov.conj()).real
    return _out(0.5 * (1.0 - fid) + regularization(U, gamma, st.dt), batched)


def fidelities(st: TEBDStepper, psi0: VidalState, psi_target: VidalState, u):
    """|<psi_target|psi(t_i)>|^2 for every i."""
    S, U, batched = _lanes(psi0, u)
    traj = _rollout_lanes(st, S, U).B
    B, n = U.shape
    ov = _overlap_with(psi_target, traj.reshape(B * n, *traj.shape[2:]))
    return _out((ov * ov.conj()).real.reshape(B, n), batched)


def fidelities_streaming(st: TEBDStepper, psi0: VidalState,
                         psi_target: VidalState, u):
    """fidelities() with one state per lane in flight; same values."""
    S, U, batched = _lanes(psi0, u)

    def measure(s):
        ov = _overlap_with(psi_target, s.B)
        return (ov * ov.conj()).real

    return _out(rollout_measure(_fwd(st), S, U, measure).T, batched)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _div_t(st: TEBDStepper, xi_B, psi_B):
    """<xi_i| dH/du |psi_i> for (B, N_t, L, chi, p, chi) stacks; (B, N_t)."""
    B, n = psi_B.shape[:2]
    return mpslib.sandwich_site_sum(xi_B.reshape(B * n, *xi_B.shape[2:]),
                                    psi_B.reshape(B * n, *psi_B.shape[2:]),
                                    0.5 * st.nn1).reshape(B, n)


def gradient(st: TEBDStepper, psi0: VidalState, psi_target: VidalState, u,
             gamma):
    """Adjoint gradient (calcAnalyticGradient) on Vidal states. Returns
    (g, (psi_t, xi_t, divT, ov)), psi_t and xi_t VidalState stacks, ov =
    <psi(T)|psi_target>."""
    S, U, batched = _lanes(psi0, u)
    X = _lanes(psi_target, u)[0]
    psi_t = _rollout_lanes(st, S, U)
    xi_t = _costate_lanes(st, X, U)
    divT = _div_t(st, xi_t.B, psi_t.B)
    ov = mpslib.overlap(psi_t.B[:, -1], X.B)
    g = (st.dt * (divT * ov[:, None] * 1j).real
         + regularization_grad(U, gamma, st.dt))
    return _out(g, batched), tuple(_out(x, batched)
                                   for x in (psi_t, xi_t, divT, ov))


def gradient_lowmem(st: TEBDStepper, psi0: VidalState,
                    psi_target: VidalState, u, gamma):
    """BFGS-mode gradient: xi is never stored, divT computed during the one
    backward sweep. Returns (g, (psi_t, None, divT, ov))."""
    S, U, batched = _lanes(psi0, u)
    X = _lanes(psi_target, u)[0]
    half = 0.5 * st.nn1
    psi_t = _rollout_lanes(st, S, U)
    n = U.shape[1]
    divT = torch.empty(U.shape, dtype=psi_t.B.dtype, device=psi_t.B.device)
    divT[:, n - 1] = mpslib.sandwich_site_sum(X.B, psi_t.B[:, -1], half)
    xi = X
    for i in range(n - 1, 0, -1):
        xi = vidal_step(st, xi, U[:, i], U[:, i - 1], forward=False)
        divT[:, i - 1] = mpslib.sandwich_site_sum(xi.B, psi_t.B[:, i - 1],
                                                  half)
    ov = mpslib.overlap(psi_t.B[:, -1], X.B)
    g = (st.dt * (divT * ov[:, None] * 1j).real
         + regularization_grad(U, gamma, st.dt))
    return _out(g, batched), (_out(psi_t, batched), None,
                              _out(divT, batched), _out(ov, batched))


def cost_and_gradient(st: TEBDStepper, psi0: VidalState,
                      psi_target: VidalState, u, gamma):
    """Cost and gradient sharing one forward sweep."""
    g, (_, _, _, ov) = gradient(st, psi0, psi_target, u, gamma)
    fid = (ov * ov.conj()).real
    return 0.5 * (1.0 - fid) + regularization(u, gamma, st.dt), g


def gradient_segmented(st: TEBDStepper, psi0: VidalState,
                       psi_target: VidalState, u, gamma, seg=None):
    """`gradient` with O(sqrt(N_t)) states in memory (two-level
    checkpointing, streaming.segmented_adjoint_gradient): the gradient path
    of reference-scale chains. Returns (g, (psiT, divT, ov))."""
    S, U, batched = _lanes(psi0, u)
    X = _lanes(psi_target, u)[0]
    half = 0.5 * st.nn1
    g, aux = segmented_adjoint_gradient(
        _fwd(st), _bwd(st),
        lambda x, s: mpslib.sandwich_site_sum(x.B, s.B, half),
        lambda sT, tgt: mpslib.overlap(sT.B, tgt.B),
        lambda uu: regularization_grad(uu, gamma, st.dt),
        S, X, U, st.dt, seg=seg)
    return _out(g, batched), tuple(_out(x, batched) for x in aux)


# ---------------------------------------------------------------------------
# exact Hessian: Vidal trajectories, snake-sweep rows
# ---------------------------------------------------------------------------

def _snake_twin(st: TEBDStepper) -> TEBDStepper:
    """A snake-sweep stepper with the same gates, chi and dt: the row
    channel of the exact Hessian (rows are not in canonical form)."""
    return dataclasses.replace(st, sweep="snake", trunc_method="eigh",
                               gauge_method="qr")


def hessian(st: TEBDStepper, psi0: VidalState, psi_target: VidalState, u,
            gamma, aux=None, row_shard=None):
    """Exact dense Hessian for one control u (N_t,) (calcHessian_*): the
    psi/xi trajectories and divT from the Vidal channel (`gradient`), the
    dH|psi_i> row states stepped through the snake twin
    (`engine.hessian`'s row batch). Without truncation the two channels
    are the same operator; with it they differ at the truncation error,
    the Hessian's own floor. aux: (psi_t, xi_t, divT, ov) from
    `gradient`. row_shard: a mesh whose "rows" axis splits the row loop
    (`engine.hessian`)."""
    if aux is None:
        _, aux = gradient(st, psi0, psi_target, u, gamma)
    psi_t, xi_t, divT, ov = aux
    return mps_hessian(_snake_twin(st), psi0.B, psi_target.B, u, gamma,
                       aux=(psi_t.B, xi_t.B, divT, ov), row_shard=row_shard)


def hessian_streaming(st: TEBDStepper, psi0: VidalState,
                      psi_target: VidalState, u, gamma, aux=None,
                      row_block: int = 64, progress=None):
    """`hessian` with O(row_block) live states (streaming.BlockHessian):
    Vidal steps for psi and xi, snake-twin steps for the rows; the same
    values. aux: (psiT, divT, ov) from gradient_segmented, recomputed when
    None. Built per call: there is nothing compiled to cache."""
    n = u.shape[0]
    if aux is None:
        _, aux = gradient_segmented(st, psi0, psi_target, u, gamma)
    _, divT, ov = aux
    st_row = _snake_twin(st)
    half = 0.5 * st.nn1
    bh = BlockHessian(
        n, pick_row_block(n - 1, row_block), fwd=_fwd(st), bwd=_bwd(st),
        apply_dh=lambda A: mpslib.apply_site_sum_diag(
            A, half, method=st_row.trunc_method),
        row_step=lambda A, a, b: tebd_step(st_row, A, a, b, forward=True),
        overlap=mpslib.overlap, get_b=to_mps)
    one = _lanes(psi0, u)[0], _lanes(psi_target, u)[0]
    ovm, row_norm, xih_norm, diag_ov = bh.ov_data(*one, u, progress=progress)
    return assemble_hessian(ovm, row_norm, xih_norm, diag_ov, divT, ov,
                            st.dt, regularization_hessian(
                                n, gamma, st.dt, dtype=row_norm.dtype,
                                device=row_norm.device))


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

def bond_renyi2(state: VidalState):
    """(..., L-1) per-bond Renyi-2 entropy S2 = -log(sum lam^4 /
    (sum lam^2)^2); exp(S2) is the effective bond rank (the reference's
    per-bond link-dimension log, AnalyzeBondDim)."""
    w2 = state.lam * state.lam
    tr2 = (w2 * w2).sum(-1) / (w2.sum(-1) ** 2).clamp(min=1e-30)
    return -torch.log(tr2)


def bond_vn_entropy(state: VidalState):
    """(..., L-1) per-bond von Neumann entropy from the Schmidt values."""
    w = state.lam * state.lam
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-30)
    return -torch.where(w > 1e-14, w * torch.log(w.clamp(min=1e-30)),
                        torch.zeros_like(w)).sum(-1)


def rollout_diagnostics(st: TEBDStepper, psi0: VidalState, u,
                        psi_target: VidalState = None):
    """Per-step truncation and entanglement records with one state per
    lane in flight. Returns (final state, diag) with diag a dict of time
    stacks, (N_t, ...) or (B, N_t, ...) for a control batch:
      fid   (N_t,)      |<target|psi_i>|^2 (only with psi_target)
      s2    (N_t, L-1)  per-bond Renyi-2 entropy
      disc  (N_t, L-1)  per-bond discarded weight of step i (row 0 zeros)
    (the reference's AnalyzeBondDim per-t per-bond records)."""
    S, U, batched = _lanes(psi0, u)

    def measure(s, disc):
        out = {"s2": bond_renyi2(s), "disc": disc}
        if psi_target is not None:
            ov = _overlap_with(psi_target, s.B)
            out["fid"] = (ov * ov.conj()).real
        return out

    recs = [measure(S, torch.zeros_like(S.lam[..., 0]))]
    for i in range(U.shape[1] - 1):
        S, disc = vidal_step(st, S, U[:, i], U[:, i + 1], forward=True,
                             diag=True)
        recs.append(measure(S, disc))
    diag = {k: _out(torch.stack([r[k] for r in recs], dim=1), batched)
            for k in recs[0]}
    return _out(S, batched), diag
