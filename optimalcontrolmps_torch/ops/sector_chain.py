"""Fused sector Trotter chain: CUDA kernels, plain twins, autograd.

Counterpart of optimalcontrolmps_tpu/ops/pallas_sector.py. The multistart
objective's hot loop is the merged-phase chain of sector.rollout_final run
for a (B, N_t) batch of controls, each lane with its own trajectory. In real
pairs, row form, with R(phi) the (re, im) rotation by phi:

    h_0 = R(-dt/4 u_0 nn1) psi_0,   h_i = R(-dt/2 u_i nn1) (h_{i-1} W^T)

The backward pass is reversible: the chain is unitary, so it rebuilds
h_{i-1} from h_i while the cotangent propagates, and stores no trajectory.

* `chain_final_scan` and `scan_bwd` are the plain PyTorch twins. The CPU path
  and the kernels' check use them.
* `_launch_fwd` / `_launch_bwd` run the hand-written Hopper kernels of
  `csrc/sector_chain.cu` and count their launches (`fwd_launches`,
  `bwd_launches`; a CUDA graph's replays through `count_launches`).
* `_Chain` is the autograd.Function; `chain_final` is the public entry.

Dispatch looks at the tensor's device only: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the twin.
"""

from __future__ import annotations

import torch

__all__ = ["chain_final", "chain_final_scan", "scan_bwd", "chain_constants",
           "reset_counts", "count_launches", "fwd_launches", "bwd_launches"]

N_KERNEL = 128  # the kernels' fixed sector width (ns_p)

fwd_launches = 0
bwd_launches = 0


def reset_counts() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0


def count_launches(fwd: int, bwd: int) -> None:
    """Add kernel runs that no wrapper call counted: a replayed CUDA
    graph's (negative: a capture's, which runs nothing)."""
    global fwd_launches, bwd_launches
    fwd_launches += fwd
    bwd_launches += bwd


# ---------------------------------------------------------------------------
# plain PyTorch twins (the algebra of _chain_final_scan / _scan_bwd)
# ---------------------------------------------------------------------------

def chain_final_scan(dt, Wr, Wi, nn1, u_bt, h0r, h0i):
    """(B, N_t) controls -> (B, n) final half-phased state as a real pair."""
    ph0 = (-0.25 * dt) * torch.outer(u_bt[:, 0], nn1)
    c0, s0 = torch.cos(ph0), torch.sin(ph0)
    hr = c0 * h0r[None, :] - s0 * h0i[None, :]
    hi = c0 * h0i[None, :] + s0 * h0r[None, :]
    WrT, WiT = Wr.T, Wi.T
    for i in range(1, u_bt.shape[1]):
        ar = hr @ WrT - hi @ WiT
        ai = hr @ WiT + hi @ WrT
        ph = (-0.5 * dt) * torch.outer(u_bt[:, i], nn1)
        c, s = torch.cos(ph), torch.sin(ph)
        hr, hi = c * ar - s * ai, c * ai + s * ar
    return hr, hi


def scan_bwd(dt, Wr, Wi, nn1, u_bt, hTr, hTi, gTr, gTi):
    """(B, N_t) du of a real loss with cotangent (gTr, gTi) of (hTr, hTi).
    A rotation h = R(ph) a has vjp g_a = R(-ph) g_h and
    dL/dph = sum_n (g_hi h_r - g_hr h_i)."""
    hr, hi, gr, gi = hTr, hTi, gTr, gTi
    n_t = u_bt.shape[1]
    du = [None] * n_t
    for i in range(n_t - 1, 0, -1):
        du[i] = (-0.5 * dt) * torch.sum(nn1[None, :] * (gi * hr - gr * hi),
                                        dim=1)
        ph = (-0.5 * dt) * torch.outer(u_bt[:, i], nn1)
        c, s = torch.cos(ph), torch.sin(ph)
        ar, ai = c * hr + s * hi, c * hi - s * hr          # R(-ph) h
        br, bi = c * gr + s * gi, c * gi - s * gr          # R(-ph) g
        # x W^H  (re = xr Wr + xi Wi, im = xi Wr - xr Wi)
        hr, hi = ar @ Wr + ai @ Wi, ai @ Wr - ar @ Wi
        gr, gi = br @ Wr + bi @ Wi, bi @ Wr - br @ Wi
    du[0] = (-0.25 * dt) * torch.sum(nn1[None, :] * (gi * hr - gr * hi),
                                     dim=1)
    return torch.stack(du, dim=1)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, t, shape):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _launch_fwd(dt, Wr, Wi, nn1, u_bt, h0r, h0i):
    from ._build import load_sector_chain
    global fwd_launches
    B, n_t = u_bt.shape
    n = N_KERNEL
    for name, t, shape in (("Wr", Wr, (n, n)), ("Wi", Wi, (n, n)),
                           ("nn1", nn1, (n,)), ("u_bt", u_bt, (B, n_t)),
                           ("h0r", h0r, (n,)), ("h0i", h0i, (n,))):
        _check(name, t, shape)
    if B < 1 or n_t < 1:
        raise ValueError(f"empty control batch {tuple(u_bt.shape)}")
    lib = load_sector_chain()
    hTr = torch.empty((B, n), dtype=torch.float32, device=u_bt.device)
    hTi = torch.empty_like(hTr)
    stream = torch.cuda.current_stream(u_bt.device).cuda_stream
    rc = lib.sector_chain_fwd(
        Wr.data_ptr(), Wi.data_ptr(), nn1.data_ptr(), u_bt.data_ptr(),
        h0r.data_ptr(), h0i.data_ptr(), hTr.data_ptr(), hTi.data_ptr(),
        B, n_t, -0.25 * dt, -0.5 * dt, stream)
    _raise_on(rc, "sector_chain_fwd")
    fwd_launches += 1
    return hTr, hTi


def _launch_bwd(dt, Wr, Wi, nn1, u_bt, hTr, hTi, gTr, gTi):
    from ._build import load_sector_chain
    global bwd_launches
    B, n_t = u_bt.shape
    n = N_KERNEL
    for name, t, shape in (("Wr", Wr, (n, n)), ("Wi", Wi, (n, n)),
                           ("nn1", nn1, (n,)), ("u_bt", u_bt, (B, n_t)),
                           ("hTr", hTr, (B, n)), ("hTi", hTi, (B, n)),
                           ("gTr", gTr, (B, n)), ("gTi", gTi, (B, n))):
        _check(name, t, shape)
    if B < 1 or n_t < 1:
        raise ValueError(f"empty control batch {tuple(u_bt.shape)}")
    lib = load_sector_chain()
    du = torch.empty((B, n_t), dtype=torch.float32, device=u_bt.device)
    stream = torch.cuda.current_stream(u_bt.device).cuda_stream
    rc = lib.sector_chain_bwd(
        Wr.data_ptr(), Wi.data_ptr(), nn1.data_ptr(), u_bt.data_ptr(),
        hTr.data_ptr(), hTi.data_ptr(), gTr.data_ptr(), gTi.data_ptr(),
        du.data_ptr(), B, n_t, -0.25 * dt, -0.5 * dt, stream)
    _raise_on(rc, "sector_chain_bwd")
    bwd_launches += 1
    return du


def chain_fwd(dt, Wr, Wi, nn1, u_bt, h0r, h0i):
    """Kernel on a CUDA tensor, twin on a CPU tensor."""
    if u_bt.is_cuda:
        return _launch_fwd(dt, Wr, Wi, nn1, u_bt, h0r, h0i)
    return chain_final_scan(dt, Wr, Wi, nn1, u_bt, h0r, h0i)


def chain_bwd(dt, Wr, Wi, nn1, u_bt, hTr, hTi, gTr, gTi):
    """Kernel on a CUDA tensor, twin on a CPU tensor."""
    if u_bt.is_cuda:
        return _launch_bwd(dt, Wr, Wi, nn1, u_bt, hTr, hTi, gTr, gTi)
    return scan_bwd(dt, Wr, Wi, nn1, u_bt, hTr, hTi, gTr, gTi)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _Chain(torch.autograd.Function):
    """Real-pair chain (hTr, hTi) = chain(u_bt); differentiable in u_bt
    only. W, nn1 and h0 are problem constants and get no gradient."""

    @staticmethod
    def forward(ctx, dt, Wr, Wi, nn1, u_bt, h0r, h0i):
        hTr, hTi = chain_fwd(dt, Wr, Wi, nn1, u_bt, h0r, h0i)
        ctx.dt = dt
        ctx.save_for_backward(Wr, Wi, nn1, u_bt, hTr, hTi)
        return hTr, hTi

    @staticmethod
    def backward(ctx, gTr, gTi):
        Wr, Wi, nn1, u_bt, hTr, hTi = ctx.saved_tensors
        gTr = torch.zeros_like(hTr) if gTr is None else gTr.contiguous()
        gTi = torch.zeros_like(hTi) if gTi is None else gTi.contiguous()
        du = chain_bwd(ctx.dt, Wr, Wi, nn1, u_bt, hTr, hTi, gTr, gTi)
        return None, None, None, None, du, None, None


def chain_constants(st, psi0, real=torch.float32):
    """(Wr, Wi, nn1, h0r, h0i) in `real` on the stepper's device: the padded
    J-product split into real pairs and the padded initial state. The
    kernels take float32; float64 constants run the twins on the CPU."""
    cplx = torch.complex64 if real == torch.float32 else torch.complex128
    Wr = st.WJ_fwd_p.real.to(real).contiguous()
    Wi = st.WJ_fwd_p.imag.to(real).contiguous()
    nn1 = st.nn1_p.to(real).contiguous()
    p0 = torch.zeros(st.ns_p, dtype=cplx, device=Wr.device)
    p0[:st.ns] = psi0.to(cplx)
    return Wr, Wi, nn1, p0.real.contiguous(), p0.imag.contiguous()


def chain_final(st, u_bt, psi0, consts=None):
    """Batched merged-phase chain: (B, N_t) controls -> (B, ns) final
    sector state psi_T, normalized with the doubled trailing phase
    stripped, complex64 (complex128 from float64 constants).
    Differentiable in u_bt through `_Chain`, whose outputs are real pairs;
    only the fix-up below is complex.

    `consts` is `chain_constants(st, psi0)`, built here (float32) when
    omitted; the controls are cast to its precision."""
    if consts is None:
        consts = chain_constants(st, psi0)
    Wr, Wi, nn1, h0r, h0i = consts
    u_bt = u_bt.to(Wr.dtype).contiguous()
    hTr, hTi = _Chain.apply(float(st.dt), Wr, Wi, nn1, u_bt, h0r, h0i)
    hT = torch.complex(hTr, hTi)[:, :st.ns]
    ph = torch.exp((0.25j * st.dt) * u_bt[:, -1:] * st.nn1[None, :])
    psiT = hT * ph.to(hT.dtype)
    nrm = torch.linalg.vector_norm(psiT, dim=1, keepdim=True)
    return psiT / torch.where(nrm > 1e-16, nrm,
                              torch.ones_like(nrm)).to(psiT.dtype)
