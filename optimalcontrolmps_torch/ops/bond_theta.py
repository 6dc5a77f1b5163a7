"""Two-site theta of a TEBD bond update: CUDA kernel and plain twin.

Counterpart of optimalcontrolmps_tpu/ops/pallas_kernels.py. For a batch of
bond pairs Ai, Aj (B, chi, p, chi) and the (p^2, p^2) bond gate,

    theta[b, l*p+P, Q*chi+r] = sum_{p'q} G[P*p+Q, p'*p+q]
                               * sum_m Ai[b,l,p',m] Aj[b,m,q,r]

returned as a (B, chi*p, p*chi) matrix ready for truncation.

* `bond_theta_reference` is the plain PyTorch twin: the two einsums of
  `tebd._apply_bond`, batched. The CPU path and the kernel's check use it.
* `_launch` runs the hand-written Hopper kernel of `csrc/bond_theta.cu`
  (complex64 or complex128) and counts its launches (`bond_theta_launches`).
* `bond_theta` is the public entry. It looks at the tensor's device only: a
  CUDA tensor launches the kernel (or raises), a CPU tensor takes the twin.

The operation has no backward: the MPS engine differentiates with the
analytic adjoint, and reverse-mode autodiff through the truncating rollout
is NaN anyway (eigh of the padded spectrum). A call that would need a
gradient raises.
"""

from __future__ import annotations

import torch

__all__ = ["bond_theta", "bond_theta_reference", "reset_counts",
           "bond_theta_launches"]

bond_theta_launches = 0


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


def _launch(Ai, Aj, gate):
    from ._build import load_bond_theta
    global bond_theta_launches
    if Ai.dim() != 4 or Ai.shape[1] != Ai.shape[3]:
        raise ValueError(f"Ai: expected shape (B, chi, p, chi), got "
                         f"{tuple(Ai.shape)}")
    B, chi, p, _ = Ai.shape
    for name, t, shape in (("Ai", Ai, (B, chi, p, chi)),
                           ("Aj", Aj, (B, chi, p, chi)),
                           ("gate", gate, (p * p, p * p))):
        if not t.is_cuda or t.device != Ai.device:
            raise ValueError(f"{name}: expected a CUDA tensor on "
                             f"{Ai.device}, got {t.device}")
        if t.dtype not in (torch.complex64, torch.complex128) \
                or t.dtype != Ai.dtype:
            raise TypeError(f"{name}: expected complex64 or complex128 like "
                            f"Ai ({Ai.dtype}), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if B < 1:
        raise ValueError("empty bond batch")
    lib = load_bond_theta()
    theta = torch.empty((B, chi * p, p * chi), dtype=Ai.dtype,
                        device=Ai.device)
    fn = (lib.bond_theta_c64 if Ai.dtype == torch.complex64
          else lib.bond_theta_c128)
    stream = torch.cuda.current_stream(Ai.device).cuda_stream
    rc = fn(Ai.data_ptr(), Aj.data_ptr(), gate.data_ptr(), theta.data_ptr(),
            B, chi, p, stream)
    if rc != 0:
        raise RuntimeError(f"bond_theta (B={B}, chi={chi}, p={p}, "
                           f"{Ai.dtype}): CUDA error {rc}")
    bond_theta_launches += 1
    return theta


def bond_theta(Ai, Aj, gate):
    """Kernel on CUDA tensors, twin on CPU tensors. Ai, Aj (B, chi, p, chi),
    gate (p^2, p^2) -> (B, chi*p, p*chi). Raises where a gradient would be
    needed, and on a lazy conjugate or negative view on either device."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (Ai, Aj, gate)):
        raise RuntimeError("bond_theta has no backward; differentiate the "
                           "MPS engine with its analytic adjoint")
    if any(t.is_conj() or t.is_neg() for t in (Ai, Aj, gate)):
        # the kernel reads memory as stored, and so does the check on the
        # CPU, so that a path that would hand the card a lazy view fails here
        raise ValueError("bond_theta: a conjugate or negative view; call "
                         "resolve_conj() / resolve_neg() first")
    if Ai.is_cuda:
        return _launch(Ai, Aj, gate)
    if Aj.is_cuda or gate.is_cuda:
        raise ValueError("bond_theta: Ai is on the CPU but Aj or the gate "
                         "is on a CUDA device")
    return bond_theta_reference(Ai, Aj, gate)
