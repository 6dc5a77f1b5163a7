"""GROUP control parameterization: reduced-basis controls.

Counterpart of optimalcontrolmps_tpu/control.py:

    u(t_i) = u0_i + S_i * sum_n c_n f_{i,n}          (convert_control)
    (dJ/dc)_n = sum_i S_i f_{i,n} (dJ/du)_i          (convert_gradient)
    H_c = B^T H_u B,  B_{i,n} = S_i f_{i,n}          (convert_hessian)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import seeds
from .device import resolve_device

# The reference builds the sine basis with a truncated PI; the same constant
# keeps golden basis/cost vectors within 5e-6.
REFERENCE_PI = 3.14159265

__all__ = ["ControlBasis", "chopped_sine_basis", "basis_from_numpy",
           "REFERENCE_PI"]


@dataclasses.dataclass(frozen=True)
class ControlBasis:
    """u(t) = u0 + S * (f @ c). Shapes: u0, S: (N,); f: (N, M)."""
    u0: torch.Tensor
    S: torch.Tensor
    f: torch.Tensor

    @property
    def N(self) -> int:
        return self.u0.shape[0]

    @property
    def M(self) -> int:
        return self.f.shape[1]

    def jacobian(self) -> torch.Tensor:
        """du_i/dc_n = S_i f_{i,n}."""
        return self.S[:, None] * self.f

    def convert_control(self, c: torch.Tensor) -> torch.Tensor:
        """c: (M,) or (B, M) -> u: (N,) or (B, N)."""
        return self.u0 + self.S * (c @ self.f.T)

    def convert_gradient(self, grad_u: torch.Tensor) -> torch.Tensor:
        return self.jacobian().T @ grad_u

    def convert_hessian(self, hess_u: torch.Tensor) -> torch.Tensor:
        B = self.jacobian()
        return B.T @ hess_u @ B


def basis_from_numpy(u0, S, f, device=None) -> ControlBasis:
    """ControlBasis from host arrays (e.g. the JAX basis' fields), kept in
    their own dtype, on `device` (None means the card)."""
    device = resolve_device(device)
    return ControlBasis(*(torch.as_tensor(np.asarray(a), device=device)
                          for a in (u0, S, f)))


def chopped_sine_basis(u0, tstep: float, T: float, M: int,
                       dtype=torch.float64, device=None) -> ControlBasis:
    """Chopped sine basis with stitched-sigmoid shape function:

      f_{i,n} = sin((n+1) * PI * tstep * i / T)
      S = sigmoid(x; k=8, off=1.1) stitched at N/2 with
          sigmoid(x; k=-8, off=98.9) on x = linspace(0, 100, N),
          endpoints forced to 0 (pins u(0), u(T)).
    device=None means the card.
    """
    device = resolve_device(device)
    u0 = np.asarray(u0, dtype=np.float64)
    N = u0.shape[0]
    if abs(N - (1 + T / tstep)) >= 1e-5:
        raise ValueError(f"len(u0)={N} does not match T={T}, tstep={tstep}")

    x = seeds.linspace(0.0, 100.0, N)
    S = seeds.sigmoid(x, 8.0, 1.1)
    S2 = seeds.sigmoid(x, -8.0, 100.0 - 1.1)
    S[N // 2:] = S2[N // 2:]
    S[0] = 0.0
    S[N - 1] = 0.0

    i = np.arange(N, dtype=np.float64)[:, None]
    n = np.arange(M, dtype=np.float64)[None, :]
    f = np.sin((n + 1.0) * REFERENCE_PI * tstep * i / T)
    return ControlBasis(*(torch.as_tensor(a, dtype=dtype, device=device)
                          for a in (u0, S, f)))
