"""The reference's public OptimalControl class surface.

Counterpart of optimalcontrolmps_tpu/problem.py: getCost,
getAnalyticGradient, getHessian, getFidelityForAllT, getControlJacobian,
getControl, getTimeAxis and propagatePsi over the MPS or sector engine.
GRAPE mode (basis=None) takes the raw control u (N values); GROUP mode takes
basis coefficients c (M values). `bfgs=True` selects the memory-light
gradient. PyTorch runs eagerly, so there is nothing to compile or cache.
"""

from __future__ import annotations

import numpy as np
import torch

from .backends import engine_for
from .control import ControlBasis
from .engine import regularization

__all__ = ["OptimalControlProblem"]


class OptimalControlProblem:
    """GRAPE (basis=None) or GROUP (basis given) optimal-control problem."""

    def __init__(self, psi_target, psi_init, stepper, n_steps=None,
                 basis: ControlBasis | None = None, gamma: float = 0.0,
                 bfgs: bool = False):
        self.psi_target = psi_target
        self.psi_init = psi_init
        self.stepper = stepper
        self.basis = basis
        self.gamma = float(gamma)
        self.bfgs = bool(bfgs)
        if basis is not None:
            self.N, self.M = basis.N, basis.M
        else:
            if n_steps is None:
                raise ValueError("GRAPE mode needs n_steps")
            self.N, self.M = int(n_steps), 0
        self._eng = engine_for(stepper)

    def _x(self, x):
        dtype = (torch.float64 if self.psi_init.dtype == torch.complex128
                 else torch.float32)
        return torch.as_tensor(x, dtype=dtype, device=self.psi_init.device)

    def _grad_fn(self):
        return self._eng.gradient_lowmem if self.bfgs else self._eng.gradient

    # -- reference-parity surface -----------------------------------------
    def get_control(self, x):
        """getControl: u(t) for coefficients (GROUP) or u itself (GRAPE)."""
        x = self._x(x)
        return self.basis.convert_control(x) if self.basis is not None else x

    def get_cost(self, x):
        """getCost."""
        return self._eng.cost(self.stepper, self.psi_init, self.psi_target,
                              self.get_control(x), self.gamma)

    def get_analytic_gradient(self, x):
        """getAnalyticGradient."""
        g_u, _ = self._grad_fn()(self.stepper, self.psi_init,
                                 self.psi_target, self.get_control(x),
                                 self.gamma)
        return (self.basis.convert_gradient(g_u) if self.basis is not None
                else g_u)

    def get_cost_and_gradient(self, x):
        """Cost and gradient from one forward and one backward sweep."""
        u = self.get_control(x)
        g_u, (_, _, _, ov) = self._grad_fn()(self.stepper, self.psi_init,
                                             self.psi_target, u, self.gamma)
        g = (self.basis.convert_gradient(g_u) if self.basis is not None
             else g_u)
        fid = (ov * ov.conj()).real
        return (0.5 * (1.0 - fid)
                + regularization(u, self.gamma, self.stepper.dt)), g

    def get_hessian(self, x):
        """getHessian."""
        H = self._eng.hessian(self.stepper, self.psi_init, self.psi_target,
                              self.get_control(x), self.gamma)
        return (self.basis.convert_hessian(H) if self.basis is not None
                else H)

    def get_fidelity_for_all_t(self, x):
        """getFidelityForAllT."""
        return self._eng.fidelities(self.stepper, self.psi_init,
                                    self.psi_target, self.get_control(x))

    def get_control_jacobian(self):
        """getControlJacobian."""
        if self.basis is not None:
            return self.basis.jacobian()
        return self._x(np.eye(self.N))

    def get_time_axis(self):
        """getTimeAxis."""
        return np.arange(self.N) * self.stepper.dt

    def propagate_psi(self, x):
        """propagatePsi: the full psi_t stack."""
        return self._eng.rollout(self.stepper, self.psi_init,
                                 self.get_control(x))

    # -- setters (OptimalControl.hpp:62-66) -------------------------------
    def set_gamma(self, gamma):
        self.gamma = float(gamma)

    def set_bfgs(self, bfgs: bool):
        self.bfgs = bool(bfgs)

    def use_bfgs(self) -> bool:
        return self.bfgs

    def grape(self) -> "OptimalControlProblem":
        """A GRAPE view of the same physics (the reference's setGRAPE)."""
        return OptimalControlProblem(self.psi_target, self.psi_init,
                                     self.stepper, n_steps=self.N,
                                     basis=None, gamma=self.gamma,
                                     bfgs=self.bfgs)
