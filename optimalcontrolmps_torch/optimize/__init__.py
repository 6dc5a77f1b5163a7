"""Optimizers of the PyTorch port."""

from .lbfgs import LBFGSResult, minimize_lbfgs, minimize_lbfgs_batch
from .newton import NewtonResult, minimize_newton

__all__ = ["LBFGSResult", "minimize_lbfgs", "minimize_lbfgs_batch",
           "NewtonResult", "minimize_newton"]
