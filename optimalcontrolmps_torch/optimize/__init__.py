"""Optimizers of the PyTorch port."""

from .interior_point import (IPResult, cold_duals, minimize_interior_point,
                             minimize_interior_point_host)
from .lbfgs import LBFGSResult, minimize_lbfgs, minimize_lbfgs_batch
from .nelder_mead import NelderMeadResult, minimize_nelder_mead
from .newton import NewtonResult, minimize_newton
from .penalty import bound_penalty, make_penalized_cost

__all__ = ["IPResult", "cold_duals", "minimize_interior_point",
           "minimize_interior_point_host", "LBFGSResult", "minimize_lbfgs",
           "minimize_lbfgs_batch", "NelderMeadResult",
           "minimize_nelder_mead", "NewtonResult", "minimize_newton",
           "bound_penalty", "make_penalized_cost"]
