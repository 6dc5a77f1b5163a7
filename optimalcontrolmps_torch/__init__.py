"""PyTorch port of optimalcontrolmps_tpu for NVIDIA Hopper GPUs.

The first slice covers the flagship multistart solve on the fixed-N sector
engine (`flagship.solve_flagship`): the sector propagator and its
derivatives, the fused Trotter chain with hand-written CUDA kernels
(`ops/sector_chain.py`, `csrc/sector_chain.cu`), the lockstep batch L-BFGS
and the exact-Hessian Newton polish.

The package imports torch and numpy only; CUDA kernels are built on first
use (`ops/_build.py`).
"""

__version__ = "0.1.0"
