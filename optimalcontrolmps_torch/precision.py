"""Matmul-precision policy: float32 products run in full IEEE float32.

Counterpart of optimalcontrolmps_tpu/ops/precision.py. Reduced-precision
matmul passes put the flagship cost off by ~1e-2 relative, so every
float32 product of the port runs at "highest" precision: TF32 is off for
matmuls and for cuDNN. These flags govern torch's own products, not the
hand-written kernels: the sector chain's kernels take their products on the
tensor cores in 3xTF32 (each operand split into two TF32 parts, three
passes, fp32 accumulation: float32-grade, never single-pass TF32), and the
bond theta's use fp32 / fp64 FMAs.
"""

from __future__ import annotations

import torch

__all__ = ["enforce_matmul_precision"]


def enforce_matmul_precision() -> None:
    """Turn TF32 off and pin float32 matmuls to "highest". Idempotent;
    called by the port's public entry points."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
