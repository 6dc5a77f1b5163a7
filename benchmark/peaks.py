"""The chip's peaks and the least time of each kernel layer's work.

Published NVIDIA H100 SXM peaks (data sheet, dense, at the 700 W limit):
3.35 TB/s of HBM; 67 TFLOP/s float32 on the CUDA cores and float64 through
the tensor cores (DMMA); 495 TFLOP/s TF32 on the tensor cores, where a
float32-grade product takes three passes (3xTF32: small*big + big*small +
big*big). A kernel's bound is the larger of its operations over the peak
of the route that does them and its bytes over the memory rate; each input
is counted read once and each output written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FP32 = 67e12
PEAK_FP64 = 67e12
PEAK_TF32, TF32_PASSES = 495e12, 3


def bound_ms(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / HBM_BYTES_PER_S) * 1e3


def sector_chain_ms(direction: str, B: int, n_t: int, ns: int) -> float:
    """Least time of the sector chain at (B, N_t) on ns sector states (the
    padding is identity and does no work): four real (ns x ns) products
    per step and row forward; the reversible backward rebuilds the state
    and carries the cotangent, eight. float32 inputs and outputs. The
    lesser of the two routes, CUDA cores and 3xTF32 tensor cores."""
    steps, f32 = n_t - 1, 4
    if direction == "fwd":
        ops = 2 * 4 * ns * ns * steps * B
        nbytes = f32 * (2 * ns * ns + 3 * ns + B * n_t + 2 * B * ns)
    elif direction == "bwd":
        ops = 2 * 8 * ns * ns * steps * B
        nbytes = f32 * (2 * ns * ns + ns + B * n_t + 4 * B * ns + B * n_t)
    else:
        raise ValueError(direction)
    return min(bound_ms(ops, nbytes, PEAK_FP32),
               bound_ms(ops, nbytes, PEAK_TF32 / TF32_PASSES))


def bond_theta_ms(B: int, chi: int, p: int, complex128: bool) -> float:
    """Least time of one bond theta: 8 (chi^3 p^2 + p^4 chi^2) real
    operations per bond; the two sites and the gate read once, theta
    written once."""
    csize = 16 if complex128 else 8
    ops = 8 * (chi ** 3 * p ** 2 + p ** 4 * chi ** 2) * B
    nbytes = csize * (B * (2 * chi * chi * p + chi * chi * p * p) + p ** 4)
    return bound_ms(ops, nbytes, PEAK_FP64 if complex128 else PEAK_FP32)
