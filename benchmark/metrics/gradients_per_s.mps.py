"""gradients_per_s.mps: gradients per second in
bh_L5.mps_gradient (readers.gradients_per_s)."""

from benchmark.readers import gradients_per_s as read  # noqa: F401
