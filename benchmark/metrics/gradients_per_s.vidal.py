"""gradients_per_s.vidal: gradients per second in
bh_N20.vidal_gradient (readers.gradients_per_s)."""

from benchmark.readers import gradients_per_s as read  # noqa: F401
