"""device_idle_pct.mps: the device's idle share in
bh_L5.mps_gradient (readers.idle_pct)."""

from benchmark.readers import idle_pct as read  # noqa: F401
