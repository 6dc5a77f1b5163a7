"""device_idle_pct.vidal: the device's idle share in
bh_N20.vidal_gradient (readers.idle_pct)."""

from benchmark.readers import idle_pct as read  # noqa: F401
