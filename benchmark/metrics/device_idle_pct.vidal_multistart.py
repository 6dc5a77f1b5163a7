"""device_idle_pct.vidal_multistart: the device's idle share in
bh_N20.vidal_multistart (readers.idle_pct)."""

from benchmark.readers import idle_pct as read  # noqa: F401
