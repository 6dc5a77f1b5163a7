"""device_idle_pct.multistart: the device's idle share in the multistart
cell (readers.idle_pct)."""

from benchmark.readers import idle_pct as read  # noqa: F401
