"""device_idle_pct.quench: the device's idle share in
bh_N20_quench.prep_quench (readers.idle_pct)."""

from benchmark.readers import idle_pct as read  # noqa: F401
