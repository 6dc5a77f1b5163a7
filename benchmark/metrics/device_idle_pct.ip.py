"""device_idle_pct.ip: the device's idle share of the profiled window in
bh_N20_ip.ip_host (readers.idle_pct)."""

from benchmark.readers import idle_pct as read  # noqa: F401
