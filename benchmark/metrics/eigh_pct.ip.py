"""eigh_pct.ip: the eigensolver's share of device time in
bh_N20_ip.ip_host (readers.eigh_pct)."""

from benchmark.readers import eigh_pct as read  # noqa: F401
