"""eigh_pct.vidal: the eigensolver's share of device time in
bh_N20.vidal_gradient (readers.eigh_pct)."""

from benchmark.readers import eigh_pct as read  # noqa: F401
