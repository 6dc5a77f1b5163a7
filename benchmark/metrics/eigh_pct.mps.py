"""eigh_pct.mps: the eigensolver's share of device time in
bh_L5.mps_gradient (readers.eigh_pct)."""

from benchmark.readers import eigh_pct as read  # noqa: F401
