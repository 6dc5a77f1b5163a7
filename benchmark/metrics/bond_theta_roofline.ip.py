"""bond_theta_roofline.ip: the bond theta's share of its roofline at the
shapes of bh_N20_ip.ip_host's path, complex128
(readers.bond_theta_roofline)."""

from benchmark.readers import bond_theta_roofline as read  # noqa: F401
