"""bond_theta_roofline.vidal: the bond theta's share of its roofline in
bh_N20.vidal_gradient (readers.bond_theta_roofline)."""

from benchmark.readers import bond_theta_roofline as read  # noqa: F401
