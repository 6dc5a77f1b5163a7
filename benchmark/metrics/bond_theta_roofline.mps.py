"""bond_theta_roofline.mps: the bond theta's share of its roofline in
bh_L5.mps_gradient (readers.bond_theta_roofline)."""

from benchmark.readers import bond_theta_roofline as read  # noqa: F401
