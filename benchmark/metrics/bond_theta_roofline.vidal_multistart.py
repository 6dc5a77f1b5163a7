"""bond_theta_roofline.vidal_multistart: the bond theta's share of its
roofline at the four lanes' stage shapes of bh_N20.vidal_multistart,
(40 | 36, 70, 8) complex64 (readers.bond_theta_roofline)."""

from benchmark.readers import bond_theta_roofline as read  # noqa: F401
