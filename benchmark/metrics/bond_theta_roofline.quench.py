"""bond_theta_roofline.quench: the bond theta's share of its roofline at
the quench's stage shapes of bh_N20_quench.prep_quench, on the initial
state's bonds (readers.bond_theta_roofline)."""

from benchmark.readers import bond_theta_roofline as read  # noqa: F401
