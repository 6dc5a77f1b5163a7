"""Readers that several metrics share: a metric of the same quantity in
cells that report different end-to-end metrics gets a name and a file of
its own (`metrics/<name>.py`), which takes its reader from here."""


def gradients_per_s(record):
    """Lane cost-and-gradient evaluations per second: all units' gradients
    over the window (host clock)."""
    return sum(u["work"]["gradients"] for u in record["units"]) \
        / record["window_s"]


def eigh_pct(record):
    """The share of the profiled device time in kernels launched from
    inside an eigensolver call (torch.linalg.eigh and what it calls)."""
    tr = record["trace"]
    if tr is None or tr["device_s"] <= 0 or tr["eigh_s"] <= 0:
        return None
    return 100.0 * tr["eigh_s"] / tr["device_s"]


def bond_theta_roofline(record):
    """The summed bounds of the bond theta at the shapes the cell's path
    gives it over their summed CUDA-event times (peaks.bond_theta_ms)."""
    calls = (record["probes"] or {}).get("bond_theta")
    if not calls:
        return None
    return 100.0 * sum(c["bound_ms"] for c in calls) \
        / sum(c["ms"] for c in calls)


def idle_pct(record):
    """One minus the device's busy share of the profiled window, in %: one
    minus the union of device intervals over the window."""
    tr = record["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
