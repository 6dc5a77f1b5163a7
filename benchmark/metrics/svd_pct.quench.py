"""svd_pct.quench: the share of the profiled device time in cuSOLVER's SVD
kernels, matched by name in the device trace whatever host thread
launched them (the unit's `probes`, `svd`)."""


def read(record):
    svd = (record["probes"] or {}).get("svd")
    if not svd or svd["device_s"] <= 0 or svd["svd_s"] <= 0:
        return None
    return 100.0 * svd["svd_s"] / svd["device_s"]
