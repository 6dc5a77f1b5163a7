"""sector_chain_fwd_roofline: the bound of the forward chain at the
window's (lanes, N_t) over its CUDA-event time (peaks.sector_chain_ms)."""


def read(record):
    p = (record["probes"] or {}).get("sector_chain_fwd")
    return None if p is None else 100.0 * p["bound_ms"] / p["ms"]
