"""polish_pct: the polish span's share of each unit's wall time (host
clock), over the window's units."""


def read(record):
    s = [u["spans"]["polish"] / u["wall_s"] for u in record["units"]
         if "polish" in u["spans"]]
    return 100.0 * sum(s) / len(s) if s else None
