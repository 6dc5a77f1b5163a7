"""hessian_rows_pct.ip: the program's `hessian.rows` span (the exact
Hessian's row steps and their overlaps) over each unit's wall time (host
clock), over the window's units."""


def read(record):
    s = [u["spans"]["hessian.rows"] / u["wall_s"] for u in record["units"]
         if "hessian.rows" in u["spans"]]
    return 100.0 * sum(s) / len(s) if s else None
