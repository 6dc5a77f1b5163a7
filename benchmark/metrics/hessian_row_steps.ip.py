"""hessian_row_steps.ip: the exact Hessian's row steps per unit (rows times
Trotter steps, the program's `streaming.row_steps` counter), over the
window's units."""


def read(record):
    t = [u["counts"]["row_steps"] for u in record["units"]
         if "row_steps" in u["counts"]]
    return sum(t) / len(t) if t else None
