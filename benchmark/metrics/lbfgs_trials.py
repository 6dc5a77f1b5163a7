"""lbfgs_trials: lockstep line-search trials per multistart batch, as
forward sector-chain launches (the program's counter), over the window's
units."""


def read(record):
    t = [u["counts"]["trials"] for u in record["units"]]
    return sum(t) / len(t) if t and sum(t) > 0 else None
