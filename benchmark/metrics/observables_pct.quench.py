"""observables_pct.quench: the program's `observables.window` spans (the
window's correlators at every step) over each unit's wall time (host
clock), over the window's units."""


def read(record):
    s = [u["spans"]["observables.window"] / u["wall_s"]
         for u in record["units"] if "observables.window" in u["spans"]]
    return 100.0 * sum(s) / len(s) if s else None
