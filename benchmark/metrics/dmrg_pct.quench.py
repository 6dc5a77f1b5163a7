"""dmrg_pct.quench: the program's `dmrg.search` spans (both ground-state
searches of a driver run) over each unit's wall time (host clock), over
the window's units."""


def read(record):
    s = [u["spans"]["dmrg.search"] / u["wall_s"] for u in record["units"]
         if "dmrg.search" in u["spans"]]
    return 100.0 * sum(s) / len(s) if s else None
