"""dmrg_matvecs.quench: the two-site H_eff applications of both searches
per unit (the program's `dmrg.matvecs` counter), over the window's
units."""


def read(record):
    t = [u["counts"]["dmrg_matvecs"] for u in record["units"]
         if "dmrg_matvecs" in u["counts"]]
    return sum(t) / len(t) if t else None
