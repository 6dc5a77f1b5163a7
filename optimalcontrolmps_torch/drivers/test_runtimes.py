"""Runtime tables: the reference's TestRuntimes driver.

Counterpart of optimalcontrolmps_tpu/drivers/test_runtimes.py:

    python -m optimalcontrolmps_torch.drivers.test_runtimes

The reference times cost+gradient and the exact Hessian for T in {1, 2, 3}
at thread counts {1, 2, 4, 8} (N=5, Npart=5, d=5, maxM 40, tstep 1e-2).
The scaling axis here is the batch of controls: the TEBD engine's
`gradient` takes the (B, N_t) batch, and the Hessian is evaluated per
control. The tables give wall seconds per evaluation (`DeviceTimer`, after
one untimed warm-up per horizon), then the cost at every batch size.
"""

from __future__ import annotations

import sys

import torch

from .. import engine, groundstate, seeds, tebd
from ..device import resolve_device
from ..precision import enforce_matmul_precision
from ..profiling import DeviceTimer
from ..streaming import infidelity_cost
from .common import J_HOP, U_FINAL, U_INITIAL, default_dtype, effective_chi

__all__ = ["run", "main"]


def run(horizons=(1.0, 2.0, 3.0), batches=(1, 2, 4, 8), dtype=None,
        with_hessian=True, device=None) -> dict:
    """dtype None: complex128 on the CPU, complex64 on the card."""
    enforce_matmul_precision()
    device = resolve_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    real = torch.float64 if dtype == torch.complex128 else torch.float32

    L, npart, d, tstep, maxm = 5, 5, 5, 1e-2, 40
    chi = effective_chi(maxm, L, d + 1)
    st = tebd.make_stepper(L, d, J_HOP, tstep, chi, dtype=dtype,
                           device=device)
    psi_i, psi_f = (groundstate.initialize_state(L, d, npart, J_HOP, u, chi,
                                                 dtype=dtype, device=device)
                    for u in (U_INITIAL, U_FINAL))

    def cost_grad(us):
        g, (_, _, _, ov) = engine.gradient(st, psi_i, psi_f, us, 0.0)
        return infidelity_cost(ov), g

    def hessians(us):
        return [engine.hessian(st, psi_i, psi_f, u, 0.0) for u in us]

    grad_rows, hess_rows, costs, batch_costs = [], [], {}, {}
    for T in horizons:
        n = int(T / tstep + 1)
        u = torch.as_tensor(seeds.adiabatic_seed(U_INITIAL, U_FINAL, n),
                            dtype=real, device=device)
        warm = cost_grad(u[None])
        if with_hessian:
            warm = (warm, hessians(u[None]))
        DeviceTimer().start().stop(warm)     # waits for the warm-up
        row_g, row_h, batch_costs[T] = [T], [T], []
        for B in batches:
            us = u[None].expand(B, n).contiguous()
            timer = DeviceTimer().start()
            J, g = cost_grad(us)
            row_g.append(timer.stop(J, g) / B)
            batch_costs[T].append(J.cpu().numpy())
            costs[T] = float(J[0])
            if with_hessian:
                timer = DeviceTimer().start()
                row_h.append(timer.stop(hessians(us)) / B)
        grad_rows.append(row_g)
        hess_rows.append(row_h)

    def table(title, rows):
        print(f"\n=== {title} (seconds per evaluation) ===")
        print("T\t" + "\t".join(f"batch={b}" for b in batches))
        for r in rows:
            print("\t".join(f"{v:.4g}" for v in r))

    table("Cost+gradient wall time", grad_rows)
    if with_hessian:
        table("Exact Hessian wall time", hess_rows)

    print("\n=== Cost consistency (same value at all batch sizes) ===")
    for T, c in costs.items():
        print(f"T={T}: cost = {c:.10f}")
    return {"grad": grad_rows, "hess": hess_rows, "costs": costs,
            "batch_costs": batch_costs}


def main(argv=None):
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
