"""Multi-device weak-scaling harness.

Counterpart of optimalcontrolmps_tpu/drivers/scaling_bench.py, the
multi-device analogue of the reference's TestRuntimes thread sweep (1, 2,
4, 8 threads): the sharded multistart train step
(`parallel.multistart.make_train_step`) on sub-meshes of 1, 2, 4 and 8
ranks that fit the world, with the per-rank batch held fixed. It reports
the step time, ramps per second and the parallel efficiency against one
rank (perfect weak scaling = 1.0). complex64 on the card, complex128 on
the CPU.

Run it under torchrun, one rank per card (NCCL):

    torchrun --nproc_per_node=N -m optimalcontrolmps_torch.drivers.scaling_bench [per_device_batch]

Without torchrun it runs a world of one rank on the card. In Python, call
`run()` inside an initialized world (`parallel.mesh.init_distributed`, or
`parallel.spawn.run_world`): every rank calls it and gets the same rows.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["run", "main"]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(per_device_batch: int = 64, device_counts=None, T: float = 0.1,
        L: int = 3, d: int = 2, npart: int = 3, chi: int = 6, M: int = 4,
        with_hessian: bool = False, steps: int = 3) -> dict:
    from .. import control, groundstate, seeds, tebd
    from ..parallel.mesh import compute_device, make_mesh
    from ..parallel.multistart import make_train_step

    world, me = dist.get_world_size(), dist.get_rank()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= world]
    dev = compute_device()
    dt = 0.01
    N = int(round(T / dt)) + 1
    dtype = torch.complex64 if dev.type == "cuda" else torch.complex128
    real = dtype.to_real()
    st = tebd.make_stepper(L, d, 1.0, dt, chi, dtype=dtype, device=dev)
    psi_i = groundstate.initialize_state(L, d, npart, 1.0, 2.5, chi,
                                         dtype=dtype, device=dev)
    psi_f = groundstate.initialize_state(L, d, npart, 1.0, 50.0, chi,
                                         dtype=dtype, device=dev)
    basis = control.chopped_sine_basis(
        seeds.adiabatic_seed(2.5, 50.0, N), dt, T, M, dtype=real,
        device=dev)

    rows = []
    base_rate = None
    for nd in device_counts:
        mesh = make_mesh(nd)
        row = [None]
        if mesh is not None:
            step, shard = make_train_step(st, psi_i, psi_f, basis,
                                          gamma=1e-6, lr=10.0, mesh=mesh,
                                          with_hessian=with_hessian)
            B = per_device_batch * nd
            rng = np.random.default_rng(0)
            cs = shard(rng.normal(0.0, 0.1, (B, basis.M)))
            step(cs)        # warm-up
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(steps):
                cs = step(cs)[0]
            _sync(dev)
            wall = (time.perf_counter() - t0) / steps
            row = [{"devices": nd, "batch": B, "time_per_step": wall,
                    "ramps_per_s": B / wall}]
        dist.broadcast_object_list(row, src=0)
        r = row[0]
        if base_rate is None:
            base_rate = r["ramps_per_s"]
        r["efficiency"] = r["ramps_per_s"] / (base_rate * nd)
        rows.append(r)
        if me == 0:
            print(f"devices={nd:2d} batch={r['batch']:5d} "
                  f"step={r['time_per_step'] * 1e3:8.1f}ms "
                  f"ramps/s={r['ramps_per_s']:10.1f} "
                  f"weak-scaling eff={r['efficiency']:6.3f}", flush=True)
    return {"rows": rows, "per_device_batch": per_device_batch,
            "device": str(dev), "dtype": str(dtype)}


def main(argv=None):
    from ..parallel.mesh import init_distributed

    argv = sys.argv[1:] if argv is None else argv
    init_distributed()
    try:
        run(int(argv[0]) if argv else 64)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
