"""Start a world of ranks on this host and collect what each returns.

`run_world(fn, world, backend, device)` starts `world` processes with the
spawn start method (CUDA cannot be forked), joins them into one process
group through a FileStore in a temporary directory (no TCP port to collide
with other runs), calls fn(rank, world, *args) on every rank and returns
the ranks' results in rank order. fn and its results must pickle (a
module-level function; tensors moved to the host). A rank that raises, or
dies, fails the whole world: the others are stopped and RuntimeError
carries the rank's traceback. The world has TIMEOUT seconds from its start
to the last rank's exit; at that deadline the ranks still alive are
killed and joined, and RuntimeError names the ranks that did not report.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import tempfile
import time
import traceback

__all__ = ["run_world", "TIMEOUT"]

TIMEOUT = 600.0     # seconds from the ranks' start to their exit


def _child(fn, rank, world, backend, device, init_method, args, threads,
           out):
    import torch
    import torch.distributed as dist

    from .mesh import init_distributed
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        init_distributed(backend=backend, init_method=init_method,
                         world_size=world, rank=rank, device=device)
        out.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world: int, backend: str = "gloo", device="cpu",
              args: tuple = (), threads: int | None = None) -> list:
    """fn(rank, world, *args) on `world` spawned ranks; their results in
    rank order. device is every rank's compute device (init_distributed's
    `device`: "cpu", "cuda:0" for gloo ranks sharing one card, or None for
    each rank's own card under NCCL); threads sets torch's CPU threads per
    rank. Raises on any rank's failure or after TIMEOUT seconds."""
    ctx = mp.get_context("spawn")
    results, errors = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        out = ctx.Queue()
        procs = [ctx.Process(target=_child, args=(
            fn, r, world, backend, device, f"file://{tmp}/store", args,
            threads, out), daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT
        try:
            while len(results) < world and not errors:
                left = deadline - time.monotonic()
                if left <= 0:
                    late = [r for r in range(world) if r not in results]
                    errors.append(f"rank(s) {late} did not report within "
                                  f"{TIMEOUT} s")
                    break
                try:
                    rank, ok, payload = out.get(timeout=min(1.0, left))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in results]
                    if dead:
                        errors.append(f"rank(s) {dead} died (exit codes "
                                      f"{[procs[r].exitcode for r in dead]})")
                    continue
                if ok:
                    results[rank] = payload
                else:
                    errors.append(f"rank {rank} failed:\n{payload}")
        finally:
            for p in procs:
                if len(results) == world:     # all reported: let them exit
                    p.join(timeout=max(0.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                p.join()
    if errors:
        raise RuntimeError("run_world: " + "\n".join(errors))
    return [results[r] for r in range(world)]
