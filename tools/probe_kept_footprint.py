"""Peak device memory of the host interior point with its trajectories
kept, at a long horizon.

Builds bh_N20_ip's problem (benchmark/configs/bh_N20_ip.json: 20 sites,
8 local states, chi 70, complex128; the benchmark's DMRG boundary states)
with T set to the source's 5, so N_t = 1001, and runs what the driver's
`fgh_host` runs at its start (c = 0 over driver seed 1's ramp): one
`vidal.gradient_segmented`, then `vidal.hessian_streaming` on its aux,
stopped after its first (row block, time block). The Hessian's kept
state (psi_t, xi_t and the dH images of xi_t) is all made by then; later
blocks hold only other row states of the same count.

Prints one JSON line: N_t, the footprint rule's bytes
(`streaming.trajectories_fit`: 3 N_t states) and the free memory it
weighs them against, its verdict, the streaming counters, the seconds of
each phase, and the allocator's peak allocated and reserved bytes after
the gradient and after the first block. An out-of-memory error is
reported in the line, not raised.

Usage: python tools/probe_kept_footprint.py [T] [config.json] [device]
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class _Stop(Exception):
    pass


def _memory(dev, out: dict, tag: str) -> None:
    import torch
    if dev.type != "cuda":
        return
    torch.cuda.synchronize(dev)
    out[f"{tag}_allocated_bytes"] = torch.cuda.memory_allocated(dev)
    out[f"{tag}_peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    out[f"{tag}_peak_reserved_bytes"] = torch.cuda.max_memory_reserved(dev)


def main(argv):
    import torch

    from benchmark import harness
    from benchmark.units.ip_solve import input_group
    from benchmark.units.vidal_gradient import boundary_states
    from optimalcontrolmps_torch import streaming, vidal
    from optimalcontrolmps_torch.drivers import common

    harness.set_cache_dirs()
    T = float(argv[0]) if argv else 5.0
    path = (argv[1] if len(argv) > 1
            else os.path.join(REPO, "benchmark/configs/bh_N20_ip.json"))
    dev = torch.device(argv[2] if len(argv) > 2 else "cuda")
    with open(path) as fh:
        cfg = json.load(fh)
    cfg["T"] = T
    inp = input_group(cfg)
    psi = tuple(vidal.from_mps(A, device=dev)
                for A in boundary_states(cfg, dev))
    p = common.build_problem(inp, seed=cfg["driver"]["seed"],
                             engine="vidal", device=dev, states=psi)
    st, gamma = p.stepper, cfg["gamma"]
    u = p.basis.convert_control(torch.zeros(cfg["M"], dtype=p.basis.f.dtype,
                                            device=dev))
    n = u.shape[0]
    one = vidal.VidalState(p.psi_i.B[None], p.psi_i.lam[None])
    out = {"N_t": n, "device": str(dev),
           "state_bytes": sum(t.numel() * t.element_size() for t in one),
           "rule_bytes": 3 * n * sum(t.numel() * t.element_size()
                                     for t in one)}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
        out["free_bytes"] = (torch.cuda.mem_get_info(dev)[0]
                             + torch.cuda.memory_reserved(dev)
                             - torch.cuda.memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
    out["keeps"] = streaming.trajectories_fit(one, n)
    streaming.reset_counts()

    def stop(c, s):
        raise _Stop

    try:
        t0 = time.perf_counter()
        _, aux = vidal.gradient_segmented(st, p.psi_i, p.psi_f, u, gamma)
        _memory(dev, out, "gradient")
        out["gradient_s"] = time.perf_counter() - t0
        print(f"gradient {out['gradient_s']:.1f} s", file=sys.stderr,
              flush=True)
        t0 = time.perf_counter()
        try:
            vidal.hessian_streaming(
                st, p.psi_i, p.psi_f, u, gamma, aux=aux,
                row_block=cfg["driver"]["hessianRowBlock"], progress=stop)
        except _Stop:
            pass
        _memory(dev, out, "first_block")
        out["first_block_s"] = time.perf_counter() - t0
    except torch.cuda.OutOfMemoryError as e:
        out["out_of_memory"] = str(e).splitlines()[0]
    out.update(kept_trajectories=streaming.kept_trajectories,
               kept_hessians=streaming.kept_hessians,
               replayed_steps=streaming.replayed_steps,
               row_steps=streaming.row_steps)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
