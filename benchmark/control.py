"""The readings that a cell's limits are set from, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control <k>] [--fault <name>]

One set-up, then for each seed a short window of whole units (at least
one) with that seed's inputs, and the check's numbers for the program and,
for the first k seeds (all by default), for the control: the plain
reference put in the program's place one precision below the
configuration's (the units' `check(control=True)`). With --fault, the
program runs with that fault of `benchmark/faults.py` planted. One JSON
line per seed, with each unit's wall seconds. The benchmark's own runs
never run the control or a fault.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(spec, unit, ctx, seed, seconds, device, control):
    """(program readings, control readings or None, units' walls)."""
    from benchmark import harness
    ctx.seed = seed
    answers, walls, t0 = [], [], time.perf_counter()
    while not walls or time.perf_counter() - t0 < seconds:
        t_u = time.perf_counter()
        answers.append(unit.run(ctx, len(walls), harness.Spans(device))
                       ["answers"])
        harness.sync(device)
        walls.append(time.perf_counter() - t_u)
    prog = unit.check(spec["config"], spec["traffic"], seed, answers, device)
    ctl = (unit.check(spec["config"], spec["traffic"], seed, answers, device,
                      control=True) if control else None)
    return prog, ctl, walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=None,
                    help="how many of the seeds also get the control")
    ap.add_argument("--fault", default=None,
                    help="a fault of benchmark/faults.py to plant")
    args = ap.parse_args(argv)

    from benchmark import harness
    from benchmark.faults import planted
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    unit = harness.load_module("units", spec["unit"])
    device = torch.device("cuda", 0)
    n_control = len(args.seeds) if args.control is None else args.control
    with planted(args.workload, args.fault):
        ctx = unit.setup(spec["config"], spec["traffic"], args.seeds[0],
                         device, harness.Spans(device))
        for i, seed in enumerate(args.seeds):
            prog, ctl, walls = readings(spec, unit, ctx, seed, args.seconds,
                                        device, i < n_control)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": args.fault, "walls": walls,
                              "program": prog, "control": ctl,
                              "limits": spec["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
