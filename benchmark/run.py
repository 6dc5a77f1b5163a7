"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object; the last lines of standard error give each
number the correctness check compared, beside its limit. Without a CUDA
card (or with fewer cards than the cell asks for) the run fails and prints
no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one process with few threads: the host's cores are shared
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness
    harness.set_cache_dirs()
    spec = harness.cell_spec(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; the benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"benchmark: {spec['name']} needs {spec['chips']} cards, "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)

    try:
        record = harness.run_cell(spec, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0),
                                  T_PROCESS)
    except harness.Refused as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 3
    line = harness.result_line(spec, record, bool(args.trace),
                               torch.cuda.get_device_name(0), spec["chips"])
    if harness.forbidden_modules():
        print("benchmark: sys.modules holds "
              + ", ".join(harness.forbidden_modules()), file=sys.stderr)
        return 3
    if record["trace"] is not None:
        tr = record["trace"]
        print(f"trace: eigensolver ops {tr['eigh_ops']}, kernels matched "
              f"{tr['eigh_kernels']}", file=sys.stderr)
    walls = ", ".join(f"{u['wall_s']:.3f}" for u in record["units"])
    print(f"run: setup {record['setup_s']:.3f} s, window "
          f"{record['window_s']:.3f} s, {record['attempted']} units "
          f"({walls} s), check {record['check_s']:.3f} s", file=sys.stderr)
    if record["built"]:
        # a checkout's first run: its set-up includes these builds
        print("run: set-up made " + ", ".join(record["built"]),
              file=sys.stderr)
    for name, v in record["compared"].items():
        print(f"compared {name} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
