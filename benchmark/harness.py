"""The benchmark's engine: it finds a cell's files by name, runs its set-up,
its measured window of whole units and, with tracing on, a profiled
sub-window and the kernel probes; then it checks the units' answers
against the plain reference and prints the result.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name `BENCHMARK.json` gives it:

    configs/<config>.json      the configuration as it is run
    traffic/<traffic>.json     the unit's kind (a file of units/) and its
                               parameters
    workloads/<cell>.json      the limits of the numbers compared
    units/<unit>.py            set-up, one unit, probes, the check
    metrics/<metric>.py        read(record) -> value or None
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optimalcontrolmps_tpu")
CACHE = os.path.join(HERE, ".cache")


class Refused(RuntimeError):
    """A run that must print no result."""


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the port may not load, each
    compared whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    modname = "benchmark_" + kind + "_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(workload: str, bench: dict | None = None) -> dict:
    """Everything the harness needs of one cell, read from its files."""
    if bench is None:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; cells: "
                       f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    return {
        "name": workload, "chips": w["chips"],
        "config": load_json(os.path.join(ROOT, conf["file"])),
        "traffic": traffic,
        "limits": load_json(os.path.join(HERE, "workloads",
                                         workload + ".json"))["limits"],
        "unit": traffic["unit"],
        "end_to_end": [m for m in bench["end_to_end"]
                       if _for_cell(m, workload)],
        "per_layer": [m for m in bench["per_layer"]
                      if _for_cell(m, workload)],
    }


def unit_seed(seed: int, k: int) -> int:
    """A 32-bit seed for unit k of a run with `seed`."""
    return int(np.random.SeedSequence([int(seed), int(k)])
               .generate_state(1)[0])


def sample(seed: int, salt: int, n: int, k: int) -> list:
    """k of range(n), drawn from the seed (sorted)."""
    rng = np.random.default_rng([int(seed), int(salt)])
    return sorted(int(i) for i in rng.choice(n, size=min(k, n),
                                             replace=False))


class Spans:
    """Named spans around the benchmark's calls into the program: each is a
    range on the profiler's timeline (`profiling.annotate`) that waits for
    the device at its end and adds its wall time to `seconds`."""

    def __init__(self, device):
        from optimalcontrolmps_torch.profiling import annotate
        self._annotate = annotate
        self.device = device
        self.seconds: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        with self._annotate("bench." + name):
            yield
            sync(self.device)
        self.seconds[name] = self.seconds.get(name, 0.0) + \
            time.perf_counter() - t0


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` back-to-back calls, by CUDA
    events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# the profiled sub-window
# ---------------------------------------------------------------------------

def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(prof, t0_ns: int, t1_ns: int) -> dict:
    """Device busy time, the eigensolver's share, the top device operations
    and the idle gaps by the host's open spans, from the profiler's events
    between t0_ns and t1_ns (host clock, ns)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, dev = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if e.is_user_annotation() or e.name().startswith("bench."):
                continue
            dev.append((s, s + d, e.name(), e.linked_correlation_id()))
        elif e.linked_correlation_id() == 0:
            # operations and spans; runtime calls (cudaLaunchKernel ...)
            # carry the link of the operation that made them
            ops.append((s, s + d, e.name(), e.correlation_id(),
                        e.start_thread_id()))
    dev = [(max(s, t0_ns), min(e, t1_ns), n, c) for s, e, n, c in dev
           if e > t0_ns and s < t1_ns]
    busy = _union([(s, e) for s, e, _, _ in dev])
    busy_ns = sum(e - s for s, e in busy)

    # kernels launched from inside an eigensolver op (by the launching op's
    # host time, on its thread)
    by_corr = {c: (s, th) for s, e, n, c, th in ops}
    eigh = {}
    for s, e, n, c, th in ops:
        if "eigh" in n:
            eigh.setdefault(th, []).append((s, e))
    eigh = {th: _union(v) for th, v in eigh.items()}
    eigh_ns, matched = 0, {}
    for s, e, n, c in dev:
        at = by_corr.get(c)
        if at is None or at[1] not in eigh:
            continue
        iv = eigh[at[1]]
        k = bisect.bisect_right(iv, [at[0], float("inf")]) - 1
        if k >= 0 and iv[k][0] <= at[0] <= iv[k][1]:
            eigh_ns += e - s
            short = n.split("<")[0].split("(")[0].replace("void ", "")
            matched[short] = matched.get(short, 0) + 1
    eigh_ops = sorted({n for s, e, n, c, th in ops if "eigh" in n})

    per_op = {}
    for s, e, n, c in dev:
        per_op[n] = per_op.get(n, 0) + (e - s)
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps inside the window, named by the innermost benchmark span and
    # the innermost operation open on the host at the gap's middle
    gaps, prev = [], t0_ns
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1_ns > prev:
        gaps.append((prev, t1_ns))
    ops.sort()
    spans = [o for o in ops if o[2].startswith("bench.")]
    inner = [o for o in ops if not o[2].startswith("bench.")]
    by_name: dict = {}
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)

    def sweep(events):
        names, stack, j = [], [], 0
        for t, _ in mids:
            while j < len(events) and events[j][0] <= t:
                stack.append(events[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            names.append(stack[-1][2] if stack else "")
        return names

    for (t, w), sp, op in zip(mids, sweep(spans), sweep(inner)):
        key = f"{sp or 'outside spans'} | {op or 'no op'}"
        by_name[key] = by_name.get(key, 0) + w
    idle = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (t1_ns - t0_ns) / 1e9, "busy_s": busy_ns / 1e9,
        "device_s": sum(e - s for s, e, _, _ in dev) / 1e9,
        "eigh_s": eigh_ns / 1e9, "eigh_ops": eigh_ops,
        "eigh_kernels": dict(sorted(matched.items(), key=lambda kv: -kv[1])),
        "device_ops": [[n, v / 1e9] for n, v in top],
        "idle_gaps": [[n, v / 1e9] for n, v in idle],
    }


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_process: float) -> dict:
    """Set-up, the window, the trace, the check. Returns the record the
    metric readers read, with the compared numbers and `correct`."""
    import torch
    cfg, traffic = spec["config"], spec["traffic"]
    unit = load_module("units", spec["unit"])
    spans = Spans(device)
    on_card = torch.device(device).type == "cuda"
    tracing = trace and on_card
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    before = _made_files()
    ctx = unit.setup(cfg, traffic, seed, device, spans)
    sync(device)

    record = {"cell": spec["name"], "config": cfg, "traffic": traffic,
              "units": [], "trace": None, "probes": None}
    answers = []
    prof = None
    t_w0 = time.perf_counter()
    record["setup_s"] = t_w0 - t_process
    # what set-up built or cached anew: only a checkout's first run does
    record["built"] = sorted(_made_files() - before)
    t_end, last, k = t_w0, 0.0, 0
    # whole units back to back; none starts that the last one's length says
    # cannot end inside the window. A traced run profiles the units after
    # the first, and at least one.
    while k == 0 or (t_end - t_w0) + last <= seconds or (
            tracing and prof is None):
        if tracing and k == 1:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            trace_t0 = time.time_ns()
        spans.seconds = {}
        t_u = time.perf_counter()
        out = unit.run(ctx, k, spans)
        sync(device)
        t_end = time.perf_counter()
        last = t_end - t_u
        record["units"].append({"wall_s": last, "work": out["work"],
                                "counts": out.get("counts", {}),
                                "spans": dict(spans.seconds)})
        answers.append(out["answers"])
        k += 1
    record["window_s"] = t_end - t_w0
    if prof is not None:
        trace_t1 = time.time_ns()
        prof.stop()
        record["trace"] = reduce_trace(prof, trace_t0, trace_t1)
        del prof
    if forbidden_modules():
        raise Refused("after the window, sys.modules holds "
                      + ", ".join(forbidden_modules()))
    if tracing and hasattr(unit, "probes"):
        record["probes"] = unit.probes(ctx)
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if on_card else 0)
    unit.release(ctx)
    del ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = unit.check(cfg, traffic, seed, answers, device)
    record["check_s"] = time.perf_counter() - t_check
    record["compared"] = {name: {"value": readings[name],
                                 "limit": spec["limits"][name]}
                          for name in spec["limits"]}
    over = [n for n, v in record["compared"].items()
            if not (np.isfinite(v["value"]) and v["value"] <= v["limit"])]
    record["correct"] = not over
    record["attempted"] = len(answers)
    record["failed"] = len(over)
    return record


def _made_files() -> set:
    """The kernel builds and the benchmark's caches inside the checkout."""
    out = set()
    for top in (os.path.join(ROOT, "optimalcontrolmps_torch", "build"),
                CACHE):
        for d, _, files in os.walk(top):
            out |= {os.path.relpath(os.path.join(d, f), ROOT) for f in files
                    if not f.endswith(".tmp") and ".tmp." not in f}
    return out


def metrics(spec: dict, record: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on), each from its reader; a reader that finds nothing is left
    out."""
    out = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(spec: dict, record: dict, trace: bool, device_name: str,
                chips: int) -> dict:
    device = {"platform": "gpu", "kind": device_name, "count": chips,
              "memory_peak_bytes": int(record["memory_peak_bytes"])}
    line = {"correct": bool(record["correct"]),
            "attempted": record["attempted"], "failed": record["failed"],
            "metrics": metrics(spec, record, trace), "device": device}
    if trace and record["trace"] is not None:
        tr = record["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["compared"] = record["compared"]
    return line


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
