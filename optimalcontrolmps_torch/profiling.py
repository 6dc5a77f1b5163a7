"""Tracing, timing and propagation accounting.

Counterpart of optimalcontrolmps_tpu/profiling.py without its XLA compile
cache (PyTorch runs eagerly; there is nothing compiled to cache):

* `trace`: a `torch.profiler` window, written as a Chrome trace;
* `annotate`: a named range on that timeline;
* `DeviceTimer`: wall-clock laps that wait for the card's work;
* `PropagationCounter`: the reference's Nprop accounting.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["trace", "DeviceTimer", "PropagationCounter", "annotate"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (the card's kernels too when
    CUDA is available) and write `log_dir/trace.json` (chrome://tracing,
    Perfetto). Yields the profiler, for `key_averages()`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range on the profiler's timeline (record_function)."""
    return torch.profiler.record_function(name)


def _cuda_devices(x, found: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, found)
    return found


class DeviceTimer:
    """Wall-clock laps (perf_counter) that include the card's work: `stop`
    synchronizes every CUDA device that holds one of its outputs (tensors,
    or lists, tuples and dicts of them) before it reads the clock."""

    def __init__(self):
        self.laps = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, *outputs):
        for dev in _cuda_devices(outputs, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.laps.append(dt)
        return dt

    @property
    def total(self):
        return sum(self.laps)

    @property
    def mean(self):
        return self.total / len(self.laps) if self.laps else 0.0


@dataclass
class PropagationCounter:
    """The Nprop column of ProgressCache.txt: a cost is N_t rollout steps,
    a gradient 2 N_t, an exact Hessian adds N_t (N_t - 1) / 2."""
    n_steps: int
    count: int = 0
    history: list = field(default_factory=list)

    def add_cost(self):
        self.count += self.n_steps
        return self

    def add_gradient(self):
        self.count += 2 * self.n_steps
        return self

    def add_hessian(self):
        self.count += self.n_steps * (self.n_steps - 1) // 2
        return self

    def add_iteration(self, ls_trials: int = 0, exact_hessian: bool = False):
        n = self.n_steps * (2 + ls_trials)
        if exact_hessian:
            n += self.n_steps * (self.n_steps - 1) // 2
        self.count += n
        self.history.append(self.count)
        return n
