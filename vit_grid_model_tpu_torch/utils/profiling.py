"""Tracing and profiling utilities.

Counterpart of ``vit_grid_model_tpu/utils/profiling.py``:

* ``trace(dir)``: ``torch.profiler`` over the wrapped region (the CPU, and
  the card when there is one), written into ``dir`` as a Chrome/TensorBoard
  trace file;
* ``annotate(name)``: a named region on that timeline
  (``torch.profiler.record_function``);
* ``host_sync(value)``: waits for the device and reads one scalar back;
* ``StepTimer``: steady-state step timing with the warm-up steps left out;
* ``throughput_report``: the items/s summary dict for logs.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np
import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)


@contextlib.contextmanager
def trace(log_dir: str):
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """A named region on the profiler's timeline."""
    return record_function(name)


def _first_tensor(value):
    if isinstance(value, torch.Tensor):
        return value
    items = value.values() if isinstance(value, dict) else (
        value if isinstance(value, (list, tuple)) else ())
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def host_sync(value) -> float:
    """Wait for the device and read one scalar back: the sum of the first
    tensor in ``value`` (a tensor or a nest of dicts, lists and tuples), 0.0
    when it holds none."""
    t = _first_tensor(value)
    if t is None:
        return 0.0
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.detach().sum().float())


class StepTimer:
    """Steady-state step timing with warm-up exclusion and a host sync."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times = []
        self._count = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        out = {}
        yield out
        if "result" in out:
            host_sync(out["result"])
        dt = time.perf_counter() - t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    def p50(self) -> float:
        return (float(np.percentile(self.times, 50)) if self.times
                else float("nan"))


def throughput_report(timer: StepTimer, items_per_step: int,
                      unit: str = "fields") -> Dict[str, float]:
    mean = timer.mean()
    return {
        f"{unit}_per_sec": items_per_step / mean if mean else float("nan"),
        "step_ms_mean": mean * 1e3,
        "step_ms_p50": timer.p50() * 1e3,
        "steps_measured": len(timer.times),
    }
