"""Tracing and profiling utilities.

Counterpart of ``vit_grid_model_tpu/utils/profiling.py``:

* ``annotate(name)``: the program's span, a named range on the profiler's
  timeline.  While no profiler runs it is one shared no-op context, which
  costs the one call that asks; while one runs it is
  ``torch.profiler.record_function``.  Spans nest on a thread, so a
  span's self time is its range less its children's;
* ``trace(dir)``: records the block's spans and, on the card, its CUDA
  calls and kernels on the profiler's one clock, and no ATen operation
  (recording each one slows the host and opened idle gaps of up to 27% on
  the device in training); written into ``dir`` as one Chrome/TensorBoard
  trace file (``*.pt.trace.json``), and kept as events;
* ``span_paths(events)`` and ``kernels_by_span(events)``: the spans of a
  trace with their nesting, and the device time and launches of the
  kernels each span owns;
* ``host_sync(value)``: waits for the device and reads one scalar back;
* ``StepTimer``: steady-state step timing with the warm-up steps left out;
* ``throughput_report``: the items/s summary dict for logs.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import os
import socket
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType, _profiler_enabled
from torch.profiler import record_function

_OFF = contextlib.nullcontext()

#: (path, thread, start ns, end ns) of a span; the path joins the names of
#: the spans that hold it, outermost first, with "/"
Span = Tuple[str, int, int, int]


def annotate(name: str):
    """The span ``name`` over a ``with`` block: a range on the timeline of
    whatever profiler runs, and nothing while none does."""
    if not _profiler_enabled():
        return _OFF
    return record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block (see the module docstring) and write it into
    ``log_dir``.  Yields a list that holds the recorded events once the
    block has ended."""
    from torch._C._autograd import (_disable_profiler, _enable_profiler,
                                    _prepare_profiler)
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, RecordScope,
                                    _ExperimentalConfig)

    cuda = torch.cuda.is_available()
    activities = {ProfilerActivity.CPU}
    if cuda:
        activities.add(ProfilerActivity.CUDA)
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                            False, _ExperimentalConfig())
    _prepare_profiler(config, activities)
    # host ranges of the user scope alone: the spans, not the ATen ops
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    events: list = []
    try:
        yield events
    finally:
        if cuda:
            torch.cuda.synchronize()
        result = _disable_profiler()
        os.makedirs(log_dir, exist_ok=True)
        result.save(os.path.join(
            log_dir, f"{socket.gethostname()}_{os.getpid()}."
            f"{time.time_ns()}.pt.trace.json"))
        events.extend(result.events())


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _open_at(spans: List[Span], starts: List[int], reach: List[int],
             t: int, thread=None):
    """The innermost of ``spans`` (sorted by start; ``reach[i]`` the
    latest end among the first i + 1) open at ``t``, on ``thread`` or on
    any thread; None if none is."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and reach[i] > t:
        if spans[i][3] > t and thread in (None, spans[i][1]):
            return spans[i]
        i -= 1
    return None


def span_paths(events) -> List[Span]:
    """The spans among the profiler's ``events``, sorted by start.  A
    span's parent is the innermost span open at its start on its own
    thread, or else on any thread: a span the autograd engine's thread
    opens (a recompute in the backward) lies in the one its caller holds
    open meanwhile."""
    raw = sorted(((ev.name(), ev.start_thread_id(), ev.start_ns(),
                   ev.start_ns() + ev.duration_ns())
                  for ev in events
                  if ev.device_type() == DeviceType.CPU
                  and ev.is_user_annotation()), key=lambda s: (s[2], -s[3]))
    out: List[Span] = []
    starts: List[int] = []
    reach: List[int] = []
    for name, thread, s, e in raw:
        parent = (_open_at(out, starts, reach, s, thread)
                  or _open_at(out, starts, reach, s))
        out.append((f"{parent[0]}/{name}" if parent else name, thread, s, e))
        starts.append(s)
        reach.append(max(e, reach[-1]) if reach else e)
    return out


def kernels_by_span(events) -> Dict[str, List]:
    """{span path: [seconds, launches]} of the device kernels (copies and
    fills left out) among the profiler's ``events``, each counted in the
    one span that owns it; "" holds those no span owns.

    A kernel belongs to the innermost span that was open on its launching
    thread when its launch call (the host event of its correlation id)
    began.  A launch on a thread with no span open, the autograd engine's,
    belongs to the innermost span open at that moment on any thread, which
    is the one the thread that called into autograd holds."""
    spans = span_paths(events)
    starts = [s[2] for s in spans]
    reach = list(itertools.accumulate((s[3] for s in spans), max))
    calls = {ev.correlation_id(): (ev.start_ns(), ev.start_thread_id())
             for ev in events if ev.device_type() == DeviceType.CPU
             and not ev.is_user_annotation()}
    table: Dict[str, List] = {}
    for ev in events:
        if (ev.device_type() != DeviceType.CUDA or ev.is_user_annotation()
                or _is_copy(ev.name())):
            continue
        owner = None
        if ev.correlation_id() in calls:
            t, thread = calls[ev.correlation_id()]
            owner = (_open_at(spans, starts, reach, t, thread)
                     or _open_at(spans, starts, reach, t))
        row = table.setdefault(owner[0] if owner else "", [0.0, 0])
        row[0] += ev.duration_ns() * 1e-9
        row[1] += 1
    return table


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
