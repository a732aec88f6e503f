"""The traced window: torch.profiler over the window's work, reduced to
what the per-layer readers and the result's ``breakdown`` read.

On the card the profiler records CUDA activity alone: the device's
operations and the host's CUDA calls, not every ATen operation on the
host, whose cost per operation would slow the host and open idle gaps on
the device that the untraced window does not have.  The window runs from
the end of the device synchronise before the work to the end of the one
after it (``cudaDeviceSynchronize`` in the trace), so every operation the
window queued lies inside it.  Without a card (the tests) the host's
operations are recorded and the window is the host span
``gridbench.window``.  Busy time is the union of the device intervals
inside the window; an idle gap is a stretch of the window with none,
named by the innermost host call that spans its middle.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "gridbench.window"
SYNC = "cudaDeviceSynchronize"

Event = Tuple[str, int, int]          # (name, start ns, end ns)


def short_name(name: str) -> str:
    """A kernel's function name without return type, namespace, template
    arguments or parameters."""
    name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", name)
    return name.split("<")[0].split("(")[0].strip() or name


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


@dataclass
class Trace:
    start: int
    end: int
    device: List[Event]               # every device operation in the window
    host: List[Event]                 # host operations, or CUDA calls
    cuda: bool = False                # the host events are CUDA calls
    units: Dict[str, float] = field(default_factory=dict)
    cell: dict = field(default_factory=dict)
    #: the end-to-end metrics of the untraced window run before the trace
    rates: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    @property
    def kernels(self) -> List[Event]:
        return [e for e in self.device if not _is_copy(e[0])]

    def _union(self) -> List[Tuple[int, int]]:
        spans: List[Tuple[int, int]] = []
        for _, s, e in sorted(self.device, key=lambda ev: ev[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if spans and s <= spans[-1][1]:
                spans[-1] = (spans[-1][0], max(spans[-1][1], e))
            else:
                spans.append((s, e))
        return spans

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._union()) * 1e-9

    def kernel_s(self, patterns) -> float:
        """Seconds of the kernels whose name matches any of the regular
        expressions."""
        rx = [re.compile(p) for p in patterns]
        return sum(e - s for name, s, e in self.kernels
                   if any(r.search(name) for r in rx)) * 1e-9

    def launches(self) -> int:
        return len(self.kernels)

    def top_ops(self, k: int = 10) -> List[list]:
        totals: Dict[str, int] = {}
        for name, s, e in self.device:
            key = short_name(name)
            totals[key] = totals.get(key, 0) + (e - s)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns * 1e-9] for name, ns in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        gaps, at = [], self.start
        for s, e in self._union():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.end > at:
            gaps.append((at, self.end))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted((e for e in self.host if e[0] != WINDOW),
                      key=lambda ev: ev[1])
        starts = [e[1] for e in host]
        out = []
        for s, e in gaps[:k]:
            mid = (s + e) // 2
            label = "host (no CUDA call)" if self.cuda else \
                "host (no operation)"
            best = None
            for name, hs, he in host[:bisect.bisect_right(starts, mid)]:
                if he >= mid and (best is None or hs >= best):
                    best, label = hs, name
            out.append([label, (e - s) * 1e-9])
        return out


def _raw_events(prof) -> Tuple[List[Event], List[Event]]:
    """(device, host) events of a finished profile."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation() or name.startswith("gridbench."):
                continue
            device.append((name, s, e))
        else:
            host.append((name, s, e))
    return device, host


def _bounds(device: List[Event], host: List[Event], cuda: bool
            ) -> Tuple[int, int]:
    """(start, end) of the window: on the card the end of the last
    synchronise that ended before the first device operation, and of the
    first that ended after the last; else the window's host span."""
    if not cuda:
        spans = [e for e in host if e[0] == WINDOW]
        if not spans:
            raise RuntimeError("the profiler recorded no window span")
        return spans[0][1], spans[0][2]
    syncs = sorted(e[2] for e in host if e[0] == SYNC)
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    first = min(e[1] for e in device)
    last = max(e[2] for e in device)
    before = [t for t in syncs if t <= first]
    after = [t for t in syncs if t >= last]
    if not before or not after:
        raise RuntimeError("the profiler recorded no synchronise around "
                           "the window")
    return before[-1], after[0]


def traced(work: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Run ``work`` under the profiler between two device synchronises
    (``sync``), inside the window span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            sync()
            work()
            sync()
    device, host = _raw_events(prof)
    start, end = _bounds(device, host, cuda)
    device = [ev for ev in device if ev[2] > start and ev[1] < end]
    host = [ev for ev in host if ev[2] > start and ev[1] < end]
    return Trace(start, end, device, host, cuda=cuda)


def breakdown(trace: Trace) -> Optional[dict]:
    if not trace.device:
        return None
    return {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
