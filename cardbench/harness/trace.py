"""The traced run: the profiler's device timeline over a stretch of whole
runs, and what the per-layer metrics read from it.

``torch.profiler`` (CUPTI) records every kernel, copy and set on the card
and the host's operations; the trace is written to a temporary file,
parsed, and deleted.  The window is the span of the benchmark's own
annotation around the stretch.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import stats

WINDOW = "cardbench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")
NAME_CHARS = 160


@dataclasses.dataclass
class Event:
    name: str
    start: float  # microseconds, the profiler's clock
    end: float


@dataclasses.dataclass
class TraceContext:
    """What a metric's reader gets: the traced stretch and the cell."""

    config: dict
    device_name: str
    runs: int  # whole runs in the stretch
    iterations: List[int]  # minor iterations of each traced run
    window: Tuple[float, float]
    device: List[Event]
    host: List[Event]
    probes: Dict[str, list] = dataclasses.field(default_factory=dict)
    syncs: List[int] = dataclasses.field(default_factory=list)

    def kernels(self, pattern: str) -> List[Event]:
        """The device events inside the window whose name matches
        ``pattern`` (a regular expression, case-insensitive)."""
        rx = re.compile(pattern, re.IGNORECASE)
        return [e for e in self.device_in_window() if rx.search(e.name)]

    def device_in_window(self) -> List[Event]:
        lo, hi = self.window
        return [e for e in self.device if e.end > lo and e.start < hi]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self) -> float:
        merged = stats.union(((e.start, e.end) for e in self.device),
                             clip=self.window)
        return stats.covered(merged) * 1e-6


def seconds(events: List[Event]) -> float:
    return sum(e.end - e.start for e in events) * 1e-6


def profile(stretch) -> Tuple[List[Event], List[Event], Tuple[float, float]]:
    """Run ``stretch()`` under the profiler inside the window's annotation;
    returns (device events, host events, window), times in microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            stretch()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return parse(trace)


def parse(trace: dict):
    device, host, window = [], [], None
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ev = Event(e.get("name", ""), float(e["ts"]),
                   float(e["ts"]) + float(e["dur"]))
        cat = e.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            device.append(ev)
        elif cat in HOST_CATEGORIES:
            if ev.name == WINDOW and cat == "user_annotation":
                window = (ev.start, ev.end)
            else:
                host.append(ev)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    return device, host, window


def top_device_ops(ctx: TraceContext, n: int = 10) -> List[list]:
    """The device operations that took the most time, summed by name."""
    total: Dict[str, float] = defaultdict(float)
    for e in ctx.device_in_window():
        total[e.name[:NAME_CHARS]] += (e.end - e.start) * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            ][:n]


def _host_at(host: List[Event], starts: List[float], t: float
             ) -> Optional[str]:
    """The innermost host operation running at ``t``: of nested
    operations, the latest to start (``host`` sorted by start)."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(host[max(0, i - 5000):i]):
        if e.end > t:
            return e.name
    return None


def idle_gaps(ctx: TraceContext, n: int = 10) -> List[list]:
    """The device's idle time in the window, summed by the host operation
    running in the middle of each gap, the largest first."""
    merged = stats.union(((e.start, e.end) for e in ctx.device),
                         clip=ctx.window)
    found = sorted(stats.gaps(merged, ctx.window),
                   key=lambda g: g[0] - g[1])[:2000]
    host = sorted(ctx.host, key=lambda e: e.start)
    starts = [e.start for e in host]
    total: Dict[str, float] = defaultdict(float)
    for start, end in found:
        name = (_host_at(host, starts, 0.5 * (start + end))
                or "host (no op)")
        total[name[:NAME_CHARS]] += (end - start) * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            ][:n]
