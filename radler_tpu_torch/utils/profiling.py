"""Profiling hooks (an aid the reference lacks — SURVEY.md §5).

Port of ``radler_tpu.utils.profiling``: :func:`trace` captures the enclosed
region with ``torch.profiler`` (the host and, where there is a card, its
kernels) as a Chrome trace, :func:`annotate` names a sub-region in it, and
:class:`PhaseTimer` is a wall-clock timer for host-side breakdowns whose
phases can wait for the card first (:func:`force_sync`).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture the enclosed region and write it to ``log_dir`` as a Chrome
    trace (``trace.json``, readable by ``chrome://tracing`` or Perfetto):

    >>> with profiling.trace("radler-trace"):
    ...     radler.perform(0)

    The CPU is traced always, CUDA where a card is available."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named sub-region inside a trace: a ``record_function`` range, and
    an NVTX range on the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _tensor_leaves(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for value in x.values():
            yield from _tensor_leaves(value)
    elif isinstance(x, (list, tuple)):
        for value in x:
            yield from _tensor_leaves(value)


def force_sync(x) -> None:
    """Wait for every CUDA device that holds a tensor leaf of ``x`` (a
    tensor, or lists, tuples and dicts of them) to finish its queued work;
    CPU tensors need no wait.

    The JAX package's version fetches a value computed from ``x``, because
    its remote-dispatch backend acknowledged an enqueue and not its
    completion; ``torch.cuda.synchronize`` waits for completion, so that
    probe is not ported."""
    devices = {t.device for t in _tensor_leaves(x) if t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulating wall-clock timer for host-side phase breakdowns."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[object] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                force_sync(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name}: {self.totals[name]:.3f}s over {self.counts[name]} "
                "calls"
            )
        return "\n".join(lines)
