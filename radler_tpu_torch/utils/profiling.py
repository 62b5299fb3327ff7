"""Profiling hooks (an aid the reference lacks — SURVEY.md §5).

:func:`trace` captures the enclosed region with ``torch.profiler`` (the host
and, where there is a card, its kernels and copies) as a Chrome trace, and
:func:`annotate` names a span inside whatever profiler is recording.  The
program opens its spans at its layer boundaries (``radler.perform``,
``clark.b2``, ``multiscale.pass``, ...): they are ``record_function``
ranges, so they share the profiler's clock with the device's kernels and
stay in the profiler's memory until it writes its trace.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import ContextManager, Iterator

import torch

# What :func:`annotate` returns while no profiler records: entering it does
# nothing, and one object serves every span.
_NO_SPAN = contextlib.nullcontext()


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


def annotate(name: str) -> ContextManager:
    """A span named ``name`` around the enclosed code: a ``record_function``
    range while a profiler records, else a shared no-op (a flag check, so
    the spans cost nothing measurable in an untraced run; still, none sits
    inside a minor iteration)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
