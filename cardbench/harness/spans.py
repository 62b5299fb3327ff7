"""The program's spans in the traced run: the intervals that the spans of
one name cover, and the card's idle time inside them.

The port opens ``record_function`` ranges at its layer boundaries
(``radler.perform``, ``clark.select``, ``multiscale.loop``, ...); they are
host events of the profiler's trace, on the clock of the device's events.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from . import stats

Intervals = List[Tuple[float, float]]


def intervals(ctx, name: str) -> Intervals:
    """The disjoint, sorted union of the spans named ``name``, cut to the
    window."""
    return stats.union(((e.start, e.end) for e in ctx.host
                        if e.name == name), clip=ctx.window)


def intersect(a: Sequence[Tuple[float, float]],
              b: Sequence[Tuple[float, float]]) -> Intervals:
    """The intersection of two disjoint, sorted interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        start, end = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if end > start:
            out.append((start, end))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_s(ctx, inside: Intervals, outside: Intervals = ()) -> float:
    """The card's idle time (the window's stretches that no device
    interval covers) inside ``inside`` and outside ``outside``, in
    seconds."""
    busy = stats.union(((e.start, e.end) for e in ctx.device),
                       clip=ctx.window)
    idle = intersect(stats.gaps(busy, ctx.window), inside)
    return (stats.covered(idle)
            - stats.covered(intersect(idle, list(outside)))) * 1e-6
