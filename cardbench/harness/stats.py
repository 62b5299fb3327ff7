"""The end-to-end arithmetic: rates, percentiles, spreads, and the union of
the device's busy intervals."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple


def rate(total: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0.0:
        raise ValueError("a window of no length")
    return total / seconds


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile of every value, interpolated between the two
    nearest order statistics (``statistics.quantiles`` inclusive); a single
    value is its own percentile."""
    values = list(values)
    if not values:
        raise ValueError("no values")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union(intervals: Iterable[Tuple[float, float]],
          clip: Tuple[float, float] = None) -> List[Tuple[float, float]]:
    """The disjoint, sorted union of ``(start, end)`` intervals, each cut
    to ``clip`` when given."""
    spans = []
    for start, end in intervals:
        if clip is not None:
            start, end = max(start, clip[0]), min(end, clip[1])
        if end > start:
            spans.append((start, end))
    spans.sort()
    merged: List[Tuple[float, float]] = []
    for start, end in spans:
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def covered(intervals: Iterable[Tuple[float, float]]) -> float:
    return sum(end - start for start, end in intervals)


def gaps(merged: List[Tuple[float, float]],
         window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The stretches of ``window`` that no interval of ``merged`` (from
    :func:`union` with that clip) covers."""
    out, at = [], window[0]
    for start, end in merged:
        if start > at:
            out.append((at, start))
        at = max(at, end)
    if window[1] > at:
        out.append((at, window[1]))
    return out
