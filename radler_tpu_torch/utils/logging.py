"""Leveled logging (equivalent of aocommon::Logger + ControllableLog).

The reference's per-sub-image ``SubImageLogSet`` unmutes only the most
central active facet (``cpp/logging/subimage_logset.h``); here facet logs are
tagged with their index and filtered by level.  Set ``RADLER_TPU_LOG`` to
``debug``/``info``/``warn``/``error``/``none`` (default ``warn``).
"""

from __future__ import annotations

import os
import sys

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40, "none": 100}


def _threshold() -> int:
    return _LEVELS.get(os.environ.get("RADLER_TPU_LOG", "warn").lower(), 30)


def is_enabled(level: str) -> bool:
    """Whether messages at ``level`` are emitted — lets callers skip
    building expensive log arguments (e.g. device scalar pulls)."""
    return _threshold() <= _LEVELS.get(level, 30)


def debug(msg: str) -> None:
    if _threshold() <= 10:
        print(f"[radler-tpu debug] {msg}", file=sys.stderr)


def info(msg: str) -> None:
    if _threshold() <= 20:
        print(f"[radler-tpu] {msg}", file=sys.stderr)


def warn(msg: str) -> None:
    if _threshold() <= 30:
        print(f"[radler-tpu WARNING] {msg}", file=sys.stderr)


def error(msg: str) -> None:
    if _threshold() <= 40:
        print(f"[radler-tpu ERROR] {msg}", file=sys.stderr)


class FacetLog:
    """Tagged logger for one facet (equivalent of ``ControllableLog``)."""

    def __init__(self, index: int):
        self.index = index
        self.muted = False

    def info(self, msg: str) -> None:
        if not self.muted:
            info(f"[facet {self.index}] {msg}")

    def warn(self, msg: str) -> None:
        warn(f"[facet {self.index}] {msg}")
