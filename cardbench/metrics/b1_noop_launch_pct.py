"""B1's launches that do nothing, in linear mode as multiscale's dense
subminor loop runs it (``kernels/hogbom_step.py``, ``csrc/hogbom_step.cu``):
the Högbom loop enqueues 64 iterations between two host reads, and those
enqueued after the loop stopped on the card return at once.  The share of
the traced stretch's enqueued iterations that were such no-ops, in percent.

The probe reads the program's counters ``run_chunks.enqueued`` and
``run_chunks.noops`` as it is installed and as it is removed; it wraps
nothing.  A program without them gives no record, and the metric none.
"""

import contextlib
import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class B1Counts:
    enqueued: int
    noops: int


def _counters() -> Optional[Tuple[int, int]]:
    from radler_tpu_torch.kernels import hogbom_step

    loop = hogbom_step.run_chunks
    enqueued = getattr(loop, "enqueued", None)
    noops = getattr(loop, "noops", None)
    if not isinstance(enqueued, int) or not isinstance(noops, int):
        return None
    return enqueued, noops


class B1NoopProbe:
    def __init__(self):
        self.counts: List[B1Counts] = []
        self.run = 0

    @contextlib.contextmanager
    def installed(self):
        before = _counters()
        try:
            yield self
        finally:
            after = _counters()
            if before is not None and after is not None:
                self.counts.append(B1Counts(after[0] - before[0],
                                            after[1] - before[1]))

    def settle(self, run_iterations) -> List[B1Counts]:
        return self.counts


def probe():
    return B1NoopProbe()


def read(ctx):
    counts = ctx.probes.get("b1_noop_launch_pct", [])
    enqueued = sum(c.enqueued for c in counts)
    if not enqueued:
        return None
    return 100.0 * sum(c.noops for c in counts) / enqueued
