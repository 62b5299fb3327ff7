"""The Clark route's candidate selection a run
(``models/subminor.py`` ``SubMinorLoop.find_peak_positions``): the
program's ``clark.select`` spans, summed, over the traced runs, in
milliseconds.  A span starts after the initial peak's host read has
drained the queue and ends at ``torch.nonzero``'s read, so it holds the
selection's own host and card work and nothing queued before it."""

from cardbench.harness import spans, stats


def read(ctx):
    select = spans.intervals(ctx, "clark.select")
    if not select or not ctx.runs:
        return None
    return stats.covered(select) * 1e-3 / ctx.runs
