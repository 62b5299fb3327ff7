"""The card's idle time a run that the entry layer holds it back
(``radler.py`` ``Radler.perform``): the idle time inside the program's
``radler.perform`` spans and outside its ``radler.algorithm`` spans (the
loads, the noise estimate, the thresholds, the store), over the traced
runs, in milliseconds."""

from cardbench.harness import spans


def read(ctx):
    perform = spans.intervals(ctx, "radler.perform")
    if not perform or not ctx.runs:
        return None
    algorithm = spans.intervals(ctx, "radler.algorithm")
    return spans.idle_s(ctx, perform, algorithm) * 1e3 / ctx.runs
