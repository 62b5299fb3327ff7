"""Host syncs a run (entry layer, ``radler.py`` ``Radler.perform``): the
operations that CUDA's sync debug mode warns about (reads to the host,
blocking copies) over whole runs, a mean over the counted runs."""


def read(ctx):
    if not ctx.syncs:
        return None
    return sum(ctx.syncs) / len(ctx.syncs)
