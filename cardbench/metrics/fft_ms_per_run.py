"""cuFFT's device time a run (``ops/convolution.py`` and the multiscale
loop's transforms): the traced stretch's kernels whose names are cuFFT's,
summed, over the traced runs, in milliseconds."""

from cardbench.harness.trace import seconds

CUFFT = r"fft|radix"


def read(ctx):
    events = ctx.kernels(CUFFT)
    if not events or not ctx.runs:
        return None
    return seconds(events) * 1e3 / ctx.runs
