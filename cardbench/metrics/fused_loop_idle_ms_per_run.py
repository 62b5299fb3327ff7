"""The card's idle time a run inside multiscale's fused loop
(``models/multiscale_fused.py``): the idle time inside the program's
``multiscale.loop`` spans (the host's pacing of the loop: its decisions,
maxima reads and dense-loop chunk reads; the banks' set-up and the
perform's loads and stores left out), over the traced runs, in
milliseconds."""

from cardbench.harness import spans


def read(ctx):
    loop = spans.intervals(ctx, "multiscale.loop")
    if not loop or not ctx.runs:
        return None
    return spans.idle_s(ctx, loop) * 1e3 / ctx.runs
