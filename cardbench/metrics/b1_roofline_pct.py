"""B1's share of its roofline in linear mode (``kernels/hogbom_step.py``,
``csrc/hogbom_step.cu``), as multiscale's dense subminor loop runs it: the
least time the card could take for the iterations that ran (each a step
over every plane with a weight plane, ``roofline.b1_linear_work``; the
traced runs' minor iterations, not the launches, of which the no-ops that
end a 64-iteration chunk do no work), over the device time of every B1
launch, in percent."""

from cardbench.harness import roofline
from cardbench.harness.trace import seconds

KERNEL = r"hogbom_\w*step\w*_kernel"


def read(ctx):
    events = ctx.kernels(KERNEL)
    iterations = sum(ctx.iterations)
    if not events or not iterations:
        return None
    size = int(ctx.config["image_size"])
    planes = len(ctx.config["channels_mhz"])
    n_bytes, n_flops = roofline.b1_linear_work(planes, size, size,
                                               iterations)
    bound, _ = roofline.bound_s(n_bytes, n_flops, ctx.device_name)
    return 100.0 * bound / seconds(events)
