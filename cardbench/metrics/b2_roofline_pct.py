"""B2's share of its roofline (``kernels/subminor_loop.py``,
``csrc/subminor_loop.cu``): the least time the card could take for the
work the Clark subminor runs needed (``roofline.b2_work``, with N, K and
each call's iterations from this metric's probe), over the device time of
the ``subminor_loop_kernel`` launches, in percent.

The probe wraps the port's Python entry ``subminor_loop`` as the Clark
route calls it (``radler_tpu_torch.models.subminor.subminor_loop``) in the
traced runs, and records each call's planes N, candidates K, starting
iteration and fit constants, and the run it belongs to.  The iterations a
call ran follow from the next call's start, or from the run's final count.
"""

import contextlib
import dataclasses
from typing import Dict, List

from cardbench.harness import roofline
from cardbench.harness.trace import seconds

KERNEL = r"subminor_loop_kernel"


@dataclasses.dataclass
class B2Call:
    run: int
    n_planes: int
    k: int
    start: int
    fit_bytes: int
    iterations: int = 0


class B2Probe:
    def __init__(self):
        self.calls: List[B2Call] = []
        self.run = 0

    @contextlib.contextmanager
    def installed(self):
        from radler_tpu_torch.models import subminor as module

        real = module.subminor_loop

        def recording(residual_k, model_k, rms_k, xs, ys, psfs, coef, fit,
                      params, **kwargs):
            fit_bytes = 0
            if fit is not None:
                fit_bytes = sum(t.numel() * t.element_size()
                                for t in fit if hasattr(t, "numel"))
            self.calls.append(B2Call(
                run=self.run, n_planes=residual_k.shape[0],
                k=residual_k.shape[1], start=int(params.start_iteration),
                fit_bytes=fit_bytes))
            return real(residual_k, model_k, rms_k, xs, ys, psfs, coef, fit,
                        params, **kwargs)

        module.subminor_loop = recording
        try:
            yield self
        finally:
            module.subminor_loop = real

    def settle(self, run_iterations: Dict[int, int]) -> List[B2Call]:
        """Each call's iterations, given each run's final count."""
        for i, call in enumerate(self.calls):
            nxt = self.calls[i + 1] if i + 1 < len(self.calls) else None
            end = (nxt.start if nxt is not None and nxt.run == call.run
                   else run_iterations[call.run])
            call.iterations = end - call.start
        return self.calls


def probe():
    return B2Probe()


def read(ctx):
    events = ctx.kernels(KERNEL)
    calls = [c for c in ctx.probes.get("b2_roofline_pct", [])
             if c.iterations > 0]
    if not events or not calls:
        return None
    n_bytes = n_flops = 0.0
    for c in calls:
        b, f = roofline.b2_work(c.n_planes, c.k, c.iterations, c.fit_bytes)
        n_bytes += b
        n_flops += f
    bound, _ = roofline.bound_s(n_bytes, n_flops, ctx.device_name)
    return 100.0 * bound / seconds(events)
