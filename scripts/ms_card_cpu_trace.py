#!/usr/bin/env python3
"""Multiscale on the card against the port's CPU run, pass by pass.

Runs config 3's settings (``chip_smoke.py``) on the host path's dense route
(``RADLER_TPU_NO_FUSED_MS``) at 256^2 x 4 channels on two
fields, on the CPU and on one NVIDIA GPU, and prints for every subminor
pass of each run its scale, its first and last iteration, its threshold,
the peak it started from and the peak it stopped at, then the first pass
where the two runs part by more than 1e-5 relative and the residuals'
largest difference at the end.  The fields: config 3's diffuse emission
alone (``make_diffuse_problem``), whose largest scale takes every
component, and the smoke's check field of point sources on that emission
(``make_ms_check_problem``).  Run from the root of a checkout:

    python3 scripts/ms_card_cpu_trace.py

It imports nothing of JAX.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SIZE, CHANNELS, ITERATIONS = 256, 4, 300


def trace(psfs, residual, device):
    """One perform on ``device``: (iterations, [(scale index, first
    iteration, last iteration, threshold, start peak, stop peak)], the
    residual)."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.models import multiscale as ms

    passes, scale = [], [None]
    real_loop, real_select = ms.dense_subminor_loop, ms.select_maximum_scale

    def recording_loop(*args, **kwargs):
        out = real_loop(*args, **kwargs)
        passes.append((scale[0], args[6], out[2], float(args[4]),
                       float(args[9][0]), float(out[3])))
        return out

    def recording_select(scales):
        scale[0] = real_select(scales)
        return scale[0]

    ms.dense_subminor_loop, ms.select_maximum_scale = (recording_loop,
                                                       recording_select)
    try:
        res, model = residual.copy(), np.zeros_like(residual)
        r = rd.Radler(cs._ms_settings(SIZE, ITERATIONS), psfs, res, model,
                      0.0, frequencies=cs._ms_frequencies(CHANNELS),
                      device=device)
        with cs._ms_route("dense"):
            r.perform(0)
    finally:
        ms.dense_subminor_loop, ms.select_maximum_scale = (real_loop,
                                                           real_select)
    return r.iteration_number, passes, res


def main():
    if not torch.cuda.is_available():
        print("ms_card_cpu_trace.py needs a CUDA device", file=sys.stderr)
        return 1
    cs.phase_card()
    for name, make in (("diffuse", cs.make_diffuse_problem),
                       ("check", cs.make_ms_check_problem)):
        psfs, residual = make(SIZE, CHANNELS)
        (n_c, cpu, res_c), (n_g, card, res_g) = [
            trace(psfs, residual, d) for d in ("cpu", "cuda")]
        cs.say(f"== {name}: CPU {n_c} iterations, card {n_g} ==")
        cs.say("pass: scale, iterations, threshold, start peak, stop peak "
               "(CPU | card)")
        parted = None
        for i in range(max(len(cpu), len(card))):
            a = cpu[i] if i < len(cpu) else None
            b = card[i] if i < len(card) else None
            cs.say(f"{i:3d}: {a} | {b}")
            if parted is None and (
                    a is None or b is None or a[:3] != b[:3]
                    or any(abs(x - y) > 1e-5 * abs(x)
                           for x, y in zip(a[3:], b[3:]))):
                parted = i
        scale = max(1.0, float(np.abs(res_c).max()))
        cs.say(f"first pass that parts by more than 1e-5: {parted}; at the "
               f"end max|residual difference| "
               f"{float(np.abs(res_g - res_c).max()) / scale:.3g} of "
               f"max(1, |res|max)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
