#!/usr/bin/env python3
"""A debug subset of ``chip_smoke.py``: build the kernels, print what
``-Xptxas -v`` says of each, and run the phases of the kernels named on the
command line, on one NVIDIA GPU.  Run from the root of a checkout:

    python3 scripts/kernel_probe.py b2        # the subminor kernel
    python3 scripts/kernel_probe.py b3        # the à-trous kernel
    python3 scripts/kernel_probe.py ms        # multiscale: B1 linear, config 3
    python3 scripts/kernel_probe.py b2 b3 check   # against plain only

``check`` leaves out the timing phases.  It imports nothing of JAX.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv):
    if not torch.cuda.is_available():
        print("kernel_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    cs.say("== the card ==")
    cs.phase_card()
    timed = "check" not in argv
    if "b2" in argv:
        cs.say("== the subminor kernel against its plain version ==")
        cs.phase_subminor_vs_plain()
        cs.say("== the subminor kernel at config 2's shapes ==")
        psf2, residual2 = cs.make_problem(cs.CLARK_SIZE, cs.N_SOURCES)
        if timed:
            cs.phase_subminor_times(psf2, residual2)
        cs.say("== config 2 (Clark) through Radler.perform ==")
        cs.phase_config2(psf2, residual2)
        cs.say("== point-source contract, Clark ==")
        cs.phase_contract(clark=True)
    if "b3" in argv:
        cs.say("== the à-trous kernel (B3) against its plain version ==")
        cs.phase_atrous_vs_plain()
        if timed:
            cs.say("== B3 times at 4096^2 ==")
            cs.phase_atrous_times()
        cs.say("== config 4 (IUWT 4096^2) through Radler.perform ==")
        iuwt = cs.phase_config4()
        cs.say("== B3 against its plain version at config 4's shapes ==")
        cs.phase_atrous_main_shapes(iuwt[2])
        cs.say("== the IUWT diffuse-source contract ==")
        cs.phase_iuwt_contract()
    if "ms" in argv:
        cs.say("== B1 in linear mode at config 3's shape against its plain "
               "version ==")
        cs.phase_linear_b1()
        cs.say("== config 3 (multiscale 2048^2 x 8 channels) through "
               "Radler.perform ==")
        cs.phase_config3()
        cs.say("== point-source contract, multiscale ==")
        cs.phase_ms_contract()
        cs.say("== multiscale on the card against the CPU ==")
        cs.phase_ms_card_vs_cpu()
    cs.say("probe done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
