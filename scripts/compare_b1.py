#!/usr/bin/env python3
"""B1's single-cube step and select at config 1's shape (4096^2, one plane,
no weight plane), timed for several checkouts in one run on one NVIDIA GPU.

    python3 scripts/compare_b1.py PARENT_ROOT . . PARENT_ROOT

Each root is a checkout (for example an unpacked ``git archive`` of another
commit); each runs in its own process from its own root, so its kernels
build from its own sources, and prints ``chip_smoke.phase_kernel_times``'s
lines (CUDA events; plain, kernel, kernel, plain).  Give the roots in turns
(parent, change, change, parent) to compare two commits on one card.  It
imports nothing of JAX.
"""

import subprocess
import sys
from pathlib import Path

_RUN = """
import sys
sys.path.insert(0, '.')
import chip_smoke as cs
cs.phase_card()
psf, residual = cs.make_problem(cs.SIZE, cs.N_SOURCES)
times = cs.phase_kernel_times(psf, residual)
print('step_ms', times['hogbom_step'][0], 'select_ms',
      times['hogbom_select'][0], flush=True)
"""


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        print(f"== {Path(root).resolve()} ==", flush=True)
        subprocess.run([sys.executable, "-c", _RUN], cwd=root, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
