#!/usr/bin/env python3
"""B1 timed for several checkouts in one run on one NVIDIA GPU.

    python3 scripts/compare_b1.py PARENT_ROOT . . PARENT_ROOT
    python3 scripts/compare_b1.py --facets PARENT_ROOT . . PARENT_ROOT

Each root is a checkout (for example an unpacked ``git archive`` of another
commit); each runs in its own process from its own root, so its kernels
build from its own sources.  Give the roots in turns (parent, change,
change, parent) to compare two commits on one card.  It imports nothing of
JAX.

* By default: the single-cube step and select at config 1's shape (4096^2,
  one plane, no weight plane), ``chip_smoke.phase_kernel_times``'s lines
  (CUDA events; plain, kernel, kernel, plain).
* ``--facets``: the facet step at config 5's shape ([4, 8, 2372, 2390],
  squared mode, shared PSFs, a weight plane that is 0 outside config 5's
  true boxes, every facet active), by CUDA events over 20 launches, over
  the true boxes where the checkout's ``hogbom_step_facets`` takes
  ``boxes`` and over the common box where it does not (the same result
  inside the boxes); then two 400-iteration lockstep loops
  (``facet_hogbom_loop`` with the 2-term polynomial fit between launches,
  as config 5 runs it), timed on the host clock around a synchronize.
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

# Config 5's true boxes (rows, columns), as its split gives them at 4096^2
# (x, y at (0, 0), (2224, 0), (0, 1732), (2134, 1724)).
F5_BOXES = [(1870, 2364), (1796, 1872), (2364, 2390), (2372, 1962)]

_FACETS = """
import inspect, sys, time
sys.path.insert(0, '.')
import torch
import chip_smoke as cs
import radler_tpu_torch as rd
from radler_tpu_torch.image_set import CubeMeta
from radler_tpu_torch.kernels import hogbom_step as hs
from radler_tpu_torch.ops.spectral_fitting import SpectralFitter
cs.phase_card()
boxes = BOXES
height, width = max(b[0] for b in boxes), max(b[1] for b in boxes)
F, C, P = len(boxes), 2, 4
dev = torch.device('cuda')
g = torch.Generator(device=dev).manual_seed(5)
res = torch.randn((F, C * P, height, width), generator=g, device=dev) * 0.01
weight = torch.rand((F, height, width), generator=g, device=dev)
for f, (rows, cols) in enumerate(boxes):
    weight[f, rows:] = 0.0
    weight[f, :, cols:] = 0.0
yy = (torch.arange(height, device=dev) - height // 2)[:, None].float()
xx = (torch.arange(width, device=dev) - width // 2)[None].float()
psfs = torch.stack([torch.exp(-(yy ** 2 + xx ** 2) / (2.0 * (3.0 + c) ** 2))
                    for c in range(C)])
meta = CubeMeta(C, P, (1.0,) * C, (True,) * P, 1.0, True, (1e8, 1.1e8))
mode, chan, pol = hs.integration_coefficients(meta)
coefs = torch.as_tensor(hs.kernel_coefficients(mode, chan, pol), device=dev)
states, peaks = [], []
for f in range(F):
    y, x = divmod(int(torch.argmax(res[f, 0].abs() * weight[f])), width)
    states.append([y, x, 1, 0, 0, 1, y * width + x, 0])
    peaks.append((float(res[f, 0, y, x]), x, y, True))
state = torch.tensor(states, dtype=torch.int32, device=dev)
values = res[torch.arange(F), :, state[:, 0].long(), state[:, 1].long()] * 0.1
model = torch.zeros_like(res)
boxed = 'boxes' in inspect.signature(hs.hogbom_step_facets).parameters
kw = dict(mode=mode, n_polarizations=P, allow_negative=True)
loop_kw = {}
if boxed:
    kw['boxes'] = loop_kw['boxes'] = torch.tensor(boxes, dtype=torch.int32)
step_ms, _ = cs._time_ms(lambda: hs.hogbom_step_facets(
    res, model, psfs, values, state, coefs, weight, **kw), 20)
print('facet_step_ms', step_ms, 'true boxes' if boxed else 'common box',
      flush=True)
fitter = SpectralFitter(rd.SpectralFittingMode.POLYNOMIAL, 2,
                        list(meta.frequencies), list(meta.weights))
for _ in range(2):
    r, m = res.clone(), torch.zeros_like(res)
    params = hs.FacetLoopParams.make(0.1, [0.0] * F, [1e9] * F, 0.0,
                                     [400] * F, False, dev)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = hs.facet_hogbom_loop(r, m, psfs, weight, None, peaks, params,
                               [0] * F, meta=meta, allow_negative=True,
                               fitter=fitter, **loop_kw)
    torch.cuda.synchronize()
    print('lockstep_loop_ms', (time.perf_counter() - start) * 1e3,
          'lockstep', out.lockstep, 'iterations',
          [o.iteration for o in out.results], flush=True)
"""


def main(argv):
    facets = "--facets" in argv
    roots = [a for a in argv if a != "--facets"]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    code = _FACETS.replace("BOXES", repr(F5_BOXES)) if facets else _RUN
    for root in roots:
        print(f"== {Path(root).resolve()} ==", flush=True)
        subprocess.run([sys.executable, "-c", code], cwd=root, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
