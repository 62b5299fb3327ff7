#!/usr/bin/env python3
"""B1 timed for several checkouts in one run on one NVIDIA GPU.

    python3 scripts/compare_b1.py PARENT_ROOT . . PARENT_ROOT
    python3 scripts/compare_b1.py --facets PARENT_ROOT . . PARENT_ROOT

Each root is a checkout (for example an unpacked ``git archive`` of another
commit); each runs in its own process from its own root, so its kernels
build from its own sources.  Give the roots in turns (parent, change,
change, parent) to compare two commits on one card.  It imports nothing of
JAX.

An iteration of B1 is what the checkout launches for one Högbom iteration:
the step and then the select where the checkout has a separate select
(``hogbom_select``), the step with its select folded in where it does not.
Each time is by CUDA events over many iterations in a row, with the host's
time to enqueue them beside it.

* By default: an iteration at config 1's shape (4096^2, one plane, no
  weight plane) and the step alone (the launch that writes partials only)
  in the same run; an iteration in linear mode with a weight plane at
  config 3's shape ([8, 2048, 2048]), in squared mode with a weight plane
  at [8, 2048, 2048] (2 channels x IQUV) and in normal mode at the
  joined-channel cell's shape ([4, 4096, 4096]); a 5000-iteration
  ``hogbom_loop`` at
  config 1 on the host clock around a synchronize, twice; config 1's
  perform (``chip_smoke._perform``: a warm-up and 3 performs of 5000
  iterations, minor iterations/s); and the card's idle share in one more
  perform, from ``torch.profiler``'s kernel intervals.
* ``--facets``: an iteration of the facet step at config 5's shape ([4, 8,
  2372, 2390], config 5's true boxes, every facet active) in squared mode
  with shared PSFs and a weight plane that is 0 outside the boxes, and in
  linear mode with a PSF stack a facet; then two 400-iteration lockstep
  loops (``facet_hogbom_loop`` with the 2-term polynomial fit between
  launches, as config 5 runs it), on the host clock around a synchronize.
"""

import subprocess
import sys
from pathlib import Path

_COMMON = """
import sys, time
sys.path.insert(0, '.')
import torch
import chip_smoke as cs
import radler_tpu_torch as rd
from radler_tpu_torch.image_set import CubeMeta
from radler_tpu_torch.kernels import hogbom_step as hs
cs.phase_card()
FOLDED = not hasattr(hs, 'hogbom_select')
print('select', 'folded into the step' if FOLDED else 'its own launch',
      flush=True)
dev = torch.device('cuda')


def iteration(step, select, res, model, psfs, coefs, weight, b, params, kw):
    '''One B1 iteration as this checkout launches it.'''
    args = (res, model, psfs, b.values, b.state, coefs, weight)
    if FOLDED:
        return lambda: step(*args, **kw, buffers=b, params=params)

    def pair():
        select(step(*args, **kw), res, b, params, None)
    return pair


def timed(label, fn, repeats):
    device_ms, host_ms = cs._time_ms(fn, repeats)
    print(label, 'ms', device_ms, 'host_enqueue_ms', host_ms, flush=True)
"""

_RUN = _COMMON + """
psf, residual = cs.make_problem(cs.SIZE, cs.N_SOURCES)
res = torch.as_tensor(residual, device=dev)[None].clone()
psfs = torch.as_tensor(psf, device=dev)[None]
coefs = torch.ones(1, device=dev)
flat = int(torch.argmax(res[0].abs()))
y0, x0 = divmod(flat, cs.SIZE)


def buffers(res, y, x, n_flat, gain):
    state = torch.tensor([y, x, 1, 0, 0, 1, n_flat, 0], dtype=torch.int32,
                         device=dev)
    raw = res[:, y, x].clone()
    return hs.LoopBuffers(state, torch.zeros(1, device=dev), raw, raw * gain)


params = hs.LoopParams.make(cs.GAIN, 0.0, 1.0, 0.0, 2**30, False)
kw = dict(mode='signed', n_polarizations=1, allow_negative=True)
model = torch.zeros_like(res)
select = None if FOLDED else hs.hogbom_select
b = buffers(res, y0, x0, flat, cs.GAIN)
timed('config1_iteration', iteration(hs.hogbom_step, select, res, model,
                                     psfs, coefs, None, b, params, kw), 200)
b = buffers(res, y0, x0, flat, cs.GAIN)
timed('config1_step_alone', lambda: hs.hogbom_step(
    res, model, psfs, b.values, b.state, coefs, None, **kw), 200)

inputs = cs._case_inputs('linear', cs.MS_CHANNELS, 1, False, cs.MS_SIZE,
                         cs.MS_SIZE, seed=cs.MS_CHANNELS)
lres = inputs['res'].clone()
lflat = int(torch.argmax(lres[0].abs()))
ly, lx = divmod(lflat, cs.MS_SIZE)
lb = buffers(lres, ly, lx, lflat, 0.1)
timed('linear_iteration', iteration(
    hs.hogbom_step, select, lres, torch.zeros_like(lres), inputs['psfs'],
    inputs['coefs'], inputs['weight'], lb, params,
    dict(mode='linear', n_polarizations=1, allow_negative=True)), 50)
del inputs, lres, lb
# The other joined integrations: squared (2 channels x IQUV, config 5's
# planes) with a weight plane at 2048^2, and normal at the joined-channel
# cell's shape (4 channels at 4096^2, no weight plane).
for label, mode, C, P, size, use_weight in (
        ('squared', 'squared', 2, 4, 2048, True),
        ('normal', 'normal', 4, 1, cs.SIZE, False)):
    inputs = cs._case_inputs(mode, C, P, mode == 'squared', size, size,
                             seed=C * 10 + P)
    jres = inputs['res'].clone()
    jflat = int(torch.argmax(jres[0].abs()))
    jy, jx = divmod(jflat, size)
    jb = buffers(jres, jy, jx, jflat, 0.1)
    timed(f'{label}_iteration', iteration(
        hs.hogbom_step, select, jres, torch.zeros_like(jres), inputs['psfs'],
        inputs['coefs'], inputs['weight'] if use_weight else None, jb,
        params, dict(mode=mode, n_polarizations=P, allow_negative=True)), 20)
    del inputs, jres, jb

res_d = torch.as_tensor(residual, device=dev)
psf_d = torch.as_tensor(psf, device=dev)
meta = CubeMeta(1, 1, (1.0,), (True,), 1.0, False, (0.0,))
value0 = float(res_d.view(-1)[flat])
for _ in range(2):
    r, m = res_d[None].clone(), torch.zeros_like(res_d[None])
    loop = hs.LoopParams.make(cs.GAIN, cs.THRESHOLD, abs(value0), 0.0,
                              cs.ITERATIONS, False)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = hs.hogbom_loop(r, m, psf_d[None], None, None,
                         (value0, x0, y0, True), loop, 0, meta=meta,
                         allow_negative=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    print('hogbom_loop_ms', seconds * 1e3, 'iterations', out.iteration,
          'ms_per_iteration', seconds * 1e3 / out.iteration, flush=True)
cs._perform(psf_d, res_d, cs.ITERATIONS)  # warm-up
for _ in range(3):
    n, seconds = cs._perform(psf_d, res_d, cs.ITERATIONS)[:2]
    print('config1_perform_s', seconds, 'iterations', n,
          'minor_iterations_per_s', n / seconds, flush=True)

# The card's idle share in one more perform, from the profiler's kernel
# intervals: 1 - (their union) / (first kernel's start to last one's end).
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    cs._perform(psf_d, res_d, cs.ITERATIONS)
device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
spans = sorted((e.time_range.start, e.time_range.end) for e in device)
by_name = {}
for e in device:
    by_name[e.name] = by_name.get(e.name, 0.0) + (
        e.time_range.end - e.time_range.start)
busy, reach = 0.0, None
for start, end in spans:
    if reach is None or start > reach:
        busy += end - start
        reach = end
    elif end > reach:
        busy += end - reach
        reach = end
if spans:
    window = max(e for _, e in spans) - spans[0][0]
    print('config1_idle_share', 1.0 - busy / window, 'kernels', len(spans),
          'window_ms', window / 1e3, flush=True)
    for name, total in sorted(by_name.items(), key=lambda kv: -kv[1])[:4]:
        print('config1_device_time', repr(name[:60]), 'ms', total / 1e3,
              'share', total / window, flush=True)
else:
    print('config1_idle_share not measured: the profiler saw no device '
          'time', flush=True)
"""

# Config 5's true boxes (rows, columns), as its split gives them at 4096^2
# (x, y at (0, 0), (2224, 0), (0, 1732), (2134, 1724)).
F5_BOXES = [(1870, 2364), (1796, 1872), (2364, 2390), (2372, 1962)]

_FACETS = _COMMON + """
from radler_tpu_torch.ops.spectral_fitting import SpectralFitter
boxes = BOXES
height, width = max(b[0] for b in boxes), max(b[1] for b in boxes)
F, C, P = len(boxes), 2, 4
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
box_table = torch.tensor(boxes, dtype=torch.int32)
states, peaks = [], []
for f in range(F):
    y, x = divmod(int(torch.argmax(res[f, 0].abs() * weight[f])), width)
    states.append([y, x, 1, 0, 0, 1, y * width + x, 0])
    peaks.append((float(res[f, 0, y, x]), x, y, True))
params = hs.FacetLoopParams.make(0.1, [0.0] * F, [1.0] * F, 0.0,
                                 [2**30] * F, False, dev)
select = None if FOLDED else hs.hogbom_select_facets
model = torch.zeros_like(res)


def facet_buffers():
    state = torch.tensor(states, dtype=torch.int32, device=dev)
    raw = res[torch.arange(F), :, state[:, 0].long(), state[:, 1].long()]
    return hs.LoopBuffers(state, torch.zeros(F, device=dev), raw.clone(),
                          raw * params.gain)


runs = (('squared', hs.integration_coefficients(meta), psfs),
        ('linear', ('linear', [1.0 / (C * P)] * (C * P), [1.0]),
         torch.stack([psfs * (1.0 + 0.1 * f) for f in range(F)])))
for label, (mode, chan, pol), stack in runs:
    coefs = torch.as_tensor(hs.kernel_coefficients(mode, chan, pol),
                            device=dev)
    kw = dict(mode=mode, n_polarizations=P, allow_negative=True,
              boxes=box_table)
    timed(f'facet_{label}_iteration', iteration(
        hs.hogbom_step_facets, select, res.clone(), model, stack, coefs,
        weight, facet_buffers(), params, kw), 10)
    del stack
fitter = SpectralFitter(rd.SpectralFittingMode.POLYNOMIAL, 2,
                        list(meta.frequencies), list(meta.weights))
for _ in range(2):
    r, m = res.clone(), torch.zeros_like(res)
    loop = hs.FacetLoopParams.make(0.1, [0.0] * F, [1e9] * F, 0.0,
                                   [400] * F, False, dev)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = hs.facet_hogbom_loop(r, m, psfs, weight, None, peaks, loop,
                               [0] * F, meta=meta, allow_negative=True,
                               fitter=fitter, boxes=box_table)
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
