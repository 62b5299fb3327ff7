#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``radler_tpu_torch/csrc`` (one ``nvcc``
per source, all at once), compares each kernel with its plain PyTorch
version on the card, runs ``radler_tpu_torch.Radler(...).perform`` on CUDA
tensors and prints what it measured:

* Högbom CLEAN: the 4096^2 headline problem (config 1), a joined-channel
  cube, and the point-source contract;
* the Clark subminor loop, the library's default: its kernel against its
  plain version at every cluster size, its times per iteration at four
  candidate counts, the 2048^2 problem of config 2 with the time split of a
  perform, the point-source contract,
  and one perform with local-RMS weighting;
* the batched inverse FFT against per-plane inverses and NumPy, once;
* IUWT: the à-trous kernel against its plain version (7 shapes at 1 to 5
  scales, 4096^2 at 6 to 9, with two and with three scales in its fused
  launch), its times at 4096^2 for 1 to 9 scales beside cuDNN's dilated
  convolution, config 4 (IUWT 4096^2, 16 structure
  iterations) with the time split of a perform, the kernel against its
  plain version at every shape config 4 gave it, and the 128^2
  diffuse-source contract;
* the mesh Högbom loop, its shards all on the one card: the shard-local
  kernel (B4) and the Högbom step on row shards against their plain
  versions, B4's time, the joined-channel cube on a chan 4 x tile 2 mesh
  against the single-device perform, 2 channels x 2 polarizations with
  squared joins on chan 2 x tile 4, and the point-source contract on
  chan 1 x tile 8.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits with a non-zero code; without a CUDA device it exits at once.

It imports nothing of JAX or of the ``radler_tpu`` package.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 7
SIZE = 4096
N_SOURCES = 300
ITERATIONS = 5000
GAIN = 0.1
THRESHOLD = 0.05
RAGGED = (1000, 1300)
TRACE_ITERATIONS = 200
# Config 2: ``bench.py --engine clark --size 2048``.
CLARK_SIZE = 2048
# The subminor kernel against its plain version: candidate sets of a few
# thousand pixels from a 512^2 cube, 300 iterations each.
SUBMINOR_SIZE = 512
SUBMINOR_K = 3000
SUBMINOR_ITERATIONS = 300
# Two more candidate sets: fewer candidates than one block has threads, and
# a count that no cluster size times 1024 divides; and one whose state (4
# planes) outgrows the shared memory of a whole cluster, so that the plan
# itself keeps it in global memory.
SUBMINOR_K_SMALL = 37
SUBMINOR_K_RAGGED = 5003
SUBMINOR_K_GLOBAL = 150_000
# Candidate counts at which the subminor kernel is timed at every cluster
# size, beside config 2's own set: the last is beyond what a cluster's
# shared memory holds at one plane.
SUBMINOR_TIMED_K = (1000, 10_000, 300_000)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# Iterations of one timed subminor launch at config 2's shapes.
SUBMINOR_TIMED_ITERATIONS = 200
# Kernel and plain version perform the same float32 operations in the same
# order, so they are expected to agree bit for bit; this bounds what the
# smoke test accepts.
TOLERANCE = 1e-6
DEVICE = "cuda"
# Config 4: ``bench.py --engine iuwt --size 4096 --iters 16``.
IUWT_SIZE = 4096
IUWT_ITERATIONS = 16
IUWT_SEED = 5
# B3 against its plain version: (shape, label, scale counts).  Config 4
# decomposes its 4096^2 images at 9 scales.
ATROUS_SHAPES = [((4096, 4096), "4096^2", range(1, 10)),
                 ((1000, 1300), "1000x1300", range(1, 6)),
                 ((200, 300), "200x300", range(1, 6)),
                 ((128, 128), "128^2", range(1, 6)),
                 ((3, 200, 300), "batch of 3 x 200x300", range(1, 6)),
                 # Narrower than a tile and its halo; a width that no 16
                 # bytes divide.
                 ((20, 300), "20x300", range(1, 6)),
                 ((130, 1001), "130x1001", range(1, 6))]
# B3's times at 4096^2: 1 to 9 scales; the kernels line reports the scale
# count that config 4 gives B3 most often.
ATROUS_TIMED_SCALES = range(1, 10)
# The IUWT contract: the card's residual against the port's CPU run of the
# same inputs, absolute per pixel and relative in rms (read: under 4e-6).
CARD_VS_CPU = 1e-4
# The mesh configuration: the joined-channel cube through Radler.perform on
# MESH_DEVICES shards (chan 4 x tile 2), all on the one card.
MESH_DEVICES = 8
MESH_ITERATIONS = 2000
# A mesh perform against the single-device perform of the same cube: equal
# iteration counts and residual and model within this (the JAX package's
# own mesh-against-single-device gate, tests/test_mesh_clean.py).
MESH_VS_SINGLE = 2e-6
# B4 against its plain version: (label, mode, planes, polarizations, image
# height, width, tiles, shard index).  The first is the mesh
# configuration's shard; the ragged image's 250-row tiles are a shape the
# TPU kernel could not take (8-row blocks).
B4_CASES = [
    ("normal 1 plane", "normal", 1, 1, 4096, 4096, 2, 1),
    ("normal 1ch x 2pol", "normal", 2, 2, 4096, 4096, 4, 1),
    ("squared 1ch x 2pol", "squared", 2, 2, 4096, 4096, 4, 2),
    ("signed", "signed", 1, 1, 4096, 4096, 2, 0),
    ("linear 2 planes", "linear", 2, 1, 4096, 4096, 4, 3),
    ("ragged normal 2ch", "normal", 2, 1, 1000, 1300, 4, 1),
    ("ragged squared 1ch x 2pol", "squared", 2, 2, 1000, 1300, 4, 2),
]
# B1 on row shards against its plain version (same fields): every plane of
# the shard's rows, as the mesh runs it when it splits no channels.
B1_SHARD_CASES = [
    ("normal 4ch", "normal", 4, 1, 4096, 4096, 8, 3),
    ("squared 2ch x 2pol", "squared", 4, 2, 4096, 4096, 8, 7),
    ("ragged signed", "signed", 1, 1, 1000, 1300, 4, 2),
]
# The card's published peaks (H100 SXM data sheet, 700 W): device memory
# and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def say(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# Problems, made with NumPy from a seed
# ---------------------------------------------------------------------------


def _pad_center(img, n):
    out = np.zeros((n, n), img.dtype)
    h, w = img.shape
    top, left = n // 2 - h // 2, n // 2 - w // 2
    out[top : top + h, left : left + w] = img
    return out


def _crop_center(img, n):
    h, w = img.shape
    top, left = h // 2 - n // 2, w // 2 - n // 2
    return img[top : top + n, left : left + n]


def make_problem(size, n_sources, seed=SEED):
    """Point sources convolved with a Gaussian PSF with a faint sidelobe
    ring: the problem of ``bench.py --engine dense`` (``make_problem``)."""
    rng = np.random.default_rng(seed)
    psf = np.zeros((size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2.0 + (xx - size // 2) ** 2.0
    psf += np.exp(-r2 / (2.0 * 2.5**2)).astype(np.float32)
    ring = np.exp(-((np.sqrt(r2) - 12.0) ** 2) / (2.0 * 2.0**2))
    psf += 0.08 * ring.astype(np.float32)
    sky = np.zeros((size, size), np.float32)
    margin = size // 8
    ys = rng.integers(margin, size - margin, n_sources)
    xs = rng.integers(margin, size - margin, n_sources)
    amps = rng.uniform(0.2, 1.0, n_sources).astype(np.float32)
    np.add.at(sky, (ys, xs), amps)
    pad = 1 << (size - 1).bit_length()
    psf_f = np.fft.rfft2(np.fft.ifftshift(_pad_center(psf, 2 * pad)))
    sky_f = np.fft.rfft2(_pad_center(sky, 2 * pad))
    conv = np.fft.irfft2(psf_f * sky_f, s=(2 * pad, 2 * pad))
    residual = _crop_center(conv, size).astype(np.float32)
    return psf, residual


def make_diffuse_problem(size, n_channels, seed=IUWT_SEED):
    """Extended emission convolved with a Gaussian PSF with a sidelobe ring:
    the problem of configs 3 and 4 (``bench.py``'s
    ``make_diffuse_problem``), regenerated in NumPy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psfs = []
    for c in range(n_channels):
        w = 2.5 * (1.0 + 0.04 * c)
        p = np.exp(-r2 / (2 * w * w))
        p += 0.06 * np.exp(-((np.sqrt(r2) - 14 * (1 + 0.03 * c)) ** 2) / 6)
        psfs.append(p.astype(np.float32))
    psfs = np.stack(psfs)
    sky = np.zeros((size, size), np.float32)
    for _ in range(60):
        cy, cx = rng.integers(size // 8, 7 * size // 8, 2)
        s = rng.uniform(1.5, 25)
        a = rng.uniform(0.2, 1.0)
        m = max(1, int(4 * s))
        y0, y1 = max(0, cy - m), min(size, cy + m)
        x0, x1 = max(0, cx - m), min(size, cx + m)
        sky[y0:y1, x0:x1] += a * np.exp(
            -((yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2)
            / (2 * s * s)
        )
    residual = np.empty((n_channels, size, size), np.float32)
    for c in range(n_channels):
        fp = np.fft.rfft2(np.fft.ifftshift(psfs[c]))
        residual[c] = np.fft.irfft2(
            np.fft.rfft2(sky * (1 + 0.1 * c)) * fp, s=(size, size)
        ).astype(np.float32)
    return psfs, residual


def rms(t):
    return float(torch.sqrt(torch.mean(t.double() ** 2)))


def bound_ms(n_bytes, n_flops=0.0):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the peak rate; returns
    (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / FP32_FLOPS_PER_S
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    say(f"nvidia-smi: {smi}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device: {torch.cuda.get_device_name(0)}")
    from radler_tpu_torch.kernels import _build

    start = time.perf_counter()
    _build.library()
    say(f"kernel library: {_build.BuildInfo.path} "
        f"(nvcc {_build.BuildInfo.seconds:.1f} s, load "
        f"{time.perf_counter() - start:.1f} s)")
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say(f"  ptxas: {line.strip()}")
    return smi


# (name, mode, n_channels, n_polarizations, squared_joins)
KERNEL_CASES = [
    ("signed 1x1", "signed", 1, 1, False),
    ("normal 4ch x 1pol", "normal", 4, 1, False),
    ("normal 2ch x IQUV", "normal", 2, 4, False),
    ("squared 2ch x IQUV", "squared", 2, 4, True),
    ("linear 4 planes", "linear", 4, 1, False),
]


def _case_inputs(mode, C, P, squared, height, width, seed):
    """A residual cube with sources on noise, per-channel PSFs, weights and
    the kernel coefficients of the case, all on the card."""
    from radler_tpu_torch.image_set import (
        CubeMeta,
        linear_integration_coefficients,
    )
    from radler_tpu_torch.kernels import hogbom_step as hs

    rng = np.random.default_rng(seed)
    n = C * P
    weights = tuple(float(w) for w in rng.uniform(0.5, 2.0, C))
    meta = CubeMeta(C, P, weights, (True,) * P, 1.0, squared,
                    tuple(1e8 + 1e7 * c for c in range(C)))
    if mode == "linear":
        chan, pol = linear_integration_coefficients(meta), np.ones(1)
    else:
        got, chan, pol = hs.integration_coefficients(meta)
        assert got == mode, (got, mode)
    res = rng.normal(scale=0.01, size=(n, height, width)).astype(np.float32)
    for _ in range(40):
        y, x = rng.integers(0, height), rng.integers(0, width)
        res[:, y, x] += rng.uniform(0.5, 2.0, n).astype(np.float32)
    yy, xx = np.mgrid[0:height, 0:width]
    r2 = (yy - height // 2) ** 2.0 + (xx - width // 2) ** 2.0
    psfs = np.stack(
        [np.exp(-r2 / (2.0 * (2.0 + 0.25 * c) ** 2)) for c in range(C)]
    ).astype(np.float32)
    weight = rng.uniform(0.0, 1.0, (height, width)).astype(np.float32)
    dev = torch.device(DEVICE)
    return dict(
        res=torch.as_tensor(res, device=dev),
        psfs=torch.as_tensor(psfs, device=dev),
        weight=torch.as_tensor(weight, device=dev),
        coefs=torch.as_tensor(hs.kernel_coefficients(mode, chan, pol),
                              device=dev),
        P=P,
    )


def _trace(inputs, mode, use_weight, allow_negative, plain):
    """TRACE_ITERATIONS iterations of step + select from the brightest
    pixel of plane 0; returns the (y, x) of every iteration and the final
    tensors."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    res = inputs["res"].clone()
    model = torch.zeros_like(res)
    n, height, width = res.shape
    flat = int(torch.argmax(res[0].abs()))
    y0, x0 = divmod(flat, width)
    state = torch.tensor([y0, x0, 1, 0, 0, 1, flat, 0], dtype=torch.int32,
                         device=res.device)
    raw = res[:, y0, x0].clone()
    params = hs.LoopParams.make(GAIN, 0.0, float(raw.abs().max()), 0.0,
                                TRACE_ITERATIONS, False)
    buffers = hs.LoopBuffers(state, torch.zeros(1, device=res.device), raw,
                             raw * params.gain)
    step = hs.hogbom_step_reference if plain else hs.hogbom_step
    select = hs.hogbom_select_reference if plain else hs.hogbom_select
    weight = inputs["weight"] if use_weight else None
    peaks = []
    for _ in range(TRACE_ITERATIONS):
        partials = step(res, model, inputs["psfs"], buffers.values,
                        buffers.state, inputs["coefs"], weight, mode=mode,
                        n_polarizations=inputs["P"],
                        allow_negative=allow_negative)
        select(partials, res, buffers, params)
        peaks.append(buffers.state[:2].clone())
    torch.cuda.synchronize()
    return torch.stack(peaks), res, model, buffers


def phase_kernels_vs_plain():
    """Every integration mode, weight on and off, negatives allowed or not,
    at the main path's size and at a ragged shape: the kernel loop against
    the plain loop on the card."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    worst = {"hogbom_step": 0.0, "hogbom_select": 0.0}
    for height, width in ((SIZE, SIZE), RAGGED):
        for name, mode, C, P, squared in KERNEL_CASES:
            inputs = _case_inputs(mode, C, P, squared, height, width,
                                  seed=C * 10 + P)
            for use_weight in (False, True):
                for allow_negative in (True, False):
                    pk, rk, mk, bk = _trace(inputs, mode, use_weight,
                                            allow_negative, plain=False)
                    pp, rp, mp, bp = _trace(inputs, mode, use_weight,
                                            allow_negative, plain=True)
                    it_k = int(bk.state[hs.ITERATION])
                    it_p = int(bp.state[hs.ITERATION])
                    same_peaks = bool(torch.equal(pk, pp))
                    d_res = float((rk - rp).abs().max())
                    d_mod = float((mk - mp).abs().max())
                    d_sel = max(
                        float((bk.value - bp.value).abs().max()),
                        float((bk.values - bp.values).abs().max()),
                    )
                    say(f"  {height}x{width} {name:20s} weight={use_weight:d} "
                        f"allow_negative={allow_negative:d}: iterations "
                        f"{it_k}/{it_p}, same peaks {same_peaks}, "
                        f"max|dres| {d_res:.3g}, max|dmodel| {d_mod:.3g}, "
                        f"max|dvalue| {d_sel:.3g}")
                    if not (it_k == it_p and same_peaks and d_res <= TOLERANCE
                            and d_mod <= TOLERANCE and d_sel <= TOLERANCE
                            and torch.equal(bk.state, bp.state)):
                        raise AssertionError(
                            f"kernel and plain loop disagree: {height}x{width} "
                            f"{name} weight={use_weight} "
                            f"allow_negative={allow_negative}"
                        )
                    worst["hogbom_step"] = max(worst["hogbom_step"], d_res,
                                               d_mod)
                    worst["hogbom_select"] = max(worst["hogbom_select"], d_sel)
            del inputs
            torch.cuda.empty_cache()
    return worst


def _time_ms(fn, repeats):
    """Mean milliseconds of ``fn`` over ``repeats`` calls, after two warm-up
    calls: (device time by CUDA events, host time to enqueue).  A spin of
    about half a second on the card before the first event lets the host
    queue every launch first, so the events time the device work and not
    the host's launch rate, unless the host needs longer than the spin."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    start.record()
    host_start = time.perf_counter()
    for _ in range(repeats):
        fn()
    host_ms = (time.perf_counter() - host_start) * 1e3 / repeats
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats, host_ms


def phase_kernel_times(psf, residual):
    """Each kernel against its plain version at the main path's shapes
    (4096^2, one plane, no weight), in turns: plain, kernel, kernel, plain."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    dev = torch.device(DEVICE)
    res = torch.as_tensor(residual, device=dev)[None].clone()
    model = torch.zeros_like(res)
    psfs = torch.as_tensor(psf, device=dev)[None]
    coefs = torch.ones(1, device=dev)
    flat = int(torch.argmax(res[0].abs()))
    y0, x0 = divmod(flat, SIZE)
    params = hs.LoopParams.make(GAIN, 0.0, 1.0, 0.0, 2**30, False)

    def buffers():
        state = torch.tensor([y0, x0, 1, 0, 0, 1, flat, 0], dtype=torch.int32,
                             device=dev)
        raw = res[:, y0, x0].clone()
        return hs.LoopBuffers(state, torch.zeros(1, device=dev), raw,
                              raw * params.gain)

    b = buffers()
    kw = dict(mode="signed", n_polarizations=1, allow_negative=True)
    partials = hs.hogbom_step(res, model, psfs, b.values, b.state, coefs,
                              None, **kw)
    times = {"hogbom_step": [], "hogbom_select": []}
    for plain in (True, False, False, True):
        step = hs.hogbom_step_reference if plain else hs.hogbom_step
        select = hs.hogbom_select_reference if plain else hs.hogbom_select
        b = buffers()
        t_step, h_step = _time_ms(
            lambda: step(res, model, psfs, b.values, b.state, coefs, None,
                         **kw), 20)
        t_select, h_select = _time_ms(
            lambda: select(partials, res, b, params), 50)
        times["hogbom_step"].append(t_step)
        times["hogbom_select"].append(t_select)
        say(f"  {'plain ' if plain else 'kernel'} hogbom_step {t_step:.4f} ms "
            f"(host enqueue {h_step:.4f} ms), hogbom_select {t_select:.4f} ms "
            f"(host enqueue {h_select:.4f} ms)")
    out = {}
    for name, (p1, k1, k2, p2) in times.items():
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
    # The least bytes each must move: the step reads the residual and the
    # PSF and writes the residual; the select reads the partials and the
    # residual's values at the peak.
    out["bytes"] = {
        "hogbom_step": 3 * res.numel() * 4,
        "hogbom_select": sum(p.numel() * p.element_size() for p in partials)
        + res.shape[0] * 4,
    }
    return out


def _counts():
    from radler_tpu_torch.kernels import hogbom_step as hs

    return hs.hogbom_step.launches, hs.hogbom_select.launches


def _reset_counts():
    from radler_tpu_torch.kernels import hogbom_step as hs
    from radler_tpu_torch.kernels import iuwt_atrous as ia
    from radler_tpu_torch.kernels import subminor_loop as sl
    from radler_tpu_torch.kernels import subtract_integrate as si

    hs.hogbom_step.launches = 0
    hs.hogbom_select.launches = 0
    sl.subminor_loop.launches = 0
    ia.atrous_decompose_lo.launches = 0
    si.subtract_integrate.launches = 0


def _settings(size, iterations, clark=False):
    import radler_tpu_torch as rd

    s = rd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.minor_iteration_count = iterations
    s.absolute_threshold = THRESHOLD
    s.minor_loop_gain = GAIN
    s.generic.use_sub_minor_optimization = clark
    return s


def _perform(psf, res, iterations, **kwargs):
    """One major iteration on fresh CUDA copies; returns (iterations,
    seconds, launch counts, residual, model)."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.kernels import hogbom_step as hs

    res = res.clone()
    model = torch.zeros_like(res)
    r = rd.Radler(_settings(res.shape[-1], iterations), psf, res, model, 0.0,
                  **kwargs)
    torch.cuda.synchronize()
    _reset_counts()
    start = time.perf_counter()
    r.perform(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = _counts()
    n = r.iteration_number
    if not (counts[0] == counts[1] and n <= counts[0] < n + hs.CHUNK):
        raise AssertionError(f"launch counts {counts} for {n} iterations")
    if n == iterations and counts[0] != n:
        raise AssertionError(f"launch counts {counts} != {n} iterations")
    table = r._table
    out_res = torch.stack([e.residual_accessor.array for e in table])
    out_mod = torch.stack([e.model_accessor.array for e in table])
    if not (torch.isfinite(out_res).all() and torch.isfinite(out_mod).all()):
        raise AssertionError("non-finite residual or model")
    return n, seconds, counts, out_res, out_mod


def phase_main_path(psf, residual):
    """Config 1: 4096^2 Högbom through Radler.perform on CUDA tensors."""
    from radler_tpu_torch.kernels import hogbom_step as hs
    from radler_tpu_torch.image_set import CubeMeta

    dev = torch.device(DEVICE)
    psf_d = torch.as_tensor(psf, device=dev)
    res_d = torch.as_tensor(residual, device=dev)
    _perform(psf_d, res_d, ITERATIONS)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    runs = [_perform(psf_d, res_d, ITERATIONS) for _ in range(3)]
    n, _, counts, out_res, out_mod = runs[0]
    best = min(r[1] for r in runs)
    say(f"  perform: {n} iterations; seconds "
        f"{', '.join(f'{r[1]:.4f}' for r in runs)}; best "
        f"{n / best:.1f} minor iterations/s; launches hogbom_step "
        f"{counts[0]}, hogbom_select {counts[1]}")
    say(f"  residual rms {rms(res_d):.6g} -> {rms(out_res):.6g}; model sum "
        f"{float(out_mod.double().sum()):.6g}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if not rms(out_res) < rms(res_d):
        raise AssertionError("the residual did not shrink")
    main_counts = counts

    # The minor loop alone, kernel against plain, in turns, on the same
    # tensors (1000 iterations each: the plain loop is slow).
    meta = CubeMeta(1, 1, (1.0,), (True,), 1.0, False, (0.0,))
    flat = int(torch.argmax(res_d.abs()))
    y0, x0 = divmod(flat, SIZE)
    value0 = float(res_d.view(-1)[flat])
    rates = {True: [], False: []}
    finals = {}
    for plain in (False, True, True, False):
        r = res_d[None].clone()
        m = torch.zeros_like(r)
        params = hs.LoopParams.make(GAIN, THRESHOLD, abs(value0), 4.0, 1000,
                                    False)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = hs.hogbom_loop(r, m, psf_d[None], None, None,
                             (value0, x0, y0, True), params, 0, meta=meta,
                             allow_negative=True, plain=plain)
        torch.cuda.synchronize()
        rates[plain].append(out.iteration / (time.perf_counter() - start))
        finals[plain] = (out, r, m)
    (out_k, r_k, m_k), (out_p, r_p, m_p) = finals[False], finals[True]
    d = max(float((r_k - r_p).abs().max()), float((m_k - m_p).abs().max()))
    say(f"  hogbom_loop kernel vs plain: {out_k} / {out_p}, max|diff| {d:.3g}")
    if out_k != out_p or d > TOLERANCE:
        raise AssertionError("kernel and plain hogbom_loop disagree")
    say(f"  hogbom_loop 1000 iterations: kernel "
        f"{', '.join(f'{v:.1f}' for v in rates[False])} it/s; plain "
        f"{', '.join(f'{v:.1f}' for v in rates[True])} it/s")
    return main_counts, n / best


def _joined_inputs(psf, residual):
    """The joined-channel cube on the card: config 1's problem scaled to 4
    channels by a spectral index of -0.7, channel weights (1, 0.8, 1.2,
    0.5).  Returns (psfs, residual, Radler keyword arguments)."""
    dev = torch.device(DEVICE)
    C = 4
    freqs = np.array([[1.0e8 + c * 2e7, 1.2e8 + c * 2e7] for c in range(C)])
    scale = ((freqs.mean(1) / freqs.mean()) ** -0.7).astype(np.float32)
    res = torch.as_tensor(residual, device=dev)[None] * torch.as_tensor(
        scale, device=dev)[:, None, None]
    psfs = torch.as_tensor(psf, device=dev)[None].repeat(C, 1, 1)
    weights = np.array([1.0, 0.8, 1.2, 0.5])
    return psfs, res, dict(frequencies=freqs, weights=weights)


def phase_joined_channels(psf, residual):
    """4096^2 x 4 channels through perform, channel weights, NO_FITTING."""
    import radler_tpu_torch as rd

    psfs, res, kwargs = _joined_inputs(psf, residual)
    assert _settings(SIZE, 1).spectral_fitting.mode == (
        rd.SpectralFittingMode.NO_FITTING)
    n, seconds, counts, out_res, _ = _perform(psfs, res, 2000, **kwargs)
    say(f"  perform 4 channels: {n} iterations in {seconds:.4f} s, "
        f"{n / seconds:.1f} minor iterations/s; launches {counts}; "
        f"residual rms {rms(res):.6g} -> {rms(out_res):.6g}")
    if not rms(out_res) < rms(res):
        raise AssertionError("the residual did not shrink")


def phase_contract(clark=False, mesh=False):
    """The point-source contract of tests/test_radler.py on the card, with
    the Högbom loop, the Clark loop, or the Högbom loop on a mesh of
    MESH_DEVICES shards (chan 1 x tile 8: B1 on row shards)."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.kernels import hogbom_step as hs
    from radler_tpu_torch.kernels import subminor_loop as sl
    from radler_tpu_torch.kernels import subtract_integrate as si

    size = 64
    point = np.array([[0.0, 0.4, 0.0], [0.25, 1.0, 0.5], [0.0, 0.6, 0.0]],
                     np.float32)
    for sx, sy in ((0, 0), (-9, 15)):
        psf = np.zeros((size, size), np.float32)
        psf[31:34, 31:34] = point
        res = np.zeros((size, size), np.float32)
        cy, cx = size // 2 + sy, size // 2 + sx
        res[cy - 1 : cy + 2, cx - 1 : cx + 2] = 2.5 * point
        s = _settings(size, 1000, clark=clark)
        s.absolute_threshold = 1e-8
        s.parallel.use_device_mesh = mesh
        s.parallel.n_devices = MESH_DEVICES if mesh else 0
        dev = torch.device(DEVICE)
        res_d = torch.as_tensor(res, device=dev)
        model_d = torch.zeros_like(res_d)
        r = rd.Radler(s, torch.as_tensor(psf, device=dev), res_d, model_d,
                      0.0)
        _reset_counts()
        if r.perform(0) is not False:
            raise AssertionError("perform asked for another major iteration")
        if clark and (sl.subminor_loop.launches, _counts()) != (1, (0, 0)):
            raise AssertionError("the Clark perform did not launch B2 once")
        n = r.iteration_number
        if mesh and not (si.subtract_integrate.launches == 0
                         and hs.hogbom_select.launches == 0
                         and n * MESH_DEVICES <= hs.hogbom_step.launches
                         < (n + hs.CHUNK) * MESH_DEVICES):
            raise AssertionError(
                f"the mesh perform's launches: B1 {hs.hogbom_step.launches}, "
                f"select {hs.hogbom_select.launches}, B4 "
                f"{si.subtract_integrate.launches} for {n} iterations")
        out_res = r._table.front.residual_accessor.array.cpu().numpy()
        out_mod = r._table.front.model_accessor.array.cpu().numpy()
        peak = out_mod[cy, cx]
        others = np.delete(out_mod.ravel(), cy * size + cx)
        launched = f"B1 launches {hs.hogbom_step.launches}, " if mesh else ""
        say(f"  shift ({sx},{sy}): {n} iterations, {launched}"
            f"max|residual| {np.abs(out_res).max():.3g}, model peak "
            f"{peak:.7f}, max|model elsewhere| {np.abs(others).max():.3g}")
        if not (np.abs(out_res).max() < 2e-6 and abs(peak - 2.5) <= 2.5e-4
                and np.abs(others).max() < 2e-6):
            raise AssertionError("the point-source contract failed")


# ---------------------------------------------------------------------------
# The Clark subminor loop
# ---------------------------------------------------------------------------


def _subminor_state(C, P, use_rms, allow_negative, seed, bad_psf=False,
                    k_target=SUBMINOR_K):
    """A candidate set of about ``k_target`` pixels from a SUBMINOR_SIZE^2
    cube of positive and negative sources on noise, selected by the port's
    SubMinorLoop.  Returns the loop's inputs on the card."""
    from radler_tpu_torch.image_set import (
        CubeMeta,
        linear_integration_coefficients,
    )
    from radler_tpu_torch.models.subminor import SubMinorLoop

    rng = np.random.default_rng(seed)
    size = SUBMINOR_SIZE
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2.0 + (xx - size // 2) ** 2.0
    psfs = np.stack([
        np.exp(-r2 / (2.0 * (2.0 + 0.3 * c) ** 2))
        + 0.08 * np.exp(-((np.sqrt(r2) - 12.0) ** 2) / 8.0)
        for c in range(C)
    ]).astype(np.float32)
    if bad_psf:  # every subtraction grows the peak: the loop diverges
        psfs *= np.float32(-2.5)
    sky = np.zeros((size, size), np.float32)
    ys, xs = rng.integers(size // 8, 7 * size // 8, (2, 60))
    np.add.at(sky, (ys, xs), rng.uniform(-1.0, 1.0, 60).astype(np.float32))
    planes = []
    for c in range(C):
        conv = np.fft.irfft2(np.fft.rfft2(sky) * np.fft.rfft2(
            np.fft.ifftshift(np.abs(psfs[c]))), s=(size, size))
        for p in range(P):
            planes.append(conv * (1.0 - 0.2 * p) * (1.0 + 0.1 * c))
    cube = np.stack(planes) + rng.normal(scale=0.005, size=(C * P, size, size))
    dev = torch.device(DEVICE)
    cube_d = torch.as_tensor(cube.astype(np.float32), device=dev)
    meta = CubeMeta(C, P, tuple(float(w) for w in rng.uniform(0.5, 2.0, C)),
                    (True,) * P, 1.0, False,
                    tuple(1e8 + 2e7 * c for c in range(C)))
    coef = torch.as_tensor(linear_integration_coefficients(meta), device=dev)
    integrated = torch.einsum("i,ihw->hw", coef, cube_d).abs()
    loop = SubMinorLoop(size, size, 2 * size, 2 * size)
    loop.set_threshold(float(integrated.flatten().sort().values[-k_target]),
                       0.0)
    loop.allow_negative_components = allow_negative
    if use_rms:
        loop.rms_factor_image = torch.as_tensor(
            (0.6 + 0.8 * xx / size).astype(np.float32), device=dev)
    k = loop.find_peak_positions(cube_d, meta)
    return dict(loop=loop, k=k, psfs=torch.as_tensor(psfs, device=dev),
                coef=coef, meta=meta)


def _subminor_run(state, params, proj, plan=None):
    """One run on a fresh copy of the state: the plain version when ``plan``
    is None, else the kernel launched by that plan."""
    from radler_tpu_torch.kernels import subminor_loop as sl

    loop = state["loop"]
    res = loop._residual_k.clone()
    model = torch.zeros_like(res)
    args = (res, model, loop._rms_k, loop._xs, loop._ys, state["psfs"],
            state["coef"], proj, params)
    n_pols = state["meta"].n_polarizations
    if plan is None:
        out = sl.subminor_loop_reference(*args, n_polarizations=n_pols)
    else:
        out = sl.subminor_loop(*args, n_polarizations=n_pols, _plan=plan)
    torch.cuda.synchronize()
    return out, res, model


def _subminor_plans(n, k):
    """The launch plans a case is held to: the plan the wrapper takes by
    itself, every cluster size (the state in shared memory where it fits),
    the largest cluster with the state in global memory, and, where the raw
    values can travel with the argmax, a cluster and one block where they
    do not."""
    from radler_tpu_torch.kernels import subminor_loop as sl

    plans = [sl.cluster_plan(n, k)]
    plans += [sl.cluster_plan(n, k, cluster_size=r) for r in CLUSTER_SIZES]
    plans.append(sl.cluster_plan(n, k, cluster_size=sl.MAX_CLUSTER,
                                 on_chip=False))
    if n <= sl.SHIP_RAW_MAX_IMAGES:
        plans.append(sl.cluster_plan(n, k, cluster_size=4, ship_raw=False))
        plans.append(sl.cluster_plan(n, k, cluster_size=1, ship_raw=False))
    return plans


def _plan_name(plan):
    return (f"R={plan.cluster_size}"
            f" x{plan.threads}"
            f"{'' if plan.on_chip else ' global'}"
            f"{' raw' if plan.ship_raw else ''}")


def _subminor_cases():
    """(name, C, P, use_rms, allow_negative, fit, divergence_limit,
    stop_on_negative, bad_psf, k_target)."""
    cases = []
    for C, P in ((1, 1), (4, 1), (2, 2)):
        for use_rms in (False, True):
            for allow_negative in (True, False):
                fits = ("NO_FITTING", "POLYNOMIAL") if C > 1 else ("NO_FITTING",)
                for fit in fits:
                    divergence = 4.0 if use_rms != allow_negative else 0.0
                    cases.append((f"{C}ch x {P}pol", C, P, use_rms,
                                  allow_negative, fit, divergence, False,
                                  False, SUBMINOR_K))
    cases.append(("stop on negative", 1, 1, False, True, "NO_FITTING", 0.0,
                  True, False, SUBMINOR_K))
    cases.append(("diverging", 2, 1, False, True, "POLYNOMIAL", 4.0, False,
                  True, SUBMINOR_K))
    cases.append(("under one block", 1, 1, True, True, "NO_FITTING", 4.0,
                  False, False, SUBMINOR_K_SMALL))
    cases.append(("ragged K", 2, 2, True, True, "POLYNOMIAL", 4.0, False,
                  False, SUBMINOR_K_RAGGED))
    cases.append(("beyond shared memory", 4, 1, False, True, "POLYNOMIAL",
                  0.0, False, False, SUBMINOR_K_GLOBAL))
    return cases


def phase_subminor_vs_plain():
    """Kernel B2 against its plain version on the card, over plane counts,
    rms factor, negatives, spectral fit, divergence, stop-on-negative and
    candidate counts, each case at every plan of _subminor_plans: equal
    output bits and state, max |difference| 0."""
    from radler_tpu_torch.kernels import subminor_loop as sl
    from radler_tpu_torch.ops.spectral_fitting import SpectralFitter
    from radler_tpu_torch.settings import SpectralFittingMode

    worst = 0.0
    for i, (name, C, P, use_rms, allow_negative, fit, divergence, stop_neg,
            bad_psf, k_target) in enumerate(_subminor_cases()):
        state = _subminor_state(C, P, use_rms, allow_negative, seed=20 + i,
                                bad_psf=bad_psf, k_target=k_target)
        proj = None
        if fit == "POLYNOMIAL":
            fitter = SpectralFitter(SpectralFittingMode.POLYNOMIAL, 2,
                                    state["meta"].frequencies,
                                    state["meta"].weights)
            proj = torch.as_tensor(
                np.asarray(fitter._projection, np.float32), device=DEVICE)
        params = sl.SubminorParams.make(
            float(state["loop"].threshold) * 0.3, GAIN, 0,
            SUBMINOR_ITERATIONS, divergence, allow_negative, stop_neg)
        out_p, res_p, mod_p = _subminor_run(state, params, proj)
        got_p = sl.read_result(out_p)
        plans = _subminor_plans(C * P, state["k"])
        if k_target == SUBMINOR_K_GLOBAL and plans[0].on_chip:
            raise AssertionError(f"{name}: the plan kept K = {state['k']} in "
                                 "shared memory")
        d = 0.0
        for plan in plans:
            out_k, res_k, mod_k = _subminor_run(state, params, proj, plan)
            d_plan = max(float((res_k - res_p).abs().max()),
                         float((mod_k - mod_p).abs().max()))
            if not (torch.equal(out_k, out_p) and d_plan == 0.0):
                raise AssertionError(
                    f"subminor kernel and plain disagree: {name}, "
                    f"{_plan_name(plan)}: kernel {sl.read_result(out_k)}, "
                    f"plain {got_p}, max|diff| {d_plan:.3g}")
            d = max(d, d_plan)
        say(f"  {name:20s} rms={use_rms:d} allow_negative={allow_negative:d} "
            f"{fit:10s} divergence={divergence:g} K={state['k']}: plain "
            f"{got_p}; kernel equal at {_plan_name(plans[0])} (its own plan), "
            f"{', '.join(_plan_name(p) for p in plans[1:])}; max|diff| "
            f"{d:.3g}")
        if stop_neg and not (got_p[0] < SUBMINOR_ITERATIONS and got_p[1] < 0):
            raise AssertionError("the stop-on-negative case did not stop")
        if bad_psf and not got_p[2]:
            raise AssertionError("the diverging case did not diverge")
        worst = max(worst, d)
        del state
    return worst


def _clark_loop(res_d, meta, settings):
    """A SubMinorLoop configured as GenericClean configures it for one
    perform on ``res_d`` (the initial peak's major-loop threshold included),
    with the candidate set selected."""
    from radler_tpu_torch.models.subminor import (
        SubMinorLoop,
        choose_padded_size,
    )
    from radler_tpu_torch.ops.peak_finder import border_from_ratio

    size = res_d.shape[-1]
    initial = float(res_d.abs().max())
    threshold = max(settings.absolute_threshold,
                    initial * (1.0 - settings.major_loop_gain))
    ph, pw = choose_padded_size(size, size, 1.1)
    loop = SubMinorLoop(size, size, pw, ph)
    loop.set_iteration_info(0, settings.minor_iteration_count)
    loop.set_threshold(threshold, threshold * 0.99)
    loop.set_gain(settings.minor_loop_gain)
    loop.divergence_limit = settings.divergence_limit
    loop.set_clean_borders(*border_from_ratio(size, size,
                                              settings.border_ratio))
    return loop


def phase_subminor_times(psf, residual):
    """B2 at config 2's candidate set.  First the whole run of config 2's
    perform, kernel (by the plan the wrapper takes) against plain, each on
    its own copy of the selected state: equal output, residual and model.
    Then both timed in turns plain, kernel, kernel, plain, one launch of
    SUBMINOR_TIMED_ITERATIONS iterations each; the kernel at every cluster
    size, and with and without the raw values in the first exchange, at
    config 2's set and at the counts of SUBMINOR_TIMED_K, each list run
    forward and then backward; and the PSF gather that replaces the TPU's
    interaction matrix, alone.  Returns (max |difference|, kernel ms, plain
    ms, bound, cluster size of the plan)."""
    from radler_tpu_torch.image_set import (
        CubeMeta,
        linear_integration_coefficients,
    )
    from radler_tpu_torch.kernels import subminor_loop as sl

    dev = torch.device(DEVICE)
    res_d = torch.as_tensor(residual, device=dev)[None]
    psfs = torch.as_tensor(psf, device=dev)[None]
    meta = CubeMeta(1, 1, (1.0,), (True,), 1.0, False, (0.0,))
    loop = _clark_loop(res_d[0], meta,
                       _settings(CLARK_SIZE, ITERATIONS, clark=True))
    k = loop.find_peak_positions(res_d, meta)
    coef = torch.as_tensor(linear_integration_coefficients(meta), device=dev)

    def launch(loop, plan, params, res_k, model_k):
        args = (res_k, model_k, None, loop._xs, loop._ys, psfs, coef, None,
                params)
        if plan is None:
            return sl.subminor_loop_reference(*args, n_polarizations=1)
        return sl.subminor_loop(*args, n_polarizations=1, _plan=plan)

    own = sl.cluster_plan(1, k)
    perform_params = sl.SubminorParams.make(
        loop.threshold, loop.gain, loop.current_iteration, loop.max_iterations,
        loop.divergence_limit, loop.allow_negative_components,
        loop.stop_on_negative_component)
    finals = []
    for plan in (own, None):
        res_k = loop._residual_k.clone()
        model_k = torch.zeros_like(res_k)
        out = launch(loop, plan, perform_params, res_k, model_k)
        torch.cuda.synchronize()
        finals.append((out, res_k, model_k))
    (out_k, res_k, mod_k), (out_p, res_p, mod_p) = finals
    d = max(float((res_k - res_p).abs().max()),
            float((mod_k - mod_p).abs().max()))
    say(f"  K = {k}, the plan: {own}")
    say(f"  config 2's whole run: kernel {sl.read_result(out_k)}, "
        f"plain {sl.read_result(out_p)}, max|diff| {d:.3g}")
    if not (torch.equal(out_k, out_p) and torch.equal(res_k, res_p)
            and torch.equal(mod_k, mod_p)):
        raise AssertionError("subminor kernel and plain disagree at config 2")
    if sl.read_result(out_k)[0] == 0:
        raise AssertionError("config 2's subminor run made no iteration")
    if own.cluster_size < 2:
        raise AssertionError("config 2 does not run on a cluster")

    params = sl.SubminorParams.make(0.0, GAIN, 0, SUBMINOR_TIMED_ITERATIONS,
                                    0.0, True, False)
    res_k = loop._residual_k.clone()
    model_k = torch.zeros_like(res_k)
    times = {True: [], False: []}
    for plain in (True, False, False, True):
        ms, host_ms = _time_ms(
            lambda: launch(loop, None if plain else own, params, res_k,
                           model_k), 1 if plain else 5)
        times[plain].append(ms)
        say(f"  {'plain ' if plain else 'kernel'} subminor_loop: {ms:.4f} ms "
            f"per launch of {SUBMINOR_TIMED_ITERATIONS} iterations, "
            f"{ms * 1e3 / SUBMINOR_TIMED_ITERATIONS:.2f} us per iteration "
            f"(host enqueue {host_ms:.4f} ms)")

    # Every cluster size, and both exchanges, at four candidate counts.
    integrated = res_d[0].abs().flatten().sort().values
    for k_target in (*SUBMINOR_TIMED_K[:2], None, *SUBMINOR_TIMED_K[2:]):
        timed = loop
        if k_target is not None:
            timed = _clark_loop(res_d[0], meta,
                                _settings(CLARK_SIZE, ITERATIONS, clark=True))
            timed.set_threshold(float(integrated[-k_target]), 0.0)
            timed.find_peak_positions(res_d, meta)
        k_timed = timed._residual_k.shape[1]
        chosen = sl.cluster_plan(1, k_timed)
        plans = [sl.cluster_plan(1, k_timed, cluster_size=r)
                 for r in CLUSTER_SIZES]
        plans.append(chosen._replace(ship_raw=False))
        res_t = timed._residual_k.clone()
        model_t = torch.zeros_like(res_t)
        readings = {i: [] for i in range(len(plans))}
        for i in (*range(len(plans)), *reversed(range(len(plans)))):
            ms, _ = _time_ms(
                lambda: launch(timed, plans[i], params, res_t, model_t), 3)
            readings[i].append(ms * 1e3 / SUBMINOR_TIMED_ITERATIONS)
        say(f"  K = {k_timed}: us per iteration "
            + "; ".join(f"{_plan_name(plans[i])} {a:.2f}, {b:.2f}"
                        for i, (a, b) in readings.items())
            + f"; the plan takes {_plan_name(chosen)}")

    # The PSF values at every candidate relative to one component: what the
    # kernel gathers per iteration, as plain torch ops.
    psf_flat = psfs.reshape(1, -1)
    m = k // 2
    xs, ys = loop._xs.long(), loop._ys.long()

    def gather():
        sy = ys - ys[m] + CLARK_SIZE // 2
        sx = xs - xs[m] + CLARK_SIZE // 2
        inside = (sy >= 0) & (sy < CLARK_SIZE) & (sx >= 0) & (sx < CLARK_SIZE)
        src = sy.clamp(0, CLARK_SIZE - 1) * CLARK_SIZE + sx.clamp(
            0, CLARK_SIZE - 1)
        return torch.where(inside, psf_flat[:, src], 0.0)

    gather_ms, _ = _time_ms(gather, 200)
    say(f"  PSF gather at the candidates (plain torch ops) "
        f"{gather_ms * 1e3:.2f} us per iteration; the interaction matrix "
        f"it replaces would hold {k * k * 4 / 1e9:.1f} GB")
    # The timed launch's least work: the [1, K] residual and model, the
    # positions, the coefficient and the whole PSF read once, residual and
    # model written once; per iteration and candidate one fused
    # multiply-add, the integration and a compare.
    n_bytes = 4 * (4 * k + 2 * k + 1 + psfs.numel())
    n_flops = SUBMINOR_TIMED_ITERATIONS * k * 4
    return d, sum(times[False]) / 2, sum(times[True]) / 2, bound_ms(
        n_bytes, n_flops), own.cluster_size


def phase_config2(psf, residual):
    """Config 2, the Clark loop at 2048^2, through Radler.perform: one B2
    launch per perform, the rate, and the time split of a perform."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.image_set import CubeMeta
    from radler_tpu_torch.kernels import subminor_loop as sl

    dev = torch.device(DEVICE)
    psf_d = torch.as_tensor(psf, device=dev)
    res_d = torch.as_tensor(residual, device=dev)
    settings = _settings(CLARK_SIZE, ITERATIONS, clark=True)

    def perform():
        res = res_d.clone()
        model = torch.zeros_like(res)
        r = rd.Radler(settings, psf_d, res, model, 0.0)
        torch.cuda.synchronize()
        _reset_counts()
        start = time.perf_counter()
        r.perform(0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = (sl.subminor_loop.launches, *_counts())
        if counts != (1, 0, 0):
            raise AssertionError(f"launch counts {counts} for a Clark perform")
        table = r._table
        return (r.iteration_number, seconds, counts[0],
                table.front.residual_accessor.array,
                table.front.model_accessor.array)

    perform()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    runs = [perform() for _ in range(3)]
    n, _, launches, out_res, out_mod = runs[-1]
    best = min(r[1] for r in runs)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if not (torch.isfinite(out_res).all() and torch.isfinite(out_mod).all()):
        raise AssertionError("non-finite residual or model")
    if not rms(out_res) < rms(res_d):
        raise AssertionError("the residual did not shrink")

    # The split of one perform's main steps, each synchronized: candidate
    # selection, the B2 launch and its result read, the FFT correction.
    meta = CubeMeta(1, 1, (1.0,), (True,), 1.0, False, (0.0,))
    cube = res_d[None].clone()
    loop = _clark_loop(res_d, meta, settings)
    split = {}
    torch.cuda.synchronize()
    start = time.perf_counter()
    k = loop.find_peak_positions(cube, meta)
    torch.cuda.synchronize()
    split["selection"] = time.perf_counter() - start
    start = time.perf_counter()
    loop.run(cube, meta, psf_d[None])
    torch.cuda.synchronize()
    split["B2 launch"] = time.perf_counter() - start
    start = time.perf_counter()
    new_res, full_model = loop.correct_residual_dirty(cube, psf_d[None])
    torch.cuda.synchronize()
    split["FFT correction"] = time.perf_counter() - start
    d_split = float((new_res[0] - out_res).abs().max())
    if loop.current_iteration != n or d_split > TOLERANCE:
        raise AssertionError(
            f"the split run differs from perform's: {loop.current_iteration} "
            f"iterations, max|dres| {d_split:.3g}")
    say(f"  perform: K = {k}, {n} iterations; seconds "
        f"{', '.join(f'{r[1]:.4f}' for r in runs)}; best "
        f"{n / best:.1f} minor iterations/s; subminor_loop launches "
        f"{launches} per perform")
    say("  split of one perform: " + ", ".join(
        f"{name} {sec * 1e3:.3f} ms" for name, sec in split.items()))
    say(f"  residual rms {rms(res_d):.6g} -> {rms(out_res):.6g}; model sum "
        f"{float(out_mod.double().sum()):.6g}; max_memory_allocated "
        f"{peak_mib:.1f} MiB")
    return launches, n / best


def phase_local_rms(psf, residual):
    """One perform with local-RMS weighting (RMS_WINDOW) at 2048^2, Clark."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.kernels import subminor_loop as sl

    dev = torch.device(DEVICE)
    res = torch.as_tensor(residual, device=dev)
    noise = np.random.default_rng(SEED).normal(scale=0.01, size=res.shape)
    res = res + torch.as_tensor(noise.astype(np.float32), device=dev)
    before = rms(res)
    s = _settings(CLARK_SIZE, 2000, clark=True)
    # The weighting divides by the local RMS, which is high around the
    # sources: their weighted peaks are a few times the noise (0.01).
    s.absolute_threshold = 0.02
    s.pixel_scale.x = s.pixel_scale.y = np.deg2rad(1.0 / 3600.0)
    s.local_rms.method = rd.LocalRmsMethod.RMS_WINDOW
    s.local_rms.window = 5.0
    r = rd.Radler(s, torch.as_tensor(psf, device=dev), res,
                  torch.zeros_like(res), 5.0 * s.pixel_scale.x)
    _reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    r.perform(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    out = r._table.front.residual_accessor.array
    say(f"  RMS_WINDOW perform: {r.iteration_number} iterations in "
        f"{seconds:.4f} s; subminor_loop launches {sl.subminor_loop.launches}; "
        f"residual rms {before:.6g} -> {rms(out):.6g}")
    if sl.subminor_loop.launches != 1 or r.iteration_number == 0:
        raise AssertionError("the local-RMS perform did not run B2")
    if not (torch.isfinite(out).all() and rms(out) < before):
        raise AssertionError("the local-RMS perform went wrong")


def phase_batched_irfft():
    """The batched inverse FFT against per-plane inverses on the card and
    against NumPy, once: the JAX package maps inverses per plane for a TPU
    fault that the port does not work around."""
    rng = np.random.default_rng(SEED)
    s = (CLARK_SIZE, CLARK_SIZE)
    images = rng.normal(size=(8, *s)).astype(np.float32)
    spec = torch.fft.rfft2(torch.as_tensor(images, device=DEVICE))
    batched = torch.fft.irfft2(spec, s=s)
    planes = torch.stack([torch.fft.irfft2(p, s=s) for p in spec])
    scale = float(planes.abs().max())
    rel = float((batched - planes).abs().max()) / scale
    ref = np.fft.irfft2(spec[0].cpu().numpy().astype(np.complex128), s=s)
    rel_np = float(np.abs(batched[0].cpu().numpy() - ref).max()
                   / np.abs(ref).max())
    rel_img = float(np.abs(batched.cpu().numpy() - images).max()
                    / np.abs(images).max())
    say(f"  [8, {CLARK_SIZE}, {CLARK_SIZE}] irfft2: batched vs per-plane "
        f"max rel {rel:.3g}; batched plane 0 vs NumPy float64 max rel "
        f"{rel_np:.3g}; round trip max rel {rel_img:.3g}")
    if max(rel, rel_np, rel_img) > 1e-5:
        raise AssertionError("the batched inverse FFT is inaccurate")


# ---------------------------------------------------------------------------
# IUWT
# ---------------------------------------------------------------------------


def _atrous_case(img, n_lo, label, quiet=False):
    """B3 and its plain version on ``img``: raises unless they are
    bit-equal; returns the largest |difference|."""
    from radler_tpu_torch.kernels import iuwt_atrous as ia

    pw, psmooth = ia.atrous_decompose_lo_reference(img, n_lo)
    w, smooth = ia.atrous_decompose_lo(img, n_lo)
    torch.cuda.synchronize()
    d = max(float((w - pw).abs().max()),
            float((smooth - psmooth).abs().max()))
    if not (torch.equal(w, pw) and torch.equal(smooth, psmooth)):
        raise AssertionError(
            f"B3 and its plain version disagree: {label}, n_lo={n_lo}, "
            f"max|diff| {d:.3g}")
    if not quiet:
        plan = ia.launch_plan(n_lo, *img.shape[-2:])
        say(f"  {label:22s} n_lo={n_lo}: bit-equal in {len(plan)} launches, "
            f"max|diff| {d:.3g}")
    return d


def phase_atrous_vs_plain():
    """Kernel B3 against its plain version on the card: every shape of
    ATROUS_SHAPES at its scale counts, bit-equal.  Returns the largest
    |difference| (0 when all agree)."""
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for shape, label, scale_counts in ATROUS_SHAPES:
        img = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                              device=DEVICE)
        for n_lo in scale_counts:
            worst = max(worst, _atrous_case(img, n_lo, label))
        del img
        torch.cuda.empty_cache()
    return worst


def phase_atrous_main_shapes(cases):
    """B3 against its plain version at every (input shape, scale count)
    that config 4's perform gave it (``cases``, a Counter of calls), on
    random inputs, bit-equal.  Returns the largest |difference|."""
    rng = np.random.default_rng(SEED + 1)
    worst = 0.0
    for shape, n_lo in sorted(cases):
        img = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                              device=DEVICE)
        worst = max(worst, _atrous_case(img, n_lo, "x".join(map(str, shape)),
                                        quiet=True))
    listed = ", ".join(f"{list(shape)} at {n_lo} scales: {calls} calls"
                       for (shape, n_lo), calls in sorted(cases.items()))
    say(f"  {len(cases)} distinct cases ({listed}): all bit-equal, "
        f"max|diff| {worst:.3g}")
    return worst


def _conv_cascade(image, n_lo, kh, kv):
    """The same scales with cuDNN: per scale two dilated 1x5 and 5x1
    convolutions with zero padding, twice, and the difference (the library
    yardstick of B3; the port never calls it)."""
    import torch.nn.functional as F
    from radler_tpu_torch.kernels.iuwt_atrous import dilation

    x = image[None, None]
    planes = []
    for s in range(n_lo):
        d = dilation(s)

        def smooth(v):
            v = F.conv2d(v, kh, padding=(0, 2 * d), dilation=(1, d))
            return F.conv2d(v, kv, padding=(2 * d, 0), dilation=(d, 1))

        i1 = smooth(x)
        planes.append(x - smooth(i1))
        x = i1
    return planes, x


def phase_atrous_times():
    """B3 at 4096^2 for each of ATROUS_TIMED_SCALES against its plain
    version (in turns plain, kernel, kernel, plain) and against the same
    cascade as cuDNN dilated convolutions (TF32 off).  Returns
    {n_lo: (kernel ms, plain ms, library ms, bytes, flops)}."""
    from radler_tpu_torch.kernels import iuwt_atrous as ia

    rng = np.random.default_rng(SEED)
    img = torch.as_tensor(
        rng.standard_normal((IUWT_SIZE, IUWT_SIZE)).astype(np.float32),
        device=DEVICE)
    taps = torch.tensor(ia.TAPS, dtype=torch.float32, device=DEVICE)
    kh, kv = taps.reshape(1, 1, 1, 5), taps.reshape(1, 1, 5, 1)
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    pixels = img.numel()
    for n_lo in ATROUS_TIMED_SCALES:
        w, smooth = ia.atrous_decompose_lo(img, n_lo)
        lib_w, lib_smooth = _conv_cascade(img, n_lo, kh, kv)
        d_lib = max(max(float((a - b).abs().max()) for a, b in
                        zip(w, lib_w)),
                    float((lib_smooth[0, 0] - smooth).abs().max()))
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = (ia.atrous_decompose_lo if which == "kernel"
                  else ia.atrous_decompose_lo_reference)
            ms, _ = _time_ms(lambda: fn(img, n_lo), 10)
            times[which].append(ms)
        lib_ms, _ = _time_ms(lambda: _conv_cascade(img, n_lo, kh, kv), 10)
        k_ms = sum(times["kernel"]) / 2
        p_ms = sum(times["plain"]) / 2
        # The function's least work: one plane read, n_lo + 1 written; per
        # scale and pixel four 5-tap passes (each value's three products
        # once and four sums) and a subtraction.
        n_bytes = (n_lo + 2) * pixels * 4
        n_flops = n_lo * 29 * pixels
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        out[n_lo] = (k_ms, p_ms, lib_ms, n_bytes, n_flops)
        say(f"  n_lo={n_lo}: kernel {times['kernel'][0]:.4f}, "
            f"{times['kernel'][1]:.4f} ms "
            f"({len(ia.launch_plan(n_lo, IUWT_SIZE, IUWT_SIZE))} launches); "
            f"plain "
            f"{times['plain'][0]:.4f}, {times['plain'][1]:.4f} ms; cuDNN "
            f"cascade {lib_ms:.4f} ms (max|diff| to B3 {d_lib:.3g}); bound "
            f"{b_ms * 1e3:.1f} us ({b_by}, {n_bytes / 1e6:.1f} MB); "
            f"{n_bytes / (k_ms * 1e-3) / 1e9:.0f} GB/s")
        if d_lib > 1e-5:
            raise AssertionError("B3 and the cuDNN cascade disagree")
    torch.backends.cudnn.allow_tf32 = True
    return out


def _iuwt_settings(size, iterations, major_loop_gain=1.0):
    import radler_tpu_torch as rd

    s = rd.Settings()
    s.algorithm_type = rd.AlgorithmType.IUWT
    s.trimmed_image_width = s.trimmed_image_height = size
    s.minor_iteration_count = iterations
    s.major_loop_gain = major_loop_gain
    return s


def _count_syncs(run):
    """Run ``run()`` with CUDA's sync debug mode on and count the
    synchronizing operations it warns about (reads to the host, blocking
    copies)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _timed_split(split):
    """Wrap the IUWT's main steps with synchronized timers that add to
    ``split``; returns a function that restores them."""
    from radler_tpu_torch.models import iuwt as iuwt_model
    from radler_tpu_torch.ops import iuwt as iuwt_ops

    saved = []

    def wrap(module, name, label):
        fn = getattr(module, name)
        saved.append((module, name, fn))

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls, seconds = split.get(label, (0, 0.0))
            split[label] = (calls + 1, seconds + time.perf_counter() - start)
            return out

        setattr(module, name, timed)

    wrap(iuwt_ops, "decompose", "decompose (B3)")
    wrap(iuwt_ops, "recompose", "recompose (shifted adds)")
    wrap(iuwt_ops, "convolve_same_prefft", "FFT convolution in the CG")
    wrap(iuwt_ops, "convolve_same", "other FFT convolutions")
    wrap(iuwt_model, "convolve_same", "other FFT convolutions")
    wrap(iuwt_ops, "mad_sigma_batched", "MAD sigma (sort)")
    wrap(iuwt_ops, "structure_stats_select", "stats + selection (inclusive)")
    wrap(iuwt_ops, "conjugate_gradient", "CG solve (inclusive)")

    def restore():
        for module, name, fn in saved:
            setattr(module, name, fn)

    return restore


def phase_config4():
    """Config 4: IUWT 4096^2, one channel, 16 structure iterations, major
    gain 0.8, through Radler.perform on CUDA tensors: a warm-up and the
    best of 2, B3 launches and host syncs per perform, peak memory, then
    the split of one perform's time.  Returns (B3 launches, structure
    iterations per second, a Counter of the (input shape, scale count)
    calls that the warm-up gave B3)."""
    from collections import Counter

    import radler_tpu_torch as rd
    from radler_tpu_torch.kernels import iuwt_atrous as ia
    from radler_tpu_torch.ops import iuwt as iuwt_ops

    start = time.perf_counter()
    psfs, residual = make_diffuse_problem(IUWT_SIZE, 1)
    say(f"  problem made in {time.perf_counter() - start:.1f} s (NumPy)")
    psf_d = torch.as_tensor(psfs[0], device=DEVICE)
    res_d = torch.as_tensor(residual[0], device=DEVICE)
    del psfs, residual

    def perform(count_syncs=False):
        res = res_d.clone()
        r = rd.Radler(_iuwt_settings(IUWT_SIZE, IUWT_ITERATIONS, 0.8), psf_d,
                      res, torch.zeros_like(res), 0.0)
        torch.cuda.synchronize()
        _reset_counts()
        begin = time.perf_counter()
        syncs = None
        if count_syncs:
            syncs = _count_syncs(lambda: r.perform(0))
        else:
            r.perform(0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - begin
        front = r._table.front
        return (r.iteration_number, seconds, ia.atrous_decompose_lo.launches,
                syncs, front.residual_accessor.array,
                front.model_accessor.array)

    b3_cases = Counter()
    real_b3 = iuwt_ops.atrous_decompose_lo

    def recording_b3(image, n_lo, **kwargs):
        b3_cases[(tuple(image.shape), n_lo)] += 1
        return real_b3(image, n_lo, **kwargs)

    iuwt_ops.atrous_decompose_lo = recording_b3
    try:
        warm = perform()
    finally:
        iuwt_ops.atrous_decompose_lo = real_b3
    say(f"  warm-up perform: {warm[0]} structure iterations in "
        f"{warm[1]:.4f} s")
    torch.cuda.reset_peak_memory_stats()
    runs = [perform() for _ in range(2)]
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    n, _, launches, _, out_res, out_mod = runs[-1]
    best = min(r[1] for r in runs)
    if any(r[0] != n or r[2] != launches for r in runs + [warm]):
        raise AssertionError("config 4's performs differ in iterations or "
                             "B3 launches")
    if not (torch.isfinite(out_res).all() and torch.isfinite(out_mod).all()):
        raise AssertionError("non-finite residual or model")
    if not (n > 0 and launches > 0 and rms(out_res) < rms(res_d)):
        raise AssertionError("config 4 did not clean through B3")
    planned = sum(calls * len(ia.launch_plan(n_lo, *shape[-2:]))
                  for (shape, n_lo), calls in b3_cases.items())
    if launches != planned:
        raise AssertionError(f"config 4 launched B3 {launches} times, its "
                             f"launch plans give {planned}")
    counted = perform(count_syncs=True)
    say(f"  perform: {n} structure iterations; seconds "
        f"{', '.join(f'{r[1]:.4f}' for r in runs)}; best "
        f"{n / best:.3f} structure iterations/s; B3 launches {launches} per "
        f"perform; host syncs {counted[3]} per perform (sync debug mode on, "
        f"{counted[1]:.4f} s)")
    say(f"  residual rms {rms(res_d):.6g} -> {rms(out_res):.6g}; model sum "
        f"{float(out_mod.double().sum()):.6g}; max_memory_allocated "
        f"{peak_mib:.1f} MiB")
    split = {}
    restore = _timed_split(split)
    try:
        timed = perform()
    finally:
        restore()
    say(f"  split of one perform ({timed[1]:.4f} s with a synchronize "
        f"around each step; inclusive times, steps nest):")
    for label, (calls, seconds) in split.items():
        say(f"    {label}: {calls} calls, {seconds * 1e3:.1f} ms")
    return launches, n / best, b3_cases


def phase_iuwt_contract():
    """The 128^2 diffuse source of the IUWT tests on CUDA tensors against
    the port's CPU run of the same inputs, at 40 and 50 structure
    iterations: the residual within CARD_VS_CPU absolute and relative rms
    (the same code on the same inputs), and at 50 (the JAX test's setting)
    the JAX test's gates."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.kernels import iuwt_atrous as ia
    from radler_tpu_torch.ops.convolution import padded_convolve

    size = 128
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psf = np.exp(-r2 / 8.0).astype(np.float32)
    sky = np.exp(-((yy - 60.0) ** 2 + (xx - 70.0) ** 2) / 32.0).astype(
        np.float32)
    res = padded_convolve(torch.as_tensor(sky), torch.as_tensor(psf)).numpy()
    res += np.random.default_rng(0).normal(scale=1e-3, size=res.shape).astype(
        np.float32)
    host_rms = lambda a: float(np.sqrt((a.astype(np.float64) ** 2).mean()))  # noqa: E731
    for iterations in (40, 50):
        cpu_res, cpu_model = res.copy(), np.zeros_like(res)
        rd.Radler(_iuwt_settings(size, iterations), psf, cpu_res, cpu_model,
                  0.0, device="cpu").perform(0)
        _reset_counts()
        r = rd.Radler(_iuwt_settings(size, iterations),
                      torch.as_tensor(psf, device=DEVICE),
                      torch.as_tensor(res, device=DEVICE),
                      torch.zeros(size, size, device=DEVICE), 0.0)
        r.perform(0)
        front = r._table.front
        out_res = front.residual_accessor.array.cpu().numpy()
        out_mod = front.model_accessor.array.cpu().numpy()
        d = float(np.abs(out_res - cpu_res).max())
        rel = abs(host_rms(out_res) - host_rms(cpu_res)) / host_rms(cpu_res)
        flux_rel = abs(out_mod.sum() - cpu_model.sum()) / cpu_model.sum()
        say(f"  {iterations} iterations: card {r.iteration_number}, B3 "
            f"launches {ia.atrous_decompose_lo.launches}; residual rms "
            f"{host_rms(res):.6g} -> {host_rms(out_res):.6g} (CPU "
            f"{host_rms(cpu_res):.6g}); max|dres| to CPU {d:.3g}, rms rel "
            f"{rel:.3g}; model flux {out_mod.sum():.6g} (CPU "
            f"{cpu_model.sum():.6g}, sky {sky.sum():.6g})")
        ok = (r.iteration_number == iterations and d <= CARD_VS_CPU
              and rel <= CARD_VS_CPU and flux_rel <= 1e-3
              and ia.atrous_decompose_lo.launches > 0)
        if iterations == 50:
            ok = ok and (host_rms(out_res) <= 0.25 * host_rms(res)
                         and np.abs(out_res).max() <= 0.1 * np.abs(res).max()
                         and abs(out_mod.sum() - sky.sum()) < 0.2 * sky.sum())
        if not ok:
            raise AssertionError(f"the IUWT contract failed at {iterations} "
                                 "iterations")


# ---------------------------------------------------------------------------
# The mesh Högbom loop
# ---------------------------------------------------------------------------


def _gaussian_psfs(count, height, width):
    yy, xx = np.mgrid[0:height, 0:width]
    r2 = (yy - height // 2) ** 2.0 + (xx - width // 2) ** 2.0
    return np.stack([np.exp(-r2 / (2.0 * (2.0 + 0.25 * c) ** 2))
                     for c in range(count)]).astype(np.float32)


def _shard_inputs(case, seed):
    """One shard of a case of B4_CASES or B1_SHARD_CASES on the card: its
    rows of a residual with sources on noise, the PSFs of its channels at
    the full image size, component values, B4's plane and polarization
    coefficients, B1's coefficients and a weight for its rows."""
    from radler_tpu_torch.kernels import hogbom_step as hs
    from radler_tpu_torch.kernels import subtract_integrate as si

    _, mode, n, P, height, width, tiles, shard = case
    h_loc = height // tiles
    rng = np.random.default_rng(seed)
    res = rng.normal(scale=0.01, size=(n, h_loc, width)).astype(np.float32)
    for _ in range(40):
        y, x = rng.integers(0, h_loc), rng.integers(0, width)
        res[:, y, x] += rng.uniform(0.5, 2.0, n).astype(np.float32)
    n_chan = n // P
    chan = rng.uniform(0.2, 1.2, n if mode in ("signed", "linear")
                       else n_chan).astype(np.float32)
    pol = rng.uniform(0.3, 1.0, P).astype(np.float32)
    dev = torch.device(DEVICE)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return dict(
        res=t(res), psfs=t(_gaussian_psfs(n_chan, height, width)),
        values=t(rng.uniform(-0.5, 0.8, n).astype(np.float32)),
        coefs=t(si.plane_coefficients(mode, chan, P)), pol=t(pol),
        b1_coefs=t(hs.kernel_coefficients(mode, chan, pol)),
        weight=t(rng.uniform(0.0, 1.0, (h_loc, width)).astype(np.float32)),
        r0=shard * h_loc, h_loc=h_loc,
    )


def _shard_peaks(r0, h_loc, height, width):
    """Peaks in the shard, in a shard above and below where there is one,
    and at the image's four corners."""
    peaks = [(r0 + h_loc // 3, width // 3)]
    if r0 >= 37:
        peaks.append((r0 - 37, width - 5))
    if r0 + h_loc + 41 < height:
        peaks.append((r0 + h_loc + 41, 7))
    return peaks + [(0, 0), (0, width - 1), (height - 1, 0),
                    (height - 1, width - 1)]


def _state_at(y, x, width):
    return torch.tensor([y, x, 1, 0, 0, 1, y * width + x, 0],
                        dtype=torch.int32, device=DEVICE)


def _compare(label, kernel_out, plain_out):
    """Raise unless the kernel's tensors equal the plain version's bit for
    bit; return the largest |difference|."""
    torch.cuda.synchronize()
    d = max(float((a.double() - b.double()).abs().max())
            for a, b in zip(kernel_out, plain_out))
    if not all(torch.equal(a, b) for a, b in zip(kernel_out, plain_out)):
        raise AssertionError(f"kernel and plain version disagree: {label}, "
                             f"max|diff| {d:.3g}")
    return d


def phase_mesh_kernels_vs_plain():
    """B4 at B4_CASES and B1 with a row offset at B1_SHARD_CASES against
    their plain versions, at every peak of _shard_peaks: residual, model,
    B4's integration part and B1's partials bit-equal.  Returns the largest
    |difference| of each."""
    from radler_tpu_torch.kernels import hogbom_step as hs
    from radler_tpu_torch.kernels import subtract_integrate as si

    worst = {"subtract_integrate": 0.0, "hogbom_step": 0.0}
    for i, case in enumerate(B4_CASES + B1_SHARD_CASES):
        is_b4 = i < len(B4_CASES)
        label, mode, n, P, height, width = case[:6]
        c = _shard_inputs(case, seed=40 + i)
        r0, h_loc = c["r0"], c["h_loc"]
        peaks = _shard_peaks(r0, h_loc, height, width)
        for y, x in peaks:
            outs = []
            for plain in (False, True):
                res = c["res"].clone()
                model = torch.zeros_like(res)
                state = _state_at(y, x, width)
                if is_b4:
                    part = torch.full((h_loc, width), 3.0, device=DEVICE)
                    run = (si.subtract_integrate_reference if plain
                           else si.subtract_integrate)
                    run(res, model, c["psfs"], c["values"], state,
                        c["coefs"], c["pol"], part, mode=mode,
                        n_polarizations=P, row_offset=r0)
                    outs.append((res, model, part))
                else:
                    step = (hs.hogbom_step_reference if plain
                            else hs.hogbom_step)
                    parts = step(res, model, c["psfs"], c["values"], state,
                                 c["b1_coefs"], c["weight"], mode=mode,
                                 n_polarizations=P, allow_negative=True,
                                 row_offset=r0)
                    outs.append((res, model, *parts))
            name = "subtract_integrate" if is_b4 else "hogbom_step"
            worst[name] = max(worst[name], _compare(
                f"{name} {label} peak {(y, x)}", *outs))
        say(f"  {'B4' if is_b4 else 'B1'} {label:26s} shard [{n}, {h_loc}, "
            f"{width}] at row {r0} of {height}: {len(peaks)} peaks, "
            "bit-equal")
        del c
        torch.cuda.empty_cache()
    return worst


def phase_b4_times():
    """B4 at the mesh configuration's shard, [1, 2048, 4096] in normal mode
    with its peak inside the shard, against its plain version, in turns
    plain, kernel, kernel, plain.  Returns (kernel ms, plain ms, (bound ms,
    bound_by), bytes)."""
    from radler_tpu_torch.kernels import subtract_integrate as si

    case = B4_CASES[0]
    c = _shard_inputs(case, seed=40)
    _, mode, n, P, height, width = case[:6]
    r0, h_loc = c["r0"], c["h_loc"]
    state = _state_at(r0 + h_loc // 3, width // 3, width)
    res = c["res"].clone()
    model = torch.zeros_like(res)
    part = torch.empty((h_loc, width), device=DEVICE)
    times = {True: [], False: []}
    for plain in (True, False, False, True):
        run = si.subtract_integrate_reference if plain else (
            si.subtract_integrate)
        ms, host_ms = _time_ms(
            lambda: run(res, model, c["psfs"], c["values"], state,
                        c["coefs"], c["pol"], part, mode=mode,
                        n_polarizations=P, row_offset=r0), 20)
        times[plain].append(ms)
        say(f"  {'plain ' if plain else 'kernel'} subtract_integrate "
            f"[{n}, {h_loc}, {width}]: {ms:.4f} ms (host enqueue "
            f"{host_ms:.4f} ms)")
    # The least bytes: the residual read and written, the PSF window under
    # the shard's rows read, the part written; per pixel and plane a
    # multiply and a subtraction, then the coefficient's multiply.
    n_bytes = (3 * n + 1) * h_loc * width * 4
    n_flops = 3 * n * h_loc * width
    k_ms, p_ms = sum(times[False]) / 2, sum(times[True]) / 2
    b = bound_ms(n_bytes, n_flops)
    say(f"  bound {b[0] * 1e3:.1f} us ({b[1]}, {n_bytes / 1e6:.1f} MB, the "
        f"PSF window; the whole PSF plane would add "
        f"{(height - h_loc) * width * 4 / 1e6:.1f} MB); kernel "
        f"{n_bytes / (k_ms * 1e-3) / 1e9:.0f} GB/s")
    return k_ms, p_ms, b


def _mesh_settings(size, iterations, use_mesh):
    s = _settings(size, iterations)
    s.parallel.use_device_mesh = use_mesh
    s.parallel.n_devices = MESH_DEVICES if use_mesh else 0
    return s


def _launch_counts():
    """(B4, B1 step, B1 select) launches since the last _reset_counts."""
    from radler_tpu_torch.kernels import hogbom_step as hs
    from radler_tpu_torch.kernels import subtract_integrate as si

    return (si.subtract_integrate.launches, hs.hogbom_step.launches,
            hs.hogbom_select.launches)


def _run_perform(make_radler, count_syncs=False):
    """Build a Radler with ``make_radler()``, then time one perform with the
    launch counts reset just before it.  Returns (iterations, seconds,
    (B4, B1 step, B1 select) launches, host syncs or None, residual cube,
    model cube, the perform's peak device memory above what was allocated
    before it, in MiB)."""
    r = make_radler()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start = time.perf_counter()
    syncs = None
    if count_syncs:
        syncs = _count_syncs(lambda: r.perform(0))
    else:
        r.perform(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = _launch_counts()
    out_res = torch.stack([e.residual_accessor.array for e in r._table])
    out_mod = torch.stack([e.model_accessor.array for e in r._table])
    if not (torch.isfinite(out_res).all() and torch.isfinite(out_mod).all()):
        raise AssertionError("non-finite residual or model")
    peak_mib = (torch.cuda.max_memory_allocated() - before) / 2**20
    return (r.iteration_number, seconds, counts, syncs, out_res, out_mod,
            peak_mib)


def _check_mesh_run(label, mesh_run, single_run, chan):
    """A mesh perform against the single-device perform of the same cube:
    equal iteration counts, residual and model within MESH_VS_SINGLE, and
    one launch of the shard kernel per shard and iteration (B4 when the
    mesh splits channels, B1 otherwise), none of the other."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    n, _, counts = mesh_run[:3]
    d_res = float((mesh_run[4] - single_run[4]).abs().max())
    d_mod = float((mesh_run[5] - single_run[5]).abs().max())
    say(f"  {label}: {n} iterations (single device {single_run[0]}), "
        f"max|dres| {d_res:.3g}, max|dmodel| {d_mod:.3g} against the "
        f"single-device perform; launches B4 {counts[0]}, B1 step "
        f"{counts[1]}, B1 select {counts[2]}")
    shard_kernel, other = (counts[0], counts[1]) if chan > 1 else (
        counts[1], counts[0])
    if not (n * MESH_DEVICES <= shard_kernel < (n + hs.CHUNK) * MESH_DEVICES
            and other == 0 and counts[2] == 0 and n > 0):
        raise AssertionError(f"{label}: launches {counts} for {n} iterations")
    if n != single_run[0] or max(d_res, d_mod) > MESH_VS_SINGLE:
        raise AssertionError(f"{label}: the mesh and single-device performs "
                             "differ")
    return max(d_res, d_mod)


def phase_mesh_perform(psf, residual):
    """The mesh configuration: the joined-channel cube (4 x 4096^2,
    MESH_ITERATIONS iterations, Högbom) through Radler.perform on a chan 4 x
    tile 2 mesh on the card: a warm-up and the best of 3 (minor iterations
    per second), launches, host syncs per perform and peak memory, against
    the single-device perform of the same cube (best of 2).  Returns (B4
    launches, mesh rate, single-device rate)."""
    import radler_tpu_torch as rd

    psfs, res, kwargs = _joined_inputs(psf, residual)

    def radler(use_mesh):
        return lambda: rd.Radler(
            _mesh_settings(SIZE, MESH_ITERATIONS, use_mesh), psfs,
            res.clone(), torch.zeros_like(res), 0.0, **kwargs)

    def timed(use_mesh, count):
        """``count`` performs; the first one's cubes and every one's
        numbers (later cubes are dropped so as not to count in the peak
        memory of the runs after them)."""
        runs = []
        for i in range(count):
            run = _run_perform(radler(use_mesh))
            runs.append(run if i == 0 else run[:4] + (None, None) + run[6:])
        return runs

    singles = timed(False, 2)
    timed(True, 1)  # warm-up
    runs = timed(True, 3)
    counted = _run_perform(radler(True), count_syncs=True)
    if any(r[0] != runs[0][0] or r[2] != runs[0][2] for r in runs + [counted]):
        raise AssertionError("the mesh performs differ in iterations or "
                             "launches")
    _check_mesh_run("chan 4 x tile 2", runs[0], singles[0], chan=4)
    n = runs[0][0]
    best = min(r[1] for r in runs)
    best_single = min(r[1] for r in singles)
    say(f"  mesh perform: seconds {', '.join(f'{r[1]:.4f}' for r in runs)}; "
        f"best {n / best:.1f} minor iterations/s (single device "
        f"{n / best_single:.1f}, seconds "
        f"{', '.join(f'{r[1]:.4f}' for r in singles)}); host syncs "
        f"{counted[3]} per perform (sync debug mode on, {counted[1]:.4f} s)")
    say(f"  peak device memory of a perform above its inputs: mesh "
        f"{max(r[6] for r in runs):.1f} MiB, single device "
        f"{max(r[6] for r in singles):.1f} MiB (inputs: the 4 x {SIZE}^2 "
        f"residual and PSFs, {2 * res.numel() * 4 / 2**20:.1f} MiB)")
    say(f"  residual rms {rms(res):.6g} -> {rms(runs[0][4]):.6g}")
    return runs[0][2][0], n / best, n / best_single


def phase_mesh_squared(psf2, residual2):
    """2 channels x 2 linked polarizations (XX, YY) with squared joins at
    2048^2, 1000 iterations, through Radler.perform on a chan 2 x tile 4
    mesh (B4 in squared mode) against the single-device perform."""
    import radler_tpu_torch as rd

    dev = torch.device(DEVICE)
    psf_d = torch.as_tensor(psf2, device=dev)
    base = torch.as_tensor(residual2, device=dev)

    def radler(use_mesh):
        def make():
            s = _mesh_settings(CLARK_SIZE, 1000, use_mesh)
            s.squared_joins = True
            table = rd.WorkTable([], 2, 2)
            for ch in range(2):
                for p, name in enumerate(("XX", "YY")):
                    e = rd.WorkTableEntry()
                    e.polarization = getattr(rd.Polarization, name)
                    e.original_channel_index = ch
                    e.image_weight = 1.0
                    e.band_start_frequency = 1.0e8 + ch * 2e7
                    e.band_end_frequency = 1.2e8 + ch * 2e7
                    if p == 0:
                        e.psf_accessors = [rd.TensorImageAccessor(psf_d)]
                    img = base * ((1.0 + 0.1 * ch) * (1.0 - 0.3 * p))
                    e.residual_accessor = rd.TensorImageAccessor(img)
                    e.model_accessor = rd.TensorImageAccessor(
                        torch.zeros_like(img))
                    table.add_entry(e)
            return rd.Radler(s, table, beam_size=0.0)
        return make

    single = _run_perform(radler(False))
    mesh = _run_perform(radler(True))
    _check_mesh_run("2ch x 2pol squared, chan 2 x tile 4", mesh, single,
                    chan=2)
    say(f"  seconds: mesh {mesh[1]:.4f}, single device {single[1]:.4f}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    import radler_tpu_torch  # noqa: F401  (fails outside a checkout)

    start = time.perf_counter()
    say("== the card ==")
    smi = phase_card()
    say("== Högbom kernels against their plain versions ==")
    worst = phase_kernels_vs_plain()
    say("== the 4096^2 problem (seed 7, 300 sources) ==")
    psf, residual = make_problem(SIZE, N_SOURCES)
    say("== Högbom kernel times at the main path's shapes ==")
    times = phase_kernel_times(psf, residual)
    say("== config 1 through Radler.perform ==")
    counts, rate = phase_main_path(psf, residual)
    say("== joined channels through Radler.perform ==")
    phase_joined_channels(psf, residual)
    say("== B4 and B1 on row shards against their plain versions ==")
    worst_mesh = phase_mesh_kernels_vs_plain()
    worst["hogbom_step"] = max(worst["hogbom_step"], worst_mesh["hogbom_step"])
    worst["subtract_integrate"] = worst_mesh["subtract_integrate"]
    say("== B4 time at the mesh configuration's shard ==")
    b4_times = phase_b4_times()
    say("== the mesh configuration (joined channels, chan 4 x tile 2) "
        "through Radler.perform ==")
    mesh = phase_mesh_perform(psf, residual)
    del psf, residual
    say("== point-source contract, Högbom ==")
    phase_contract()
    say("== point-source contract, Högbom on a chan 1 x tile 8 mesh ==")
    phase_contract(mesh=True)
    say("== the subminor kernel against its plain version ==")
    worst_small = phase_subminor_vs_plain()
    say("== the 2048^2 problem (seed 7, 300 sources) ==")
    psf2, residual2 = make_problem(CLARK_SIZE, N_SOURCES)
    say("== the subminor kernel at config 2's shapes ==")
    worst_config2, kernel_ms, plain_ms, b2_bound, b2_cluster = (
        phase_subminor_times(psf2, residual2))
    worst["subminor_loop"] = max(worst_small, worst_config2)
    times["subminor_loop"] = (kernel_ms, plain_ms)
    say("== config 2 (Clark) through Radler.perform ==")
    clark = phase_config2(psf2, residual2)
    say("== local RMS through Radler.perform, Clark ==")
    phase_local_rms(psf2, residual2)
    say("== 2ch x 2pol squared joins on a chan 2 x tile 4 mesh ==")
    phase_mesh_squared(psf2, residual2)
    say("== point-source contract, Clark ==")
    phase_contract(clark=True)
    say("== batched irfft2 ==")
    phase_batched_irfft()
    say("== the à-trous kernel (B3) against its plain version ==")
    worst["atrous_decompose_lo"] = phase_atrous_vs_plain()
    say("== B3 times at 4096^2 ==")
    atrous = phase_atrous_times()
    say("== config 4 (IUWT 4096^2) through Radler.perform ==")
    iuwt = phase_config4()
    say("== B3 against its plain version at config 4's shapes ==")
    worst["atrous_decompose_lo"] = max(worst["atrous_decompose_lo"],
                                       phase_atrous_main_shapes(iuwt[2]))
    say("== the IUWT diffuse-source contract ==")
    phase_iuwt_contract()
    say(f"phases took {time.perf_counter() - start:.1f} s")

    kernels = []
    for name, launches in zip(("hogbom_step", "hogbom_select"), counts):
        b_ms, b_by = bound_ms(times["bytes"][name])
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "radler_tpu_torch/csrc/hogbom_step.cu",
            "replaces": "radler_tpu/ops/pallas/hogbom_step.py:37",
            "launches": launches,
            "max_abs_err": worst[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    kernels.append({
        "name": "subminor_loop",
        "route": "cuda",
        "source": "radler_tpu_torch/csrc/subminor_loop.cu",
        "replaces": "radler_tpu/ops/pallas/subminor_fused.py:89",
        "launches": clark[0],
        "max_abs_err": worst["subminor_loop"],
        "ms": times["subminor_loop"][0],
        "plain_ms": times["subminor_loop"][1],
        "bound_ms": b2_bound[0],
        "bound_by": b2_bound[1],
        "library_ms": None,
    })
    # B3 at the case config 4 gave it most often.
    (shape, n_main), _ = iuwt[2].most_common(1)[0]
    if shape != (IUWT_SIZE, IUWT_SIZE):
        raise AssertionError(f"config 4 ran B3 mostly at {shape}, which "
                             "phase_atrous_times does not time")
    k_ms, p_ms, lib_ms, n_bytes, n_flops = atrous[n_main]
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    kernels.append({
        "name": "atrous_decompose_lo",
        "route": "cuda",
        "source": "radler_tpu_torch/csrc/iuwt_atrous.cu",
        "replaces": "radler_tpu/ops/pallas/iuwt_atrous.py:74",
        "launches": iuwt[0],
        "max_abs_err": worst["atrous_decompose_lo"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": lib_ms,
    })
    b4_ms, b4_plain_ms, (b4_bound_ms, b4_bound_by) = b4_times
    kernels.append({
        "name": "subtract_integrate",
        "route": "cuda",
        "source": "radler_tpu_torch/csrc/subtract_integrate.cu",
        "replaces": "radler_tpu/ops/pallas/hogbom_step.py:329",
        "launches": mesh[0],
        "max_abs_err": worst["subtract_integrate"],
        "ms": b4_ms,
        "plain_ms": b4_plain_ms,
        "bound_ms": b4_bound_ms,
        "bound_by": b4_bound_by,
        "library_ms": None,
    })
    say(f"config 1: {rate:.1f} minor iterations/s through perform (Högbom)")
    say(f"config 2: {clark[1]:.1f} minor iterations/s through perform "
        f"(Clark); B2 on a cluster of {b2_cluster} blocks, "
        f"{kernel_ms * 1e3 / SUBMINOR_TIMED_ITERATIONS:.2f} us per iteration")
    b3_ms, b3_bound = atrous[3][0], bound_ms(*atrous[3][3:])[0]
    say(f"config 4: {iuwt[1]:.3f} structure iterations/s through perform "
        f"(IUWT); B3 at 4096^2, 3 scales: {b3_ms * 1e3:.1f} us against its "
        f"{b3_bound * 1e3:.1f} us bound; at config 4's most frequent "
        f"{n_main} scales: {k_ms * 1e3:.1f} us against {b_ms * 1e3:.1f} us")
    say(f"mesh: {mesh[1]:.1f} minor iterations/s through perform (4 x "
        f"4096^2, chan 4 x tile 2 on one card; single device "
        f"{mesh[2]:.1f}); B4 at [1, 2048, 4096]: {b4_ms * 1e3:.1f} us "
        f"against its {b4_bound_ms * 1e3:.1f} us bound")
    print(smi)  # name, power limit: as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
