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
* the mesh Högbom loop, its shards on the card: the shard-local
  kernel (B4) and the Högbom step on row shards against their plain
  versions, B4's time, the joined-channel cube on a chan 4 x tile 2 mesh
  against the single-device perform, 2 channels x 2 polarizations with
  squared joins on chan 2 x tile 4, and the point-source contract on
  chan 1 x tile 8;
* the mesh's Clark subminor loop (the Clark default on a mesh: B2 with a
  tile axis, one cluster a tile in one launch): the joined-channel cube on
  chan 4 x tile 2 and config 2 on chan 1 x tile 8, each with its rate, its
  per-tile candidate counts, launches, the split of a perform, the banded
  emulation (today's B2 on each tile's rows in turn, equal results) and
  the single-device perform beside it, every tile of the launch replayed
  against the plain version, and the tile axis timed at config 2's
  segments against today's B2 launched on each tile in turn and the plain
  version;
* the mesh over several cards through Radler.perform: config 1 on chan 1
  x tile 8, the joined-channel cube on chan 4 x tile 2, config 2's mesh
  Clark and the multiscale mesh, their shards spread over every visible
  card (up to 8; with one card, over 4 groups of shards on it), each
  bit-equal to the same mesh on one card and within its gate of the
  single device (the Clark mesh's difference printed), with the launches,
  the time an iteration and the peak memory on each card, and a profiled
  perform's busy share of each card;
* the Clark loop with the log-polynomial and the forced-term fit in B2's
  body: B2 against its plain version with each fit (4 x 1, 2 x 2, 8 x 1
  and 40 x 1 planes, with and without an rms factor, at every plan; the
  tile axis over 8 ragged tiles), 8192^2 x 4 channels (1200 sources with
  their own spectral index) through Radler.perform with each fit (rate,
  launches, K and the plan, peak memory, the split of a perform, B2 at the
  recorded state against plain and timed beside the projection), a 4096^2
  x 4 log-polynomial perform on the Högbom kernel (the JAX package's rule),
  512^2 x 4 on the card against the port's CPU run with each fit, the
  joined-channel cube on chan 4 x tile 2 with a log-polynomial fit against
  the port's CPU mesh run, and multiscale's Clark route with it (config
  3's field, every B2 call replayed; 256^2 x 4 against the CPU);
* MORE_SANE (two major iterations of a stand-in program written to a
  temporary directory, never the real one) and a PYTHON plug-in
  Högbom-cleaning in NumPy, at config 2's field: wall time and the share of
  it spent copying between the card and the host;
* multiscale CLEAN: the Högbom step in linear mode with a weight plane at
  config 3's shape against its plain version and its time, config 3
  (multiscale 2048^2 x 8 channels, 2-term polynomial fit, 600 iterations)
  on its three routes in one run (the fused loop, the default; the host
  path's dense and Clark routes) with each route's rate, host syncs, peak
  memory and time split (each step's time and peak memory), the point-source contract and a 256^2 x
  4-channel perform against the port's CPU run on the fused and the dense
  route, a 2048^2 x 4-channel perform on a chan 4 x tile 2 mesh (B4 in
  linear mode) against the single-device fused perform, and B4's time at
  that mesh's shard;
* facets: B1's facet mode (one launch an iteration for every facet, each
  facet's select folded in) against its plain version, bit for bit (1, 4
  and 9 facets, shared and per-facet PSFs, squared and linear, with and
  without a weight plane, over ragged true boxes (nothing outside them
  read or written) and over the common box, an inactive facet; one facet
  against the single-cube launch) and its time at config 5's shape and
  true boxes against the bound of those boxes, squared with shared PSFs
  and linear with a PSF stack a facet, config 5
  (4096^2 x 2 channels x I, Q, U, V, squared joins, 2-term fit, 2 x 2
  facets, 400 iterations a facet) on five routes (generic batched, generic
  serial with the Högbom and the Clark setting, multiscale serial and
  batched) with each route's rate summed over the facets, facet 0's
  count, lockstep iterations and passes, I rms, peak memory, host syncs
  and boxes, and a 256^2 faceted field on the card against the port's CPU
  run (generic batched, multiscale serial and batched), with config 5's
  split from both integrations;
* ASP: the point-source contract, a 2048^2 x 4-channel perform (rate,
  host syncs, peak memory, the split of a perform) and a 256^2 x
  2-channel field against the port's CPU run;
* component optimization (generic CLEAN's linear solve and gradient
  descent, multiscale's gradient descent) after auto-masking, on the card
  against the port's CPU run, and the linear solve from the card's inputs
  on the CPU, with its own FFTs and with the card's right-hand side.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits with a non-zero code; without a CUDA device it exits at once.

It imports nothing of JAX or of the ``radler_tpu`` package.
"""

import contextlib
import inspect
import itertools
import json
import os
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
    ("linear, multiscale mesh shard", "linear", 1, 1, 2048, 2048, 2, 1),
    ("ragged normal 2ch", "normal", 2, 1, 1000, 1300, 4, 1),
    ("ragged squared 1ch x 2pol", "squared", 2, 2, 1000, 1300, 4, 2),
]
B4_LINEAR_CASE = 5  # B4 as the multiscale mesh runs it
# B1 on row shards against its plain version (same fields): every plane of
# the shard's rows, as the mesh runs it when it splits no channels.
B1_SHARD_CASES = [
    ("normal 4ch", "normal", 4, 1, 4096, 4096, 8, 3),
    ("squared 2ch x 2pol", "squared", 4, 2, 4096, 4096, 8, 7),
    ("ragged signed", "signed", 1, 1, 1000, 1300, 4, 2),
]
# Config 3: ``bench.py --engine multiscale --size 2048 --iters 600``: the
# diffuse problem at 8 channels, a polynomial fit of 2 terms, the cubes on
# the card.
MS_SIZE = 2048
MS_CHANNELS = 8
MS_ITERATIONS = 600
# The multiscale card against the port's CPU run of the same arrays: a
# 256^2 x 4-channel field of 20 point sources on faint diffuse emission
# (three scales take components), stopped at its iteration limit (19 short
# of its threshold) and run on to its threshold at twice the limit; equal
# iteration counts and components per scale, residual and model within
# this of max(1, |res|max).
MS_CHECK_SIZE = 256
MS_CHECK_CHANNELS = 4
MS_CHECK_ITERATIONS = 300
MS_CARD_VS_CPU = 1e-5
# The multiscale mesh: MS_MESH_CHANNELS channels of the check field at
# config 3's size on chan 4 x tile 2 (B4 in linear mode on one plane of
# 1024 rows a shard), config 3's settings; against the single-device
# fused perform: equal iteration counts, the cubes within this (the JAX
# package's own gate, tests/test_mesh_multiscale.py).
MS_MESH_CHANNELS = 4
MS_MESH_VS_SINGLE = 2e-5
# The mesh over several cards: the mesh cells' MESH_DEVICES shards spread
# over the visible cards, up to 8, or over this many groups on the one
# card; CARDS_ITERATIONS Högbom iterations a perform at 4096^2.
MESH_GROUPS_ON_ONE_CARD = 4
CARDS_ITERATIONS = 1000
# The spread workloads (batched facets, IUWT, ASP): meshes of this many
# shards (config 5: one facet a shard), config 4 cut to so many structure
# iterations and ASP to so many minor iterations, both held within
# SPREAD_GATE of max(1, |res|max) against one group (the JAX package's
# tolerance between a mesh and a single device: the slab FFTs and the
# partial sums round apart).
SPREAD_DEVICES = 4
SPREAD_IUWT_ITERATIONS = 8
SPREAD_ASP_ITERATIONS = 20
SPREAD_GATE = 2e-5
# B3's row-block mode is checked, every launch on every block, at the main
# path's scale count and at this one, the most a 4096^2 image has.
ROW_BLOCK_CHECK_SCALES = 9
# The profiled performs of the Högbom cells (the profiler's events of a
# 1000-iteration perform take about a minute to read back).
CARDS_PROFILE_ITERATIONS = 100
# Config 5 (``benchmarks/config5_proxy.py --size 4096 --channels 2 --facets
# 2 --iters 400``): I, Q, U, V x 2 channels of config 3's diffuse emission,
# squared joins, a 2-term polynomial fit, gain 0.1, major gain 0.85, 2 x 2
# facets, 400 iterations per facet.
F5_SIZE = 4096
F5_CHANNELS = 2
F5_GRID = 2
F5_ITERATIONS = 400
F5_POL_FLUX = (1.0, 0.3, -0.2, 0.1)  # I, Q, U, V
# The JAX package's own bound between its batched and serial generic
# facets (tests/test_batched_facets.py:267-277).
F5_BATCHED_VS_SERIAL = 5e-5
# Lockstep iterations of B1's facet mode against its plain version at
# config 5's shape (the plain version takes about 8 ms an iteration).
F5_TRACE_ITERATIONS = 48
# The small faceted field on the card against the CPU.
F5_CHECK_SIZE = 256
F5_CHECK_CONTRACT = 2e-6
# ASP (AlgorithmType.ADAPTIVE_SCALE_PIXEL): config 3's settings at
# ASP_SIZE^2 x ASP_CHANNELS for ASP_ITERATIONS minor iterations
# (make_point_grid_problem's field), and its card-against-CPU field.
ASP_SIZE = 2048
ASP_CHANNELS = 4
ASP_ITERATIONS = 200
ASP_CHECK_SIZE = 256
# Component optimization on the card against the CPU; the bound of the
# linear solve's model (phase_component_optimization_card_vs_cpu).
CO_SIZE = 256
CO_LINEAR_CARD_VS_CPU = 1e-3
# The card's published peaks (H100 SXM data sheet, 700 W): device memory
# and float32 outside the tensor cores.
# The spectral cells: make_problem's field over 8192^2 at config 1's
# density (300 sources per 4096^2), 4 channels (weights 1), each source's
# spectral index from N(-0.7, 0.2); the Clark loop with a 2-term
# LOG_POLYNOMIAL or FORCED_TERMS fit in B2's body.  At 4096^2 the JAX
# package's rule takes the Högbom kernel for such a fit (a 4096^2 x 4
# perform, SPECTRAL_HOGBOM_ITERATIONS, shows it); at 512^2 x 4 the card's
# B2 is held against the port's CPU run.
SPECTRAL_SIZE = 8192
SPECTRAL_SOURCES = 1200
SPECTRAL_MHZ = (120.0, 140.0, 160.0, 180.0)
SPECTRAL_INDEX = (-0.7, 0.2)
SPECTRAL_HOGBOM_SIZE = 4096
SPECTRAL_HOGBOM_SOURCES = 300
SPECTRAL_HOGBOM_ITERATIONS = 1000
SPECTRAL_CHECK_SIZE = 512
SPECTRAL_CHECK_SOURCES = 40
SPECTRAL_CHECK_ITERATIONS = 1000
FIT_MODES = ("LOG_POLYNOMIAL", "FORCED_TERMS")
# The parity contract (ROADMAP): the residual within 2e-6 absolute, the
# model within 1e-4 of its peak; between card and CPU only the FFT
# correction's rounding differs.
FIT_RESIDUAL_ATOL = 2e-6
FIT_MODEL_RTOL = 1e-4
# The mesh's Clark loop with a fit, a tile's iterations (its CPU run is
# the plain tile axis, each tile in turn).
MESH_FIT_ITERATIONS = 150
# B2 with a fit against its plain version: iterations a case (a third of
# them at 40 planes), and the iterations of the timed launches at the
# 8192^2 cell's recorded state (the plain version's turns pace both).
FIT_CASE_ITERATIONS = 100
FIT_TIMED_ITERATIONS = 100

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def say(*parts):
    print(*parts, flush=True)


# Each phase's heading, start and seconds, for the summary at the end.
_phase_log = []


def section(title=None):
    """Close the running phase (print its seconds) and, given a title, print
    the next one's heading and start it."""
    now = time.perf_counter()
    if _phase_log and _phase_log[-1][2] is None:
        _phase_log[-1][2] = now - _phase_log[-1][1]
        say(f"  (phase: {_phase_log[-1][2]:.1f} s)")
    if title is not None:
        _phase_log.append([title, now, None])
        say(f"== {title} ==")


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


def make_ms_check_problem(size, n_channels, seed=SEED):
    """20 point sources on config 3's diffuse emission at 1/500 of its
    brightness, under its PSFs, the points' spectra falling 5% a channel;
    returns (psfs, residual)."""
    psfs, diffuse = make_diffuse_problem(size, n_channels)
    rng = np.random.default_rng(seed)
    sky = np.zeros((size, size))
    ys = rng.integers(size // 8, 7 * size // 8, 20)
    xs = rng.integers(size // 8, 7 * size // 8, 20)
    np.add.at(sky, (ys, xs), rng.uniform(0.2, 1.0, 20))
    points = np.stack([
        np.fft.irfft2(np.fft.rfft2(sky * (1 - 0.05 * c))
                      * np.fft.rfft2(np.fft.ifftshift(psfs[c])), s=sky.shape)
        for c in range(n_channels)
    ])
    return psfs, (0.002 * diffuse + points).astype(np.float32)


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
    # The facet splitter's host helpers, built here so that no timed
    # perform pays their compile.
    start = time.perf_counter()
    _build.host_library()
    say(f"host library built and loaded in "
        f"{time.perf_counter() - start:.1f} s")
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
    """TRACE_ITERATIONS iterations of B1 (the step with its select folded
    in; ``plain``: the plain step, then the plain select) from the
    brightest pixel of plane 0; returns the (y, x) of every iteration and
    the final tensors.  The kernel's counter must read 0 after every
    launch."""
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
    weight = inputs["weight"] if use_weight else None
    peaks = []
    for _ in range(TRACE_ITERATIONS):
        step(res, model, inputs["psfs"], buffers.values, buffers.state,
             inputs["coefs"], weight, mode=mode, n_polarizations=inputs["P"],
             allow_negative=allow_negative, buffers=buffers, params=params)
        peaks.append(buffers.state[:2].clone())
    torch.cuda.synchronize()
    if not plain and int(buffers.workspace.counters.sum()) != 0:
        raise AssertionError("B1's counter is not 0 after its launches")
    return torch.stack(peaks), res, model, buffers


def phase_kernels_vs_plain():
    """Every integration mode, weight on and off, negatives allowed or not,
    at the main path's size and at a ragged shape: the kernel loop (one
    launch an iteration, the select folded in) against the plain loop (the
    plain step, then the plain select) on the card."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    worst = {"hogbom_step": 0.0}
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
                                               d_mod, d_sel)
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
    """B1 at the main path's shapes (4096^2, one plane, no weight): the
    launch with its select folded in against its plain version (the plain
    step, then the plain select), in turns plain, kernel, kernel, plain,
    and beside them the step alone (the instantiation that writes partials
    only, as row shards run it): the fused launch less the step alone is
    the select's tail."""
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

    kw = dict(mode="signed", n_polarizations=1, allow_negative=True)
    times = {"hogbom_step": [], "step alone": []}
    for plain in (True, False, False, True):
        step = hs.hogbom_step_reference if plain else hs.hogbom_step
        b = buffers()
        t_step, h_step = _time_ms(
            lambda: step(res, model, psfs, b.values, b.state, coefs, None,
                         **kw, buffers=b, params=params), 20)
        times["hogbom_step"].append(t_step)
        line = (f"  {'plain ' if plain else 'kernel'} hogbom_step (select "
                f"folded in) {t_step:.4f} ms (host enqueue {h_step:.4f} ms)")
        if not plain:
            b = buffers()
            t_alone, h_alone = _time_ms(
                lambda: hs.hogbom_step(res, model, psfs, b.values, b.state,
                                       coefs, None, **kw), 20)
            times["step alone"].append(t_alone)
            line += (f"; the step alone {t_alone:.4f} ms (host enqueue "
                     f"{h_alone:.4f} ms)")
        say(line)
    p1, k1, k2, p2 = times["hogbom_step"]
    alone = sum(times["step alone"]) / 2
    out = {"hogbom_step": ((k1 + k2) / 2, (p1 + p2) / 2), "alone": alone}
    say(f"  the select's tail: {out['hogbom_step'][0] - alone:.4f} ms (the "
        "launch less the step alone)")
    # The least bytes the launch must move: it reads the residual and the
    # PSF and writes the residual, writes the partials (12 bytes a block;
    # the last block reads them back from L2) and reads the residual's
    # values at the peak.
    n_parts = -(-res[0].numel() // hs.PIXELS_PER_BLOCK)
    out["bytes"] = {
        "hogbom_step": 3 * res.numel() * 4 + 12 * n_parts
        + res.shape[0] * 4,
    }
    return out


def _counts():
    """B1's launches since the last _reset_counts (each one an iteration,
    its select folded in)."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    return hs.hogbom_step.launches


def _reset_counts():
    from radler_tpu_torch.kernels import hogbom_step as hs
    from radler_tpu_torch.kernels import iuwt_atrous as ia
    from radler_tpu_torch.kernels import subminor_loop as sl
    from radler_tpu_torch.kernels import subtract_integrate as si

    hs.hogbom_step.launches = 0
    hs.hogbom_step_facets.launches = 0
    sl.subminor_loop.launches = 0
    sl.subminor_loop_tiles.launches = 0
    ia.atrous_decompose_lo.launches = 0
    si.subtract_integrate.launches = 0
    ia.atrous_rows.launches = 0
    for fn in (hs.hogbom_step, sl.subminor_loop_tiles, si.subtract_integrate,
               hs.hogbom_step_facets, ia.atrous_rows):
        fn.launches_by_card.clear()


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
    seconds, B1 launches, residual, model)."""
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
    if not n <= counts < n + hs.CHUNK:
        raise AssertionError(f"B1 launches {counts} for {n} iterations")
    if n == iterations and counts != n:
        raise AssertionError(f"B1 launches {counts} != {n} iterations")
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
        f"{counts} (one an iteration, its select folded in)")
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
        if clark and (sl.subminor_loop.launches, _counts()) != (1, 0):
            raise AssertionError("the Clark perform did not launch B2 once")
        n = r.iteration_number
        if mesh and not (si.subtract_integrate.launches == 0
                         and n * MESH_DEVICES <= hs.hogbom_step.launches
                         < (n + hs.CHUNK) * MESH_DEVICES):
            raise AssertionError(
                f"the mesh perform's launches: B1 {hs.hogbom_step.launches}, "
                f"B4 {si.subtract_integrate.launches} for {n} iterations")
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


def _subminor_replay(args, kwargs, plan=None):
    """One run of B2's arguments ``args`` on fresh copies of its residual
    and model state: the plain version when ``plan`` is None, else the
    kernel launched by that plan.  Returns (output, residual, model)."""
    from radler_tpu_torch.kernels import subminor_loop as sl

    res, model = args[0].clone(), args[1].clone()
    args = (res, model) + tuple(args[2:])
    if plan is None:
        out = sl.subminor_loop_reference(*args, **kwargs)
    else:
        out = sl.subminor_loop(*args, **kwargs, _plan=plan)
    torch.cuda.synchronize()
    return out, res, model


def _subminor_replay_all(name, args, kwargs):
    """The plain version of one B2 call against the kernel at every plan of
    :func:`_subminor_plans`: equal output bits and state, else raises.
    Returns (the plain result, the plans, max |difference|, the plain
    model)."""
    from radler_tpu_torch.kernels import subminor_loop as sl

    out_p, res_p, mod_p = _subminor_replay(args, kwargs)
    got_p = sl.read_result(out_p)
    plans = _subminor_plans(*args[0].shape, fit=args[7])
    d = 0.0
    for plan in plans:
        out_k, res_k, mod_k = _subminor_replay(args, kwargs, plan)
        d_plan = max(float((res_k - res_p).abs().max()),
                     float((mod_k - mod_p).abs().max()))
        if not (torch.equal(out_k, out_p) and d_plan == 0.0):
            raise AssertionError(
                f"subminor kernel and plain disagree: {name}, "
                f"{_plan_name(plan)}: kernel {sl.read_result(out_k)}, "
                f"plain {got_p}, max|diff| {d_plan:.3g}")
        d = max(d, d_plan)
    return got_p, plans, d, mod_p


def _subminor_plans(n, k, fit=None):
    """The launch plans a case (with the spectral fit ``fit``) is held to:
    the plan the wrapper takes by itself, every cluster size (the state in
    shared memory where it fits), the largest cluster with the state in
    global memory, and, where the raw values travel with the argmax, a
    cluster and one block where they do not; then the grid route (one block
    a multiprocessor) with the state where it fits, in global memory, and
    without raw values."""
    from radler_tpu_torch.kernels import subminor_loop as sl

    sms = sl.sm_count(torch.device(DEVICE))
    plans = [sl.cluster_plan(n, k, fit=fit, sm_count=sms)]
    plans += [sl.cluster_plan(n, k, fit=fit, cluster_size=r)
              for r in CLUSTER_SIZES]
    plans.append(sl.cluster_plan(n, k, fit=fit, cluster_size=sl.MAX_CLUSTER,
                                 on_chip=False))
    if plans[0].ship_raw:
        plans.append(sl.cluster_plan(n, k, fit=fit, cluster_size=4,
                                     ship_raw=False))
        plans.append(sl.cluster_plan(n, k, fit=fit, cluster_size=1,
                                     ship_raw=False))
    plans.append(sl.cluster_plan(n, k, fit=fit, grid_blocks=sms))
    plans.append(sl.cluster_plan(n, k, fit=fit, grid_blocks=sms,
                                 on_chip=False))
    if plans[0].ship_raw:
        plans.append(sl.cluster_plan(n, k, fit=fit, grid_blocks=sms,
                                     ship_raw=False))
    return plans


def _plan_name(plan):
    route = (f"grid {plan.grid_blocks}" if plan.grid_blocks
             else f"R={plan.cluster_size}")
    return (f"{route}"
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
    # The most planes whose raw values travel with the argmax (config 3's 8
    # channels on the Clark route).
    cases.append(("8ch x 1pol", 8, 1, True, True, "POLYNOMIAL", 4.0, False,
                  False, SUBMINOR_K))
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
            proj = sl.projection_fit(torch.as_tensor(
                np.asarray(fitter._projection, np.float32), device=DEVICE))
        params = sl.SubminorParams.make(
            float(state["loop"].threshold) * 0.3, GAIN, 0,
            SUBMINOR_ITERATIONS, divergence, allow_negative, stop_neg)
        loop = state["loop"]
        args = (loop._residual_k, torch.zeros_like(loop._residual_k),
                loop._rms_k, loop._xs, loop._ys, state["psfs"], state["coef"],
                proj, params)
        got_p, plans, d, _ = _subminor_replay_all(
            name, args, dict(n_polarizations=P))
        if k_target == SUBMINOR_K_GLOBAL and (
                sl.cluster_plan(C * P, state["k"], fit=proj).on_chip
                or not (plans[0].grid_blocks and plans[0].on_chip)):
            raise AssertionError(
                f"{name}: K = {state['k']} fits one cluster's shared memory, "
                f"or the plan {_plan_name(plans[0])} does not hold it on the "
                "grid")
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


# ---------------------------------------------------------------------------
# B2 with the log-polynomial and forced-term fits
# ---------------------------------------------------------------------------


def _b2_registers():
    """ptxas's registers and spill stores for each instantiation of B2
    (route, state place, exchange, fit), from this process's build log;
    returns {(route, on_chip, ship_raw, fit): (registers, spill bytes)}."""
    import re

    from radler_tpu_torch.kernels import _build

    fits = {1: "none/projection", 2: "log-polynomial", 3: "forced terms"}
    out, current = {}, None
    for line in _build.BuildInfo.log.splitlines():
        m = re.search(
            r"subminor_loop_kernelILb(\d)ELb(\d)ELb(\d)ELi(\d)EE", line)
        if "Compiling entry function" in line:
            current = (("cluster", "grid")[int(m.group(1))], m.group(2),
                       m.group(3), fits[int(m.group(4))]) if m else None
        elif current and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            out[current] = [None, spill]
        elif current and "Used" in line and "registers" in line:
            out.setdefault(current, [None, 0])[0] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            current = None
    for (route, on_chip, ship_raw, fit), (regs, spill) in sorted(
            out.items()):
        say(f"  B2 {route} on_chip={on_chip} ship_raw={ship_raw} {fit}: "
            f"{regs} registers, {spill} bytes spill stores")
    return out


def _fit_for(mode, state, seed):
    """B2's fit of ``mode`` (2 terms) for a :func:`_subminor_state`
    candidate set; the forced terms a spectral-index image drawn from
    SPECTRAL_INDEX, gathered at the candidates."""
    from radler_tpu_torch.models.subminor import fit_arguments
    from radler_tpu_torch.ops.spectral_fitting import SpectralFitter
    from radler_tpu_torch.settings import SpectralFittingMode

    meta = state["meta"]
    fitter = SpectralFitter(getattr(SpectralFittingMode, mode), 2,
                            meta.frequencies, meta.weights)
    if mode == "FORCED_TERMS":
        rng = np.random.default_rng(seed)
        fitter.set_forced_terms(torch.as_tensor(rng.normal(
            *SPECTRAL_INDEX, (1, SUBMINOR_SIZE, SUBMINOR_SIZE)).astype(
                np.float32), device=DEVICE))
    loop = state["loop"]
    return fit_arguments(fitter, DEVICE, loop._xs, loop._ys)


def _tile_fit_check(label, args, counts, P):
    """B2's tile axis on ``args`` (the single launch's arguments) cut into
    the segments ``counts``: the kernel at its own plan and at the largest
    cluster with the state in global memory and no raw values, against
    the plain version, bit for bit.  Returns max |difference|."""
    from radler_tpu_torch.kernels import subminor_loop as sl

    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                              dtype=torch.int32, device=DEVICE)
    n = args[0].shape[0]
    plans = [None, sl.cluster_plan(n, max(counts), fit=args[7],
                                   cluster_size=sl.MAX_CLUSTER, on_chip=False,
                                   ship_raw=False)]
    outs = []
    for plan in ["plain"] + plans:
        res, model = args[0].clone(), args[1].clone()
        run = (res, model) + tuple(args[2:])
        if plan == "plain":
            out = sl.subminor_loop_tiles_reference(*run, counts,
                                                   n_polarizations=P)
        else:
            out = sl.subminor_loop_tiles(*run, offsets, counts,
                                         n_polarizations=P, _plan=plan)
        torch.cuda.synchronize()
        outs.append((out, res, model))
    (op, rp, mp), d = outs[0], 0.0
    for ok, rk, mk in outs[1:]:
        d = max(d, float((rk - rp).abs().max()), float((mk - mp).abs().max()))
        if not (torch.equal(ok, op) and torch.equal(rk, rp)
                and torch.equal(mk, mp)):
            raise AssertionError(
                f"{label}: B2's tile axis and its plain version disagree: "
                f"kernel {sl.read_tile_results(ok)}, plain "
                f"{sl.read_tile_results(op)}")
    iterations = [it for it, _, _ in sl.read_tile_results(op)]
    say(f"  {label}, tile axis over {len(counts)} tiles K {counts}: "
        f"iterations {iterations}, kernel equal to plain at its own plan and "
        f"R=16 global, no raw values; max|diff| {d:.3g}")
    if max(iterations) == 0:
        raise AssertionError(f"{label}: the tile axis made no iteration")
    return d


def phase_subminor_fits_vs_plain():
    """B2 with the log-polynomial and the forced-term fit in its body against
    its plain version on the card: 4 x 1, 2 x 2, 8 x 1 and 40 x 1 planes
    (the ship-raw exchange up to 8 planes, the owner's above), with and
    without an rms factor, over :func:`_subminor_state`'s positive and
    negative sources, negatives allowed (the log-polynomial's sign); each at
    every plan of :func:`_subminor_plans`.  Then each fit on B2's tile axis
    over 8 ragged tiles, an empty one among them.  Equal output bits and
    state, else raises.  Returns {mode: max |difference|}."""
    from radler_tpu_torch.kernels import subminor_loop as sl

    start = time.perf_counter()
    _b2_registers()
    worst = {}
    shapes = ((4, 1), (2, 2), (8, 1), (40, 1))
    for mode in FIT_MODES:
        worst[mode], negatives_seen = 0.0, 0
        for i, ((C, P), use_rms) in enumerate(
                itertools.product(shapes, (False, True))):
            state = _subminor_state(C, P, use_rms, True, seed=60 + i)
            fit = _fit_for(mode, state, seed=80 + i)
            loop = state["loop"]
            iterations = FIT_CASE_ITERATIONS // (1 if C * P <= 8 else 3)
            params = sl.SubminorParams.make(
                float(loop.threshold) * 0.3, GAIN, 0, iterations, 4.0, True,
                False)
            args = (loop._residual_k, torch.zeros_like(loop._residual_k),
                    loop._rms_k, loop._xs, loop._ys, state["psfs"],
                    state["coef"], fit, params)
            name = f"{mode} {C}ch x {P}pol rms={use_rms:d}"
            got_p, plans, d, mod_p = _subminor_replay_all(
                name, args, dict(n_polarizations=P))
            negatives = int((mod_p.sum(0) < 0).sum())
            say(f"  {name:34s} K={state['k']}: plain {got_p}, "
                f"{negatives} negative components; kernel equal at "
                f"{_plan_name(plans[0])} (its own plan), "
                f"{', '.join(_plan_name(p) for p in plans[1:])}; max|diff| "
                f"{d:.3g}")
            if got_p[0] < 10:
                raise AssertionError(f"{name}: {got_p[0]} iterations")
            negatives_seen += negatives
            worst[mode] = max(worst[mode], d)
            if (C, P, use_rms) == (2, 2, True):
                k = state["k"]
                counts = [150, 0, 37, 1200, 5, 640, 300]
                counts.append(k - sum(counts))
                worst[mode] = max(worst[mode], _tile_fit_check(
                    name, args, counts, P))
            del state
        if negatives_seen == 0:
            raise AssertionError(f"{mode}: no case took a negative component")
    say(f"  ({time.perf_counter() - start:.1f} s)")
    return worst


def make_spectral_problem(size, n_sources, seed=SEED):
    """:func:`make_problem`'s field over the SPECTRAL_MHZ channels, made on
    the card with torch.fft: each source's amplitude (0.2 to 1.0 at the
    reference frequency, the channels' mean) times (nu / nu_ref)^alpha, alpha
    drawn from N(SPECTRAL_INDEX); each channel's PSF make_problem's with its
    width scaled by nu_ref / nu.  Returns (psfs [C, H, W], residual [C, H,
    W], the spectral-index map [1, H, W] (each source's alpha at its pixel,
    the mean elsewhere), channel edges [C, 2] in Hz)."""
    rng = np.random.default_rng(seed)
    nu = np.array(SPECTRAL_MHZ) * 1e6
    ref = nu.mean()
    margin = size // 8
    ys = rng.integers(margin, size - margin, n_sources)
    xs = rng.integers(margin, size - margin, n_sources)
    amps = rng.uniform(0.2, 1.0, n_sources)
    alphas = rng.normal(*SPECTRAL_INDEX, n_sources)
    dev = torch.device(DEVICE)
    at = (torch.as_tensor(ys, device=dev), torch.as_tensor(xs, device=dev))
    index_map = np.full((1, size, size), SPECTRAL_INDEX[0], np.float32)
    index_map[0, ys[::-1], xs[::-1]] = alphas[::-1]  # the first one wins
    d = torch.arange(size, device=dev, dtype=torch.float32) - size // 2
    r2 = d[:, None] ** 2 + d[None, :] ** 2
    psfs = torch.empty((len(nu), size, size), device=dev)
    residual = torch.empty_like(psfs)
    for c, f in enumerate(nu):
        s = float(ref / f)
        psfs[c] = (torch.exp(-r2 / (2.0 * (2.5 * s) ** 2))
                   + 0.08 * torch.exp(-(torch.sqrt(r2) - 12.0 * s) ** 2
                                      / (2.0 * (2.0 * s) ** 2)))
        sky = torch.zeros((size, size), device=dev)
        sky.index_put_(at, torch.as_tensor(amps * (f / ref) ** alphas,
                                           dtype=torch.float32, device=dev),
                       accumulate=True)
        residual[c] = torch.fft.irfft2(
            torch.fft.rfft2(sky) * torch.fft.rfft2(
                torch.fft.ifftshift(psfs[c])), s=(size, size))
        del sky
    del r2, d
    freqs = np.stack([nu - 5e6, nu + 5e6], axis=1)
    return psfs, residual, index_map, freqs


def _spectral_settings(size, iterations, mode, forced_filename=None):
    """Clark (the default) with the 2-term ``mode`` fit."""
    import radler_tpu_torch as rd

    s = _settings(size, iterations, clark=True)
    s.spectral_fitting.mode = getattr(rd.SpectralFittingMode, mode)
    s.spectral_fitting.terms = 2
    if mode == "FORCED_TERMS":
        s.spectral_fitting.forced_filename = forced_filename
    return s


def _spectral_radler(settings, psfs, res0, freqs, device=None):
    import radler_tpu_torch as rd

    extra = {} if device is None else {"device": device}
    return rd.Radler(settings, psfs, res0.clone(), torch.zeros_like(res0),
                     0.0, frequencies=freqs, weights=np.ones(len(freqs)),
                     **extra)


@contextlib.contextmanager
def _recording_b2(calls):
    """Record each B2 call of the Clark route (copies of its inputs)."""
    from radler_tpu_torch.models import subminor as subminor_module

    real = subminor_module.subminor_loop

    def recording(*args, **kwargs):
        calls.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a
                            for a in args), kwargs))
        return real(*args, **kwargs)

    subminor_module.subminor_loop = recording
    try:
        yield
    finally:
        subminor_module.subminor_loop = real


def _psf_sector_bytes(args, kwargs, iterations, params):
    """The bytes of the 32-byte sectors that a B2 run's PSF gathers touch:
    for each of its ``iterations`` components (found by running the kernel
    one iteration at a time from the call's state, each launch's component
    the model column it changed), the sectors that the candidates' row runs
    reach in a PSF plane (the runs clipped to the PSF), times the PSF
    planes.  Returns (bytes, mean sectors an iteration and plane)."""
    from radler_tpu_torch.kernels import subminor_loop as sl

    res0, _, rms_k, xs, ys, psfs, coef, fit, _ = args
    n_psf, height, width = psfs.shape
    res, model = res0.clone(), torch.zeros_like(res0)
    xs_l, ys_l = xs.long(), ys.long()
    sectors = 0
    for t in range(iterations):
        before = model.clone()
        one = params._replace(start_iteration=t, max_iterations=t + 1)
        sl.subminor_loop(res, model, rms_k, xs, ys, psfs, coef, fit, one,
                         **kwargs)
        m = int((model != before).any(0).nonzero()[0, 0])
        sy = ys_l - ys_l[m] + height // 2
        sx = xs_l - xs_l[m] + width // 2
        inside = (sy >= 0) & (sy < height) & (sx >= 0) & (sx < width)
        sectors += int(torch.unique((sy * width + sx)[inside] // 8).numel())
    return 32 * n_psf * sectors, sectors / iterations


@contextlib.contextmanager
def _b2_on_the_grid():
    """Every B2 call of the Clark route on the grid route, whatever its K
    (``_plan``: one block a multiprocessor)."""
    from radler_tpu_torch.kernels import subminor_loop as sl
    from radler_tpu_torch.models import subminor as subminor_module

    real = subminor_module.subminor_loop

    def on_the_grid(*args, **kwargs):
        res_k, fit = args[0], args[7]
        kwargs["_plan"] = sl.cluster_plan(
            res_k.shape[0], res_k.shape[1], fit=fit,
            grid_blocks=sl.sm_count(res_k.device))
        return real(*args, **kwargs)

    subminor_module.subminor_loop = on_the_grid
    try:
        yield
    finally:
        subminor_module.subminor_loop = real


def _b2_fit_times(call, fitter_args):
    """B2 at a recorded call's candidate state, FIT_TIMED_ITERATIONS
    iterations from threshold 0, with the call's fit: the kernel by the
    wrapper's own plan and forced onto one cluster against plain first
    (bit-equal), then timed by CUDA events in turns plain, the fit by its
    plan, the fit on one cluster, the polynomial projection of the same
    channels, no fit, and back.  Returns a dict (ms, cluster_ms, plain_ms,
    projection_ms, none_ms, max|diff|, plan, bound, sector_bound)."""
    from radler_tpu_torch.kernels import subminor_loop as sl
    from radler_tpu_torch.ops.spectral_fitting import SpectralFitter
    from radler_tpu_torch.settings import SpectralFittingMode

    args, kwargs = call
    res0, _, rms_k, xs, ys, psfs, coef, fit, _ = args
    n, k = res0.shape
    params = sl.SubminorParams.make(0.0, GAIN, 0, FIT_TIMED_ITERATIONS, 0.0,
                                    True, False)
    projection = sl.projection_fit(torch.as_tensor(np.asarray(SpectralFitter(
        SpectralFittingMode.POLYNOMIAL, 2, *fitter_args)._projection,
        np.float32), device=DEVICE))
    plan = sl.cluster_plan(n, k, fit=fit, sm_count=sl.sm_count(res0.device))
    cluster = sl.cluster_plan(n, k, fit=fit)
    res_k, model_k = res0.clone(), torch.zeros_like(res0)

    def run(kind, res=res_k, model=model_k):
        chosen = {"fit": fit, "cluster": fit, "plain": fit,
                  "projection": projection, "none": None}[kind]
        a = (res, model, rms_k, xs, ys, psfs, coef, chosen, params)
        if kind == "plain":
            return sl.subminor_loop_reference(*a, **kwargs)
        return sl.subminor_loop(*a, **kwargs,
                                _plan=cluster if kind == "cluster" else None)

    finals = []
    for kind in ("fit", "cluster", "plain"):
        res, model = res0.clone(), torch.zeros_like(res0)
        out = run(kind, res, model)
        torch.cuda.synchronize()
        finals.append((out, res, model))
    op, rp, mp = finals[-1]
    d = 0.0
    for kind, (ok, rk, mk) in zip(("its plan", "one cluster"), finals):
        d = max(d, float((rk - rp).abs().max()), float((mk - mp).abs().max()))
        if not (torch.equal(ok, op) and torch.equal(rk, rp)
                and torch.equal(mk, mp)):
            raise AssertionError(
                f"B2 with its fit ({kind}) and plain disagree at the "
                f"recorded state: kernel {sl.read_result(ok)}, plain "
                f"{sl.read_result(op)}")
    readings = {"plain": [], "fit": [], "cluster": [], "projection": [],
                "none": []}
    for kind in ("plain", "fit", "cluster", "projection", "none", "none",
                 "projection", "cluster", "fit", "plain"):
        ms, _ = _time_ms(lambda: run(kind), 1 if kind == "plain" else 5)
        readings[kind].append(ms)
    mean = {kind: sum(v) / len(v) for kind, v in readings.items()}
    # The least work: the [N, K] state read and written, the model written,
    # the positions (and rms, and forced terms) read, the coefficients, the
    # fit's constants and the PSF values gathered; per iteration and candidate about
    # four float32 operations a plane (the fit's own are a few hundred an
    # iteration, nothing beside them).
    # The PSF values are gathered, one a candidate and a channel each
    # iteration: at most the run's iterations times K times the channels,
    # never more than the whole PSF.
    iterations = sl.read_result(op)[0]
    rows = fit.forced_rows
    psf_values = min(psfs.numel(), iterations * k * psfs.shape[0])
    state_bytes = 4 * (3 * n * k + 2 * k + (k if rms_k is not None else 0)
                       + rows * k + n + fit.shared_floats(n))
    bound = bound_ms(state_bytes + 4 * psf_values, iterations * k * 4 * n)
    # The same with the PSF read as the 32-byte sectors the candidates' row
    # runs touch, which is what the memory moves.
    sector_bytes, sectors = _psf_sector_bytes(args, kwargs, iterations,
                                              params)
    sector_bound = bound_ms(state_bytes + sector_bytes)
    return dict(ms=mean["fit"], cluster_ms=mean["cluster"],
                plain_ms=mean["plain"], projection_ms=mean["projection"],
                none_ms=mean["none"], readings=readings, worst=d,
                plan=_plan_name(plan), bound=bound,
                sector_bound=sector_bound, sectors=sectors)


def phase_spectral_performs():
    """The spectral cells: :func:`make_spectral_problem`'s 8192^2 x 4
    channels (1200 sources), Clark (the default), ITERATIONS minor
    iterations, gain GAIN, threshold THRESHOLD, through Radler.perform with
    a 2-term LOG_POLYNOMIAL and a 2-term FORCED_TERMS fit (the term image
    the sources' spectral-index map, written to a FITS file as a user gives
    it).  For each: a recorded warm-up and the best of 2 (minor iterations
    per second, B2 and B1 launches of each perform: 1 and 0), K and the
    plan, peak device memory, the split of one perform (selection; the fit's
    constants, B2 and its read; scatter and FFT correction), and B2 at the
    recorded state against its plain version and timed beside the
    projection.  Then a 4096^2 x 4 log-polynomial perform, which takes the
    Högbom kernel by the JAX package's rule (B1 launches, no B2).  Returns
    {mode: dict}."""
    from radler_tpu_torch.kernels import subminor_loop as sl
    from radler_tpu_torch.models import subminor as subminor_module
    from radler_tpu_torch.utils.fits import write_fits_image
    import tempfile

    start = time.perf_counter()
    psfs, res, index_map, freqs = make_spectral_problem(SPECTRAL_SIZE,
                                                        SPECTRAL_SOURCES)
    torch.cuda.synchronize()
    say(f"  problem made on the card in {time.perf_counter() - start:.1f} s")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        forced = os.path.join(tmp, "forced.fits")
        write_fits_image(forced, index_map)
        for mode in FIT_MODES:
            settings = _spectral_settings(SPECTRAL_SIZE, ITERATIONS, mode,
                                          forced)

            def make():
                return _spectral_radler(settings, psfs, res, freqs)

            calls = []
            with _recording_b2(calls):
                first = _run_perform(make)
            runs = []
            for _ in range(2):
                run = _run_perform(make)
                runs.append(run + ((sl.subminor_loop.launches,),))
                del run
            launches = [(r[7][0], r[2][1]) for r in runs]
            if len(calls) != 1 or any(lc != (1, 0) for lc in launches):
                raise AssertionError(f"{mode}: {len(calls)} recorded B2 "
                                     f"calls, (B2, B1) launches {launches}")
            n = first[0]
            if not (all(r[0] == n for r in runs) and torch.equal(
                    runs[0][4], first[4])):
                raise AssertionError(f"{mode}: the performs differ")
            split, memory = {}, {}
            restore = _timed_steps(split, [
                (subminor_module.SubMinorLoop, "find_peak_positions",
                 "selection"),
                (subminor_module.SubMinorLoop, "run",
                 "fit constants, B2 and its read"),
                (subminor_module.SubMinorLoop, "correct_residual_dirty",
                 "scatter and FFT correction"),
            ], memory=memory)
            try:
                timed = _run_perform(make)
            finally:
                restore()
            if not torch.equal(timed[4], first[4]):
                raise AssertionError(f"{mode}: the split perform differs")
            args = calls[0][0]
            k, fit = args[0].shape[1], args[7]
            plan = sl.cluster_plan(args[0].shape[0], k, fit=fit,
                                   sm_count=sl.sm_count(args[0].device))
            if not plan.grid_blocks:
                raise AssertionError(f"{mode}: K = {k} did not take the grid")
            best = min(r[1] for r in runs)
            out_res = first[4]
            say(f"  {mode}: {n} iterations, K = {k}, plan "
                f"{_plan_name(plan)}; seconds "
                f"{', '.join(f'{r[1]:.4f}' for r in runs)}; best "
                f"{n / best:.1f} minor iterations/s; (B2, B1) launches a "
                f"perform {launches[0]}; peak memory "
                f"{max(r[6] for r in runs):.1f} MiB above the inputs "
                f"(inputs {torch.cuda.memory_allocated() / 2**20:.1f} MiB "
                "allocated)")
            say("  split of one perform: " + ", ".join(
                f"{name} {sec * 1e3:.3f} ms ({calls_} call"
                f"{'s' if calls_ > 1 else ''})"
                for name, (calls_, sec) in split.items()))
            say(f"  residual rms {rms(res):.6g} -> {rms(out_res):.6g}; "
                f"model sum {float(first[5].double().sum()):.6g}")
            if not (rms(out_res) < rms(res) and n > 0):
                raise AssertionError(f"{mode}: the perform did not clean")
            del first, runs, timed, out_res
            times = _b2_fit_times(calls[0], (freqs.mean(axis=1),
                                             np.ones(len(freqs))))
            per = 1e3 / FIT_TIMED_ITERATIONS
            say(f"  B2 at the recorded state, {FIT_TIMED_ITERATIONS} "
                f"iterations from threshold 0: kernel by its plan "
                f"({times['plan']}) and on one cluster equal to plain "
                f"(max|diff| {times['worst']:.3g}); ms " + "; ".join(
                    f"{kind} {', '.join(f'{v:.4f}' for v in values)}"
                    for kind, values in times["readings"].items())
                + f"; {times['ms'] * per:.2f} us an iteration with the fit "
                f"by its plan, {times['cluster_ms'] * per:.2f} on one "
                f"cluster, {times['projection_ms'] * per:.2f} with the "
                f"projection; bound {times['bound'][0]:.4f} ms "
                f"({times['bound'][1]}, 4 bytes a PSF value), "
                f"{times['sector_bound'][0]:.4f} ms counting the PSF's "
                f"32-byte sectors ({times['sectors']:.1f} a plane an "
                "iteration)")
            out[mode] = dict(rate=n / best, launches=launches[0][0], k=k,
                             split=split, **times)
            del calls
            torch.cuda.empty_cache()
    del psfs, res, index_map
    torch.cuda.empty_cache()

    # The JAX package's rule at 4096^2: a fit that is not the projection
    # takes the Högbom kernel.
    psfs, res, _, freqs = make_spectral_problem(SPECTRAL_HOGBOM_SIZE,
                                                SPECTRAL_HOGBOM_SOURCES)
    settings = _spectral_settings(SPECTRAL_HOGBOM_SIZE,
                                  SPECTRAL_HOGBOM_ITERATIONS,
                                  "LOG_POLYNOMIAL")
    run = _run_perform(lambda: _spectral_radler(settings, psfs, res, freqs))
    b2, b1 = sl.subminor_loop.launches, run[2][1]
    say(f"  {SPECTRAL_HOGBOM_SIZE}^2 x 4 LOG_POLYNOMIAL: {run[0]} "
        f"iterations in {run[1]:.4f} s; B1 launches {b1}, B2 launches {b2}")
    if not (b2 == 0 and b1 >= run[0] > 0):
        raise AssertionError(f"{SPECTRAL_HOGBOM_SIZE}^2 with a "
                             "log-polynomial fit did not take the Högbom "
                             "kernel")
    del psfs, res, run
    torch.cuda.empty_cache()
    return out


def _spectral_perform_on(device, settings, psfs, res0, freqs):
    """One perform on ``device`` of copies of the inputs; returns (again,
    iterations, residual, model on the host, B2 launches)."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.kernels import subminor_loop as sl

    psfs, res = psfs.to(device), res0.to(device).clone()
    model = torch.zeros_like(res)
    r = rd.Radler(settings, psfs, res, model, 0.0, frequencies=freqs,
                  weights=np.ones(len(freqs)), device=device)
    _reset_counts()
    again = r.perform(0)
    launches = sl.subminor_loop.launches
    return (again, r.iteration_number,
            torch.stack([e.residual_accessor.array for e in r._table]).cpu(),
            torch.stack([e.model_accessor.array for e in r._table]).cpu(),
            launches)


def phase_spectral_card_vs_cpu():
    """:func:`make_spectral_problem` at SPECTRAL_CHECK_SIZE^2 x 4 with each
    fit, Clark, on the card (B2 with the fit in its body: the Högbom rule's
    size limit set to 0 for the run) against the port's CPU run (its plain
    version): equal ``perform()`` results and iteration counts, the
    residual within FIT_RESIDUAL_ATOL, the model within FIT_MODEL_RTOL of
    its peak.  The card runs twice: by the plan (one cluster at this K) and
    with B2 forced onto the grid route."""
    from radler_tpu_torch.models import generic_clean as gc
    from radler_tpu_torch.utils.fits import write_fits_image
    import tempfile

    psfs, res, index_map, freqs = make_spectral_problem(
        SPECTRAL_CHECK_SIZE, SPECTRAL_CHECK_SOURCES)
    limit = gc._HOGBOM_FALLBACK_PIXELS
    gc._HOGBOM_FALLBACK_PIXELS = 0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            forced = os.path.join(tmp, "forced.fits")
            write_fits_image(forced, index_map)
            for mode in FIT_MODES:
                settings = _spectral_settings(
                    SPECTRAL_CHECK_SIZE, SPECTRAL_CHECK_ITERATIONS, mode,
                    forced)
                start = time.perf_counter()
                cpu = _spectral_perform_on("cpu", settings, psfs, res, freqs)
                t_cpu = time.perf_counter() - start
                peak = float(cpu[3].abs().max())
                for route in ("its plan", "the grid"):
                    start = time.perf_counter()
                    if route == "the grid":
                        with _b2_on_the_grid():
                            card = _spectral_perform_on(DEVICE, settings,
                                                        psfs, res, freqs)
                    else:
                        card = _spectral_perform_on(DEVICE, settings, psfs,
                                                    res, freqs)
                    t_card = time.perf_counter() - start
                    d_res = float((card[2] - cpu[2]).abs().max())
                    d_mod = float((card[3] - cpu[3]).abs().max())
                    say(f"  {mode}, B2 by {route}: card {card[1]} "
                        f"iterations ({t_card:.2f} s, {card[4]} B2 "
                        f"launches), CPU {cpu[1]} ({t_cpu:.2f} s); perform() "
                        f"{card[0]} / {cpu[0]}; max|dres| {d_res:.3g}, "
                        f"max|dmodel| {d_mod:.3g} of the model peak "
                        f"{peak:.4g}")
                    if not (card[:2] == cpu[:2] and card[1] > 0
                            and card[4] >= 1 and d_res <= FIT_RESIDUAL_ATOL
                            and d_mod <= FIT_MODEL_RTOL * peak):
                        raise AssertionError(f"{mode}, B2 by {route}: the "
                                             "card and the CPU disagree")
    finally:
        gc._HOGBOM_FALLBACK_PIXELS = limit


def phase_mesh_clark_fit(psfs, res, kwargs):
    """The joined-channel cube on a chan 4 x tile 2 mesh (the mesh's Clark
    loop: B2's tile axis) with a 2-term LOG_POLYNOMIAL fit in its body,
    MESH_FIT_ITERATIONS a tile: a recorded perform and a timed one on the
    card (one tile launch, no B1 or single B2 launch), the split and the
    banded emulation, every tile replayed against the plain version, and
    the port's CPU mesh run of the same cube: equal counts, the residual
    within FIT_RESIDUAL_ATOL, the model within FIT_MODEL_RTOL of its peak.
    Returns a dict."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.kernels import subminor_loop as sl

    settings = _mesh_settings(SIZE, MESH_FIT_ITERATIONS, True)
    settings.generic.use_sub_minor_optimization = True
    settings.spectral_fitting.mode = rd.SpectralFittingMode.LOG_POLYNOMIAL
    settings.spectral_fitting.terms = 2

    def make(device=None):
        extra = {} if device is None else {"device": device}
        p = psfs if device is None else psfs.to(device)
        r0 = res if device is None else res.to(device)
        return lambda: rd.Radler(settings, p, r0.clone(),
                                 torch.zeros_like(r0), 0.0, **kwargs, **extra)

    calls, tile_calls = [], []
    with _recording_mesh_clark(calls, tile_calls):
        first = _run_perform(make())
    timed = _run_perform(make())
    launches = (sl.subminor_loop_tiles.launches, sl.subminor_loop.launches,
                timed[2][1])
    if len(calls) != 1 or len(tile_calls) != 1 or launches != (1, 0, 0):
        raise AssertionError(f"mesh with a fit: {len(calls)} calls, "
                             f"(tile, single B2, B1) launches {launches}")
    if timed[0] != first[0] or not torch.equal(timed[4], first[4]):
        raise AssertionError("mesh with a fit: the performs differ")
    split, counts = _mesh_clark_split(calls[0], first[4])
    worst = _check_tile_replay("mesh, log-polynomial", tile_calls)
    start = time.perf_counter()
    r = make("cpu")()
    r.perform(0)
    t_cpu = time.perf_counter() - start
    cpu_res = torch.stack([e.residual_accessor.array for e in r._table])
    cpu_mod = torch.stack([e.model_accessor.array for e in r._table])
    d_res = float((first[4].cpu() - cpu_res).abs().max())
    peak = float(cpu_mod.abs().max())
    d_mod = float((first[5].cpu() - cpu_mod).abs().max())
    n = first[0]
    say(f"  chan 4 x tile 2, LOG_POLYNOMIAL: {n} iterations summed over the "
        f"tiles, K per tile {counts}; {timed[1]:.4f} s, "
        f"{n / timed[1]:.1f} minor iterations/s; (tile, single B2, B1) "
        f"launches {launches}")
    say("  split of one perform's mesh subminor: " + ", ".join(
        f"{name} {sec * 1e3:.3f} ms" for name, sec in split.items()))
    say(f"  the port's CPU mesh run: {r.iteration_number} iterations "
        f"({t_cpu:.1f} s); max|dres| {d_res:.3g}, max|dmodel| {d_mod:.3g} "
        f"of the model peak {peak:.4g}")
    if not (r.iteration_number == n > 0 and d_res <= FIT_RESIDUAL_ATOL
            and d_mod <= FIT_MODEL_RTOL * peak):
        raise AssertionError("the mesh with a fit: card and CPU disagree")
    return dict(n=n, rate=n / timed[1], launches=launches[0], worst=worst,
                counts=counts)


def phase_ms_clark_fit():
    """Multiscale's Clark route (the host path with the dense loop's limit
    at 0, as config 3's Clark route) with a 2-term LOG_POLYNOMIAL fit: config
    3's field through Radler.perform on the card (rate, B2 launches, no
    B1), every B2 call replayed against its plain version at every plan;
    then :func:`make_ms_check_problem`'s field against the port's CPU run
    at the multiscale gate (equal iterations and components per scale,
    cubes within MS_CARD_VS_CPU).  Returns a dict."""
    psfs, residual = make_diffuse_problem(MS_SIZE, MS_CHANNELS)
    psf_d = torch.as_tensor(psfs, device=DEVICE)
    res_d = torch.as_tensor(residual, device=DEVICE)
    del psfs, residual
    settings = _ms_settings(MS_SIZE, MS_ITERATIONS, "LOG_POLYNOMIAL")
    calls = []
    with _recording_b2(calls):
        first = _ms_perform(psf_d, res_d, settings, route="clark")
    run = _ms_perform(psf_d, res_d, settings, route="clark")
    n, seconds, (b1, b2) = run[0], run[1], run[2]
    say(f"  config 3's field, LOG_POLYNOMIAL, Clark route: {n} iterations "
        f"in {seconds:.4f} s, {n / seconds:.1f} minor iterations/s; B2 "
        f"launches {b2}, B1 {b1}; {run[4]} subminor passes; channel 0's "
        f"residual rms {rms(res_d[0]):.6g} -> {rms(run[5][0]):.6g}")
    if not (b1 == 0 and b2 == len(calls) > 0 and first[0] == n
            and torch.equal(first[5], run[5])):
        raise AssertionError("the multiscale Clark route with a fit ran the "
                             "wrong kernels or differs between performs")
    del first, run, psf_d, res_d
    worst = 0.0
    for i, (args, kwargs) in enumerate(calls):
        _, _, d, _ = _subminor_replay_all(f"multiscale LOG_POLYNOMIAL pass {i}",
                                          args, kwargs)
        worst = max(worst, d)
    say(f"  its {len(calls)} B2 calls replayed: kernel equal to plain at "
        f"every plan; max|diff| {worst:.3g}")
    del calls
    torch.cuda.empty_cache()
    psfs, residual = make_ms_check_problem(MS_CHECK_SIZE, MS_CHECK_CHANNELS)
    cpu, card = [_ms_check_perform(psfs, residual, MS_CHECK_ITERATIONS,
                                   device, "clark", "LOG_POLYNOMIAL")
                 for device in ("cpu", DEVICE)]
    (n_c, comp_c, res_c, mod_c, t_c, _), (n_g, comp_g, res_g, mod_g, t_g, _) = (
        cpu, card)
    scale = max(1.0, float(np.abs(res_c).max()))
    d_res = float(np.abs(res_g - res_c).max()) / scale
    d_mod = float(np.abs(mod_g - mod_c).max()) / scale
    say(f"  {MS_CHECK_SIZE}^2 x {MS_CHECK_CHANNELS}, LOG_POLYNOMIAL, Clark "
        f"route: card {n_g} iterations ({t_g:.2f} s), CPU {n_c} "
        f"({t_c:.2f} s); components per scale {comp_g} / {comp_c}; "
        f"max|dres| {d_res:.3g}, max|dmodel| {d_mod:.3g} of max(1, "
        "|res|max)")
    if not (n_g == n_c > 0 and comp_g == comp_c and d_res <= MS_CARD_VS_CPU
            and d_mod <= MS_CARD_VS_CPU):
        raise AssertionError("the multiscale Clark route with a fit: card "
                             "and CPU disagree")
    return dict(rate=n / seconds, b2=b2, worst=worst)


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
    size, with and without the raw values in the first exchange, and on the
    grid route (one block a multiprocessor), at config 2's set and at the counts of SUBMINOR_TIMED_K, each list run
    forward and then backward; and the PSF gather that replaces the TPU's
    interaction matrix, alone.  Returns (max |difference|, kernel ms, plain
    ms, bound, the plan's name)."""
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

    sms = sl.sm_count(dev)
    own = sl.cluster_plan(1, k, sm_count=sms)
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
    if own.grid_blocks != (sms if k > sl.GRID_VALUES else 0):
        raise AssertionError(f"config 2's plan {_plan_name(own)} is not "
                             "its route by GRID_VALUES")

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

    # Every cluster size, both exchanges and the grid route, at four
    # candidate counts.
    integrated = res_d[0].abs().flatten().sort().values
    for k_target in (*SUBMINOR_TIMED_K[:2], None, *SUBMINOR_TIMED_K[2:]):
        timed = loop
        if k_target is not None:
            timed = _clark_loop(res_d[0], meta,
                                _settings(CLARK_SIZE, ITERATIONS, clark=True))
            timed.set_threshold(float(integrated[-k_target]), 0.0)
            timed.find_peak_positions(res_d, meta)
        k_timed = timed._residual_k.shape[1]
        chosen = sl.cluster_plan(1, k_timed, sm_count=sms)
        plans = [sl.cluster_plan(1, k_timed, cluster_size=r)
                 for r in CLUSTER_SIZES]
        plans.append(sl.cluster_plan(1, k_timed)._replace(ship_raw=False))
        plans.append(sl.cluster_plan(1, k_timed, grid_blocks=sms))
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
        n_bytes, n_flops), _plan_name(own)


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
        counts = (sl.subminor_loop.launches, _counts())
        if counts != (1, 0):
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


def phase_b4_times(case_index=0):
    """B4 at a shard of B4_CASES, by default the mesh configuration's,
    [1, 2048, 4096] in normal mode, with its peak inside the shard, against
    its plain version, in turns plain, kernel, kernel, plain.  Returns
    (kernel ms, plain ms, (bound ms, bound_by))."""
    from radler_tpu_torch.kernels import subtract_integrate as si

    case = B4_CASES[case_index]
    c = _shard_inputs(case, seed=40 + case_index)
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
    """(B4, B1) launches since the last _reset_counts."""
    from radler_tpu_torch.kernels import hogbom_step as hs
    from radler_tpu_torch.kernels import subtract_integrate as si

    return si.subtract_integrate.launches, hs.hogbom_step.launches


def _run_perform(make_radler, count_syncs=False):
    """Build a Radler with ``make_radler()``, then time one perform with the
    launch counts reset just before it.  Returns (iterations, seconds,
    (B4, B1) launches, host syncs or None, residual cube,
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
        f"single-device perform; launches B4 {counts[0]}, B1 "
        f"{counts[1]}")
    shard_kernel, other = (counts[0], counts[1]) if chan > 1 else (
        counts[1], counts[0])
    if not (n * MESH_DEVICES <= shard_kernel < (n + hs.CHUNK) * MESH_DEVICES
            and other == 0 and n > 0):
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


# ---------------------------------------------------------------------------
# Multiscale CLEAN
# ---------------------------------------------------------------------------


def phase_linear_b1():
    """B1 in linear mode with a weight plane at config 3's shape ([8, 2048,
    2048], the linear coefficients of 8 channels): the kernel loop against
    the plain loop over TRACE_ITERATIONS iterations (bit-equal), then the
    time of a launch (its select folded in, the weight plane also the rms
    factor) in turns plain, kernel, kernel, plain.  Returns (max
    |difference|, kernel ms, plain ms, bytes the launch must move)."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    inputs = _case_inputs("linear", MS_CHANNELS, 1, False, MS_SIZE, MS_SIZE,
                          seed=MS_CHANNELS)
    worst = 0.0
    for allow_negative in (True, False):
        pk, rk, mk, bk = _trace(inputs, "linear", True, allow_negative,
                                plain=False)
        pp, rp, mp, bp = _trace(inputs, "linear", True, allow_negative,
                                plain=True)
        d = max(float((rk - rp).abs().max()), float((mk - mp).abs().max()),
                float((bk.value - bp.value).abs().max()),
                float((bk.values - bp.values).abs().max()))
        same = bool(torch.equal(pk, pp) and torch.equal(bk.state, bp.state))
        say(f"  linear {MS_CHANNELS}x{MS_SIZE}x{MS_SIZE} weight=1 "
            f"allow_negative={allow_negative:d}: iterations "
            f"{int(bk.state[hs.ITERATION])}/{int(bp.state[hs.ITERATION])}, "
            f"same peaks and state {same}, max|difference| {d:.3g}")
        if not (same and d == 0.0):
            raise AssertionError("B1 in linear mode and its plain version "
                                 "disagree at config 3's shape")
        worst = max(worst, d)

    res, psfs = inputs["res"].clone(), inputs["psfs"]
    weight, coefs = inputs["weight"], inputs["coefs"]
    model = torch.zeros_like(res)
    flat = int(torch.argmax(res[0].abs()))
    y0, x0 = divmod(flat, MS_SIZE)
    params = hs.LoopParams.make(0.1, 0.0, 1.0, 0.0, 2**30, False)
    kw = dict(mode="linear", n_polarizations=1, allow_negative=True)
    times = {True: [], False: []}
    for plain in (True, False, False, True):
        step = hs.hogbom_step_reference if plain else hs.hogbom_step
        state = torch.tensor([y0, x0, 1, 0, 0, 1, flat, 0], dtype=torch.int32,
                             device=res.device)
        raw = res[:, y0, x0].clone()
        b = hs.LoopBuffers(state, torch.zeros(1, device=res.device), raw,
                           raw * params.gain)
        t_step, h_step = _time_ms(
            lambda: step(res, model, psfs, b.values, b.state, coefs, weight,
                         **kw, buffers=b, params=params, rms=weight), 20)
        times[plain].append(t_step)
        say(f"  {'plain ' if plain else 'kernel'} hogbom_step linear (select "
            f"folded in) {t_step:.4f} ms (host enqueue {h_step:.4f} ms)")
    n_parts = -(-weight.numel() // hs.PIXELS_PER_BLOCK)
    n_bytes = (3 * res.numel() * 4 + weight.numel() * 4 + 12 * n_parts
               + res.shape[0] * 4)
    del inputs, res, model
    torch.cuda.empty_cache()
    return (worst, sum(times[False]) / 2, sum(times[True]) / 2, n_bytes)


def _ms_settings(size, iterations, fit_mode="POLYNOMIAL"):
    import radler_tpu_torch as rd

    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.algorithm_type = rd.AlgorithmType.MULTISCALE
    s.minor_iteration_count = iterations
    s.minor_loop_gain = 0.1
    s.major_loop_gain = 0.85
    s.spectral_fitting.mode = getattr(rd.SpectralFittingMode, fit_mode)
    s.spectral_fitting.terms = 2
    return s


def _ms_frequencies(n_channels):
    """``bench.py``'s channel frequencies for config 3."""
    return np.array([[1.0e8 + c * 1e7, 1.1e8 + c * 1e7]
                     for c in range(n_channels)])


@contextlib.contextmanager
def _ms_route(route):
    """Run multiscale on ``route``: "fused" (the default: the fused loop),
    "dense" (the host path, ``RADLER_TPU_NO_FUSED_MS``: the dense subminor
    loop) or "clark" (the host path with the Clark subminor loop)."""
    from radler_tpu_torch.models import multiscale as ms

    saved = os.environ.pop("RADLER_TPU_NO_FUSED_MS", None)
    limit = ms.DENSE_SUBMINOR_MAX_PIXELS
    if route != "fused":
        os.environ["RADLER_TPU_NO_FUSED_MS"] = "1"
    if route == "clark":
        ms.DENSE_SUBMINOR_MAX_PIXELS = 0
    try:
        yield
    finally:
        ms.DENSE_SUBMINOR_MAX_PIXELS = limit
        os.environ.pop("RADLER_TPU_NO_FUSED_MS", None)
        if saved is not None:
            os.environ["RADLER_TPU_NO_FUSED_MS"] = saved


def _ms_radler(psfs, res0, settings):
    """A multiscale Radler on a copy of ``res0`` on the card, and a function
    that puts it back to its start (the residual, an empty model and no
    iterations done) while it keeps what it built (the fused banks, the
    kernel spectra): the next perform does the first one's work again."""
    import radler_tpu_torch as rd

    r = rd.Radler(settings, psfs, res0.clone(), torch.zeros_like(res0), 0.0,
                  frequencies=_ms_frequencies(res0.shape[0]))
    start = [(e.residual_accessor.array.clone(),
              e.model_accessor.array.clone()) for e in r._table]

    def rewind():
        for e, (res, mod) in zip(r._table, start):
            e.residual_accessor.array = res.clone()
            e.model_accessor.array = mod.clone()
        r._parallel.first_algorithm.iteration_number = 0

    return r, rewind


def _ms_perform(psfs, res0, settings, count_syncs=False, route="fused",
                kept=None):
    """One multiscale perform of ``res0`` on the card on ``route``: on a
    fresh Radler, or on ``kept`` (a :func:`_ms_radler` pair, rewound
    first).  Returns (iterations, seconds, (B1, B2) launches, host syncs
    or None, subminor passes, residual cube, model
    cube)."""
    from radler_tpu_torch.kernels import hogbom_step as hs
    from radler_tpu_torch.kernels import subminor_loop as sl
    from radler_tpu_torch.models import multiscale as ms
    from radler_tpu_torch.models import multiscale_fused as mf

    if kept is None:
        r, rewind = _ms_radler(psfs, res0, settings)
    else:
        r, rewind = kept
    rewind()
    passes = [0]
    saved = [(ms.MultiScaleAlgorithm, "_run_fast_sub_loop"),
             (mf, "dense_subminor_loop")]
    saved = [(owner, name, getattr(owner, name)) for owner, name in saved]

    def counting(fn):
        def counted(*args, **kwargs):
            passes[0] += 1
            return fn(*args, **kwargs)
        return counted

    for owner, name, fn in saved:
        setattr(owner, name, counting(fn))
    try:
        with _ms_route(route):
            torch.cuda.synchronize()
            _reset_counts()
            start = time.perf_counter()
            syncs = None
            if count_syncs:
                syncs = _count_syncs(lambda: r.perform(0))
            else:
                r.perform(0)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            launches = (hs.hogbom_step.launches, sl.subminor_loop.launches)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    fused = r._parallel.first_algorithm._fused_banks is not None
    if fused != (route == "fused"):
        raise AssertionError(f"the {route} route ran the "
                             f"{'fused' if fused else 'host'} path")
    out_res = torch.stack([e.residual_accessor.array for e in r._table])
    out_mod = torch.stack([e.model_accessor.array for e in r._table])
    if not (torch.isfinite(out_res).all() and torch.isfinite(out_mod).all()):
        raise AssertionError("non-finite residual or model")
    return (r.iteration_number, seconds, launches, syncs, passes[0], out_res,
            out_mod)


def _sync_cards():
    """Wait for every visible card."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _timed_steps(split, targets, by_caller=None, memory=None):
    """Wrap each ``(owner, name, label)`` of ``targets`` with a synchronized
    timer that adds the step's own time, without the wrapped steps it
    calls, to ``split[label]``; a label of None is looked up in
    ``by_caller`` by the caller's function name.  With a dict ``memory``,
    also keep per label the device memory of its call with the highest
    peak: ``(peak, allocated at its entry)`` in bytes, the peak including
    the wrapped steps it calls; the peaks reached outside every wrapped
    step go under None (the caller adds the perform's tail after it).
    Every card is synchronized around each step.  Returns a function that
    restores them."""
    saved = []
    nested = []  # per open step: the seconds of the wrapped steps it called
    peaks = []  # per open step: the highest device memory read inside it

    def read_peak():
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for i, p in enumerate(peaks):
            peaks[i] = max(p, peak)
        if not peaks:
            memory[None] = max(memory.get(None, 0), peak)

    def wrap(owner, name, label):
        fn = getattr(owner, name)
        saved.append((owner, name, fn))
        if inspect.isgeneratorfunction(fn):
            setattr(owner, name, timed_resumes(fn, label))
            return

        def timed(*args, **kwargs):
            key = label
            if key is None:
                key = by_caller.get(sys._getframe(1).f_code.co_name,
                                    "PSF convolutions")
            _sync_cards()
            if memory is not None:
                read_peak()
                entry = torch.cuda.memory_allocated()
                peaks.append(entry)
            start = time.perf_counter()
            nested.append(0.0)
            try:
                out = fn(*args, **kwargs)
                _sync_cards()
            finally:
                inner = nested.pop()
                if memory is not None:
                    read_peak()
                    peak = peaks.pop()
                    if peak > memory.get(key, (-1, 0))[0]:
                        memory[key] = (peak, entry)
            seconds = time.perf_counter() - start
            if nested:
                nested[-1] += seconds
            calls, total = split.get(key, (0, 0.0))
            split[key] = (calls + 1, total + seconds - inner)
            return out

        setattr(owner, name, timed)

    def timed_resumes(fn, label):
        """A generator loop's wrapper: each resume, from one yield to the
        next, adds its own time to ``split[label]`` (its device memory is
        not kept); a call counts once, at its end."""
        def timed(*args, **kwargs):
            loop = fn(*args, **kwargs)
            while True:
                _sync_cards()
                start = time.perf_counter()
                nested.append(0.0)
                end = None
                try:
                    next(loop)
                except StopIteration as stop:
                    end = stop
                _sync_cards()
                inner = nested.pop()
                seconds = time.perf_counter() - start
                if nested:
                    nested[-1] += seconds
                calls, total = split.get(label, (0, 0.0))
                split[label] = (calls + (end is not None),
                                total + seconds - inner)
                if end is not None:
                    return end.value
                yield

        return timed

    for target in targets:
        wrap(*target)

    def restore():
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)

    return restore


def _ms_timed_split(split, memory=None):
    """Time the host path's main steps into ``split`` (and their device
    memory into ``memory``, see :func:`_timed_steps`); a convolution with a
    scale kernel is labelled by its caller."""
    from radler_tpu_torch.models import multiscale as ms

    alg = ms.MultiScaleAlgorithm
    return _timed_steps(split, [
        (alg, "_find_active_scale_convolved_maxima",
         "scale maxima (FFT bank, argmaxes, one host read)"),
        (ms, "get_linear_integrated", "linear integration"),
        (alg, "_scale_convolve", None),
        (ms, "_twice_convolved_stack", "PSF convolutions"),
        (alg, "_kernel_fft", "scale kernels (NumPy, copy, rfft2)"),
        (alg, "_scale_valid_stack", "search windows (NumPy, copy)"),
        (ms, "dense_subminor_loop", "dense loop (B1 linear)"),
        (alg, "_clark_sub_loop", "Clark loop (candidates, B2, reads)"),
        (ms, "correct_residual", "correction FFTs"),
    ], by_caller={
        "execute_major_iteration": "scale-convolved residual",
        "_run_fast_sub_loop": "model add (scale convolution)",
    }, memory=memory)


def _ms_fused_split(split, memory=None):
    """Time the fused route's steps into ``split`` (and their device memory
    into ``memory``, see :func:`_timed_steps`), the banks' own FFTs
    apart."""
    from radler_tpu_torch.models import multiscale as ms
    from radler_tpu_torch.models import multiscale_fused as mf

    alg = ms.MultiScaleAlgorithm
    return _timed_steps(split, [
        (alg, "_prepare_fused_banks",
         "banks, besides their FFTs (kept: one PSF comparison)"),
        (ms, "centered_embed_kernel_fft", "banks: embedded spectra"),
        (ms, "forward_fft2", "banks: PSF forward FFTs"),
        (ms, "inverse_fft2_real", "banks: peaks and twice-convolved PSFs"),
        (alg, "_scale_valid_stack", "search windows (NumPy, copy)"),
        (mf, "spectral_scale_maxima",
         "maxima (S inverse FFTs, argmaxes, one host read)"),
        (mf, "scale_convolved_cube", "scale-convolved cube (N inverse FFTs)"),
        (mf, "dense_subminor_loop", "dense loop (B1 linear + fit)"),
        (mf, "correct_small", "correction, small size (spectral)"),
        (mf, "correct_large", "correction, large size (image space)"),
    ], memory=memory)


def _ms_best(psf_d, res_d, settings, route, kept=None, count=2):
    """A warm-up and ``count`` performs on ``route``; checks that they agree
    and launch what the route launches; returns (best seconds, the last
    run)."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    warm = _ms_perform(psf_d, res_d, settings, route=route, kept=kept)
    runs = [_ms_perform(psf_d, res_d, settings, route=route, kept=kept)
            for _ in range(count)]
    n, _, launches, _, passes = runs[-1][:5]
    if any(r[0] != n or r[2] != launches or r[4] != passes
           or not torch.equal(r[5], runs[-1][5]) for r in runs + [warm]):
        raise AssertionError(f"config 3's performs on the {route} route "
                             "differ in iterations, launches, passes or "
                             "residual")
    step, b2 = launches
    if route == "clark":
        ok = step == 0 and 0 < b2 <= passes
    else:
        ok = (b2 == 0 and passes > 0
              and n <= step < n + hs.CHUNK * passes)
    if not (ok and n > 0):
        raise AssertionError(f"config 3's {route} route launched B1 {step}, "
                             f"B2 {b2} times for {n} iterations in {passes} "
                             "subminor passes")
    return min(r[1] for r in runs), runs[-1], [r[1] for r in runs]


def _say_split(split, seconds, passes, label, memory=None, base=0):
    """Print a split of :func:`_timed_steps`; with its ``memory``, each
    step's peak device memory above ``base`` (the memory allocated before
    the perform), the live memory at that call's entry, and the step that
    holds the perform's peak."""
    say(f"  split of one perform on a {label} Radler ({seconds:.4f} s with a "
        f"synchronize around each step; {passes} subminor passes):")
    mib = 1 / 2**20
    for key, (calls, t) in split.items():
        line = (f"    {key}: {calls} calls, {t * 1e3:.1f} ms, "
                f"{t * 1e3 / passes:.2f} ms a pass")
        if memory is not None and key in memory:
            peak, entry = memory[key]
            line += (f"; peak {(peak - base) * mib:.1f} MiB above the "
                     f"perform's start, {(entry - base) * mib:.1f} live at "
                     f"its entry")
        say(line)
    rest = seconds - sum(v[1] for v in split.values())
    say(f"    the rest: {rest * 1e3:.1f} ms")
    if memory is not None:
        outside = memory.get(None, 0)
        peak, where = max((v[0], k) for k, v in memory.items()
                          if k is not None)
        if outside > peak:
            peak, where = outside, "outside the steps above"
        say(f"    peak device memory of the perform {(peak - base) * mib:.1f} "
            f"MiB above its start, in {where} (outside the steps "
            f"{(outside - base) * mib:.1f})")


def _fused_bank_sizes(radler, n_images):
    """Print the bytes of a Radler's kept fused banks, tensor by tensor,
    beside one spectral residual and one image cube."""
    banks = radler._parallel.first_algorithm._fused_banks[4]
    names = ("kernel spectra (small)", "twice-convolved PSFs",
             "PSF spectra (small)", "kernel spectra (large)",
             "PSF spectra (large)")
    parts = [(n, tuple(t.shape), t.numel() * t.element_size() / 2**20)
             for n, t in zip(names, banks[:5]) if t is not None]
    _, ph, pw_half = banks[0].shape
    height, width = banks[1].shape[2:]
    say(f"    kept fused banks {sum(p[2] for p in parts):.1f} MiB: "
        + ", ".join(f"{n} {shape} {b:.1f}" for n, shape, b in parts)
        + f"; one spectral residual [{n_images}, {ph}, {pw_half}] "
        f"complex64 {n_images * ph * pw_half * 8 / 2**20:.1f} MiB; one "
        f"image cube [{n_images}, {height}, {width}] float32 "
        f"{n_images * height * width * 4 / 2**20:.1f} MiB")


def phase_config3():
    """Config 3: multiscale 2048^2 x 8 channels, 2-term polynomial fit,
    600 minor iterations, gain 0.1, major gain 0.85, through
    Radler.perform on CUDA tensors, on its three routes in one run: the
    fused loop (the default; B1 in linear mode with the weight plane in its
    dense subminor loop, components in coefficient space), the host path's
    dense route (the same B1 loop with the fit between launches) and its
    Clark route (B2 on 8 planes).  For each: a warm-up and the best of 2 on
    a fresh Radler each (banks or kernel spectra built) and on one kept
    Radler (kept, as across major iterations); passes, launches, host
    syncs, peak memory of each, channel 0's residual rms, the split of one
    perform per pass on each with each step's peak memory (and the fused
    route's kept banks, tensor by tensor).  Then B2 against its plain version on every
    Clark pass's inputs.  Returns a dict of the numbers the summary and the
    kernels line use."""
    from radler_tpu_torch.models import subminor as subminor_module

    start = time.perf_counter()
    psfs, residual = make_diffuse_problem(MS_SIZE, MS_CHANNELS)
    say(f"  problem made in {time.perf_counter() - start:.1f} s (NumPy)")
    psf_d = torch.as_tensor(psfs, device=DEVICE)
    res_d = torch.as_tensor(residual, device=DEVICE)
    del psfs, residual
    settings = _ms_settings(MS_SIZE, MS_ITERATIONS)
    rms0 = rms(res_d[0])

    # The Clark route's B2 calls, each input kept for the replay below.
    b2_calls = []
    real_b2 = subminor_module.subminor_loop

    def recording_b2(*args, **kwargs):
        b2_calls.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a
                               for a in args), kwargs))
        return real_b2(*args, **kwargs)

    subminor_module.subminor_loop = recording_b2
    try:
        _ms_perform(psf_d, res_d, settings, route="clark")
    finally:
        subminor_module.subminor_loop = real_b2

    out, residuals = {}, {}
    for route, splitter in (("fused", _ms_fused_split),
                            ("dense", _ms_timed_split),
                            ("clark", _ms_timed_split)):
        peaks = []
        for kept in (None, _ms_radler(psf_d, res_d, settings)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            runs = _ms_best(psf_d, res_d, settings, route, kept=kept)
            peaks.append((torch.cuda.max_memory_allocated() - base) / 2**20)
            if kept is None:
                fresh, run, fresh_s = runs
            else:
                best, kept_run, kept_s = runs
                kept_radler = kept
        n, _, (step, b2), _, passes, out_res, out_mod = run
        if not (kept_run[0] == n and torch.equal(kept_run[5], out_res)):
            raise AssertionError(f"the {route} route's kept Radler differs "
                                 "from a fresh one")
        counted = _ms_perform(psf_d, res_d, settings, count_syncs=True,
                              route=route, kept=kept_radler)
        rms1 = rms(out_res[0])
        if not rms1 < rms0:
            raise AssertionError(f"config 3's {route} route did not clean")
        say(f"  {route} route: {n} iterations in {passes} subminor passes; "
            f"fresh Radler seconds {', '.join(f'{t:.4f}' for t in fresh_s)} "
            f"(best {n / fresh:.1f} minor iterations/s); kept Radler "
            f"seconds {', '.join(f'{t:.4f}' for t in kept_s)} (best "
            f"{n / best:.1f} minor iterations/s); launches hogbom_step "
            f"{step} (its select folded in), subminor_loop {b2} per "
            f"perform; host syncs {counted[3]} per perform on the kept "
            f"Radler (sync debug mode on, {counted[1]:.4f} s)")
        say(f"    channel 0 residual rms {rms0:.6g} -> {rms1:.6g}; model sum "
            f"{float(out_mod.double().sum()):.6g}; peak device memory above "
            f"the inputs: fresh Radler {peaks[0]:.1f} MiB, kept "
            f"{peaks[1]:.1f} MiB")
        for radler, label in ((kept_radler, "kept"), (None, "fresh")):
            split, memory = {}, {}
            restore = splitter(split, memory)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            try:
                timed = _ms_perform(psf_d, res_d, settings, route=route,
                                    kept=radler)
            finally:
                restore()
            memory[None] = max(memory.get(None, 0),
                               torch.cuda.max_memory_allocated())
            if timed[0] != n or not torch.equal(timed[5], out_res):
                raise AssertionError("the split perform differs from the "
                                     "others")
            _say_split(split, timed[1], passes, label, memory, base)
            if route == "fused" and radler is not None:
                _fused_bank_sizes(radler[0], out_res.shape[0])
        out[route] = dict(n=n, step=step, b2=b2, rate=n / best,
                          fresh=n / fresh, syncs=counted[3],
                          peak_mib=peaks[0], kept_peak_mib=peaks[1])
        residuals[route] = out_res
        del kept_radler, run, kept_run, counted, timed, out_mod
        torch.cuda.empty_cache()
    for route in ("fused", "clark"):
        d = float((residuals[route] - residuals["dense"]).abs().max())
        say(f"  max|{route} residual - the dense route's| {d:.3g}")
    if not (out["clark"]["b2"] == len(b2_calls) and out["clark"]["step"] == 0
            and out["fused"]["b2"] == out["dense"]["b2"] == 0):
        raise AssertionError("config 3's routes launched the wrong kernels")
    del res_d, psf_d, residuals
    out["worst_b2"] = _check_config3_b2(b2_calls)
    del b2_calls
    torch.cuda.empty_cache()
    return out


def _check_config3_b2(calls):
    """Every B2 call of config 3's Clark route, replayed from a copy of its
    inputs: the plain version against the kernel at its own plan and every
    plan of :func:`_subminor_plans`, bit-equal.  Returns max |difference|."""
    start = time.perf_counter()
    worst, ks, done, own = 0.0, [], [], set()
    for i, (args, kwargs) in enumerate(calls):
        (iteration, _, _), plans, d, _ = _subminor_replay_all(
            f"config 3, Clark pass {i}", args, kwargs)
        ks.append(args[0].shape[1])
        done.append(iteration - args[8].start_iteration)
        own.add(_plan_name(plans[0]))
        worst = max(worst, d)
    n = calls[0][0][0].shape[0]
    say(f"  B2 at config 3's {len(calls)} Clark passes ({n} planes, the "
        f"{'2-term fit' if calls[0][0][7] is not None else 'no fit'}), "
        f"K {min(ks)}..{max(ks)}, {sum(done)} iterations in all: kernel "
        f"equal to plain at each pass's own plan ({', '.join(sorted(own))}), "
        f"every cluster size, the state in global memory, the exchange "
        f"without raw values and the grid route; max|diff| {worst:.3g} "
        f"({time.perf_counter() - start:.1f} s)")
    if sum(done) == 0:
        raise AssertionError("config 3's Clark passes made no iterations")
    return worst


def phase_ms_contract(route):
    """The multiscale point-source contract of tests/test_radler.py on the
    card, on ``route`` (see :func:`_ms_route`): residual under 2e-6, the
    model 2.5 at the source within 1e-4 relative and under 2e-6
    elsewhere."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.kernels import hogbom_step as hs

    size, (sx, sy) = 64, (-9, 15)
    point = np.array([[0.0, 0.4, 0.0], [0.25, 1.0, 0.5], [0.0, 0.6, 0.0]],
                     np.float32)
    psf = np.zeros((size, size), np.float32)
    psf[31:34, 31:34] = point
    res = np.zeros((size, size), np.float32)
    cy, cx = size // 2 + sy, size // 2 + sx
    res[cy - 1 : cy + 2, cx - 1 : cx + 2] = 2.5 * point
    s = rd.Settings()
    s.algorithm_type = rd.AlgorithmType.MULTISCALE
    s.trimmed_image_width = s.trimmed_image_height = size
    s.pixel_scale.x = s.pixel_scale.y = np.deg2rad(1.0 / 60.0)
    s.absolute_threshold = 1e-7
    s.minor_iteration_count = 600
    dev = torch.device(DEVICE)
    r = rd.Radler(s, torch.as_tensor(psf, device=dev),
                  torch.as_tensor(res, device=dev),
                  torch.zeros(size, size, device=dev), 0.0)
    _reset_counts()
    with _ms_route(route):
        if r.perform(0) is not False:
            raise AssertionError("perform asked for another major iteration")
    if (r._parallel.first_algorithm._fused_banks is not None) != (
            route == "fused"):
        raise AssertionError(f"the contract did not run the {route} route")
    out_res = r._table.front.residual_accessor.array.cpu().numpy()
    out_mod = r._table.front.model_accessor.array.cpu().numpy()
    peak = out_mod[cy, cx]
    others = np.delete(out_mod.ravel(), cy * size + cx)
    say(f"  {route} route, shift ({sx},{sy}): {r.iteration_number} "
        "iterations, B1 launches "
        f"{hs.hogbom_step.launches}; max|residual| {np.abs(out_res).max():.3g},"
        f" model peak {peak:.7f}, max|model elsewhere| "
        f"{np.abs(others).max():.3g}")
    if not (np.abs(out_res).max() < 2e-6 and abs(peak - 2.5) <= 2.5e-4
            and np.abs(others).max() < 2e-6 and hs.hogbom_step.launches > 0):
        raise AssertionError("the multiscale point-source contract failed")


def _ms_check_perform(psfs, residual, iterations, device, route,
                      fit_mode="POLYNOMIAL"):
    """One perform of config 3's settings (with the 2-term ``fit_mode``
    fit) at ``iterations`` on a copy of ``residual`` on ``device`` on
    ``route``; returns (iterations,
    components per scale, residual, model, seconds, (the major iteration's
    first threshold, the biased peak its last stop test read) on the host
    path, the final biased peak on the fused route)."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.models import multiscale as ms

    size, n_channels = residual.shape[-1], residual.shape[0]
    res, model = residual.copy(), np.zeros_like(residual)
    peaks = []
    real_select = ms.select_maximum_scale

    def recording_select(scales):
        index = real_select(scales)
        if index is not None:
            e = scales[index]
            peaks.append(e.max_unnormalized_image_value * e.bias_factor)
        return index

    finals = []
    real_execute = ms.MultiScaleAlgorithm._execute_fused

    def recording_execute(self, *args, **kwargs):
        result = real_execute(self, *args, **kwargs)
        finals.append(result.final_peak_value)
        return result

    ms.select_maximum_scale = recording_select
    ms.MultiScaleAlgorithm._execute_fused = recording_execute
    try:
        with _ms_route(route):
            start = time.perf_counter()
            settings = _ms_settings(size, iterations, fit_mode)
            r = rd.Radler(settings, psfs, res, model, 0.0,
                          frequencies=_ms_frequencies(n_channels),
                          device=device)
            r.perform(0)
            seconds = time.perf_counter() - start
    finally:
        ms.select_maximum_scale = real_select
        ms.MultiScaleAlgorithm._execute_fused = real_execute
    alg = r._parallel.first_algorithm
    if bool(finals) != (route == "fused"):
        raise AssertionError(f"the check did not run the {route} route")
    if finals:
        stop = (float("nan"), finals[-1])
    else:
        # execute_major_iteration's first threshold, from its initial peak.
        stop = (max(abs(peaks[0]) * (1.0 - settings.major_loop_gain),
                    alg.major_iteration_threshold, alg.threshold), peaks[-1])
    return (r.iteration_number,
            [e.n_components_cleaned for e in alg.scale_infos], res, model,
            seconds, stop)


def phase_ms_card_vs_cpu(route):
    """:func:`make_ms_check_problem`'s 256^2 x 4-channel field (config 3's
    settings; three scales take components) on ``route`` on the card
    against the port's CPU run of the same arrays, twice: stopped at
    MS_CHECK_ITERATIONS, and run on to its threshold.  Each: equal
    iteration counts and components per scale, residual and model within
    MS_CARD_VS_CPU of max(1, |res|max)."""
    psfs, residual = make_ms_check_problem(MS_CHECK_SIZE, MS_CHECK_CHANNELS)
    for limit, stop in ((MS_CHECK_ITERATIONS, "the iteration limit"),
                        (2 * MS_CHECK_ITERATIONS, "its threshold")):
        cpu, card = [_ms_check_perform(psfs, residual, limit, device, route)
                     for device in ("cpu", DEVICE)]
        (n_c, comp_c, res_c, mod_c, t_c, stop_c) = cpu
        (n_g, comp_g, res_g, mod_g, t_g, stop_g) = card
        scale = max(1.0, float(np.abs(res_c).max()))
        d_res = float(np.abs(res_g - res_c).max()) / scale
        d_mod = float(np.abs(mod_g - mod_c).max()) / scale
        say(f"  {route} route, stopped at {stop} ({limit}): card {n_g} "
            "iterations "
            f"({t_g:.2f} s), CPU {n_c} ({t_c:.2f} s); components per scale "
            f"{comp_g} / {comp_c}; max|dres| {d_res:.3g}, max|dmodel| "
            f"{d_mod:.3g} of max(1, |res|max); the last stop test's "
            f"threshold and peak (fused: the final biased peak): card "
            f"{stop_g[0]:.7g}, {stop_g[1]:.7g}, CPU {stop_c[0]:.7g}, "
            f"{stop_c[1]:.7g}")
        if not (n_g == n_c > 0 and comp_g == comp_c and d_res <= MS_CARD_VS_CPU
                and d_mod <= MS_CARD_VS_CPU and sum(c > 0 for c in comp_c) > 1
                and (n_c == limit) == (limit == MS_CHECK_ITERATIONS)):
            raise AssertionError(f"stopped at {stop}: the multiscale perform "
                                 "on the card and on the CPU disagree")


def phase_ms_mesh():
    """The multiscale mesh: :func:`make_ms_check_problem` at MS_SIZE^2 x
    MS_MESH_CHANNELS with config 3's settings through Radler.perform on a
    chan 4 x tile 2 mesh on the card (the fused loop, its dense subminor
    loop on the shards: B4 in linear mode, components in coefficient
    space), a warm-up and one perform, against the single-device fused
    perform: equal iteration counts, the cubes within MS_MESH_VS_SINGLE, B4
    launched on every shard every iteration and B1 not at all.  Returns
    (B4 launches, mesh rate, single-device rate)."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.kernels import hogbom_step as hs

    psfs, residual = make_ms_check_problem(MS_SIZE, MS_MESH_CHANNELS)
    psf_d = torch.as_tensor(psfs, device=DEVICE)
    res_d = torch.as_tensor(residual, device=DEVICE)
    del psfs, residual

    def radler(use_mesh):
        s = _ms_settings(MS_SIZE, MS_ITERATIONS)
        s.parallel.use_device_mesh = use_mesh
        s.parallel.n_devices = MESH_DEVICES if use_mesh else 0
        return lambda: rd.Radler(
            s, psf_d, res_d.clone(), torch.zeros_like(res_d), 0.0,
            frequencies=_ms_frequencies(MS_MESH_CHANNELS))

    with _ms_route("fused"):
        single = _run_perform(radler(False))
        _run_perform(radler(True))  # warm-up
        mesh = _run_perform(radler(True))
    n, seconds, (b4, step) = mesh[:3]
    d_res = float((mesh[4] - single[4]).abs().max())
    d_mod = float((mesh[5] - single[5]).abs().max())
    say(f"  chan 4 x tile 2: {n} iterations in {seconds:.4f} s, "
        f"{n / seconds:.1f} minor iterations/s (single device {single[0]} in "
        f"{single[1]:.4f} s, {single[0] / single[1]:.1f}); launches B4 {b4}, "
        f"B1 {step}; max|dres| {d_res:.3g}, "
        f"max|dmodel| {d_mod:.3g} against the single-device perform; peak "
        f"device memory above the inputs: mesh {mesh[6]:.1f} MiB, single "
        f"{single[6]:.1f} MiB; channel 0 residual rms {rms(res_d[0]):.6g} -> "
        f"{rms(mesh[4][0]):.6g}")
    if not (n > 0 and n * MESH_DEVICES <= b4
            and step == 0 and single[2][1] >= single[0]):
        raise AssertionError(f"the multiscale mesh launched B4 {b4}, B1 "
                             f"{step} times for {n} iterations")
    if n != single[0] or max(d_res, d_mod) > MS_MESH_VS_SINGLE:
        raise AssertionError("the multiscale mesh and single-device "
                             "performs differ")
    single_rate = single[0] / single[1]
    del res_d, psf_d, mesh, single
    torch.cuda.empty_cache()
    return b4, n / seconds, single_rate


# ---------------------------------------------------------------------------
# The mesh over several cards
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _listed_cards(cards):
    """While open, Radler's meshes spread over ``cards`` (the run's card
    first): the mesh module's card listing is replaced.  ``None`` keeps the
    real listing, every visible card."""
    from radler_tpu_torch.parallel import mesh as pm

    real = pm.visible_cards
    if cards is not None:
        pm.visible_cards = lambda device: list(cards)
    try:
        yield
    finally:
        pm.visible_cards = real


def _mesh_kernels():
    from radler_tpu_torch.kernels import hogbom_step as hs
    from radler_tpu_torch.kernels import subminor_loop as sl
    from radler_tpu_torch.kernels import subtract_integrate as si

    return {"B1": hs.hogbom_step, "B4": si.subtract_integrate,
            "B2": sl.subminor_loop_tiles}


def _run_on_cards(make_radler, cards):
    """One perform of ``make_radler()`` with the meshes over ``cards``
    (see :func:`_listed_cards`), every card synchronized around it and the
    launch counts reset just before it.  Returns a dict: iterations,
    seconds, launches of B1, B4 and B2 by card, the cubes, each card's peak
    memory above what it held before (MiB) and the mesh."""
    count = torch.cuda.device_count()
    with _listed_cards(cards):
        r = make_radler()
        before = []
        for i in range(count):
            torch.cuda.synchronize(i)
            torch.cuda.reset_peak_memory_stats(i)
            before.append(torch.cuda.memory_allocated(i))
        _reset_counts()
        start = time.perf_counter()
        r.perform(0)
        for i in range(count):
            torch.cuda.synchronize(i)
        seconds = time.perf_counter() - start
    launches = {name: dict(fn.launches_by_card)
                for name, fn in _mesh_kernels().items()}
    out_res = torch.stack([e.residual_accessor.array for e in r._table])
    out_mod = torch.stack([e.model_accessor.array for e in r._table])
    if not (torch.isfinite(out_res).all() and torch.isfinite(out_mod).all()):
        raise AssertionError("non-finite residual or model")
    peaks = [(torch.cuda.max_memory_allocated(i) - before[i]) / 2**20
             for i in range(count)]
    mesh = r._parallel.first_algorithm.device_mesh
    return dict(n=r.iteration_number, seconds=seconds, launches=launches,
                res=out_res, mod=out_mod, peaks=peaks, mesh=mesh)


def _card_time(make_radler, cards):
    """Where a perform's time goes: one perform with the meshes over
    ``cards`` under ``torch.profiler``.  For each card, the union of its
    device intervals over the window from the first device interval on
    any card to the last (its busy share) and its device time by name (the
    three largest); for the host, the six largest self CPU times by op,
    with their calls, both per iteration.  Returns a dict (``cards`` None
    where the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with _listed_cards(cards):
        r = make_radler()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            r.perform(0)
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
            seconds = time.perf_counter() - start
    n = max(r.iteration_number, 1)
    host = sorted(((e.key, e.count / n, e.self_cpu_time_total / n)
                   for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda t: -t[2])[:6]
    out = dict(ms=seconds / n * 1e3, host=host, cards=None)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        return out
    first = min(e.time_range.start for e in device)
    window = max(e.time_range.end for e in device) - first
    out["cards"] = {}
    for index in sorted({e.device_index for e in device}):
        mine = [e for e in device if e.device_index == index]
        busy, reach = 0.0, None
        for begin, end in sorted((e.time_range.start, e.time_range.end)
                                 for e in mine):
            if reach is None or begin > reach:
                busy, reach = busy + end - begin, end
            elif end > reach:
                busy, reach = busy + end - reach, end
        by_name = {}
        for e in mine:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        out["cards"][index] = (busy / window,
                               [(k[:48], t / 1e3) for k, t in top])
    return out


def _say_card_time(label, timed):
    say(f"    profiled perform, {label}: {timed['ms']:.4f} ms an iteration "
        "(profiler on); host self CPU an iteration: " + ", ".join(
            f"{key} {us:.1f} us ({calls:.1f} calls)"
            for key, calls, us in timed["host"]))
    if timed["cards"] is None:
        say("    the profiler saw no device time (busy shares not measured)")
    for index, (share, top) in (timed["cards"] or {}).items():
        say(f"      card {index}: busy {share:.4f} of the window; "
            + ", ".join(f"{name} {ms:.3f} ms" for name, ms in top))


def _expected_launches(mesh, kernel, n):
    """The least launches of ``kernel`` on each card for ``n`` iterations
    on ``mesh``: every shard once an iteration (B1 and B4), one tile-axis
    launch a group that holds Clark tiles (B2)."""
    from radler_tpu_torch.parallel import mesh as pm

    want = {}
    if kernel == "B2":
        for _, _, g in pm.tile_runs(mesh):
            index = mesh.card(g).index
            want[index] = want.get(index, 0) + 1
        return want
    per_group = mesh.size // mesh.groups
    for g in range(mesh.groups):
        index = mesh.card(g).index
        want[index] = want.get(index, 0) + n * per_group
    return want


def _cards_cell(label, make_radler, kernel, spread, one, single_gate,
                loops=1, profiled=False):
    """One cell of the mesh-over-cards phase: the perform with the shards
    over ``spread`` (None: every visible card) against the same perform on
    one group on the card (``one``), bit for bit, and against the
    single-device perform within ``single_gate`` (None: printed only, the
    mesh's Clark loop being another algorithm than the single device's).
    Checks that ``kernel`` launched on every card that holds shards, every
    shard every iteration (and, over ``loops`` minor loops a perform, fewer
    than CHUNK times more, the no-op launches after each loop's stop; None:
    not counted), and no other mesh kernel; with ``profiled``, a perform
    of CARDS_PROFILE_ITERATIONS iterations on one group and one spread
    under the profiler (:func:`_card_time`; ``make_radler`` then takes the
    iterations as its second argument).  Returns the cell's numbers."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    single = _run_on_cards(lambda: make_radler(False), one)
    base = _run_on_cards(lambda: make_radler(True), one)
    run = _run_on_cards(lambda: make_radler(True), spread)
    mesh, n = run["mesh"], run["n"]
    if base["mesh"].groups != 1 or mesh.groups < 2:
        raise AssertionError(f"{label}: {base['mesh'].groups} and "
                             f"{mesh.groups} groups")
    same = (n == base["n"] and torch.equal(run["res"], base["res"])
            and torch.equal(run["mod"], base["mod"]))
    d_res = float((run["res"] - single["res"]).abs().max())
    d_mod = float((run["mod"] - single["mod"]).abs().max())
    want = _expected_launches(mesh, kernel, n)
    got = run["launches"][kernel]
    others = {k: v for k, v in run["launches"].items() if k != kernel and v}
    say(f"  {label}: chan {mesh.chan} x tile {mesh.tile} over "
        f"{[str(d) for d in mesh.devices]}; {n} iterations (one group "
        f"{base['n']}, single device {single['n']}); bit-equal to the "
        f"one-group mesh: {same}; max|dres| {d_res:.3g}, max|dmodel| "
        f"{d_mod:.3g} against the single device")
    say(f"    {kernel} launches by card {dict(sorted(got.items()))} (at least "
        f"{dict(sorted(want.items()))}); seconds {run['seconds']:.4f}, "
        f"{run['seconds'] / max(n, 1) * 1e3:.4f} ms an iteration against "
        f"{base['seconds'] / max(base['n'], 1) * 1e3:.4f} on one group and "
        f"{single['seconds'] / max(single['n'], 1) * 1e3:.4f} on one device; "
        f"peak memory by card (MiB above its inputs) "
        f"{[round(p, 1) for p in run['peaks']]}, one group "
        f"{[round(p, 1) for p in base['peaks']]}")
    if not same:
        raise AssertionError(f"{label}: the spread mesh and the one-group "
                             "mesh differ")
    def in_range(i):
        if kernel == "B2":
            return got[i] == want[i]
        shards = want[i] // n
        return want[i] <= got[i] and (
            loops is None or got[i] < want[i] + loops * hs.CHUNK * shards)

    if n <= 0 or others or set(got) != set(want) or not all(
            in_range(i) for i in want):
        raise AssertionError(f"{label}: launches {run['launches']} for {n} "
                             f"iterations, expected {want}")
    if single_gate is not None and (n != single["n"]
                                    or max(d_res, d_mod) > single_gate):
        raise AssertionError(f"{label}: the mesh and single-device performs "
                             "differ")
    busy = None
    if profiled:
        busy = {which: _card_time(
                    lambda: make_radler(True, CARDS_PROFILE_ITERATIONS),
                    cards) for which, cards in (("one group", one),
                                                ("spread", spread))}
        for which, timed in busy.items():
            _say_card_time(which, timed)
    return dict(groups=[str(d) for d in mesh.devices], n=n, busy=busy,
                ms=run["seconds"] / n * 1e3,
                one_ms=base["seconds"] / base["n"] * 1e3,
                single_ms=single["seconds"] / single["n"] * 1e3,
                launches=got, peaks=run["peaks"])


def phase_mesh_cards(psf, residual):
    """The mesh over several cards through Radler.perform: config 1 on chan
    1 x tile 8 (B1 on row shards), the joined-channel cube on chan 4 x
    tile 2 (B4), config 2 with the Clark default on chan 1 x tile 8 (B2's
    tile axis) and the multiscale mesh (MS_MESH_CHANNELS x MS_SIZE^2, B4
    linear), MESH_DEVICES shards each, spread over the visible cards (up
    to 8) or, with one card, over MESH_GROUPS_ON_ONE_CARD groups on it.
    Each cell is bit-equal to its one-group mesh and holds MESH_VS_SINGLE
    (MS_MESH_VS_SINGLE for multiscale) against the single device.  Returns
    the cells' numbers."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.parallel import mesh as pm

    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(f"  visible cards: {count}")
    for i, line in enumerate(smi.splitlines()):
        say(f"    card {i}: {torch.cuda.get_device_name(i)}; nvidia-smi: "
            f"{line.strip()}")
    psf_1 = torch.as_tensor(psf, device=DEVICE)
    res_1 = torch.as_tensor(residual, device=DEVICE)
    lead = psf_1.device
    say(f"  peer access: {pm.peer_access(pm.visible_cards(lead))}")
    one = [lead]
    spread = None
    if count < 2:
        spread = [lead] * MESH_GROUPS_ON_ONE_CARD
        say(f"  one card: the shards spread over {MESH_GROUPS_ON_ONE_CARD} "
            "groups on it")
    psfs_j, res_j, kwargs_j = _joined_inputs(psf, residual)

    def hogbom(psfs, res, kwargs):
        return lambda use_mesh, iterations=CARDS_ITERATIONS: rd.Radler(
            _mesh_settings(SIZE, iterations, use_mesh), psfs, res.clone(),
            torch.zeros_like(res), 0.0, **kwargs)

    cells = {}
    cells["config 1"] = _cards_cell(
        "config 1 (4096^2, Högbom)", hogbom(psf_1, res_1, {}), "B1", spread,
        one, MESH_VS_SINGLE, profiled=True)
    cells["joined"] = _cards_cell(
        "joined channels (4 x 4096^2, Högbom)",
        hogbom(psfs_j, res_j, kwargs_j), "B4", spread, one, MESH_VS_SINGLE,
        profiled=True)
    del psfs_j, res_j, psf_1, res_1
    psf2, residual2 = make_problem(CLARK_SIZE, N_SOURCES)
    psf_2 = torch.as_tensor(psf2, device=DEVICE)
    res_2 = torch.as_tensor(residual2, device=DEVICE)
    cells["config 2"] = _cards_cell(
        "config 2 (2048^2, Clark)",
        lambda use_mesh: _mesh_clark_radler(psf_2, res_2, {}, CLARK_SIZE,
                                            ITERATIONS, use_mesh)(),
        "B2", spread, one, None)
    del psf_2, res_2
    psfs, residual_ms = make_ms_check_problem(MS_SIZE, MS_MESH_CHANNELS)
    psf_d = torch.as_tensor(psfs, device=DEVICE)
    res_d = torch.as_tensor(residual_ms, device=DEVICE)

    def multiscale(use_mesh):
        s = _ms_settings(MS_SIZE, MS_ITERATIONS)
        s.parallel.use_device_mesh = use_mesh
        s.parallel.n_devices = MESH_DEVICES if use_mesh else 0
        return rd.Radler(s, psf_d, res_d.clone(), torch.zeros_like(res_d),
                         0.0, frequencies=_ms_frequencies(MS_MESH_CHANNELS))

    with _ms_route("fused"):
        cells["multiscale"] = _cards_cell(
            f"multiscale ({MS_MESH_CHANNELS} x {MS_SIZE}^2, fused)",
            multiscale, "B4", spread, one, MS_MESH_VS_SINGLE, loops=None)
    del psf_d, res_d
    torch.cuda.empty_cache()
    return cells


# ---------------------------------------------------------------------------
# The batched facets, IUWT and ASP spread over the cards
# ---------------------------------------------------------------------------


def _spread_run(make_radler, cards):
    """One perform of ``make_radler()`` with the meshes over ``cards`` (the
    run's card alone for one group), every card synchronized around it and
    the launch counts and the slab FFTs' exchanged bytes reset just before
    it.  Returns a dict: iterations (a facet each where there are facets),
    seconds, B1's facet-mode and B3's row-block launches by card, bytes
    exchanged, peak memory by card above its start (MiB), the cubes, the
    mesh and the lockstep iterations."""
    from radler_tpu_torch.kernels import hogbom_step as hs
    from radler_tpu_torch.kernels import iuwt_atrous as ia
    from radler_tpu_torch.parallel import rows as pr

    count = torch.cuda.device_count()
    with _listed_cards(cards):
        r = make_radler()
        before = []
        for i in range(count):
            torch.cuda.synchronize(i)
            torch.cuda.reset_peak_memory_stats(i)
            before.append(torch.cuda.memory_allocated(i))
        _reset_counts()
        pr.exchange_bytes[0] = 0
        start = time.perf_counter()
        r.perform(0)
        for i in range(count):
            torch.cuda.synchronize(i)
        seconds = time.perf_counter() - start
    p = r._parallel
    out_res = torch.stack([e.residual_accessor.array for e in r._table])
    out_mod = torch.stack([e.model_accessor.array for e in r._table])
    if not (torch.isfinite(out_res).all() and torch.isfinite(out_mod).all()):
        raise AssertionError("non-finite residual or model")
    return dict(
        n=[a.iteration_number for a in p.algorithms], seconds=seconds,
        facet_launches=dict(hs.hogbom_step_facets.launches_by_card),
        row_launches=dict(ia.atrous_rows.launches_by_card),
        exchanged=pr.exchange_bytes[0],
        peaks=[(torch.cuda.max_memory_allocated(i) - before[i]) / 2**20
               for i in range(count)],
        res=out_res, mod=out_mod, mesh=p.first_algorithm.device_mesh,
        lockstep=p.last_lockstep, route=p.last_route)


def _spread_cell(label, make_radler, spread, one, gate, timed=()):
    """A spread cell: the perform over ``spread`` between two performs on
    one group on the card (``one``; the first also warms the card up),
    bit-equal to them where ``gate`` is None, else with equal counts and
    within ``gate`` of max(1, |res|max).  The last two performs time the
    steps ``timed`` (:func:`_timed_steps` targets, a synchronize around
    each).  Prints the times, the steps, launches by card and peak memory
    by card; returns the spread run and the second one-group run."""
    first = _spread_run(make_radler, one)
    splits = []
    for cards in (spread, one):
        split = {}
        restore = _timed_steps(split, list(timed))
        try:
            splits.append((_spread_run(make_radler, cards), split))
        finally:
            restore()
    (run, run_split), (base, base_split) = splits
    if not (first["n"] == base["n"] and torch.equal(first["res"], base["res"])
            and torch.equal(first["mod"], base["mod"])):
        raise AssertionError(f"{label}: two one-group performs differ")
    if base["mesh"].groups != 1 or run["mesh"].groups < 2:
        raise AssertionError(f"{label}: {base['mesh'].groups} and "
                             f"{run['mesh'].groups} groups")
    scale = max(1.0, float(base["res"].abs().max()))
    d_res = float((run["res"] - base["res"]).abs().max()) / scale
    d_mod = float((run["mod"] - base["mod"]).abs().max()) / scale
    same = (run["n"] == base["n"] and torch.equal(run["res"], base["res"])
            and torch.equal(run["mod"], base["mod"]))
    say(f"  {label}: chan {run['mesh'].chan} x tile {run['mesh'].tile} over "
        f"{[str(d) for d in run['mesh'].devices]}; counts {run['n']} (one "
        f"group {base['n']}); bit-equal: {same}; max|dres|, max|dmodel| "
        f"{d_res:.3g}, {d_mod:.3g} of max(1, |res|max)")
    say(f"    perform {run['seconds']:.4f} s (one group, before and "
        f"after: {first['seconds']:.4f}, {base['seconds']:.4f} s); lockstep {run['lockstep']} (one group "
        f"{base['lockstep']}); B1 facet-mode launches by card "
        f"{dict(sorted(run['facet_launches'].items()))} (one group "
        f"{dict(sorted(base['facet_launches'].items()))}); B3 row-block "
        f"launches by card {dict(sorted(run['row_launches'].items()))}; "
        f"slab exchanges {run['exchanged'] / 1e6:.1f} MB; peak memory by "
        f"card (MiB above its start) {[round(p, 1) for p in run['peaks']]}, "
        f"one group {[round(p, 1) for p in base['peaks']]}")
    for which, split, perform in (("spread", run_split, run),
                                  ("one group", base_split, base)):
        for key, (calls, seconds) in split.items():
            say(f"    {which}: {key}: {calls} calls, {seconds * 1e3:.1f} ms "
                f"({100 * seconds / perform['seconds']:.1f}% of its "
                "perform)")
    if gate is None and not same:
        raise AssertionError(f"{label}: the spread perform and the one-group "
                             "perform differ")
    if gate is not None and (run["n"] != base["n"] or max(d_res, d_mod)
                             > gate):
        raise AssertionError(f"{label}: the spread perform parts from the "
                             "one-group perform")
    return run, base


def _row_block_checks(n_lo, parts):
    """B3's row-block mode at IUWT_SIZE^2 cut into ``parts`` row blocks, at
    ``n_lo`` scales: every launch of the plan (the fused pair, then each
    lattice scale, whose halo of 4 dilations spans several blocks from
    scale 8 on) on every part's block (the edge parts with the image's
    zero boundary on one side, the inner ones with halos on both) against
    its plain version and against the whole image's decompose, its wavelet
    planes and its carried plane; then the spread decompose over ``parts``
    groups of the card against the whole-image decompose.  Raises where
    the bits differ; returns the largest |kernel - plain| and |spread -
    whole|."""
    from radler_tpu_torch.kernels import iuwt_atrous as ia
    from radler_tpu_torch.parallel import rows as pr

    rng = np.random.default_rng(SEED + n_lo)
    img = torch.as_tensor(
        rng.standard_normal((IUWT_SIZE, IUWT_SIZE)).astype(np.float32),
        device=DEVICE)
    w, smooth = ia.atrous_decompose_lo(img, n_lo)
    whole = torch.cat([w, smooth[None]])
    del w, smooth
    plan = ia.launch_plan(n_lo, IUWT_SIZE, IUWT_SIZE)
    # Each launch's input, and the plane it carries on: the smooth plane
    # of the scales before it.
    carried = [img] + [ia.atrous_decompose_lo(img, s.first_scale)[1]
                       for s in plan[1:]] + [whole[-1]]
    rows = IUWT_SIZE // parts
    worst, launches = 0.0, 0
    for p in range(parts):
        r0 = p * rows
        for i, step in enumerate(plan):
            reach = ia.launch_reach(step)
            a, b = max(0, r0 - reach), min(IUWT_SIZE, r0 + rows + reach)
            block = carried[i][a:b].contiguous()
            got = {}
            for which, fn in (("kernel", ia.atrous_rows),
                              ("plain", ia.atrous_rows_reference)):
                w = torch.empty((step.n_scales, rows, IUWT_SIZE),
                                device=img.device)
                smooth = torch.empty((rows, IUWT_SIZE), device=img.device)
                fn(block, step, r0 - a, rows, w, smooth)
                got[which] = (w, smooth)
            launches += 1
            (wk, sk), (wp, sp) = got["kernel"], got["plain"]
            worst = max(worst, float((wk - wp).abs().max()),
                        float((sk - sp).abs().max()))
            want = whole[step.first_scale:step.first_scale + step.n_scales,
                         r0:r0 + rows]
            if not (torch.equal(wk, wp) and torch.equal(sk, sp)
                    and torch.equal(wk, want)
                    and torch.equal(sk, carried[i + 1][r0:r0 + rows])):
                raise AssertionError(
                    f"B3's row-block mode, {n_lo} scales, part {p} of "
                    f"{parts}, launch {i} (scales from {step.first_scale}, "
                    f"halo {reach} rows): not the plain version's or the "
                    "whole image's bits")
    layout = pr.RowLayout(tuple(rows * p for p in range(parts + 1)),
                          (img.device,) * parts)
    spread = pr.decompose_rows(pr.Rows.scatter(img, layout), n_lo).gather()
    gap = float((spread - whole).abs().max())
    if not torch.equal(spread, whole):
        raise AssertionError(f"the spread decompose at {n_lo} scales is not "
                             "the whole image's")
    say(f"  {n_lo} scales on {parts} row blocks: {launches} launches (every "
        f"launch of the plan on every block, edge and inner) equal to their "
        f"plain versions and to the whole image's decompose; the spread "
        f"decompose over {parts} groups of the card equal to the whole "
        f"image's; max|kernel - plain| {worst}, max|spread - whole| {gap}")
    del img, whole, carried, spread
    torch.cuda.empty_cache()
    return max(worst, gap)


def _row_block_times(n_lo, parts):
    """B3's row-block mode at IUWT_SIZE^2 cut into ``parts`` row blocks:
    every launch of the plan on an inner part's block (its rows with the
    halo each launch reaches) against its plain version (bit-equal, then
    timed in turns) and cuDNN's dilated cascade on the block's first
    input; the spread decompose over ``parts`` groups of the card against
    the whole-image decompose (bit-equal, timed); then
    :func:`_row_block_checks` at ``n_lo`` and ROW_BLOCK_CHECK_SCALES
    scales.  Returns (kernel ms, plain ms, library ms, bytes, flops, the
    largest |kernel - plain| and |spread - whole| of every check)."""
    from radler_tpu_torch.kernels import iuwt_atrous as ia
    from radler_tpu_torch.parallel import rows as pr

    rng = np.random.default_rng(SEED)
    img = torch.as_tensor(
        rng.standard_normal((IUWT_SIZE, IUWT_SIZE)).astype(np.float32),
        device=DEVICE)
    lead = img.device
    w, smooth = ia.atrous_decompose_lo(img, n_lo)
    whole = torch.cat([w, smooth[None]])
    plan = ia.launch_plan(n_lo, IUWT_SIZE, IUWT_SIZE)
    rows = IUWT_SIZE // parts
    r0 = rows  # part 1: halos on both sides
    # Each launch's input: the image, then the plane the launch before it
    # carried (the smooth plane of the scales so far).
    inputs = [img] + [ia.atrous_decompose_lo(img, s.first_scale)[1]
                      for s in plan[1:]]
    blocks = []
    for step, plane in zip(plan, inputs):
        reach = ia.launch_reach(step)
        a, b = max(0, r0 - reach), min(IUWT_SIZE, r0 + rows + reach)
        blocks.append((step, plane[a:b].contiguous(), r0 - a))
    outs = {}
    for which, fn in (("kernel", ia.atrous_rows),
                      ("plain", ia.atrous_rows_reference)):
        got = []
        for step, block, out0 in blocks:
            w = torch.empty((step.n_scales, rows, IUWT_SIZE), device=lead)
            smooth = torch.empty((rows, IUWT_SIZE), device=lead)
            fn(block, step, out0, rows, w, smooth)
            got.append((w, smooth))
        outs[which] = got
    torch.cuda.synchronize()
    worst = max(float((a - b).abs().max())
                for (wk, sk), (wp, sp) in zip(outs["kernel"], outs["plain"])
                for a, b in ((wk, wp), (sk, sp)))
    for (step, _, _), (w, _) in zip(blocks, outs["kernel"]):
        for t in range(step.n_scales):
            if not torch.equal(w[t], whole[step.first_scale + t,
                                           r0:r0 + rows]):
                raise AssertionError("B3's row-block mode is not the "
                                     "whole image's decompose")
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = ia.atrous_rows if which == "kernel" else ia.atrous_rows_reference

        def launches():
            for (step, block, out0), (w, smooth) in zip(blocks,
                                                       outs[which]):
                fn(block, step, out0, rows, w, smooth)

        times[which].append(_time_ms(launches, 10)[0])
    taps = torch.tensor(ia.TAPS, dtype=torch.float32, device=lead)
    kh, kv = taps.reshape(1, 1, 1, 5), taps.reshape(1, 1, 5, 1)
    torch.backends.cudnn.allow_tf32 = False
    lib_ms, _ = _time_ms(lambda: _conv_cascade(blocks[0][1], n_lo, kh, kv),
                         10)
    n_bytes = sum(block.numel() * 4 + (step.n_scales + 1) * rows
                  * IUWT_SIZE * 4 for step, block, _ in blocks)
    n_flops = n_lo * 29 * rows * IUWT_SIZE
    layout = pr.RowLayout(tuple(rows * p for p in range(parts + 1)),
                          (lead,) * parts)
    spread = pr.decompose_rows(pr.Rows.scatter(img, layout), n_lo).gather()
    torch.cuda.synchronize()
    if not torch.equal(spread, whole):
        raise AssertionError("the spread decompose is not the whole image's")
    spread_ms, _ = _time_ms(
        lambda: pr.decompose_rows(pr.Rows.scatter(img, layout), n_lo), 5)
    whole_ms, _ = _time_ms(lambda: ia.atrous_decompose_lo(img, n_lo), 5)
    # Every launch on every block, at the main path's scale count and at
    # the most a 4096^2 image has.
    worst = max([worst] + [_row_block_checks(n, parts)
                           for n in sorted({n_lo, ROW_BLOCK_CHECK_SCALES})])
    k_ms, p_ms = sum(times["kernel"]) / 2, sum(times["plain"]) / 2
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    say(f"  {n_lo} scales, part 1 of {parts} ({rows} rows and their halos, "
        f"{len(plan)} launches): kernel {times['kernel'][0]:.4f}, "
        f"{times['kernel'][1]:.4f} ms; plain {times['plain'][0]:.4f}, "
        f"{times['plain'][1]:.4f} ms; cuDNN's cascade on the first block "
        f"{lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} "
        f"MB with the halo rows); max|kernel - plain| {worst}; the spread "
        f"decompose over {parts} groups of the card {spread_ms:.4f} ms "
        f"(bit-equal) against {whole_ms:.4f} ms whole")
    return k_ms, p_ms, lib_ms, n_bytes, n_flops, worst


def phase_mesh_spread(row_scales):
    """The batched facets, IUWT and ASP spread over every visible card (up
    to 8) or, with one card, over MESH_GROUPS_ON_ONE_CARD groups on it,
    each through Radler.perform against one group on the card: config 5's
    batched generic and multiscale routes (SPREAD_DEVICES shards, one facet
    a shard; bit-equal), config 4 cut to SPREAD_IUWT_ITERATIONS structure
    iterations (the rows over SPREAD_DEVICES shards) and ASP at ASP_SIZE^2
    (SPREAD_ASP_ITERATIONS iterations; one channel, since with ASP's four
    the JAX package's rule keeps the rows on chan 0's card up to 4 cards),
    both within SPREAD_GATE; then B3's row-block mode at IUWT_SIZE^2 on
    SPREAD_DEVICES blocks at ``row_scales`` scales (config 4's most frequent
    count).  Returns the cells and B3's row-block numbers."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.models import asp as asp_module
    from radler_tpu_torch.models import generic_clean as gc
    from radler_tpu_torch.models import multiscale as ms_module
    from radler_tpu_torch.ops import iuwt as iuwt_ops

    count = torch.cuda.device_count()
    lead = torch.empty(0, device=DEVICE).device  # with its index
    one = [lead]
    spread = None if count > 1 else [lead] * MESH_GROUPS_ON_ONE_CARD
    say(f"  {count} visible cards: " + (
        "the workloads spread over them" if spread is None else
        f"{MESH_GROUPS_ON_ONE_CARD} groups on the one card"))
    cells = {}
    facet_loops = {
        "generic": [
            (gc, "facet_hogbom_loop", "the lockstep loop"),
            (gc.GenericClean, "_spread_facet_loops",
             "the lockstep loops, a card each")],
        "multiscale": [
            (ms_module, "facet_fused_multiscale_minor_loop",
             "the batched loop"),
            (ms_module.MultiScaleAlgorithm, "_spread_fused_facets",
             "the batched loops, a card each")]}
    psfs, base = make_diffuse_problem(F5_SIZE, F5_CHANNELS)
    for algorithm in ("generic", "multiscale"):
        def make(algorithm=algorithm):
            s = _f5_settings(F5_SIZE, algorithm)
            s.parallel.use_device_mesh = True
            s.parallel.n_devices = SPREAD_DEVICES
            return _f5_radler(s, psfs, base, lead)

        with _facet_route("batched"):
            run, one_run = _spread_cell(
                f"config 5, {algorithm} batched", make, spread, one, None,
                timed=facet_loops[algorithm])
        if run["route"] != "batched" or not run["facet_launches"]:
            raise AssertionError(f"config 5 {algorithm}: route "
                                 f"{run['route']}, no facet-mode launch")
        if set(run["facet_launches"]) != set(d.index or 0 for d in
                                             run["mesh"].devices):
            raise AssertionError(f"config 5 {algorithm}: facet-mode launches "
                                 f"by card {run['facet_launches']}")
        cells[f"config 5 {algorithm}"] = (run, one_run)
    del psfs, base
    ipsfs, iresidual = make_diffuse_problem(IUWT_SIZE, 1)
    psf_i = torch.as_tensor(ipsfs[0], device=lead)
    res_i = torch.as_tensor(iresidual[0], device=lead)
    del ipsfs, iresidual

    def iuwt():
        s = _iuwt_settings(IUWT_SIZE, SPREAD_IUWT_ITERATIONS, 0.8)
        s.parallel.use_device_mesh = True
        s.parallel.n_devices = SPREAD_DEVICES
        res = res_i.clone()
        return rd.Radler(s, psf_i, res, torch.zeros_like(res), 0.0)

    run, one_run = _spread_cell(
        f"config 4 ({SPREAD_IUWT_ITERATIONS} structure iterations)", iuwt,
        spread, one, SPREAD_GATE,
        timed=[(iuwt_ops.SpreadOps, "conjugate_gradient_guarded",
                "the CG with its RMS guard"),
               (iuwt_ops, "conjugate_gradient_guarded",
                "the CG with its RMS guard")])
    if not run["row_launches"] or (count > 1 and run["exchanged"] <= 0):
        raise AssertionError("config 4 did not run B3's row-block mode and "
                             "the slab FFTs between the cards")
    cells["config 4"] = (run, one_run)
    del psf_i, res_i
    apsfs, abase = make_point_grid_problem(ASP_SIZE, 1, 8)
    psf_a = torch.as_tensor(apsfs, device=lead)
    res_a = torch.as_tensor(abase, device=lead)
    del apsfs, abase

    def asp():
        s = _asp_settings(ASP_SIZE, SPREAD_ASP_ITERATIONS)
        s.spectral_fitting.mode = rd.SpectralFittingMode.NO_FITTING
        s.parallel.use_device_mesh = True
        s.parallel.n_devices = SPREAD_DEVICES
        return rd.Radler(s, psf_a, res_a.clone(), torch.zeros_like(res_a),
                         0.0)

    cells["ASP"] = _spread_cell(
        f"ASP ({ASP_SIZE}^2, one channel, {SPREAD_ASP_ITERATIONS} "
        "iterations)", asp, spread, one, SPREAD_GATE,
        timed=[(asp_module, "fit_2d_gaussian_full",
                "Gaussian fits (host, SciPy)"),
               (asp_module, "padded_convolve",
                "a component's padded convolution with the PSFs (lead)"),
               (asp_module, "update_rows",
                "a component's update shipped to each card's rows")])
    if cells["ASP"][0]["exchanged"] <= 0 and count > 1:
        raise AssertionError("ASP's slab FFTs moved nothing between cards")
    del psf_a, res_a
    torch.cuda.empty_cache()
    _slab_times(lead, spread)
    return cells, _row_block_times(row_scales, SPREAD_DEVICES)


def _slab_times(lead, spread):
    """One slab FFT convolution at IUWT_SIZE^2 over SPREAD_DEVICES row
    parts on the spread cards (``spread``; None: the visible cards), its
    bytes across cards and its time against ``convolve_same`` on the lead
    card (CUDA events on the lead, every card synchronized after), and
    the agreement of the two."""
    from radler_tpu_torch.ops.convolution import (convolve_same,
                                                  prepare_kernel_fft)
    from radler_tpu_torch.parallel import rows as pr

    cards = spread or [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    parts = SPREAD_DEVICES
    devices = tuple(cards[p * len(cards) // parts] for p in range(parts))
    rows = IUWT_SIZE // parts
    layout = pr.RowLayout(tuple(rows * p for p in range(parts + 1)), devices)
    rng = np.random.default_rng(SEED)
    img = torch.as_tensor(rng.standard_normal(
        (IUWT_SIZE, IUWT_SIZE)).astype(np.float32), device=lead)
    ker = torch.as_tensor(rng.standard_normal(
        (IUWT_SIZE, IUWT_SIZE)).astype(np.float32), device=lead)
    spec = pr.SlabSpectrum(prepare_kernel_fft(ker), layout)
    spread_img = pr.Rows.scatter(img, layout)
    want = convolve_same(img, ker)
    pr.exchange_bytes[0] = 0
    got = pr.convolve_rows(spread_img, spec).gather()
    moved = pr.exchange_bytes[0]
    gap = float((got - want).abs().max() / want.abs().max())

    def synced(fn):
        def run():
            fn()
            for d in set(devices):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
        return run

    slab_ms, _ = _time_ms(synced(lambda: pr.convolve_rows(spread_img, spec)),
                          5)
    one_ms, _ = _time_ms(synced(lambda: convolve_same(img, ker)), 5)
    say(f"  a slab FFT convolution at {IUWT_SIZE}^2 over {parts} row parts "
        f"on {[str(d) for d in devices]}: {slab_ms:.4f} ms, "
        f"{moved / 1e6:.1f} MB between cards, against convolve_same on one "
        f"card {one_ms:.4f} ms; max|slab - one| {gap:.3g} of max|one|")


# ---------------------------------------------------------------------------
# Facets (config 5)
# ---------------------------------------------------------------------------


def _ragged_boxes(n_facets, height, width):
    """True boxes (rows, columns) for F facets in a height x width common
    box: full width but not full height, the inactive facet 1's, one pixel
    wide, a few rows, then boxes a little smaller each."""
    boxes = [(height - 3, width), (height - 5, width - 9), (height - 10, 1),
             (17, width - 27)]
    boxes += [(height - 5 * f, width - 9 * f) for f in range(4, n_facets)]
    return boxes[:n_facets]


def _facet_inputs(mode, n_facets, shared, height, width, seed, boxes=None,
                  planes=None):
    """F facets' cubes at (height, width), the common box, each searchable
    only in its own top-left true box ``boxes[f]`` (rows, columns; the
    weight zero outside it), with shared or per-facet PSFs and a loop state
    at each facet's brightest searchable pixel; facet 1 is inactive from
    the start.  ``inputs["boxes"]`` holds the boxes for the step.
    ``planes`` (channels, polarizations) overrides the mode's default."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    C, P = planes or ((2, 4) if mode == "squared" else (4, 1))
    cases = [_case_inputs(mode, C, P, mode == "squared", height, width,
                          seed + f) for f in range(n_facets)]
    dev = torch.device(DEVICE)
    boxes = boxes or _ragged_boxes(n_facets, height, width)
    weight = torch.stack([c["weight"] for c in cases])
    for f, (rows, cols) in enumerate(boxes):
        weight[f, rows:, :] = 0.0
        weight[f, :, cols:] = 0.0
    res = torch.stack([c["res"] for c in cases])
    states, raw = [], []
    for f, (rows, cols) in enumerate(boxes):
        box = res[f, 0, :rows, :cols].abs() * weight[f, :rows, :cols]
        y, x = divmod(int(torch.argmax(box)), cols)
        states.append([y, x, 1, 0, 0, int(f != 1), y * width + x, 0])
        raw.append(res[f, :, y, x])
    psfs = cases[0]["psfs"] if shared else torch.stack(
        [c["psfs"] * (1.0 - 0.05 * f) for f, c in enumerate(cases)])
    raw = torch.stack(raw)
    params = hs.FacetLoopParams.make(
        GAIN, [0.0] * n_facets, [float(raw.abs().max())] * n_facets, 4.0,
        [TRACE_ITERATIONS] * n_facets, False, dev)
    return dict(res=res, psfs=psfs, weight=weight, coefs=cases[0]["coefs"],
                P=P, state=torch.tensor(states, dtype=torch.int32, device=dev),
                raw=raw, params=params, C=C,
                boxes=torch.tensor(boxes, dtype=torch.int32))


def _facet_trace(inputs, mode, use_weight, plain, iterations,
                 rms_in_select=True, boxed=True):
    """``iterations`` lockstep iterations of the facet-mode launch, each
    facet's select folded in (``plain``: the plain step, then the plain
    select; the weight plane, when used, also the select's RMS plane unless
    ``rms_in_select`` is False, as in config 5's loop), over the true boxes
    or, unless ``boxed``, the common box; returns the final tensors and
    buffers.  The kernel's counters must read 0 after every launch."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    res = inputs["res"].clone()
    model = torch.zeros_like(res)
    params = inputs["params"]
    buffers = hs.LoopBuffers(inputs["state"].clone(),
                             torch.zeros(res.shape[0], device=res.device),
                             inputs["raw"].clone(),
                             inputs["raw"] * params.gain)
    step = hs.hogbom_step_facets_reference if plain else hs.hogbom_step_facets
    weight = inputs["weight"] if use_weight else None
    for _ in range(iterations):
        step(res, model, inputs["psfs"], buffers.values, buffers.state,
             inputs["coefs"], weight, mode=mode, n_polarizations=inputs["P"],
             allow_negative=True, boxes=inputs["boxes"] if boxed else None,
             buffers=buffers, params=params,
             rms=weight if rms_in_select else None)
    torch.cuda.synchronize()
    if not plain and int(buffers.workspace.counters.abs().sum()) != 0:
        raise AssertionError("B1's facet counters are not 0 after their "
                             "launches")
    return res, model, buffers


def _facet_difference(kernel, plain):
    """The largest difference between two ``_facet_trace`` results, and
    whether their states are equal."""
    (rk, mk, bk), (rp, mp, bp) = kernel, plain
    diff = max(float((rk - rp).abs().max()), float((mk - mp).abs().max()),
               float((bk.value - bp.value).abs().max()),
               float((bk.values - bp.values).abs().max()))
    return diff, bool(torch.equal(bk.state, bp.state))


def phase_facet_b1_vs_plain():
    """B1's facet mode against its plain version, bit for bit: 1, 4 and 9
    facets (9 at a small box), shared and per-facet PSFs, squared and linear
    integration, with and without a weight plane, over ragged true boxes
    (full width, one pixel wide, a few rows; nothing outside them read or
    written) and over the common box, facet 1 inactive from the start; one
    facet over the common box (the single-cube launch with the facet's
    limits) against the single-cube launch.  Returns the largest
    difference."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    worst = 0.0
    cases = [(1, (509, 731)), (4, RAGGED), (9, (130, 203))]
    for n_facets, (height, width) in cases:
        for mode in ("squared", "linear"):
            for shared in (True, False):
                inputs = _facet_inputs(mode, n_facets, shared, height, width,
                                       seed=n_facets * 7)
                padding = torch.ones((n_facets, height, width),
                                     dtype=torch.bool, device=DEVICE)
                for f, (rows, cols) in enumerate(inputs["boxes"].tolist()):
                    padding[f, :rows, :cols] = False
                for use_weight, boxed in itertools.product((False, True),
                                                           (True, False)):
                    rk, mk, bk = _facet_trace(inputs, mode, use_weight,
                                              False, TRACE_ITERATIONS // 4,
                                              boxed=boxed)
                    diff, same = _facet_difference(
                        (rk, mk, bk), _facet_trace(inputs, mode, use_weight,
                                                   True,
                                                   TRACE_ITERATIONS // 4,
                                                   boxed=boxed))
                    iterations = bk.state[:, hs.ITERATION].tolist()
                    label = (f"{n_facets} facets {height}x{width} {mode} "
                             f"{'shared' if shared else 'per-facet'} PSFs "
                             f"weight={use_weight:d} "
                             f"{'true boxes' if boxed else 'common box'}")
                    untouched = True
                    if boxed:
                        pad = padding[:, None].expand_as(rk)
                        untouched = bool(torch.equal(rk[pad],
                                                     inputs["res"][pad]))
                    if n_facets == 1 and not boxed:
                        one = _single_trace(inputs, mode, use_weight,
                                            TRACE_ITERATIONS // 4)
                        diff = max(diff, float((one[0] - rk[0]).abs().max()),
                                   float((one[1] - mk[0]).abs().max()))
                        same = same and bool(torch.equal(one[2].state,
                                                         bk.state[0]))
                    say(f"  {label}: iterations {iterations}, same states "
                        f"{same}, max|difference| {diff:.3g}, padding "
                        f"untouched {untouched}")
                    if not (same and diff == 0.0 and untouched and (
                            n_facets == 1 or iterations[1] == 0)):
                        raise AssertionError(f"B1's facet mode and its plain "
                                             f"version disagree: {label}")
                    worst = max(worst, diff)
                del inputs, padding
    torch.cuda.empty_cache()
    return worst


def _single_trace(inputs, mode, use_weight, iterations):
    """Facet 0 of ``inputs`` through the single-cube launch."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    res = inputs["res"][0].clone()
    model = torch.zeros_like(res)
    params = inputs["params"].facet(0)
    buffers = hs.LoopBuffers(inputs["state"][0].clone(),
                             torch.zeros(1, device=res.device),
                             inputs["raw"][0].clone(),
                             inputs["raw"][0] * params.gain)
    weight = inputs["weight"][0] if use_weight else None
    psfs = inputs["psfs"] if inputs["psfs"].ndim == 3 else inputs["psfs"][0]
    for _ in range(iterations):
        hs.hogbom_step(res, model, psfs, buffers.values, buffers.state,
                       inputs["coefs"], weight, mode=mode,
                       n_polarizations=inputs["P"], allow_negative=True,
                       buffers=buffers, params=params, rms=weight)
    torch.cuda.synchronize()
    return res, model, buffers


def facet_step_bytes(boxes, peaks, height, width, n_planes, n_chan, shared,
                     use_weight):
    """The least bytes one facet step moves: each facet's ``n_planes``
    residual planes read and written over its true box (rows, columns), its
    weight plane read there, and the PSF pixels the step reads, each once:
    the PSF shifted to a facet's peak (y, x) reads a window of the box's size
    clipped to the PSF, so shared PSFs are read over the union of the
    facets' windows and per-facet PSFs over each facet's own."""
    pixels = sum(rows * cols for rows, cols in boxes)
    windows = []
    for (rows, cols), (y, x) in zip(boxes, peaks):
        top, left = height // 2 - y, width // 2 - x
        windows.append((max(top, 0), min(top + rows, height),
                        max(left, 0), min(left + cols, width)))
    if shared:
        reached = torch.zeros((height, width), dtype=torch.bool)
        for r0, r1, c0, c1 in windows:
            if r0 < r1 and c0 < c1:
                reached[r0:r1, c0:c1] = True
        psf_pixels = int(reached.sum())
    else:
        psf_pixels = sum(max(r1 - r0, 0) * max(c1 - c0, 0)
                         for r0, r1, c0, c1 in windows)
    return ((2 * n_planes + int(use_weight)) * pixels
            + n_chan * psf_pixels) * 4


def phase_facet_b1_times(boxes, mode="squared", shared=True):
    """B1's facet mode at config 5's shape (4 facets x 8 planes, the weight
    plane on, no RMS plane) over config 5's true ``boxes`` (rows, columns)
    in their common box, all facets active: squared mode with the PSFs
    shared (generic CLEAN's batched route), or linear mode with a PSF stack
    a facet (multiscale's batched route: each facet's own twice-convolved
    PSFs).  First F5_TRACE_ITERATIONS lockstep iterations of the kernel
    (each facet's select folded in) against its plain version from the same
    inputs, bit for bit; then their times, in turns plain, kernel, kernel,
    plain.  Returns {"step": (ms, plain ms), "bytes": {"step": its least
    bytes}, "max_abs_err": the comparison's}."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    height = max(b[0] for b in boxes)
    width = max(b[1] for b in boxes)
    n_facets = len(boxes)
    inputs = _facet_inputs(mode, n_facets, shared, height, width, seed=51,
                           boxes=list(boxes), planes=(2, 4))
    inputs["state"][:, hs.ACTIVE] = 1
    kernel = _facet_trace(inputs, mode, True, False,
                          F5_TRACE_ITERATIONS, rms_in_select=False)
    diff, same = _facet_difference(
        kernel, _facet_trace(inputs, mode, True, True,
                             F5_TRACE_ITERATIONS, rms_in_select=False))
    iterations = kernel[2].state[:, hs.ITERATION].tolist()
    say(f"  against the plain version: iterations {iterations}, same states "
        f"{same}, max|difference| {diff:.3g}")
    del kernel
    if not (same and diff == 0.0
            and iterations == [F5_TRACE_ITERATIONS] * n_facets):
        raise AssertionError(f"B1's facet mode ({mode}) and its plain "
                             "version disagree at config 5's shape")
    res = inputs["res"]
    model = torch.zeros_like(res)
    weight = inputs["weight"]
    kw = dict(mode=mode, n_polarizations=inputs["P"],
              allow_negative=True, boxes=inputs["boxes"])
    params = inputs["params"]

    def buffers():
        return hs.LoopBuffers(inputs["state"].clone(),
                              torch.zeros(n_facets, device=res.device),
                              inputs["raw"].clone(),
                              inputs["raw"] * params.gain)

    times = []
    for plain in (True, False, False, True):
        step = hs.hogbom_step_facets_reference if plain else (
            hs.hogbom_step_facets)
        b = buffers()
        t_step, h_step = _time_ms(
            lambda: step(res, model, inputs["psfs"], b.values, b.state,
                         inputs["coefs"], weight, **kw, buffers=b,
                         params=params), 10)
        times.append(t_step)
        say(f"  {'plain ' if plain else 'kernel'} facet step (each facet's "
            f"select folded in) {t_step:.4f} ms (host enqueue "
            f"{h_step:.4f} ms)")
    p1, k1, k2, p2 = times
    out = {"step": ((k1 + k2) / 2, (p1 + p2) / 2)}
    # The least bytes: the step's (facet_step_bytes), each facet's partials
    # written once (12 bytes a run of its box) and its values at its peak
    # read.
    n_planes, n_chan = res.shape[1], inputs["psfs"].shape[-3]
    peaks = [tuple(p) for p in inputs["state"][:, :2].tolist()]
    pixels = sum(rows * cols for rows, cols in boxes)
    runs = sum(-(-rows * cols // hs.PIXELS_PER_BLOCK) for rows, cols in boxes)
    out["bytes"] = {
        "step": facet_step_bytes(boxes, peaks, height, width, n_planes,
                                 n_chan, shared=shared, use_weight=True)
        + 12 * runs + n_facets * n_planes * 4,
    }
    out["max_abs_err"] = diff
    say(f"  [{n_facets}, {n_planes}, {height}, {width}], {mode}, "
        f"{'shared' if shared else 'per-facet'} PSFs, true boxes "
        f"{[tuple(b) for b in boxes]} ({pixels} pixels): step "
        f"{out['step'][0]:.4f} ms (plain {out['step'][1]:.4f}), bound "
        f"{bound_ms(out['bytes']['step'])[0]:.4f} ms "
        f"({out['bytes']['step'] / 1e6:.1f} MB)")
    del inputs, res, model
    torch.cuda.empty_cache()
    return out


def phase_facet_one_times(psf, residual):
    """B1's facet mode with one facet against the single-cube B1 at config
    1's shape (4096^2, one plane, no weight plane), each with its select
    folded in, in turns single, facet, facet, single; returns (facet ms,
    single ms)."""
    from radler_tpu_torch.kernels import hogbom_step as hs

    dev = torch.device(DEVICE)
    res = torch.as_tensor(residual, device=dev)[None].clone()
    model = torch.zeros_like(res)
    psfs = torch.as_tensor(psf, device=dev)[None]
    coefs = torch.ones(1, device=dev)
    flat = int(torch.argmax(res[0].abs()))
    y0, x0 = divmod(flat, SIZE)
    state = torch.tensor([[y0, x0, 1, 0, 0, 1, flat, 0]], dtype=torch.int32,
                         device=dev)
    raw = res[None, :, y0, x0].clone()
    params = hs.FacetLoopParams.make(GAIN, [0.0], [1.0], 0.0, [2**30],
                                     False, dev)
    one = hs.LoopBuffers(state.clone(), torch.zeros(1, device=dev),
                         raw.clone(), raw * GAIN)
    single = one.facet(0)
    kw = dict(mode="signed", n_polarizations=1, allow_negative=True)
    runs = {
        "single": lambda: hs.hogbom_step(
            res, model, psfs, single.values, single.state, coefs, None, **kw,
            buffers=single, params=params.facet(0)),
        "facet": lambda: hs.hogbom_step_facets(
            res[None], model[None], psfs, one.values, one.state, coefs,
            None, **kw, buffers=one, params=params),
    }
    times = {"single": [], "facet": []}
    for name in ("single", "facet", "facet", "single"):
        t, _ = _time_ms(runs[name], 20)
        times[name].append(t)
    facet_ms = sum(times["facet"]) / 2
    single_ms = sum(times["single"]) / 2
    say(f"  one facet at [1, 1, {SIZE}, {SIZE}]: facet step "
        f"{times['facet'][0]:.4f}, {times['facet'][1]:.4f} ms; single-cube "
        f"step {times['single'][0]:.4f}, {times['single'][1]:.4f} ms")
    return facet_ms, single_ms


def _f5_settings(size, algorithm, iterations=F5_ITERATIONS):
    """``config5_proxy.py``'s settings for ``algorithm`` ("generic" or
    "multiscale")."""
    import radler_tpu_torch as rd

    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    if algorithm == "multiscale":
        s.algorithm_type = rd.AlgorithmType.MULTISCALE
    else:
        s.algorithm_type = rd.AlgorithmType.GENERIC_CLEAN
        s.absolute_threshold = 5e-3
    s.minor_iteration_count = iterations
    s.minor_loop_gain = 0.1
    s.major_loop_gain = 0.85
    s.squared_joins = True
    s.parallel.grid_width = s.parallel.grid_height = F5_GRID
    s.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    return s


def _f5_radler(settings, psfs, base, device):
    """``config5_proxy.py``'s work table on ``device``: I, Q, U, V of each
    channel (the channel's image times F5_POL_FLUX), the PSF on the I
    entry, tensor accessors."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.work_table import (
        TensorImageAccessor,
        WorkTable,
        WorkTableEntry,
    )

    pols = (rd.Polarization.STOKES_I, rd.Polarization.STOKES_Q,
            rd.Polarization.STOKES_U, rd.Polarization.STOKES_V)
    n_channels = base.shape[0]
    table = WorkTable([], n_channels, n_channels)
    base_d = torch.as_tensor(base, device=device)
    for ch in range(n_channels):
        for i, pol in enumerate(pols):
            e = WorkTableEntry()
            e.polarization = pol
            e.original_channel_index = ch
            e.image_weight = 1.0
            e.band_start_frequency = 1.0e8 + ch * 1e7
            e.band_end_frequency = 1.1e8 + ch * 1e7
            if i == 0:
                e.psf_accessors = [TensorImageAccessor(
                    torch.as_tensor(psfs[ch], device=device))]
            e.residual_accessor = TensorImageAccessor(
                base_d[ch] * F5_POL_FLUX[i])
            e.model_accessor = TensorImageAccessor(
                torch.zeros_like(base_d[ch]))
            table.add_entry(e)
    return rd.Radler(settings, table, beam_size=0.0)


def _f5_launches():
    from radler_tpu_torch.kernels import hogbom_step as hs
    from radler_tpu_torch.kernels import subminor_loop as sl

    return {"facet step": hs.hogbom_step_facets.launches,
            "B1 step": hs.hogbom_step.launches,
            "B2": sl.subminor_loop.launches}


@contextlib.contextmanager
def _facet_route(route):
    """Run facets on ``route``: "rule" (the route rule's choice), "batched"
    (the batched route forced: the budgets lifted, as config 5's stacks
    pass the JAX package's 4e9 bytes for generic CLEAN and 9e9 for
    multiscale) or "serial" (``RADLER_TPU_NO_BATCHED_FACETS``)."""
    from radler_tpu_torch.models import generic_clean as gc
    from radler_tpu_torch.models import multiscale as ms

    saved = os.environ.pop("RADLER_TPU_NO_BATCHED_FACETS", None)
    budgets = gc.BATCHED_FACETS_BUDGET, ms.BATCHED_FACETS_BUDGET
    if route == "serial":
        os.environ["RADLER_TPU_NO_BATCHED_FACETS"] = "1"
    elif route == "batched":
        gc.BATCHED_FACETS_BUDGET = ms.BATCHED_FACETS_BUDGET = float("inf")
    try:
        yield
    finally:
        gc.BATCHED_FACETS_BUDGET, ms.BATCHED_FACETS_BUDGET = budgets
        os.environ.pop("RADLER_TPU_NO_BATCHED_FACETS", None)
        if saved is not None:
            os.environ["RADLER_TPU_NO_BATCHED_FACETS"] = saved


def _f5_perform(settings, psfs, base, route, device=None,
                count_syncs=False, kept=False):
    """One faceted perform of config 5's table on ``route``, on a fresh
    Radler, or with ``kept`` on one that has done the same perform once and
    been put back to its start (the cubes, no iterations), keeping what its
    algorithms built; the launch counts reset just before it.  Returns a
    dict: per-facet iterations, seconds, launches, host syncs (or None),
    peak device memory above the start in MiB, the fused banks kept by the
    facets' clones in MiB, the boxes, the lockstep iterations, the route
    taken, the I plane's rms before and after, the residual and model cubes
    on the host, and the outer passes of the batched multiscale loop that
    ran a dense subminor loop (its calls of the lockstep loop)."""
    from radler_tpu_torch.models import multiscale_fused as mf

    device = device or DEVICE
    on_card = torch.device(device).type == "cuda"
    passes = []
    lockstep_loop = mf.facet_hogbom_steps

    def counted(*args, **kwargs):
        passes.append(1)
        return lockstep_loop(*args, **kwargs)

    with _facet_route(route):
        r = _f5_radler(settings, psfs, base, device)
        if kept:
            start = [(e.residual_accessor.array.clone(),
                      e.model_accessor.array.clone()) for e in r._table]
            r.perform(0)
            for e, (res, mod) in zip(r._table, start):
                e.residual_accessor.array = res
                e.model_accessor.array = mod
            for alg in r._parallel.algorithms:
                alg.iteration_number = 0
        i_rms0 = rms(r._table.entries[0].residual_accessor.array)
        if on_card:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        mf.facet_hogbom_steps = counted
        try:
            start = time.perf_counter()
            syncs = None
            if count_syncs:
                syncs = _count_syncs(lambda: r.perform(0))
            else:
                r.perform(0)
            if on_card:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - start
        finally:
            mf.facet_hogbom_steps = lockstep_loop
        launches = _f5_launches()
    out_res = torch.stack([e.residual_accessor.array for e in r._table])
    out_mod = torch.stack([e.model_accessor.array for e in r._table])
    if not (torch.isfinite(out_res).all() and torch.isfinite(out_mod).all()):
        raise AssertionError("non-finite residual or model")
    parallel = r._parallel
    banks = [getattr(a, "_fused_banks", None) for a in parallel.algorithms]
    banks_mib = sum(t.numel() * t.element_size() for b in banks if b
                    for t in b[4] if torch.is_tensor(t)) / 2**20
    return dict(
        banks_mib=banks_mib,
        iterations=[a.iteration_number for a in parallel.algorithms],
        first=r.iteration_number,
        seconds=seconds,
        launches=launches,
        syncs=syncs,
        peak_mib=((torch.cuda.max_memory_allocated() - before) / 2**20
                  if on_card else None),
        boxes=[(s.x, s.y, s.width, s.height)
               for s in parallel.last_sub_images],
        lockstep=parallel.last_lockstep,
        passes=len(passes),
        route=parallel.last_route,
        i_rms=(i_rms0, rms(out_res[0])),
        res=out_res.cpu().numpy(),
        mod=out_mod.cpu().numpy(),
    )


def _f5_split(settings, psfs, base, route, label):
    """One more perform of config 5 on ``route`` with a synchronize around
    each of its main steps; prints each step's own time (the steps it
    calls left out) and share of the perform."""
    import radler_tpu_torch.radler as radler_module
    from radler_tpu_torch.image_set import ImageSet
    from radler_tpu_torch.models import generic_clean as gc
    from radler_tpu_torch.models import multiscale as ms_module
    from radler_tpu_torch.models import multiscale_fused as mf
    from radler_tpu_torch.models.multiscale import MultiScaleAlgorithm
    from radler_tpu_torch.parallel import parallel_deconvolution as pd

    pdc = pd.ParallelDeconvolution
    targets = [
        (ImageSet, "load_and_average", "loading the cubes"),
        (ImageSet, "load_and_average_psfs", "loading the PSFs"),
        (radler_module, "median_and_stddev_from_mad", "noise (MAD)"),
        (pd, "make_sub_images", "the split (Dijkstra, floods; host)"),
        (pdc, "_execute_batched_run", "facet stacks, rollback, merge"),
        (gc.GenericClean, "execute_batched_facets",
         "initial peaks, thresholds (both phases)"),
        (gc, "facet_hogbom_loop", "the lockstep loop (B1 facet mode, fit)"),
        (pdc, "_run_sub_image", "facet trims, merges (serial)"),
        (MultiScaleAlgorithm, "execute_major_iteration",
         "each facet's multiscale run"),
        (MultiScaleAlgorithm, "execute_batched_facets",
         "batched multiscale: windows, results (both phases)"),
        (ms_module, "facet_fused_multiscale_minor_loop",
         "batched multiscale: the loop's host decisions, gathers"),
        (mf, "spectral_scale_maxima", "scale maxima, all facets"),
        (mf, "scale_convolved_cube", "scale-convolved cubes"),
        (mf, "facet_hogbom_steps",
         "the lockstep dense loops (B1 facet mode, linear; the fit)"),
        (mf, "correct_small", "corrections, small size"),
        (mf, "correct_large", "corrections, large size"),
        (MultiScaleAlgorithm, "_prepare_fused_banks", "fused banks"),
        (ImageSet, "assign_and_store_residual", "storing the residual"),
        (ImageSet, "interpolate_and_store_model", "storing the model"),
    ]
    split = {}
    restore = _timed_steps(split, targets)
    try:
        run = _f5_perform(settings, psfs, base, route)
    finally:
        restore()
    seconds = run["seconds"]
    say(f"  split of a {label} perform ({seconds:.3f} s with a synchronize "
        "around each step; each step's own time):")
    for key, (calls, t) in split.items():
        say(f"    {key}: {calls} calls, {t * 1e3:.1f} ms "
            f"({100 * t / seconds:.1f}%)")
    rest = seconds - sum(t for _, t in split.values())
    say(f"    the rest: {rest * 1e3:.1f} ms ({100 * rest / seconds:.1f}%)")


def _f5_check_launches(label, run):
    """The kernels of the run's route were launched, and no other Högbom
    kernel: on the batched routes one facet-mode launch a lockstep
    iteration (each facet's select folded in)."""
    n = run["launches"]
    batched = run["route"] == "batched"
    if batched:
        ok = (n["facet step"] == run["lockstep"] > 0
              and n["B1 step"] == n["B2"] == 0)
    elif "Clark" in label:
        ok = n["B2"] > 0 and n["facet step"] == 0
    else:
        ok = n["B1 step"] > 0 and n["facet step"] == 0
    if not ok:
        raise AssertionError(f"config 5, {label}: launches {n} on the "
                             f"{run['route']} route")


def phase_config5():
    """Config 5 (4096^2 x 2 channels x I, Q, U, V, squared joins, 2-term
    fit, 2 x 2 facets, 400 iterations a facet) through Radler.perform on
    five routes: generic CLEAN batched (B1's facet mode; forced, since
    config 5's stacks pass the JAX package's budget, which the port keeps),
    generic CLEAN serial with the Högbom setting (B1 on each facet) and
    with the Clark setting, ``config5_proxy.py``'s default and the route
    rule's choice here, in both packages (B2 on each facet), multiscale
    serial (each facet on the fused loop; the rule's choice, config 5
    passing the JAX package's 9e9 bytes) and multiscale batched (every
    facet's fused loop at once, its dense loops in B1's facet mode in
    linear mode; forced).  For each, two performs on fresh Radlers: one
    timed, one counting host syncs; multiscale also on a kept Radler.  The
    batched generic run agrees with the serial Högbom run within
    F5_BATCHED_VS_SERIAL (both run the dense Högbom loop; the Clark loop is
    another algorithm, which on this field stops the fourth facet
    elsewhere, in the JAX package too); the batched multiscale run's
    difference from the serial one is printed, not held (the JAX package
    holds its two routes within 3e-5 only on its own field, and on the
    smoke's 256^2 check field they part by 0.35); all five split the image
    alike."""
    psfs, base = make_diffuse_problem(F5_SIZE, F5_CHANNELS)
    runs = {}
    for label, algorithm, clark, route, expect in (
            ("generic, batched", "generic", True, "batched", "batched"),
            ("generic Högbom, serial", "generic", False, "serial", "serial"),
            ("generic Clark, serial", "generic", True, "rule", "serial"),
            ("multiscale, serial", "multiscale", True, "rule", "serial"),
            ("multiscale, batched", "multiscale", True, "batched",
             "batched")):
        settings = _f5_settings(F5_SIZE, algorithm)
        settings.generic.use_sub_minor_optimization = clark
        run = _f5_perform(settings, psfs, base, route)
        run["syncs"] = _f5_perform(settings, psfs, base, route,
                                   count_syncs=True)["syncs"]
        if label != "generic Högbom, serial" and "Clark" not in label:
            _f5_split(settings, psfs, base, route, label)
        if algorithm == "multiscale":
            kept = _f5_perform(settings, psfs, base, route, kept=True)
            if kept["iterations"] != run["iterations"]:
                raise AssertionError("config 5, multiscale: the kept "
                                     "Radler took other iterations")
            run["kept"] = kept
            say(f"  {label}, kept Radler: {kept['seconds']:.3f} s, "
                f"{sum(kept['iterations']) / kept['seconds']:.1f} it/s "
                f"summed; peak {kept['peak_mib']:.1f} MiB above the start "
                f"(fresh {run['peak_mib']:.1f}); the four clones' fused "
                f"banks {kept['banks_mib']:.1f} MiB")
        if run["route"] != expect:
            raise AssertionError(f"config 5, {label}: took the "
                                 f"{run['route']} route")
        _f5_check_launches(label, run)
        total = sum(run["iterations"])
        run["rate"] = total / run["seconds"]
        peak = ("not measured" if run["peak_mib"] is None
                else f"{run['peak_mib']:.1f} MiB")
        say(f"  {label}: {run['seconds']:.3f} s, {total} minor iterations "
            f"over the facets ({run['iterations']}; facet 0, "
            f"Radler.iteration_number: {run['first']}), "
            f"{run['rate']:.1f} it/s summed; lockstep iterations "
            f"{run['lockstep']}"
            + (f" in {run['passes']} passes" if run["passes"] else "")
            + f"; I rms {run['i_rms'][0]:.5f} -> "
            f"{run['i_rms'][1]:.5f}; peak {peak} above "
            f"the start; {run['syncs']} host syncs; launches "
            f"{run['launches']}; boxes (x, y, w, h) {run['boxes']}")
        if not run["i_rms"][1] < run["i_rms"][0]:
            raise AssertionError(f"config 5, {label}: the I rms did not fall")
        runs[label] = run
    boxes = {tuple(r["boxes"]) for r in runs.values()}
    if len(boxes) != 1:
        raise AssertionError(f"config 5: the routes split alike? {boxes}")
    b, s = runs["generic, batched"], runs["generic Högbom, serial"]
    d_res = float(np.abs(b["res"] - s["res"]).max())
    d_mod = float(np.abs(b["mod"] - s["mod"]).max())
    say(f"  generic batched against serial: iterations {b['iterations']} / "
        f"{s['iterations']}, max|dres| {d_res:.3g}, max|dmodel| {d_mod:.3g}")
    if not (b["iterations"] == s["iterations"]
            and d_res <= F5_BATCHED_VS_SERIAL
            and d_mod <= F5_BATCHED_VS_SERIAL):
        raise AssertionError("config 5: the batched and serial generic "
                             "runs disagree")
    b, s = runs["multiscale, batched"], runs["multiscale, serial"]
    scale = max(1.0, float(np.abs(s["res"]).max()))
    say(f"  multiscale batched against serial (read, not held): iterations "
        f"{b['iterations']} / {s['iterations']}, max|dres| "
        f"{float(np.abs(b['res'] - s['res']).max()) / scale:.3g}, "
        f"max|dmodel| {float(np.abs(b['mod'] - s['mod']).max()) / scale:.3g}"
        " of max(1, |res|max)")
    for run in runs.values():
        del run["res"], run["mod"]
        run.pop("kept", {}).pop("res", None)
    return runs


def phase_facets_card_vs_cpu():
    """:func:`make_ms_check_problem`'s field at F5_CHECK_SIZE^2 (2 channels
    x I, Q, U, V; point sources, so that the loops' picks do not turn on
    near-equal maxima of smooth emission), 2 x 2 facets, config 5's
    settings, generic CLEAN batched and multiscale on the serial and on the
    batched route, on the card and on the CPU: the same boxes, equal
    per-facet iteration counts, the residual within F5_CHECK_CONTRACT
    (multiscale: MS_CARD_VS_CPU) of max(1, |res|max).  Multiscale runs
    with three scales and with all six (to 64 pixels) at seed 8 on both
    routes; with all six at the field's own seed on the serial route it is
    read, not held: there one of the 64-pixel scale's components has two
    pixels that nearly tie, which rounding decides (the JAX package's own
    run moves it when its input grows by one part in 10^7;
    tests/test_torch_facets_serial.py::
    test_faceted_multiscale_all_scales_matches_jax)."""
    for algorithm, max_scales, seed, bound, route in (
            ("generic", 0, SEED, F5_CHECK_CONTRACT, "rule"),
            ("multiscale", 3, SEED, MS_CARD_VS_CPU, "serial"),
            ("multiscale", 0, 8, MS_CARD_VS_CPU, "serial"),
            ("multiscale", 0, SEED, None, "serial"),
            ("multiscale", 3, SEED, MS_CARD_VS_CPU, "rule"),
            ("multiscale", 0, 8, MS_CARD_VS_CPU, "rule")):
        psfs, base = make_ms_check_problem(F5_CHECK_SIZE, F5_CHANNELS, seed)
        settings = _f5_settings(F5_CHECK_SIZE, algorithm, 300)
        settings.multiscale.max_scales = max_scales
        card, cpu = [_f5_perform(settings, psfs, base, route, device)
                     for device in (DEVICE, "cpu")]
        if card["route"] != ("serial" if route == "serial" else "batched"):
            raise AssertionError(f"faceted {algorithm} took the "
                                 f"{card['route']} route")
        scale = max(1.0, float(np.abs(cpu["res"]).max()))
        d_res = float(np.abs(card["res"] - cpu["res"]).max()) / scale
        d_mod = float(np.abs(card["mod"] - cpu["mod"]).max()) / scale
        label = (f"{algorithm} ({card['route']}"
                 + (f", {max_scales or 'all'} scales, seed {seed}"
                    if algorithm == "multiscale" else "") + ")")
        say(f"  {label}: boxes {card['boxes']} / {cpu['boxes']}; iterations "
            f"{card['iterations']} / {cpu['iterations']}; max|dres| "
            f"{d_res:.3g}, max|dmodel| {d_mod:.3g} of max(1, |res|max)"
            + ("" if bound else " (read, not held)"))
        if not (card["boxes"] == cpu["boxes"]
                and sum(card["iterations"]) > 0):
            raise AssertionError(f"faceted {label}: the card and the CPU "
                                 "split or ran differently")
        if bound is not None and not (
                card["iterations"] == cpu["iterations"]
                and d_res <= bound and d_mod <= bound):
            raise AssertionError(f"faceted {label} on the card and on the "
                                 "CPU disagree")
    # The split of config 5's own field from the card's integration and
    # from the CPU's.
    from radler_tpu_torch.image_set import ImageSet
    from radler_tpu_torch.parallel.faceting import make_sub_images

    big_psfs, big = make_diffuse_problem(F5_SIZE, F5_CHANNELS)
    splits = []
    for device in (DEVICE, "cpu"):
        r = _f5_radler(_f5_settings(F5_SIZE, "generic"), big_psfs, big, device)
        image = ImageSet.from_table(
            r._table, r.settings.squared_joins,
            r.settings.linked_polarizations, F5_SIZE, F5_SIZE, device)
        image.load_and_average(True)
        integrated = image.get_linear_integrated().cpu().numpy()
        splits.append([(s.x, s.y, s.width, s.height)
                       for s in make_sub_images(integrated, None,
                                                r.settings)])
        del r, image
    say(f"  config 5's split from the card's integration {splits[0]}, from "
        f"the CPU's {splits[1]}")
    if splits[0] != splits[1]:
        raise AssertionError("config 5's split differs between the card "
                             "and the CPU")


def make_point_grid_problem(size, n_channels, k, seed=SEED):
    """A k x k grid of point sources (each a few pixels off its grid point,
    fluxes 0.2 to 1, spectra falling 5% a channel) under config 3's PSFs:
    ASP's field, on which the JAX package's ASP converges (every fitted
    Gaussian deconvolves to less than the beam and goes the point-source
    way); on config 3's diffuse emission its Gaussian components diverge
    (tests/test_torch_asp.py::test_asp_diffuse_field_matches_jax)."""
    psfs, _ = make_diffuse_problem(size, n_channels)
    rng = np.random.default_rng(seed)
    sky = np.zeros((size, size))
    step = size // (k + 1)
    for i in range(k):
        for j in range(k):
            y = step * (i + 1) + rng.integers(-3, 4)
            x = step * (j + 1) + rng.integers(-3, 4)
            sky[y, x] = rng.uniform(0.2, 1.0)
    return psfs, np.stack([
        np.fft.irfft2(np.fft.rfft2(sky * (1 - 0.05 * c))
                      * np.fft.rfft2(np.fft.ifftshift(psfs[c])), s=sky.shape)
        for c in range(n_channels)
    ]).astype(np.float32)


def _asp_settings(size, iterations):
    """Config 3's settings (2-term fit, gain 0.1, major gain 0.85, the
    default scales) for ASP."""
    import radler_tpu_torch as rd

    s = _ms_settings(size, iterations)
    s.algorithm_type = rd.AlgorithmType.ADAPTIVE_SCALE_PIXEL
    return s


def phase_asp_contract():
    """The reference's point-source contract for ASP on the card
    (tests/test_algorithms.py::test_asp_point_source; the TPU's reading
    in BASELINE.md:110): residual at most 2e-6, model peak 2.5 within 1e-4
    relative."""
    import radler_tpu_torch as rd

    size = 64
    point = np.array([[0.0, 0.4, 0.0], [0.25, 1.0, 0.5], [0.0, 0.6, 0.0]],
                     np.float32)
    psf = np.zeros((size, size), np.float32)
    psf[31:34, 31:34] = point
    res = np.zeros((size, size), np.float32)
    res[21:24, 26:29] = 2.5 * point
    s = rd.Settings()
    s.algorithm_type = rd.AlgorithmType.ADAPTIVE_SCALE_PIXEL
    s.trimmed_image_width = s.trimmed_image_height = size
    s.pixel_scale.x = s.pixel_scale.y = np.deg2rad(1.0 / 60.0)
    s.minor_iteration_count = 600
    s.absolute_threshold = 1e-6
    dev = torch.device(DEVICE)
    r = rd.Radler(s, torch.as_tensor(psf, device=dev),
                  torch.as_tensor(res, device=dev),
                  torch.zeros(size, size, device=dev), 0.0)
    r.perform(0)
    out_res = r._table.front.residual_accessor.array.cpu().numpy()
    out_mod = r._table.front.model_accessor.array.cpu().numpy()
    peak = float(out_mod[22, 27])
    say(f"  {r.iteration_number} iterations; max|residual| "
        f"{np.abs(out_res).max():.3g}, model peak {peak:.7f}")
    if not (np.abs(out_res).max() <= 2e-6 and abs(peak - 2.5) <= 2.5e-4):
        raise AssertionError("the ASP point-source contract failed")


def _asp_perform(psfs, res0, settings, count_syncs=False):
    """One ASP perform of ``res0`` (a tensor on the card) on a fresh Radler;
    returns (iterations, seconds, host syncs or None, peak MiB above the
    start, the residual cube)."""
    import radler_tpu_torch as rd

    r = rd.Radler(settings, psfs, res0.clone(), torch.zeros_like(res0), 0.0,
                  frequencies=_ms_frequencies(res0.shape[0]))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    syncs = _count_syncs(lambda: r.perform(0)) if count_syncs else None
    if not count_syncs:
        r.perform(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    peak = (torch.cuda.max_memory_allocated() - before) / 2**20
    res = torch.stack([e.residual_accessor.array for e in r._table])
    if not torch.isfinite(res).all():
        raise AssertionError("ASP: non-finite residual")
    return r.iteration_number, seconds, syncs, peak, res


def phase_asp_perform():
    """ASP through Radler.perform at ASP_SIZE^2 x ASP_CHANNELS (an 8 x 8
    grid of point sources, config 3's settings, ASP_ITERATIONS minor
    iterations): the best of two performs, a third counting host syncs,
    and a fourth with a synchronize around each of its steps (each step's
    own time).  Returns {"rate": iterations/s, "syncs", "peak_mib"}."""
    import radler_tpu_torch.models.asp as asp
    from radler_tpu_torch.models.multiscale import MultiScaleAlgorithm

    psfs, base = make_point_grid_problem(ASP_SIZE, ASP_CHANNELS, 8)
    psfs = torch.as_tensor(psfs, device=DEVICE)
    res0 = torch.as_tensor(base, device=DEVICE)
    settings = _asp_settings(ASP_SIZE, ASP_ITERATIONS)
    runs = [_asp_perform(psfs, res0, settings) for _ in range(2)]
    n, seconds = runs[0][0], min(r[1] for r in runs)
    syncs = _asp_perform(psfs, res0, settings, count_syncs=True)[2]
    i_rms = (rms(res0[0]), rms(runs[0][4][0]))
    say(f"  [{ASP_CHANNELS}, {ASP_SIZE}, {ASP_SIZE}]: {n} iterations, best "
        f"of 2 {seconds:.3f} s ({', '.join(f'{r[1]:.3f}' for r in runs)}), "
        f"{n / seconds:.1f} minor iterations/s; {syncs} host syncs; peak "
        f"{runs[0][3]:.1f} MiB above the start; I rms {i_rms[0]:.5f} -> "
        f"{i_rms[1]:.5f}")
    if not (n == ASP_ITERATIONS and i_rms[1] < i_rms[0]):
        raise AssertionError("the ASP perform did not clean as expected")
    targets = [
        (MultiScaleAlgorithm, "_find_active_scale_convolved_maxima",
         "the scale-maxima bank (FFTs, one read)"),
        (MultiScaleAlgorithm, "_find_peak_direct",
         "the scale-convolved peak (FFT, one read)"),
        (MultiScaleAlgorithm, "_convolve_psfs", "the scales' PSF peaks"),
        (asp, "fit_2d_gaussian_centred", "the PSF's Gaussian fit (host)"),
        (asp, "fit_2d_gaussian_full", "Gaussian fits (host, SciPy)"),
        (asp, "deconvolve_gaussian", "beam deconvolution (host)"),
        (asp, "draw_gaussian", "drawing Gaussians (host, NumPy)"),
        (asp, "convolve_same", "the Gaussian path's convolutions"),
        (asp, "padded_convolve", "the Gaussian component through the PSFs"),
        (asp, "subtract_psf_from_cube", "point-source subtractions"),
        (asp.AspAlgorithm, "_deconvolve_gaussian",
         "the Gaussian path, the rest (its window copy)"),
        (asp.AspAlgorithm, "_deconvolve_point_source",
         "the point-source path, the rest"),
        (asp, "get_linear_integrated", "linear integrations"),
    ]
    split = {}
    restore = _timed_steps(split, targets)
    try:
        timed = _asp_perform(psfs, res0, settings)[1]
    finally:
        restore()
    say(f"  split of a perform ({timed:.3f} s with a synchronize around "
        "each step; each step's own time):")
    for key, (calls, t) in split.items():
        say(f"    {key}: {calls} calls, {t * 1e3:.1f} ms "
            f"({100 * t / timed:.1f}%)")
    rest = timed - sum(t for _, t in split.values())
    say(f"    the rest: {rest * 1e3:.1f} ms ({100 * rest / timed:.1f}%)")
    return {"rate": n / seconds, "syncs": syncs, "peak_mib": runs[0][3]}


def phase_asp_card_vs_cpu():
    """ASP on a 4 x 4 grid of point sources at ASP_CHECK_SIZE^2 x 2
    channels (config 3's settings, 200 iterations) on the card against the
    port's CPU run of the same arrays: equal iteration counts, the
    residual and model within MS_CARD_VS_CPU of max(1, |res|max)."""
    import radler_tpu_torch as rd

    psfs, base = make_point_grid_problem(ASP_CHECK_SIZE, 2, 4)
    out = []
    for device in (DEVICE, "cpu"):
        res, model = base.copy(), np.zeros_like(base)
        r = rd.Radler(_asp_settings(ASP_CHECK_SIZE, 200), psfs, res, model,
                      0.0, frequencies=_ms_frequencies(2), device=device)
        start = time.perf_counter()
        r.perform(0)
        out.append((r.iteration_number, res, model,
                    time.perf_counter() - start))
    (n_g, res_g, mod_g, t_g), (n_c, res_c, mod_c, t_c) = out
    scale = max(1.0, float(np.abs(res_c).max()))
    d_res = float(np.abs(res_g - res_c).max()) / scale
    d_mod = float(np.abs(mod_g - mod_c).max()) / scale
    say(f"  card {n_g} iterations ({t_g:.2f} s), CPU {n_c} ({t_c:.2f} s); "
        f"max|dres| {d_res:.3g}, max|dmodel| {d_mod:.3g} of max(1, "
        "|res|max)")
    if not (n_g == n_c > 0 and d_res <= MS_CARD_VS_CPU
            and d_mod <= MS_CARD_VS_CPU):
        raise AssertionError("ASP on the card and on the CPU disagree")


def _linear_solve_gaps(card_inputs):
    """The linear solve of component optimization from the card's inputs
    (model, residual, PSF), three ways: on the card; on the CPU from the
    same inputs (its own FFT makes the dirty image); on the CPU from the
    card's own dirty spectrum at the components.  Prints both CPU gaps to
    the card's amplitudes, the system's condition number and the FFTs'
    spread of the right-hand side, and holds the second gap to float64
    rounding times the condition number."""
    from radler_tpu_torch.ops import component_optimization as co

    model, residual, psf = card_inputs
    ys, xs, a, dirty = co.linear_system(model, residual, psf)
    b_card = dirty[ys, xs]
    amp_card = co.solve_amplitudes(a, b_card).cpu()
    ys_c, xs_c, a_c, dirty_c = co.linear_system(model.cpu(), residual.cpu(),
                                                psf.cpu())
    if not (torch.equal(ys_c, ys.cpu()) and torch.equal(a_c, a.cpu())):
        raise AssertionError("the card's and the CPU's linear systems differ "
                             "in their positions or PSF gather")
    b_cpu = dirty_c[ys_c, xs_c]
    amp_own = co.solve_amplitudes(a_c, b_cpu)
    amp_same_b = co.solve_amplitudes(a_c, b_card.cpu())
    cond = float(torch.linalg.cond(a_c.double()))
    top = float(amp_card.abs().max())
    spread = float((b_card.cpu() - b_cpu).abs().max()) / float(
        b_cpu.abs().max())
    gap_own = float((amp_card - amp_own).abs().max()) / top
    gap_same = float((amp_card - amp_same_b).abs().max()) / top
    say(f"  linear solve, {len(ys)} components: condition number "
        f"{cond:.4g}; the right-hand side's spread card against CPU FFTs "
        f"{spread:.3g} (of max|b|); amplitude gaps to the card's, relative "
        f"to max|amplitude|: the CPU on its own dirty image {gap_own:.3g}, "
        f"the CPU on the card's dirty spectrum {gap_same:.3g}; condition "
        f"number x spread {cond * spread:.3g}")
    if gap_same > cond * 1e-13:
        raise AssertionError("the linear solve differs between the card and "
                             "the CPU on the same right-hand side")


def phase_component_optimization_card_vs_cpu():
    """Component optimization on the card against the CPU at CO_SIZE^2:
    twelve point sources in noise under config 3's PSF, auto-masking at 4
    sigma and the source list, majors until done (the perform after
    auto-masking finishes optimizes instead of cleaning): generic CLEAN
    with LINEAR_EQUATION_SOLVER and with GRADIENT_DESCENT, multiscale with
    GRADIENT_DESCENT.  Each: the optimization ran on both, equal results
    and iteration counts, the residual within MS_CARD_VS_CPU of max(1,
    |res|max), the model too after gradient descent, and within
    CO_LINEAR_CARD_VS_CPU after the linear solve: its K x K system's
    condition number (4.0e3 on this field, 40 components) carries the
    float32 FFT rounding of the dirty image at the components (about 1e-7
    relative, cuFFT against pocketfft) into the amplitudes."""
    import radler_tpu_torch as rd
    from radler_tpu_torch.models import generic_clean as gc
    from radler_tpu_torch.models import multiscale as ms
    from radler_tpu_torch.ops import component_optimization as co

    psfs, _ = make_diffuse_problem(CO_SIZE, 1)
    rng = np.random.default_rng(SEED)
    sky = np.zeros((CO_SIZE, CO_SIZE))
    ys, xs = rng.integers(CO_SIZE // 8, 7 * CO_SIZE // 8, (2, 12))
    np.add.at(sky, (ys, xs), rng.uniform(0.5, 2.0, 12))
    base = (np.fft.irfft2(np.fft.rfft2(sky) * np.fft.rfft2(
        np.fft.ifftshift(psfs[0])), s=sky.shape)
        + rng.normal(scale=0.01, size=sky.shape)).astype(np.float32)
    for algorithm, optimization, owner, name, bound in (
            ("GENERIC_CLEAN", "LINEAR_EQUATION_SOLVER", gc,
             "run_component_optimization", CO_LINEAR_CARD_VS_CPU),
            ("GENERIC_CLEAN", "GRADIENT_DESCENT", gc,
             "run_component_optimization", MS_CARD_VS_CPU),
            ("MULTISCALE", "GRADIENT_DESCENT", ms.MultiScaleAlgorithm,
             "_run_full_component_fitter", MS_CARD_VS_CPU)):
        s = rd.Settings()
        s.trimmed_image_width = s.trimmed_image_height = CO_SIZE
        s.algorithm_type = getattr(rd.AlgorithmType, algorithm)
        s.generic.use_sub_minor_optimization = False
        s.minor_iteration_count = 3000
        s.auto_mask_sigma = 4.0
        s.save_source_list = True
        s.component_optimization_algorithm = getattr(
            rd.OptimizationAlgorithm, optimization)
        out = []
        solves = []
        real_solve = co.linear_component_solve

        def recording_solve(*args, **kwargs):
            solves.append(tuple(a.clone() for a in args))
            return real_solve(*args, **kwargs)

        for device in (DEVICE, "cpu"):
            calls = []
            original = getattr(owner, name)

            def counted(*args, original=original, calls=calls, **kwargs):
                calls.append(1)
                return original(*args, **kwargs)

            res, model = base.copy(), np.zeros_like(base)
            r = rd.Radler(s, psfs[0], res, model, 0.0, device=device)
            setattr(owner, name, counted)
            co.linear_component_solve = recording_solve
            try:
                again = []
                while len(again) < 6 and (not again or again[-1]):
                    again.append(r.perform(len(again)))
            finally:
                setattr(owner, name, original)
                co.linear_component_solve = real_solve
            out.append((again, r.iteration_number, res, model, len(calls)))
        if optimization == "LINEAR_EQUATION_SOLVER":
            _linear_solve_gaps(solves[0])
        (a_g, n_g, res_g, mod_g, k_g), (a_c, n_c, res_c, mod_c, k_c) = out
        scale = max(1.0, float(np.abs(res_c).max()))
        d_res = float(np.abs(res_g - res_c).max()) / scale
        d_mod = float(np.abs(mod_g - mod_c).max()) / scale
        say(f"  {algorithm} {optimization}: performs {a_g} / {a_c}, "
            f"iterations {n_g} / {n_c}, optimizations {k_g} / {k_c}; "
            f"max|dres| {d_res:.3g}, max|dmodel| {d_mod:.3g} of max(1, "
            "|res|max)")
        if not (a_g == a_c and n_g == n_c > 0 and k_g == k_c == 1
                and d_res <= MS_CARD_VS_CPU and d_mod <= bound):
            raise AssertionError(f"component optimization ({algorithm}, "
                                 f"{optimization}) on the card and on the "
                                 "CPU disagree")


# ---------------------------------------------------------------------------
# The mesh's Clark subminor loop (B2 with a tile axis), MORE_SANE, PYTHON
# ---------------------------------------------------------------------------


def _mesh_clark_radler(psfs, res, kwargs, size, iterations, use_mesh):
    """A maker of Radlers with the Clark default on a mesh of MESH_DEVICES
    shards (or on one device), each on fresh copies of the cube."""
    import radler_tpu_torch as rd

    settings = _mesh_settings(size, iterations, use_mesh)
    settings.generic.use_sub_minor_optimization = True
    return lambda: rd.Radler(settings, psfs, res.clone(),
                             torch.zeros_like(res), 0.0, **kwargs)


@contextlib.contextmanager
def _recording_mesh_clark(calls, tile_calls):
    """Record each call of the mesh's Clark subminor loop (its arguments)
    and of B2's tile axis (copies of its inputs, for the replay)."""
    from radler_tpu_torch.models import generic_clean as gc
    from radler_tpu_torch.parallel import mesh as pm

    real_clean, real_tiles = gc.mesh_subminor_clean, pm.subminor_loop_tiles

    def recording_clean(*args, **kwargs):
        calls.append((args, kwargs))
        return real_clean(*args, **kwargs)

    def recording_tiles(*args, **kwargs):
        tile_calls.append((tuple(a.clone() if isinstance(a, torch.Tensor)
                                 else a for a in args), kwargs))
        return real_tiles(*args, **kwargs)

    gc.mesh_subminor_clean, pm.subminor_loop_tiles = (recording_clean,
                                                      recording_tiles)
    try:
        yield
    finally:
        gc.mesh_subminor_clean, pm.subminor_loop_tiles = real_clean, real_tiles


def _tile_replay(args, kwargs, kernel):
    """One run of B2's tile-axis arguments on fresh copies of its state:
    the kernel, or the plain version.  Returns (output, residual, model)."""
    from radler_tpu_torch.kernels import subminor_loop as sl

    res, model = args[0].clone(), args[1].clone()
    args = (res, model) + tuple(args[2:])
    if kernel:
        out = sl.subminor_loop_tiles(*args, **kwargs)
    else:
        out = sl.subminor_loop_tiles_reference(*args[:9], args[10], **kwargs)
    torch.cuda.synchronize()
    return out, res, model


def _check_tile_replay(label, tile_calls):
    """Every tile of every recorded tile-axis launch, replayed from copies
    of its inputs: kernel against plain version, bit-equal in the results,
    the state and the model.  Returns max |difference|."""
    from radler_tpu_torch.kernels import subminor_loop as sl

    start = time.perf_counter()
    worst = 0.0
    for args, kwargs in tile_calls:
        out_k, res_k, mod_k = _tile_replay(args, kwargs, kernel=True)
        out_p, res_p, mod_p = _tile_replay(args, kwargs, kernel=False)
        d = max(float((res_k - res_p).abs().max()),
                float((mod_k - mod_p).abs().max()))
        worst = max(worst, d)
        tiles = sl.read_tile_results(out_p)
        say(f"  {label}: replay of {len(tiles)} tiles, kernel against plain: "
            f"iterations {[t[0] - args[8].start_iteration for t in tiles]}, "
            f"max|diff| {d:.3g} ({time.perf_counter() - start:.1f} s)")
        if not (torch.equal(out_k, out_p) and d == 0.0):
            raise AssertionError(
                f"{label}: B2's tile axis and its plain version disagree: "
                f"kernel {sl.read_tile_results(out_k)}, plain {tiles}")
    return worst


def _mesh_clark_split(call, out_res):
    """The mesh's Clark subminor of one perform in its steps, each
    synchronized (selection, B2's tile launch and its read, the scatter and
    the FFT correction), from the recorded call's arguments; the result
    must be the perform's.  Then the banded per-tile emulation: each
    tile's rows selected on their own, today's B2 (no tile axis) on each in
    turn, one correction; equal iterations and residual.  Returns (the
    split, per-tile counts, the recorded candidates' state)."""
    from radler_tpu_torch.image_set import linear_integration_coefficients
    from radler_tpu_torch.kernels import subminor_loop as sl
    from radler_tpu_torch.models.subminor import (
        choose_padded_size,
        correct_residual,
    )
    from radler_tpu_torch.parallel import mesh as pm

    from radler_tpu_torch.models.subminor import fit_arguments

    (mesh, residual, psfs, rms_factor, window, considered, params), kwargs = (
        call)
    meta, fitter = kwargs["meta"], kwargs.get("fitter")
    n, height, width = residual.shape
    ph, pw = choose_padded_size(width, height, 1.1)
    coef = torch.as_tensor(linear_integration_coefficients(meta),
                           device=residual.device)
    split = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        split[name] = time.perf_counter() - t0
        return value

    cand = step("selection", lambda: pm.select_tile_candidates(
        mesh, residual, rms_factor, window, considered, meta=meta,
        allow_negative=params.allow_negative))
    model_k = torch.zeros_like(cand.residual_k)
    res_k = cand.residual_k.clone()
    results = step("B2 tile launch and read", lambda: sl.read_tile_results(
        sl.subminor_loop_tiles(res_k, model_k, cand.rms_k, cand.xs, cand.ys,
                               psfs, coef, fit_arguments(
                                   fitter, residual.device, cand.xs,
                                   cand.ys), params, cand.offsets,
                               cand.counts,
                               n_polarizations=meta.n_polarizations)))
    iteration, _, _ = pm.reduce_tile_results(results, params.start_iteration)

    def correct():
        delta = torch.zeros((n, height * width), device=residual.device)
        delta.index_copy_(1, cand.flat, model_k)
        return correct_residual(residual, delta.view(n, height, width), psfs,
                                ph, pw, meta.n_channels)

    new_res = step("scatter and FFT correction", correct)
    d = float((new_res - out_res).abs().max())
    if d > TOLERANCE:
        raise AssertionError(f"the split run differs from perform's: "
                             f"max|dres| {d:.3g}")

    # The banded emulation: one band's rows at a time, today's B2.
    h_loc = height // mesh.tile
    one = pm.Mesh(1, 1, mesh.device)
    delta = torch.zeros((n, height * width), device=residual.device)
    band_results = []
    for t in range(mesh.tile):
        band = torch.zeros_like(window)
        band[t * h_loc:(t + 1) * h_loc] = True
        own = pm.select_tile_candidates(
            one, residual, rms_factor, window & band, considered, meta=meta,
            allow_negative=params.allow_negative)
        if own.counts[0] != cand.counts[t]:
            raise AssertionError(f"band {t} selects {own.counts[0]} "
                                 f"candidates, the tile {cand.counts[t]}")
        if own.counts[0] == 0:
            band_results.append((params.start_iteration, 0.0, False))
            continue
        band_model = torch.zeros_like(own.residual_k)
        band_results.append(sl.read_result(sl.subminor_loop(
            own.residual_k, band_model, own.rms_k, own.xs, own.ys, psfs,
            coef, fit_arguments(fitter, residual.device, own.xs, own.ys),
            params, n_polarizations=meta.n_polarizations)))
        delta.index_copy_(1, own.flat, band_model)
    emulated = correct_residual(residual, delta.view(n, height, width), psfs,
                                ph, pw, meta.n_channels)
    d_band = float((emulated - out_res).abs().max())
    it_band = pm.reduce_tile_results(band_results, params.start_iteration)[0]
    say(f"  banded emulation (today's B2 on each tile's rows in turn): "
        f"{it_band} iterations against the mesh's {iteration}, tile results "
        f"{'equal' if band_results == results else 'DIFFERENT'}, max|dres| "
        f"{d_band:.3g}")
    if band_results != results or it_band != iteration or d_band > TOLERANCE:
        raise AssertionError("the mesh run and its banded emulation differ")
    return split, cand.counts


def phase_mesh_clark(label, psfs, res, kwargs, size, iterations,
                     tile_times=False):
    """A cube through Radler.perform with the Clark default on a mesh of
    MESH_DEVICES shards on the card (the mesh's Clark subminor loop: B2's
    tile axis, one launch a perform): a recorded warm-up, the best of 3
    (minor iterations per second), per-tile candidate counts, launches,
    the split of a perform and the banded emulation, the single-device
    Clark perform of the same cube beside it (best of 2), and every tile of
    the recorded launch replayed against the plain version.  With
    ``tile_times``, B2's tile axis timed at the recorded segments against
    today's B2 launched on each tile in turn and the plain version.
    Returns a dict of what the summary and the kernels line use."""
    from radler_tpu_torch.kernels import subminor_loop as sl

    calls, tile_calls = [], []
    with _recording_mesh_clark(calls, tile_calls):
        first = _run_perform(_mesh_clark_radler(psfs, res, kwargs, size,
                                                iterations, True))
    runs = [_run_perform(_mesh_clark_radler(psfs, res, kwargs, size,
                                            iterations, True))
            for _ in range(3)]
    launches = sl.subminor_loop_tiles.launches
    b2_single = sl.subminor_loop.launches
    singles = [_run_perform(_mesh_clark_radler(psfs, res, kwargs, size,
                                               iterations, False))
               for _ in range(2)]
    single_b2 = sl.subminor_loop.launches
    n = first[0]
    if len(calls) != 1 or len(tile_calls) != 1:
        raise AssertionError(f"{label}: {len(calls)} mesh Clark calls, "
                             f"{len(tile_calls)} tile launches")
    if any(r[0] != n or r[2] != (0, 0) or not torch.equal(r[4], first[4])
           for r in runs):
        raise AssertionError(f"{label}: the mesh performs differ or launched "
                             "the Högbom kernels")
    if not (launches == 1 and b2_single == 0 and single_b2 == 1):
        raise AssertionError(f"{label}: {launches} tile launches and "
                             f"{b2_single} single B2 launches a mesh "
                             f"perform, {single_b2} single-device")
    mesh = calls[0][0][0]
    split, counts = _mesh_clark_split(calls[0], first[4])
    best = min(r[1] for r in runs)
    best_single = min(r[1] for r in singles)
    say(f"  {label} (chan {mesh.chan} x tile {mesh.tile}): {n} iterations "
        f"summed over the tiles; K per tile {counts} (total {sum(counts)}); "
        f"seconds {', '.join(f'{r[1]:.4f}' for r in runs)}; best "
        f"{n / best:.1f} minor iterations/s; B2 tile launches {launches} a "
        f"perform; peak memory {max(r[6] for r in runs):.1f} MiB above the "
        "inputs")
    say("  split of one perform's mesh subminor: " + ", ".join(
        f"{name} {sec * 1e3:.3f} ms" for name, sec in split.items()))
    say(f"  single device, the same cube: {singles[0][0]} iterations, "
        f"seconds {', '.join(f'{r[1]:.4f}' for r in singles)}; best "
        f"{singles[0][0] / best_single:.1f} minor iterations/s; max|mesh "
        f"residual - single device's| "
        f"{float((first[4] - singles[0][4]).abs().max()):.3g} (the tiles "
        "clean their own candidates: a different algorithm by design)")
    say(f"  residual rms {rms(res):.6g} -> {rms(first[4]):.6g}")
    if not (rms(first[4]) < rms(res) and n > 0):
        raise AssertionError(f"{label}: the mesh perform did not clean")
    worst = _check_tile_replay(label, tile_calls)
    out = dict(n=n, rate=n / best, single=singles[0][0] / best_single,
               counts=counts, launches=launches, worst=worst, split=split)
    if tile_times:
        out["times"] = _tile_times(tile_calls[0])
    return out


def _tile_times(call):
    """B2's tile axis at a recorded launch's segments, SUBMINOR_TIMED_ITERATIONS
    iterations a tile from threshold 0, by CUDA events in turns plain, tile
    launch, T launches of today's B2 (one a tile, in turn), then the same
    backwards; the bound of the tile launch.  Returns a dict."""
    from radler_tpu_torch.kernels import subminor_loop as sl

    args, kwargs = call
    res0, _, rms_k, xs, ys, psfs, coef, fit, _, offsets, counts = args
    n, k = res0.shape
    params = sl.SubminorParams.make(0.0, GAIN, 0, SUBMINOR_TIMED_ITERATIONS,
                                    0.0, True, False)
    res_k, model_k = res0.clone(), torch.zeros_like(res0)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    segments = [
        ((res0[:, a:b].contiguous(), torch.zeros((n, b - a), device=DEVICE),
          None if rms_k is None else rms_k[a:b].contiguous(),
          xs[a:b].contiguous(), ys[a:b].contiguous()),
         fit if fit is None or fit.terms is None
         else fit._replace(terms=fit.terms[:, a:b].contiguous()))
        for a, b in zip(bounds[:-1], bounds[1:]) if b > a]

    def tiles():
        return sl.subminor_loop_tiles(res_k, model_k, rms_k, xs, ys, psfs,
                                      coef, fit, params, offsets, counts,
                                      **kwargs)

    def sequential():
        for seg, seg_fit in segments:
            sl.subminor_loop(*seg, psfs, coef, seg_fit, params, **kwargs)

    def plain():
        return sl.subminor_loop_tiles_reference(
            res_k, model_k, rms_k, xs, ys, psfs, coef, fit, params, counts,
            **kwargs)

    readings = {"plain": [], "tiles": [], "sequential": []}
    for name in ("plain", "tiles", "sequential", "sequential", "tiles",
                 "plain"):
        fn = {"plain": plain, "tiles": tiles, "sequential": sequential}[name]
        ms, _ = _time_ms(fn, 1 if name == "plain" else 5)
        readings[name].append(ms)
    # The least work of the tile launch: every tile's [N, K_t] state read
    # and written, the model written, the positions (and rms) read, the
    # coefficients, and the PSF once; per iteration and candidate about
    # four float32 operations a plane.  The PSF once per cluster (T reads)
    # is the figure where the clusters' reads do not share the L2.
    state = 4 * (3 * n * k + 2 * k + (k if rms_k is not None else 0) + n)
    psf_bytes = 4 * psfs.numel()
    n_flops = SUBMINOR_TIMED_ITERATIONS * k * 4 * n
    once = bound_ms(state + psf_bytes, n_flops)
    per_cluster = bound_ms(state + len(counts) * psf_bytes, n_flops)
    plan = sl.cluster_plan(n, max(counts), fit=fit)
    say(f"  B2 tile axis at the recorded segments ({len(counts)} tiles, K "
        f"{counts}, {n} planes, plan {_plan_name(plan)}), "
        f"{SUBMINOR_TIMED_ITERATIONS} iterations a tile: ms " + "; ".join(
            f"{name} {', '.join(f'{v:.4f}' for v in values)}"
            for name, values in readings.items())
        + f"; bound {once[0]:.4f} ms ({once[1]}, the PSF once through the "
        f"L2), {per_cluster[0]:.4f} ms with the PSF once a cluster from HBM")
    mean = {name: sum(v) / len(v) for name, v in readings.items()}
    return dict(ms=mean["tiles"], plain_ms=mean["plain"],
                sequential_ms=mean["sequential"], bound=once,
                bound_per_cluster=per_cluster)


MORE_SANE_STAND_IN = """
import importlib.util
import sys

import numpy as np

# The port's FITS module alone, loaded from its file: the package's own
# import (torch and all) would take most of the stand-in's time.
spec = importlib.util.spec_from_file_location("fits", {fits!r})
fits = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fits)
read_fits_image, write_fits_image = fits.read_fits_image, fits.write_fits_image

args = sys.argv[1:]
if "-sl" in args:
    i = args.index("-sl")
    del args[i : i + 2]
dirty_name, psf_name, output_name = args[-3:]
dirty = read_fits_image(dirty_name)
# A stand-in for MORESANE: a tenth of every pixel above 5 percent of the
# peak becomes model flux.
model = np.where(dirty > 0.05 * dirty.max(), 0.1 * dirty, 0.0)
write_fits_image(output_name + "_model.fits", model)
write_fits_image(output_name + "_residual.fits", dirty - model)
"""

PLUGIN_HOGBOM = """
import numpy as np

def deconvolve(residual, model, psf, meta):
    # Hogbom CLEAN in NumPy: subtract the PSF's overlap at each peak.
    nfreq, npol, h, w = residual.shape
    res, mod, beam = residual[0, 0], model[0, 0], psf[0]
    for _ in range(meta.max_iterations):
        y, x = divmod(int(np.abs(res).argmax()), w)
        value = meta.gain * res[y, x]
        y0, y1 = max(0, y - h // 2), min(h, y + h - h // 2)
        x0, x1 = max(0, x - w // 2), min(w, x + w - w // 2)
        res[y0:y1, x0:x1] -= value * beam[y0 - y + h // 2:y1 - y + h // 2,
                                          x0 - x + w // 2:x1 - x + w // 2]
        mod[y, x] += value
        meta.iteration_number += 1
    return {"residual": residual, "model": model,
            "level": float(np.abs(res).max()), "continue": False}
"""


@contextlib.contextmanager
def _timed_host_copies(module, seconds):
    """Add the synchronized time of ``module``'s ``to_host`` and
    ``to_device`` (the plug-in's copies between the card and the host) to
    ``seconds``."""
    real = module.to_host, module.to_device

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return value
        return run

    module.to_host, module.to_device = timed(real[0]), timed(real[1])
    try:
        yield
    finally:
        module.to_host, module.to_device = real


def phase_host_plugins(psf2, residual2):
    """MORE_SANE and PYTHON at config 2's field (2048^2 x 1) through
    Radler.perform on the card: MORE_SANE's two major iterations with a
    stand-in program written to a temporary directory (never the real
    one; a temporary ``python`` link to this interpreter goes first on PATH
    where there is no ``python``), the PYTHON plug-in Högbom-cleaning in
    NumPy for 50 iterations; each its wall time and the share of it spent
    copying between the card and the host."""
    import shutil
    import tempfile

    import radler_tpu_torch as rd
    from radler_tpu_torch.models import more_sane, python_plugin

    dev = torch.device(DEVICE)
    psf_d = torch.as_tensor(psf2, device=dev)
    res_d = torch.as_tensor(residual2, device=dev)
    repo = os.path.dirname(os.path.abspath(__file__))
    cwd, path = os.getcwd(), os.environ.get("PATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "stand_in_moresane.py")
        with open(script, "w") as f:
            f.write(MORE_SANE_STAND_IN.format(fits=os.path.join(
                repo, "radler_tpu_torch", "utils", "fits.py")))
        plugin = os.path.join(tmp, "hogbom_plugin.py")
        with open(plugin, "w") as f:
            f.write(PLUGIN_HOGBOM)
        if shutil.which("python") is None:
            os.symlink(sys.executable, os.path.join(tmp, "python"))
            os.environ["PATH"] = tmp + os.pathsep + path
        os.chdir(tmp)
        try:
            for algorithm, majors, iterations, module in (
                    ("MORE_SANE", 2, 2, more_sane),
                    ("PYTHON", 1, 50, python_plugin)):
                s = rd.Settings()
                s.algorithm_type = getattr(rd.AlgorithmType, algorithm)
                s.trimmed_image_width = s.trimmed_image_height = CLARK_SIZE
                s.minor_iteration_count = iterations
                s.minor_loop_gain = GAIN
                s.more_sane.location = script
                s.more_sane.sigma_levels = [3.0, 2.0]
                s.python.filename = plugin
                res, model = res_d.clone(), torch.zeros_like(res_d)
                r = rd.Radler(s, psf_d, res, model, 0.0)
                copies = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with _timed_host_copies(module, copies):
                    again = [r.perform(i) for i in range(majors)]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                out_res = r._table.front.residual_accessor.array
                out_mod = r._table.front.model_accessor.array
                say(f"  {algorithm}: {majors} major iteration(s), performs "
                    f"{again}, {r.iteration_number} iterations, {wall:.4f} s; "
                    f"copies between the card and the host {len(copies)}, "
                    f"{sum(copies) * 1e3:.3f} ms ({100 * sum(copies) / wall:.2f}"
                    f"% of the wall time); residual rms {rms(res_d):.6g} -> "
                    f"{rms(out_res):.6g}, model sum "
                    f"{float(out_mod.double().sum()):.6g}")
                # The stand-in MORESANE is no deconvolution: only the
                # plug-in's Högbom loop must lower the residual.
                cleaned = algorithm == "MORE_SANE" or rms(out_res) < rms(res_d)
                if not (out_res.device.type == DEVICE
                        and torch.isfinite(out_res).all() and cleaned
                        and float(out_mod.abs().max()) > 0
                        and r.iteration_number == (2 if majors == 2 else 50)):
                    raise AssertionError(f"{algorithm} did not run on the "
                                         "card as expected")
        finally:
            os.chdir(cwd)
            os.environ["PATH"] = path


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    import radler_tpu_torch  # noqa: F401  (fails outside a checkout)

    start = time.perf_counter()
    section("the card")
    smi = phase_card()
    section("Högbom kernels against their plain versions")
    worst = phase_kernels_vs_plain()
    section("the 4096^2 problem (seed 7, 300 sources)")
    psf, residual = make_problem(SIZE, N_SOURCES)
    section("Högbom kernel times at the main path's shapes")
    times = phase_kernel_times(psf, residual)
    section("B1's facet mode with one facet against B1 at config 1's shape")
    facet_one = phase_facet_one_times(psf, residual)
    section("config 1 through Radler.perform")
    counts, rate = phase_main_path(psf, residual)
    section("joined channels through Radler.perform")
    phase_joined_channels(psf, residual)
    section("B4 and B1 on row shards against their plain versions")
    worst_mesh = phase_mesh_kernels_vs_plain()
    worst["hogbom_step"] = max(worst["hogbom_step"], worst_mesh["hogbom_step"])
    worst["subtract_integrate"] = worst_mesh["subtract_integrate"]
    section("B4 time at the mesh configuration's shard")
    b4_times = phase_b4_times()
    section("the mesh configuration (joined channels, chan 4 x tile 2) "
        "through Radler.perform")
    mesh = phase_mesh_perform(psf, residual)
    section("the joined-channel cube with the Clark default on a chan 4 x "
        "tile 2 mesh (B2's tile axis)")
    psfs_j, res_j, kwargs_j = _joined_inputs(psf, residual)
    mesh_clark_joined = phase_mesh_clark("joined channels", psfs_j, res_j,
                                         kwargs_j, SIZE, MESH_ITERATIONS)
    section("the joined-channel cube with a log-polynomial fit on the chan 4 "
        "x tile 2 mesh (B2's tile axis, the fit in its body) against the "
        "port's CPU run")
    mesh_fit = phase_mesh_clark_fit(psfs_j, res_j, kwargs_j)
    del psfs_j, res_j
    section("the mesh over several cards (up to 8 cards; one card: "
        f"{MESH_GROUPS_ON_ONE_CARD} groups on it) through Radler.perform")
    cards = phase_mesh_cards(psf, residual)
    del psf, residual
    section("point-source contract, Högbom")
    phase_contract()
    section("point-source contract, Högbom on a chan 1 x tile 8 mesh")
    phase_contract(mesh=True)
    section("the subminor kernel against its plain version")
    worst_small = phase_subminor_vs_plain()
    section("the subminor kernel with the log-polynomial and forced-term "
        "fits against its plain version")
    worst_fits = phase_subminor_fits_vs_plain()
    worst_fits["LOG_POLYNOMIAL"] = max(worst_fits["LOG_POLYNOMIAL"],
                                       mesh_fit["worst"])
    section("the 2048^2 problem (seed 7, 300 sources)")
    psf2, residual2 = make_problem(CLARK_SIZE, N_SOURCES)
    section("the subminor kernel at config 2's shapes")
    worst_config2, kernel_ms, plain_ms, b2_bound, b2_plan = (
        phase_subminor_times(psf2, residual2))
    worst["subminor_loop"] = max(worst_small, worst_config2)
    times["subminor_loop"] = (kernel_ms, plain_ms)
    section("config 2 (Clark) through Radler.perform")
    clark = phase_config2(psf2, residual2)
    section("config 2 with the Clark default on a chan 1 x tile 8 mesh "
        "(B2's tile axis)")
    mesh_clark = phase_mesh_clark(
        "config 2", torch.as_tensor(psf2, device=DEVICE),
        torch.as_tensor(residual2, device=DEVICE), {}, CLARK_SIZE,
        ITERATIONS, tile_times=True)
    section("MORE_SANE and PYTHON at config 2's field")
    phase_host_plugins(psf2, residual2)
    section("local RMS through Radler.perform, Clark")
    phase_local_rms(psf2, residual2)
    section("2ch x 2pol squared joins on a chan 2 x tile 4 mesh")
    phase_mesh_squared(psf2, residual2)
    section("point-source contract, Clark")
    phase_contract(clark=True)
    section(f"{SPECTRAL_SIZE}^2 x 4 channels through Radler.perform, Clark "
        "with the log-polynomial and the forced-term fit (B2)")
    spectral = phase_spectral_performs()
    section(f"B2 with each fit on the card against the port's CPU run "
        f"({SPECTRAL_CHECK_SIZE}^2 x 4)")
    phase_spectral_card_vs_cpu()
    section("batched irfft2")
    phase_batched_irfft()
    section("the à-trous kernel (B3) against its plain version")
    worst["atrous_decompose_lo"] = phase_atrous_vs_plain()
    section("B3 times at 4096^2")
    atrous = phase_atrous_times()
    section("config 4 (IUWT 4096^2) through Radler.perform")
    iuwt = phase_config4()
    section("B3 against its plain version at config 4's shapes")
    worst["atrous_decompose_lo"] = max(worst["atrous_decompose_lo"],
                                       phase_atrous_main_shapes(iuwt[2]))
    # B3 at the case config 4 gave it most often.
    (shape, n_main), _ = iuwt[2].most_common(1)[0]
    section("the IUWT diffuse-source contract")
    phase_iuwt_contract()
    section("B1 in linear mode at config 3's shape against its plain "
        "version")
    linear = phase_linear_b1()
    section("config 3 (multiscale 2048^2 x 8 channels) through "
        "Radler.perform: the fused, dense and Clark routes")
    config3 = phase_config3()
    worst["subminor_loop"] = max(worst["subminor_loop"], config3["worst_b2"])
    for route in ("fused", "dense"):
        section(f"point-source contract, multiscale, {route} route")
        phase_ms_contract(route)
    for route in ("fused", "dense"):
        section(f"multiscale on the card against the CPU, {route} route")
        phase_ms_card_vs_cpu(route)
    section("multiscale's Clark route with a log-polynomial fit")
    ms_fit = phase_ms_clark_fit()
    worst_fits["LOG_POLYNOMIAL"] = max(worst_fits["LOG_POLYNOMIAL"],
                                       ms_fit["worst"])
    section("multiscale on a chan 4 x tile 2 mesh (2048^2 x 4 channels)")
    ms_mesh = phase_ms_mesh()
    section("B4 in linear mode at the multiscale mesh's shard")
    b4_linear = phase_b4_times(B4_LINEAR_CASE)
    section("B1's facet mode against its plain version")
    worst_facets = phase_facet_b1_vs_plain()
    section("config 5 (4096^2 x 2 channels x I, Q, U, V, 2 x 2 facets) "
        "through Radler.perform: generic batched, generic serial (Högbom, "
        "Clark), multiscale serial and batched")
    config5 = phase_config5()
    batched = config5["generic, batched"]
    f5_boxes = [(b[3], b[2]) for b in batched["boxes"]]
    box = (max(b[0] for b in f5_boxes), max(b[1] for b in f5_boxes))
    section(f"B1's facet mode at config 5's shape ({box[0]}x{box[1]}) and "
        "true boxes")
    facet_times = phase_facet_b1_times(f5_boxes)
    section(f"B1's facet mode in linear mode with a PSF stack a facet at "
        f"config 5's shape ({box[0]}x{box[1]}) and true boxes")
    facet_linear = phase_facet_b1_times(f5_boxes, "linear", shared=False)
    section("faceted performs on the card against the CPU")
    phase_facets_card_vs_cpu()
    section("the batched facets, IUWT and ASP spread over the cards (every "
            f"visible card; one card: {MESH_GROUPS_ON_ONE_CARD} groups on "
            "it) through Radler.perform")
    spread_cells, row_block = phase_mesh_spread(n_main)
    section("point-source contract, ASP")
    phase_asp_contract()
    section(f"ASP ({ASP_SIZE}^2 x {ASP_CHANNELS} channels) through "
        "Radler.perform")
    asp_run = phase_asp_perform()
    section("ASP on the card against the CPU")
    phase_asp_card_vs_cpu()
    section("component optimization on the card against the CPU")
    phase_component_optimization_card_vs_cpu()
    section()
    say(f"phases took {time.perf_counter() - start:.1f} s; the longest: "
        + "; ".join(f"{seconds:.1f} s {title}" for title, _, seconds in
                    sorted(_phase_log, key=lambda p: -p[2])[:12]))

    kernels = []
    b_ms, b_by = bound_ms(times["bytes"]["hogbom_step"])
    kernels.append({
        "name": "hogbom_step (select folded in)",
        "route": "cuda",
        "source": "radler_tpu_torch/csrc/hogbom_step.cu",
        "replaces": "radler_tpu/ops/pallas/hogbom_step.py:37",
        "launches": counts,
        "max_abs_err": worst["hogbom_step"],
        "ms": times["hogbom_step"][0],
        "plain_ms": times["hogbom_step"][1],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    })
    lin_bound_ms, lin_bound_by = bound_ms(linear[3])
    kernels.append({
        "name": "hogbom_step (linear, weight plane, select folded in)",
        "route": "cuda",
        "source": "radler_tpu_torch/csrc/hogbom_step.cu",
        "replaces": "radler_tpu/ops/pallas/hogbom_step.py:37",
        "launches": config3["fused"]["step"],
        "max_abs_err": linear[0],
        "ms": linear[1],
        "plain_ms": linear[2],
        "bound_ms": lin_bound_ms,
        "bound_by": lin_bound_by,
        "library_ms": None,
    })
    kernels.append({
        "name": f"subminor_loop ({b2_plan})",
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
    for mode, name in (("LOG_POLYNOMIAL", "log-polynomial"),
                       ("FORCED_TERMS", "forced terms")):
        cell = spectral[mode]
        kernels.append({
            "name": f"subminor_loop ({name}, {cell['plan']})",
            "route": "cuda",
            "source": "radler_tpu_torch/csrc/subminor_loop.cu",
            "replaces": "radler_tpu/ops/pallas/subminor_fused.py:89",
            "launches": cell["launches"],
            "max_abs_err": max(worst_fits[mode], cell["worst"]),
            "ms": cell["ms"],
            "plain_ms": cell["plain_ms"],
            "bound_ms": cell["bound"][0],
            "bound_by": cell["bound"][1],
            "library_ms": None,
        })
    tile_times = mesh_clark["times"]
    kernels.append({
        "name": "subminor_loop (tile axis, a cluster a tile)",
        "route": "cuda",
        "source": "radler_tpu_torch/csrc/subminor_loop.cu",
        "replaces": "radler_tpu/ops/pallas/subminor_fused.py:89",
        "launches": mesh_clark["launches"],
        "max_abs_err": max(mesh_clark["worst"], mesh_clark_joined["worst"]),
        "ms": tile_times["ms"],
        "plain_ms": tile_times["plain_ms"],
        "bound_ms": tile_times["bound"][0],
        "bound_by": tile_times["bound"][1],
        "library_ms": None,
    })
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
    rk_ms, rp_ms, rlib_ms, r_bytes, r_flops, r_worst = row_block
    rb_ms, rb_by = bound_ms(r_bytes, r_flops)
    kernels.append({
        "name": "atrous_rows (row-block mode, one block of "
                f"{SPREAD_DEVICES})",
        "route": "cuda",
        "source": "radler_tpu_torch/csrc/iuwt_atrous.cu",
        "replaces": "radler_tpu/ops/pallas/iuwt_atrous.py:74",
        "launches": sum(spread_cells["config 4"][0]["row_launches"].values()),
        "max_abs_err": r_worst,
        "ms": rk_ms,
        "plain_ms": rp_ms,
        "bound_ms": rb_ms,
        "bound_by": rb_by,
        "library_ms": rlib_ms,
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
    b4l_ms, b4l_plain_ms, (b4l_bound_ms, b4l_bound_by) = b4_linear
    kernels.append({
        "name": "subtract_integrate (linear, multiscale mesh)",
        "route": "cuda",
        "source": "radler_tpu_torch/csrc/subtract_integrate.cu",
        "replaces": "radler_tpu/ops/pallas/hogbom_step.py:329",
        "launches": ms_mesh[0],
        "max_abs_err": worst["subtract_integrate"],
        "ms": b4l_ms,
        "plain_ms": b4l_plain_ms,
        "bound_ms": b4l_bound_ms,
        "bound_by": b4l_bound_by,
        "library_ms": None,
    })
    f_bound_ms, f_bound_by = bound_ms(facet_times["bytes"]["step"])
    kernels.append({
        "name": "hogbom_step (facets, select folded in)",
        "route": "cuda",
        "source": "radler_tpu_torch/csrc/hogbom_step.cu",
        "replaces": "radler_tpu/ops/pallas/hogbom_step.py:37",
        "launches": batched["launches"]["facet step"],
        "max_abs_err": max(worst_facets, facet_times["max_abs_err"]),
        "ms": facet_times["step"][0],
        "plain_ms": facet_times["step"][1],
        "bound_ms": f_bound_ms,
        "bound_by": f_bound_by,
        "library_ms": None,
    })
    ms_batched = config5["multiscale, batched"]
    fl_bound_ms, fl_bound_by = bound_ms(facet_linear["bytes"]["step"])
    kernels.append({
        "name": "hogbom_step (facets, linear, select folded in)",
        "route": "cuda",
        "source": "radler_tpu_torch/csrc/hogbom_step.cu",
        "replaces": "radler_tpu/ops/pallas/hogbom_step.py:37",
        "launches": ms_batched["launches"]["facet step"],
        "max_abs_err": max(worst_facets, facet_linear["max_abs_err"]),
        "ms": facet_linear["step"][0],
        "plain_ms": facet_linear["step"][1],
        "bound_ms": fl_bound_ms,
        "bound_by": fl_bound_by,
        "library_ms": None,
    })
    say(f"config 1: {rate:.1f} minor iterations/s through perform (Högbom), "
        f"{counts} B1 launches (its select folded in); B1 "
        f"{times['hogbom_step'][0]:.4f} ms a launch, the step alone "
        f"{times['alone']:.4f} ms, against its "
        f"{bound_ms(times['bytes']['hogbom_step'])[0]:.4f} ms bound")
    say(f"config 2: {clark[1]:.1f} minor iterations/s through perform "
        f"(Clark); B2 by its plan {b2_plan}, "
        f"{kernel_ms * 1e3 / SUBMINOR_TIMED_ITERATIONS:.2f} us per iteration")
    say(f"mesh Clark: config 2 on chan 1 x tile 8 {mesh_clark['rate']:.1f} "
        f"minor iterations/s through perform (single device "
        f"{mesh_clark['single']:.1f}), K per tile {mesh_clark['counts']}; "
        f"the joined cube on chan 4 x tile 2 {mesh_clark_joined['rate']:.1f} "
        f"(single device {mesh_clark_joined['single']:.1f}); B2's tile "
        f"axis {tile_times['ms']:.4f} ms against {tile_times['sequential_ms']:.4f} "
        f"ms for today's B2 on each tile in turn, bound "
        f"{tile_times['bound'][0]:.4f} ms")
    say(f"spectral fits: {SPECTRAL_SIZE}^2 x 4 Clark " + "; ".join(
        f"{mode} {cell['rate']:.1f} minor iterations/s (K {cell['k']}, "
        f"{cell['plan']}), B2 {cell['ms'] * 1e3 / FIT_TIMED_ITERATIONS:.2f}"
        f" us an iteration against the projection's "
        f"{cell['projection_ms'] * 1e3 / FIT_TIMED_ITERATIONS:.2f}"
        for mode, cell in spectral.items())
        + f"; the mesh with a log-polynomial fit {mesh_fit['rate']:.1f}; "
        f"multiscale's Clark route with it {ms_fit['rate']:.1f}")
    b3_ms, b3_bound = atrous[3][0], bound_ms(*atrous[3][3:])[0]
    say(f"config 4: {iuwt[1]:.3f} structure iterations/s through perform "
        f"(IUWT); B3 at 4096^2, 3 scales: {b3_ms * 1e3:.1f} us against its "
        f"{b3_bound * 1e3:.1f} us bound; at config 4's most frequent "
        f"{n_main} scales: {k_ms * 1e3:.1f} us against {b_ms * 1e3:.1f} us")
    say(f"mesh: {mesh[1]:.1f} minor iterations/s through perform (4 x "
        f"4096^2, chan 4 x tile 2 on one card; single device "
        f"{mesh[2]:.1f}); B4 at [1, 2048, 4096]: {b4_ms * 1e3:.1f} us "
        f"against its {b4_bound_ms * 1e3:.1f} us bound")
    fused, dense = config3["fused"], config3["dense"]
    say(f"config 3: {fused['rate']:.1f} minor iterations/s through perform "
        f"on the fused route (kept Radler; fresh {fused['fresh']:.1f}), "
        f"{fused['syncs']} host syncs, {fused['peak_mib']:.1f} MiB; host "
        f"path dense route {dense['rate']:.1f} (fresh {dense['fresh']:.1f}), "
        f"{dense['syncs']} host syncs, {dense['peak_mib']:.1f} MiB; Clark "
        f"route {config3['clark']['rate']:.1f} (fresh "
        f"{config3['clark']['fresh']:.1f}) with {config3['clark']['b2']} "
        f"B2 launches; B1 linear at [{MS_CHANNELS}, "
        f"{MS_SIZE}, {MS_SIZE}]: {linear[1] * 1e3:.1f} us against its "
        f"{lin_bound_ms * 1e3:.1f} us bound")
    say(f"multiscale mesh: {ms_mesh[1]:.1f} minor iterations/s (4 x "
        f"{MS_SIZE}^2, chan 4 x tile 2 on one card; single device "
        f"{ms_mesh[2]:.1f}); B4 linear at [1, {MS_SIZE // 2}, {MS_SIZE}]: "
        f"{b4l_ms * 1e3:.1f} us against its {b4l_bound_ms * 1e3:.1f} us "
        "bound")
    say("config 5: " + "; ".join(
        f"{label} {run['rate']:.1f} minor iterations/s summed over the "
        f"facets (facet 0: {run['first']} iterations), {run['syncs']} host "
        f"syncs, {run['peak_mib']:.1f} MiB"
        for label, run in config5.items())
        + f"; the batched route's lockstep iterations {batched['lockstep']} "
        f"for {sum(batched['iterations'])} facet iterations; B1's facet "
        f"step at [4, 8, {box[0]}, {box[1]}] {facet_times['step'][0]:.4f} ms "
        f"against its {bound_ms(facet_times['bytes']['step'])[0]:.4f} ms "
        f"bound; with one facet at config 1's shape {facet_one[0]:.4f} ms "
        f"against B1's {facet_one[1]:.4f}; multiscale batched "
        f"{ms_batched['passes']} lockstep passes, B1's facet step in linear "
        f"mode with a PSF stack a facet {facet_linear['step'][0]:.4f} ms "
        f"against its {fl_bound_ms:.4f} ms bound")
    say("mesh over cards: " + "; ".join(
        f"{label} over {len(cell['groups'])} groups "
        f"({len(set(cell['groups']))} cards) {cell['ms']:.4f} ms an "
        f"iteration (one group {cell['one_ms']:.4f}, one device "
        f"{cell['single_ms']:.4f}), launches by card "
        f"{dict(sorted(cell['launches'].items()))}"
        for label, cell in cards.items()))
    say("spread over the cards: " + "; ".join(
        f"{label} {run['seconds']:.3f} s a perform over "
        f"{len(run['mesh'].devices)} groups (one group {one['seconds']:.3f} "
        f"s), lockstep {run['lockstep']} ({one['lockstep']}), peak MiB by "
        f"card {[round(p, 1) for p in run['peaks']]} (one group "
        f"{[round(p, 1) for p in one['peaks']]})"
        for label, (run, one) in spread_cells.items())
        + f"; B3's row-block mode at {IUWT_SIZE}^2, {n_main} scales, one "
        f"block of {SPREAD_DEVICES}: {rk_ms:.4f} ms against its "
        f"{rb_ms:.4f} ms bound")
    say(f"ASP: {asp_run['rate']:.1f} minor iterations/s through perform "
        f"({ASP_CHANNELS} x {ASP_SIZE}^2, point grid), {asp_run['syncs']} "
        f"host syncs, {asp_run['peak_mib']:.1f} MiB")
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
