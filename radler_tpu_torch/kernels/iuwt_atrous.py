"""The low scales of the à-trous IUWT: CUDA kernel B3 and its plain version.

Port of ``radler_tpu.ops.pallas.iuwt_atrous`` (the TPU kernel
``_atrous_kernel`` behind ``atrous_decompose_lo``).
:func:`atrous_decompose_lo` decomposes an image, or a batch of images, into
the wavelet planes of scales ``0..n_lo-1`` and the smooth plane that carries
on to scale ``n_lo``.  On CUDA tensors it launches ``csrc/iuwt_atrous.cu``
as :func:`launch_plan` says: the lowest ``FUSED_SCALES`` scales in one
launch on contiguous tiles with a halo of :func:`cascade_reach`, then one
launch per scale on tiles of the scale's lattice.  On CPU tensors it runs
:func:`atrous_decompose_lo_reference`, the plain PyTorch version, which
performs the same float32 operations in the same order, so the two agree
bit for bit.  What bounds the kernel, and its design, are in the note at
the top of the CUDA source.
"""

from __future__ import annotations

import collections
import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .hogbom_step import _check, _raise_on

# B3-spline taps [1, 4, 6, 4, 1] / 16 (iuwt_decomposition.h:243-261).
TAPS = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
# The most scales one call takes: dilation 2^(s+1) - 1 stays an int and the
# launch grid within its limits.
MAX_SCALES = 14


def dilation(scale: int) -> int:
    """Tap spacing of decomposition scale ``scale`` (``2^(scale+1) - 1``)."""
    return (1 << (scale + 1)) - 1


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _shifted(image: torch.Tensor, dist: int, axis: int) -> torch.Tensor:
    """out[i] = image[i + dist] along ``axis``, zero-filled (the reference's
    dropped taps)."""
    if dist == 0:
        return image
    n = image.shape[axis]
    pad = [0, 0] * (image.ndim - axis % image.ndim)
    pad[-2 if dist < 0 else -1] = abs(dist)
    padded = F.pad(image, pad)
    start = dist if dist > 0 else 0
    return padded.narrow(axis, start, n)


def _conv_axis(image: torch.Tensor, scale: int, axis: int) -> torch.Tensor:
    """1-D B3-spline pass with tap spacing ``2^scale - 1``: the centre tap
    first, then the taps at -2d, -d, +d, +2d."""
    d = (1 << scale) - 1
    out = TAPS[2] * image
    for h in (0, 1, 3, 4):
        out = out + TAPS[h] * _shifted(image, (h - 2) * d, axis)
    return out


def iuwt_convolve(image: torch.Tensor, scale: int) -> torch.Tensor:
    """Separable smoothing at one scale (``iuwt_decomposition.h:243-261``):
    the horizontal pass, then the vertical one.  ``scale`` is the
    reference's ``convolve`` argument (decomposition scale s uses s + 1)."""
    return _conv_axis(_conv_axis(image, scale, -1), scale, -2)


def atrous_decompose_lo_reference(
    image: torch.Tensor,
    n_lo: int,
    *,
    w: Optional[torch.Tensor] = None,
    smooth: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`atrous_decompose_lo`: per scale s,
    ``i1 = C(i0)``, ``w[s] = i0 - C(i1)``, then ``i0 = i1``."""
    if w is None:
        w = image.new_empty((n_lo, *image.shape))
    cur = image
    for s in range(n_lo):
        i1 = iuwt_convolve(cur, s + 1)
        torch.sub(cur, iuwt_convolve(i1, s + 1), out=w[s])
        cur = i1
    if smooth is None:
        return w, cur
    smooth.copy_(cur)
    return w, smooth


# ---------------------------------------------------------------------------
# Launch plan
# ---------------------------------------------------------------------------

# Scales of the fused first launch.  Two read one plane and write three,
# the function's bound; a third lost on the card (0.48 against 0.30 ms for
# three scales at 4096^2: its halo of 36 leaves one block per SM), PERF.md.
FUSED_SCALES = 2
# Core of a contiguous tile, rows by columns (Fused::kRows, kCols).
FUSED_CORE = (64, 64)
# The lattice tiles of the CUDA source, as (phases, side): `phases`
# neighbouring x-phases (at most the dilation) of side x side lattice
# points, the largest side whose buffer (with the halo of 4 points) leaves
# room for two blocks per SM.  At dilations of 31 and more, runs of 16
# phases (64 bytes) with 16 x 16 points, whose halo makes the buffer 2.25
# times the tile, beat runs of 32 (one 128-byte line) with 9 x 9 points
# (3.6 times) by 12 to 25% on the card, except on a lattice shorter than
# SHORT_LATTICE points, where the larger tile is mostly padding (0.57
# against 0.28 ms at 4096^2 and dilation 511, a lattice of 9); PERF.md.
LATTICE_TILES = ((7, 28), (15, 17), (16, 16), (32, 9))
SHORT_LATTICE = 12
# Shared memory a block may hold on the card.
SHARED_BYTES_PER_BLOCK = 232_448


def cascade_reach(n_lo: int) -> int:
    """Total tap reach (per side, per axis) of scales ``0..n_lo-1``: the
    halo a tile needs to emit all their planes.  Plane s needs the chain of
    one convolution per earlier scale (reach ``2 d_k`` each) and two
    convolutions at its own dilation (``4 d_s``)."""
    reach = carried = 0
    for s in range(n_lo):
        d = dilation(s)
        reach = max(reach, carried + 4 * d)
        carried += 2 * d
    return reach


class Launch(NamedTuple):
    """One launch of B3: ``n_scales`` scales from ``first_scale`` on.  A
    fused launch (``lattice`` false) has cores of ``rows x cols`` pixels; a
    lattice launch tiles of ``rows x cols`` lattice points and ``phases``
    neighbouring x-phases.  ``shared_bytes`` is the dynamic shared memory
    the entry point will ask for (three buffers)."""

    first_scale: int
    n_scales: int
    lattice: bool
    rows: int
    cols: int
    phases: int
    shared_bytes: int


def _fused_launch(n_scales: int) -> Launch:
    rows, cols = FUSED_CORE
    halo = cascade_reach(n_scales)
    stride = (cols + 2 * halo) | 1
    return Launch(0, n_scales, False, rows, cols, 1,
                  3 * (rows + 2 * halo) * stride * 4)


def lattice_tile(d: int, points: int) -> Tuple[int, int]:
    """(phases, side) of the tile for dilation ``d`` (7 or more) on a
    lattice whose shorter side has ``points`` points."""
    if d <= 15:
        return next(tile for tile in LATTICE_TILES if tile[0] == d)
    if d >= 32 and points < SHORT_LATTICE:
        return LATTICE_TILES[3]
    return LATTICE_TILES[2]


def _lattice_launch(scale: int, height: int, width: int) -> Launch:
    d = dilation(scale)
    phases, side = lattice_tile(d, min(-(-height // d), -(-width // d)))
    stride = ((side + 8) * phases) | 1
    return Launch(scale, 1, True, side, side, phases,
                  3 * (side + 8) * stride * 4)


def launch_plan(n_lo: int, height: int, width: int) -> List[Launch]:
    """The launches that decompose a ``height x width`` image into ``n_lo``
    scales: ``min(n_lo, FUSED_SCALES)`` scales fused, then one lattice
    launch per scale."""
    first = min(n_lo, FUSED_SCALES)
    plan = [_fused_launch(first)]
    plan += [_lattice_launch(s, height, width) for s in range(first, n_lo)]
    return plan


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _entries():
    """The kernel's two C entry points, with their signatures declared."""
    from . import _build

    lib = _build.library()
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.atrous_fused.argtypes = [ptr] * 3 + [i32] * 3 + [i64] + [i32] * 3 + [
        ptr]
    lib.atrous_scale.argtypes = [ptr] * 3 + [i32] * 8 + [ptr]
    lib.atrous_fused.restype = lib.atrous_scale.restype = i32
    return lib.atrous_fused, lib.atrous_scale


def _launch(step: Launch, image: torch.Tensor, w: torch.Tensor,
            smooth: torch.Tensor, scale_stride: int, batch: int, height: int,
            width: int, out0: int, out_rows: int, stream) -> int:
    """One launch of the plan: its scales of ``image`` (``batch`` planes of
    ``height x width``), rows ``[out0, out0 + out_rows)`` written into
    ``w`` (the first scale's plane; the others ``scale_stride`` apart) and
    ``smooth``.  Returns the entry point's CUDA error code."""
    fused, per_scale = _entries()
    if step.lattice:
        return per_scale(image.data_ptr(), w.data_ptr(), smooth.data_ptr(),
                         batch, height, width, dilation(step.first_scale),
                         step.phases, step.rows, out0, out_rows, stream)
    return fused(image.data_ptr(), w.data_ptr(), smooth.data_ptr(), batch,
                 height, width, scale_stride, step.n_scales, out0, out_rows,
                 stream)


def atrous_decompose_lo(
    image: torch.Tensor,
    n_lo: int,
    *,
    w: Optional[torch.Tensor] = None,
    smooth: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wavelet planes of scales ``0..n_lo-1`` and the carried smooth plane.

    ``image`` is ``[H, W]`` or ``[B, H, W]`` float32, contiguous.  Returns
    ``(w [n_lo, *lead, H, W], smooth [*lead, H, W])``, written into ``w``
    and ``smooth`` when they are given (contiguous, of those shapes), so
    that a caller can place the planes inside a larger coefficient stack.
    """
    if image.device.type == "cpu":
        return atrous_decompose_lo_reference(image, n_lo, w=w, smooth=smooth)
    if image.device.type != "cuda":
        raise ValueError(f"atrous_decompose_lo: unsupported device {image.device}")
    if image.ndim not in (2, 3) or not 1 <= n_lo <= MAX_SCALES:
        raise ValueError(
            f"atrous_decompose_lo: bad image shape {tuple(image.shape)} or "
            f"scale count {n_lo} (1..{MAX_SCALES})"
        )
    height, width = image.shape[-2:]
    batch = image.shape[0] if image.ndim == 3 else 1
    if not (0 < batch <= 65535 and height * width * batch < 2**31
            and height > 0 and width > 0):
        raise ValueError(
            f"atrous_decompose_lo: bad image shape {tuple(image.shape)}"
        )
    dev, f32 = image.device, torch.float32
    _check(image, "image", dev, image.shape, f32)
    if w is None:
        w = torch.empty((n_lo, *image.shape), dtype=f32, device=dev)
    if smooth is None:
        smooth = torch.empty_like(image)
    _check(w, "w", dev, (n_lo, *image.shape), f32)
    _check(smooth, "smooth", dev, image.shape, f32)
    plan = launch_plan(n_lo, height, width)
    # Each launch reads the plane the one before it carried: the last
    # writes `smooth`, the others two planes in turn.
    carried = [torch.empty_like(image) for _ in range(min(2, len(plan) - 1))]
    cur = image
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, step in enumerate(plan):
            dst = smooth if i == len(plan) - 1 else carried[i % 2]
            first = w[step.first_scale]
            err = _launch(step, cur, w[step.first_scale], dst, w.stride(0),
                          batch, height, width, 0, height, stream)
            _raise_on(err, "atrous_decompose_lo")
            atrous_decompose_lo.launches += 1
            cur = dst
    return w, smooth


atrous_decompose_lo.launches = 0


# ---------------------------------------------------------------------------
# Row-block mode
# ---------------------------------------------------------------------------


def launch_reach(step: Launch) -> int:
    """The rows of halo a launch's block needs on each side of the rows it
    writes: the cascade's reach of a fused launch, four taps at the
    dilation of a lattice launch (two convolutions of reach 2d each)."""
    if step.lattice:
        return 4 * dilation(step.first_scale)
    return cascade_reach(step.n_scales)


def atrous_rows_reference(block: torch.Tensor, step: Launch, out0: int,
                          out_rows: int, w: torch.Tensor,
                          smooth: torch.Tensor) -> None:
    """Plain version of :func:`atrous_rows`: the launch's scales of the
    block taken as an image (zero beyond its edges), rows ``[out0, out0 +
    out_rows)`` copied out.  Each of those rows reads only the block's rows
    within :func:`launch_reach`, through the taps of the whole-image
    decompose in the same order, so it holds the whole image's bits."""
    cur = block
    for t, s in enumerate(range(step.first_scale,
                                step.first_scale + step.n_scales)):
        i1 = iuwt_convolve(cur, s + 1)
        w[t].copy_(torch.sub(cur, iuwt_convolve(i1, s + 1)).narrow(
            -2, out0, out_rows))
        cur = i1
    smooth.copy_(cur.narrow(-2, out0, out_rows))


def atrous_rows(block: torch.Tensor, step: Launch, out0: int, out_rows: int,
                w: torch.Tensor, smooth: torch.Tensor) -> None:
    """B3's row-block mode: one launch of the plan (:func:`launch_plan` of
    the whole image) on ``block``, a ``[*lead, Hb, W]`` block of an image's
    rows, writing its rows ``[out0, out0 + out_rows)``: each scale's plane
    into ``w`` (``[n_scales, *lead, out_rows, W]``, contiguous planes) and
    the carried plane into ``smooth`` (``[*lead, out_rows, W]``).  The
    block holds those rows with :func:`launch_reach` rows on each side,
    clipped to the image, so that the zero boundary lies at the image's
    true top and bottom and nowhere else.  On CPU tensors it runs
    :func:`atrous_rows_reference`."""
    if block.device.type == "cpu":
        atrous_rows_reference(block, step, out0, out_rows, w, smooth)
        return
    if block.device.type != "cuda":
        raise ValueError(f"atrous_rows: unsupported device {block.device}")
    height, width = block.shape[-2:]
    batch = block.shape[0] if block.ndim == 3 else 1
    if not (block.ndim in (2, 3) and 0 < batch <= 65535
            and height * width * batch < 2**31 and 0 <= out0
            and 0 < out_rows and out0 + out_rows <= height):
        raise ValueError(f"atrous_rows: bad block {tuple(block.shape)} or "
                         f"rows [{out0}, {out0 + out_rows})")
    dev, f32 = block.device, torch.float32
    out_shape = (*block.shape[:-2], out_rows, width)
    _check(block, "block", dev, block.shape, f32)
    _check(w, "w", dev, (step.n_scales, *out_shape), f32)
    _check(smooth, "smooth", dev, out_shape, f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launch(step, block, w[0], smooth, w.stride(0), batch, height,
                      width, out0, out_rows, stream)
    _raise_on(err, "atrous_rows")
    atrous_rows.launches += 1
    atrous_rows.launches_by_card[dev.index] += 1


atrous_rows.launches = 0
atrous_rows.launches_by_card = collections.Counter()
