"""The low scales of the à-trous IUWT: CUDA kernel B3 and its plain version.

Port of ``radler_tpu.ops.pallas.iuwt_atrous`` (the TPU kernel
``_atrous_kernel`` behind ``atrous_decompose_lo``).
:func:`atrous_decompose_lo` decomposes an image, or a batch of images, into
the wavelet planes of scales ``0..n_lo-1`` and the smooth plane that carries
on to scale ``n_lo``.  On CUDA tensors it launches ``csrc/iuwt_atrous.cu``
once per scale; on CPU tensors it runs :func:`atrous_decompose_lo_reference`,
the plain PyTorch version, which performs the same float32 operations in the
same order, so the two agree bit for bit.  What bounds the kernel, and why
it runs one launch per scale, is in the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
# Kernel wrapper
# ---------------------------------------------------------------------------


def _entry():
    """The kernel's C entry point, with its signature declared."""
    from . import _build

    fn = _build.library().atrous_scale
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


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
    launch = _entry()
    cur = image
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s in range(n_lo):
            dst = smooth if s == n_lo - 1 else torch.empty_like(image)
            err = launch(cur.data_ptr(), w[s].data_ptr(), dst.data_ptr(),
                         batch, height, width, dilation(s), stream)
            _raise_on(err, "atrous_decompose_lo")
            atrous_decompose_lo.launches += 1
            cur = dst
    return w, smooth


atrous_decompose_lo.launches = 0
