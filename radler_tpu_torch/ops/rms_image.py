"""Local-RMS maps and sliding-window extrema.

Port of ``radler_tpu.ops.rms_image`` (``cpp/math/rms_image.{h,cc}`` plus the
Gaussian-beam convolution of schaapcommon's ``RestoreImage`` used by it).
The windowed RMS is a Gaussian-weighted mean of squares computed with one
padded FFT convolution; the sliding minimum is separable and clips at the
edges exactly like the reference's scalar loops.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .convolution import padded_convolve

_FWHM_TO_SIGMA = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))


def gaussian_beam_kernel(
    height: int,
    width: int,
    beam_major: float,
    beam_minor: float,
    beam_pa: float,
    pixel_scale_l: float,
    pixel_scale_m: float,
) -> np.ndarray:
    """Unit-peak elliptical Gaussian centered at (H//2, W//2); beam axes are
    FWHM in radians.  Pixel offsets are scaled per axis, so non-square pixels
    give the correctly shaped ellipse."""
    sigma_maj = max(beam_major * _FWHM_TO_SIGMA, 1e-30)
    sigma_min = max(beam_minor * _FWHM_TO_SIGMA, 1e-30)
    ys = (np.arange(height) - height // 2) * pixel_scale_m
    xs = (np.arange(width) - width // 2) * pixel_scale_l
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    cos_pa, sin_pa = np.cos(beam_pa), np.sin(beam_pa)
    xr = xx * cos_pa - yy * sin_pa
    yr = xx * sin_pa + yy * cos_pa
    arg = (xr / sigma_maj) ** 2 + (yr / sigma_min) ** 2
    return np.exp(-0.5 * arg).astype(np.float32)


def make_rms_image(
    image: torch.Tensor,
    window_size: float,
    beam_major: float,
    beam_minor: float,
    beam_pa: float,
    pixel_scale_l: float,
    pixel_scale_m: float,
) -> torch.Tensor:
    """Local RMS = sqrt(Gaussian-window mean of squares)
    (``cpp/math/rms_image.cc:16-34``)."""
    h, w = image.shape
    kernel = gaussian_beam_kernel(
        h,
        w,
        beam_major * window_size,
        beam_minor * window_size,
        beam_pa,
        pixel_scale_l,
        pixel_scale_m,
    )
    conv = padded_convolve(
        image * image, torch.as_tensor(kernel, device=image.device)
    )
    s = math.sqrt(2.0 * math.pi)
    sigma_maj = beam_major * _FWHM_TO_SIGMA
    sigma_min = beam_minor * _FWHM_TO_SIGMA
    norm = 1.0 / (
        s
        * sigma_maj
        / pixel_scale_l
        * window_size
        * s
        * sigma_min
        / pixel_scale_l
        * window_size
    )
    return torch.sqrt(torch.clamp_min(conv * float(np.float32(norm)), 0.0))


def sliding_minimum(image: torch.Tensor, window_size: int) -> torch.Tensor:
    """Separable sliding minimum with edge clipping
    (``cpp/math/rms_image.cc:36-70``): the window around pixel i spans
    ``[i - window//2, i + window - window//2 - 1]``, cut at the image edges
    (the JAX package's ``lax.reduce_window`` with a ``+inf`` init)."""
    half = window_size // 2
    pad = (half, window_size - half - 1)

    def min_along_last(x: torch.Tensor) -> torch.Tensor:
        padded = F.pad(x, pad, value=math.inf)
        return padded.unfold(-1, window_size, 1).amin(dim=-1)

    rows = min_along_last(image)
    return min_along_last(rows.transpose(0, 1)).transpose(0, 1).contiguous()


def sliding_maximum(image: torch.Tensor, window_size: int) -> torch.Tensor:
    """``cpp/math/rms_image.cc:72-77``."""
    return -sliding_minimum(-image, window_size)


def make_with_negativity_limit(
    image: torch.Tensor,
    window_size: float,
    beam_major: float,
    beam_minor: float,
    beam_pa: float,
    pixel_scale_l: float,
    pixel_scale_m: float,
) -> torch.Tensor:
    """RMS map floored at 0.3x the |sliding minimum|
    (``cpp/math/rms_image.cc:79-93``)."""
    rms = make_rms_image(
        image,
        window_size,
        beam_major,
        beam_minor,
        beam_pa,
        pixel_scale_l,
        pixel_scale_m,
    )
    beam_in_pixels = max(beam_major / pixel_scale_l, 1.0)
    win = max(int(window_size * beam_in_pixels), 1)
    smin = sliding_minimum(image, win)
    return torch.maximum(rms, smin.abs() * float(np.float32(1.5 / 5.0)))


def make_rms_factor_image(
    rms_image: torch.Tensor, local_rms_strength: float
) -> Tuple[torch.Tensor, float]:
    """Convert an RMS map into a multiplicative peak-finding factor
    (``cpp/math/rms_image.cc:95-123``).  Returns (factor_image, lowest_rms)."""
    stddev = float(rms_image.min())
    if stddev < 0.0:
        raise RuntimeError(
            "RMS image can only contain values >= 0, but contains values < 0.0"
        )
    if local_rms_strength == 0.0:
        return torch.ones_like(rms_image), stddev
    nonzero = rms_image != 0.0
    ratio = torch.where(nonzero, stddev / rms_image, 0.0)
    if local_rms_strength != 1.0:
        ratio = torch.where(nonzero, ratio**local_rms_strength, 0.0)
    return ratio, stddev
