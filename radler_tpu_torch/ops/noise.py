"""Noise estimation: median and MAD-based standard deviation.

Port of ``radler_tpu.ops.noise``: ``median_and_stddev_from_mad``, the
equivalent of ``aocommon::Image::MedianAndStdDevFromMAD`` as used by
``Radler::Perform`` (``cpp/radler.cc:162-169``), and ``mad_sigma_batched``,
the IUWT's per-scale sigma.  A sort of the finite pixels picks the same
order statistics as the JAX package's bisection over the float bit patterns,
so the two agree bit for bit.  The sort, and not ``torch.kthvalue``: on an
NVIDIA H100 80GB HBM3 (700 W power limit) at 4096^2 one ``kthvalue`` took
127 ms, and the four of them half of a 5000-iteration major iteration
(see PERF.md).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Consistency constant: stddev = MAD * 1 / Phi^-1(3/4).
MAD_TO_SIGMA = 1.4826


def _median(values: torch.Tensor) -> torch.Tensor:
    """Mean of the two middle order statistics of a non-empty 1-D tensor."""
    n = values.numel()
    ordered = torch.sort(values).values
    return 0.5 * (ordered[(n - 1) // 2] + ordered[n // 2])


def median_and_stddev_from_mad(
    image: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (median, sigma) with sigma = 1.4826 x median(|x - median|).

    Non-finite pixels are ignored (they carry zero weight in the reference's
    averaging and must not poison the noise estimate).
    """
    flat = image.reshape(-1)
    finite = flat[torch.isfinite(flat)]
    if finite.numel() == 0:
        zero = torch.zeros((), dtype=image.dtype, device=image.device)
        return zero, zero.clone()
    med = _median(finite)
    mad = _median((finite - med).abs())
    return med, mad * float(np.float32(MAD_TO_SIGMA))


# sigma = median(|x|) / Phi^-1(3/4), the IUWT's estimator
# (iuwt_deconvolution_algorithm.cc:104-110), applied as XLA compiles the
# JAX package's division by the constant: a product with its float32
# reciprocal.
_MEDIAN_ABS_TO_SIGMA = float(np.float32(1.0) / np.float32(0.674559))


def mad_sigma_batched(planes: torch.Tensor) -> torch.Tensor:
    """Per-plane sigma of a ``[S, ...]`` stack: the element at index n // 2
    of each plane's sorted |x| (the upper middle, not a mean of two) over
    0.674559; bit-equal to the JAX package's bisection."""
    flat = planes.reshape(planes.shape[0], -1).abs()
    middle = torch.sort(flat, dim=1).values[:, flat.shape[1] // 2]
    return middle * _MEDIAN_ABS_TO_SIGMA
