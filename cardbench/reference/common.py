"""Arithmetic that the references share: fused multiply-adds rounded once,
weighted sums in plane order, peak search, padded FFT convolution, the
spectral fit's constants and the cube's channel coefficients.

In float32 every function does what Radler's definition does in the order
that fixes its rounding (a fused multiply-add is rounded once, as CUDA's
``__fmaf_rn``).  In a lower precision (the control) the same formulas run
in that type with plain products and sums.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

FLT_MIN = float(np.finfo(np.float32).tiny)


def f32(v) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once.  In float32: the product is exact in
    float64, and the float64 sum, rounded twice (to float64, then float32),
    differs from one rounding only when it lies half-way between two
    float32 values while the exact sum does not; its exact error (TwoSum)
    settles that case.  Other types round the product and the sum."""
    if a.dtype != torch.float32:
        return a * b + c
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    back = s - p
    err = (p - (s - back)) + (c64 - back)
    r = s.float()
    r64 = r.double()
    toward = torch.where(s > r64, np.inf, -np.inf).to(torch.float32)
    other = torch.nextafter(r, toward)
    tie = (s != r64) & (s == (r64 + other.double()) * 0.5) & (err != 0.0)
    past = (err > 0.0) == (other.double() > r64)
    return torch.where(tie & past, other, r)


def integrate(planes: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """``sum_i planes[i] * coef[i]`` in plane order, the first a product and
    each further term one fused multiply-add."""
    s = planes[0] * coef[0]
    for i in range(1, planes.shape[0]):
        s = fma(planes[i], coef[i], s)
    return s


def good_fft_size(minimum: int) -> int:
    """The smallest even 2^a 3^b 5^c 7^d (a >= 1) at or above ``minimum``."""
    if minimum <= 2:
        return 2
    n = minimum + (minimum % 2)
    while True:
        m = n // 2
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 2


def untrim(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``image`` zero-padded into (height, width), its centre pixel on the
    canvas's centre pixel."""
    h, w = image.shape[-2:]
    top = height // 2 - h // 2
    left = width // 2 - w // 2
    return F.pad(image, (left, width - w - left, top, height - h - top))


def trim(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    h, w = image.shape[-2:]
    top = h // 2 - height // 2
    left = w // 2 - width // 2
    return image[..., top:top + height, left:left + width]


def kernel_spectrum(kernel: torch.Tensor, shape: Tuple[int, int]
                    ) -> torch.Tensor:
    """rfft2 of ``kernel`` with its centre pixel moved to the origin."""
    h, w = kernel.shape[-2:]
    rolled = torch.roll(kernel, (-(h // 2), -(w // 2)), dims=(-2, -1))
    return torch.fft.rfft2(rolled, s=tuple(shape))


def padded_convolve(image: torch.Tensor, kernel: torch.Tensor,
                    padded: Tuple[int, int]) -> torch.Tensor:
    """The linear convolution of ``image`` with the centred ``kernel``
    (both zero-padded to ``padded``), cut back to the image's size.  FFTs
    run in float32 whatever the type."""
    h, w = image.shape[-2:]
    ph, pw = padded
    dtype = image.dtype
    spec = (torch.fft.rfft2(untrim(image.float(), ph, pw))
            * kernel_spectrum(untrim(kernel.float(), ph, pw), (ph, pw)))
    out = torch.fft.irfft2(spec, s=(ph, pw)).to(dtype)
    return trim(out, h, w)


def find_peak(image: torch.Tensor) -> Tuple[float, int, int, bool]:
    """The first pixel of largest magnitude: (signed value, x, y, found),
    read to the host once."""
    h, w = image.shape
    idx = torch.argmax(image.abs().reshape(-1))
    value = image.reshape(-1)[idx]
    found = value.abs() > FLT_MIN
    v, fnd, x, y = torch.stack([value.float(), found.float(),
                                (idx % w).float(), (idx // w).float()]
                               ).tolist()
    return v, int(x), int(y), bool(fnd)


class Channels:
    """The joined channels' constants: each channel's centre frequency and
    weight, the linear join's coefficients and the spectral fit's design,
    fit matrix, projection and normalised weights (weighted least squares in
    nu/nu_ref - 1, or in log(nu/nu_ref) for the log-polynomial fit, nu_ref
    the weighted mean frequency)."""

    def __init__(self, frequencies: np.ndarray, weights: np.ndarray,
                 fit_mode: str, terms: int):
        freq = np.asarray(frequencies, np.float64).mean(axis=1)
        w = np.asarray(np.asarray(weights, np.float32), np.float64)
        self.weights = w
        self.coefficients = (w / w.sum()).astype(np.float32)
        ref = float((freq * w).sum() / w.sum())
        ratio = freq / ref
        x = np.log(ratio) if fit_mode == "LOG_POLYNOMIAL" else ratio - 1.0
        terms = min(terms, len(freq))
        self.design = np.stack([x**t for t in range(terms)], axis=1)
        wd = self.design * w[:, None]
        self.fit_matrix = np.linalg.solve(self.design.T @ wd, wd.T)
        self.projection = self.design @ self.fit_matrix
        self.mean_weights = w / max(w.sum(), 1e-300)

    def on(self, name: str, device) -> torch.Tensor:
        """A constant as float32 on ``device``."""
        return torch.as_tensor(np.ascontiguousarray(getattr(self, name),
                                                    np.float32),
                               device=device)


def finished(value, iterations_done: bool, threshold: float,
             major_threshold: float) -> bool:
    """Whether a major iteration asks for another one: its last peak
    ``value`` reached the major threshold, not the final one, and it did
    work."""
    if value is None:
        return False
    final = abs(value) <= threshold or value == 0.0
    return (abs(value) <= major_threshold) and iterations_done and not final


def ceil_padded(width: int, height: int, padding: float) -> Tuple[int, int]:
    """(height, width) of a padded convolution: ceil(padding * side), up to
    an even 7-smooth size."""
    return (good_fft_size(int(math.ceil(padding * height))),
            good_fft_size(int(math.ceil(padding * width))))
