"""Multiscale CLEAN scale kernels and the scale convolution.

Port of ``radler_tpu.ops.multiscale_kernels``
(``cpp/algorithms/multiscale/multiscale_transforms.{h,cc}``):

* tapered-quadratic kernel ``(1 - (r/alpha)^2) * Hann`` with kernel size
  ``2*ceil(scale/2) + 1`` (``multiscale_transforms.h:163-195``);
* Gaussian kernel with ``sigma = 3/16 * scale`` and a 12-sigma bounding box
  (``multiscale_transforms.h:127-161``); both sum-normalized.

The kernels are made on the host in NumPy.  Scale convolution happens at
the image's own size (circular FFT, no extra padding,
``multiscale_transforms.cc:11-23``) on tensors of any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..settings import MultiscaleShape
from .convolution import convolve_same


def gaussian_sigma(scale_in_pixels: float) -> float:
    """``multiscale_transforms.h:107-109``."""
    return scale_in_pixels * (3.0 / 16.0)


def tapered_quadratic_kernel_size(scale_in_pixels: float) -> int:
    return int(math.ceil(scale_in_pixels * 0.5) * 2.0) + 1


def make_shape_function(
    scale_in_pixels: float, max_n: int, shape: MultiscaleShape
) -> np.ndarray:
    """Sum-normalized [n, n] scale kernel (``MakeShapeFunction``)."""
    if shape == MultiscaleShape.GAUSSIAN:
        return _gaussian_kernel(scale_in_pixels, max_n)
    return _tapered_quadratic_kernel(scale_in_pixels)


def _tapered_quadratic_kernel(scale: float) -> np.ndarray:
    n = tapered_quadratic_kernel_size(scale)
    out = np.zeros((n, n), dtype=np.float32)
    if scale == 0.0:
        out[0, 0] = 1.0
        return out
    ys = np.arange(n, dtype=np.float64) - 0.5 * (n - 1)
    xs = np.arange(n, dtype=np.float64) - 0.5 * (n - 1)
    r = np.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2)
    hann = np.where(
        r * 2 <= n + 1, 0.5 * (1.0 + np.cos(2.0 * math.pi * r / (n + 1))), 0.0
    )
    x = r / scale
    quad = np.where(x < 1.0, 1.0 - x * x, 0.0)
    out = (hann * quad).astype(np.float32)
    return out / out.sum()


def _gaussian_kernel(scale: float, max_n: int) -> np.ndarray:
    sigma = gaussian_sigma(scale)
    n = int(math.ceil(sigma * 12.0 / 2.0)) * 2 + 1  # 12-sigma bounding box
    if n > max_n:
        n = max_n
        if n % 2 == 0 and n > 0:
            n -= 1
    n = max(n, 1)
    if sigma == 0.0:
        sigma = 1.0
        n = 1
    mu = float(n // 2)
    v = np.arange(n, dtype=np.float64) - mu
    g = np.exp(-v * v / (2.0 * sigma * sigma))
    out = np.outer(g, g)
    return (out / out.sum()).astype(np.float32)


def kernel_peak_value(
    scale_in_pixels: float, max_n: int, shape: MultiscaleShape
) -> float:
    """``multiscale_transforms.h:56-60``."""
    k = make_shape_function(scale_in_pixels, max_n, shape)
    n = k.shape[0]
    return float(k[n // 2, n // 2])


def embedded_kernel(
    scale_in_pixels: float, height: int, width: int, shape: MultiscaleShape
) -> np.ndarray:
    """The scale kernel zero-padded (centered) to the full image size, ready
    for circular convolution via :func:`scale_convolve`."""
    k = make_shape_function(scale_in_pixels, min(width, height), shape)
    h, w = k.shape
    out = np.zeros((height, width), k.dtype)
    top = height // 2 - h // 2
    left = width // 2 - w // 2
    out[top : top + h, left : left + w] = k
    return out


def scale_convolve(
    images: torch.Tensor, kernel_full: torch.Tensor
) -> torch.Tensor:
    """Convolve image(s) with an embedded scale kernel at image size
    (circular, like ``MultiScaleTransforms::Transform``)."""
    return convolve_same(images, kernel_full)


def add_shape_component(
    image: torch.Tensor,
    scale_in_pixels: float,
    x: int,
    y: int,
    gain: float,
    shape: MultiscaleShape,
) -> torch.Tensor:
    """A copy of ``image`` with ``gain x kernel`` stamped in at (x, y),
    clipped at the borders (``multiscale_transforms.h:62-89``)."""
    h, w = image.shape
    k = make_shape_function(scale_in_pixels, min(w, h), shape)
    n = k.shape[0]
    left = max(int(x) - n // 2, 0)
    top = max(int(y) - n // 2, 0)
    right = min(int(x) + (n + 1) // 2, w)
    bottom = min(int(y) + (n + 1) // 2, h)
    k_slice = k[
        top + n // 2 - int(y) : bottom + n // 2 - int(y),
        left + n // 2 - int(x) : right + n // 2 - int(x),
    ]
    out = image.clone()
    out[top:bottom, left:right] += gain * torch.as_tensor(
        k_slice, device=image.device
    )
    return out
