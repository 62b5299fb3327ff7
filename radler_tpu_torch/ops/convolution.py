"""FFT convolution primitives and centered trim/untrim.

Port of ``radler_tpu.ops.convolution`` (the schaapcommon FFTW path of the
reference: ``PrepareConvolutionKernel`` + ``Convolve`` +
``PaddedConvolution``, called from ``cpp/algorithms/subminor_loop.cc:195-218``
and the local-RMS maps).

All convolutions here are *centered*: the kernel's origin is pixel
``(H//2, W//2)``, matching the reference's PSF conventions.  Images are
zero-padded to a 7-smooth size to avoid wrap-around, convolved with
``torch.fft.rfft2``/``irfft2`` (cuFFT on the card), batched over every
leading dimension, and trimmed back.  The JAX package's matmul FFT and its
per-plane inverse are TPU workarounds and are not carried.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.fft_size import calculate_good_fft_size


def untrim(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Zero-pad ``image`` centered into a (height, width) canvas.

    Equivalent of ``aocommon::Image::Untrim``: the input center pixel
    ``(h//2, w//2)`` lands on the output center pixel ``(H//2, W//2)``.
    """
    h, w = image.shape[-2:]
    top = height // 2 - h // 2
    left = width // 2 - w // 2
    return F.pad(image, (left, width - w - left, top, height - h - top))


def trim(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Extract the centered (height, width) region (``aocommon::Image::Trim``)."""
    h, w = image.shape[-2:]
    top = h // 2 - height // 2
    left = w // 2 - width // 2
    return image[..., top : top + height, left : left + width]


def _centered_kernel_fft(
    kernel: torch.Tensor, shape: Tuple[int, int]
) -> torch.Tensor:
    """rfft2 of the kernel re-origined so its center pixel is at (0, 0)
    (``schaapcommon::math::PrepareConvolutionKernel``)."""
    h, w = kernel.shape[-2:]
    rolled = torch.roll(kernel, (-(h // 2), -(w // 2)), dims=(-2, -1))
    return torch.fft.rfft2(rolled, s=tuple(shape))


def forward_fft2(x: torch.Tensor) -> torch.Tensor:
    """The rfft2 half-plane spectrum of a real image stack ``[..., H, W]``."""
    return torch.fft.rfft2(x)


def inverse_fft2_real(spec: torch.Tensor,
                      shape: Tuple[int, int]) -> torch.Tensor:
    """The real ``(H, W)`` images of :func:`forward_fft2` spectra, batched
    over every leading dimension."""
    return torch.fft.irfft2(spec, s=tuple(shape))


def forward_fft2_padded(x: torch.Tensor,
                        padded_shape: Tuple[int, int]) -> torch.Tensor:
    """The spectrum of ``untrim(x, Ph, Pw)``, the centered zero-pad."""
    ph, pw = padded_shape
    if tuple(x.shape[-2:]) != (ph, pw):
        x = untrim(x, ph, pw)
    return torch.fft.rfft2(x)


def inverse_fft2_real_trimmed(spec: torch.Tensor,
                              padded_shape: Tuple[int, int],
                              out_shape: Tuple[int, int]) -> torch.Tensor:
    """``trim(inverse_fft2_real(spec, padded_shape), H, W)``: a view of the
    centered ``out_shape`` region."""
    out = inverse_fft2_real(spec, padded_shape)
    if tuple(out_shape) == tuple(padded_shape):
        return out
    return trim(out, *out_shape)


def centered_embed_kernel_fft(kernel: torch.Tensor,
                              shape: Tuple[int, int]) -> torch.Tensor:
    """Centered-embed ``kernel`` into ``shape`` and return its origin-rolled
    spectrum (batched over leading dims)."""
    if tuple(kernel.shape[-2:]) != tuple(shape):
        kernel = untrim(kernel, *shape)
    return _centered_kernel_fft(kernel, tuple(shape))


def convolve_same(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Circular centered convolution at the image's own size.

    Equivalent of ``schaapcommon::math::Convolve`` on pre-padded buffers:
    out[p] = sum_q image[q] * kernel[p - q + center].  Batched over the
    leading dims of ``image`` and ``kernel``, which broadcast.
    """
    h, w = image.shape[-2:]
    if kernel.shape[-2:] != (h, w):
        raise ValueError("convolve_same requires an image-sized kernel")
    spec = torch.fft.rfft2(image) * _centered_kernel_fft(kernel, (h, w))
    return torch.fft.irfft2(spec, s=(h, w)).to(image.dtype)


def prepare_kernel_fft(kernel: torch.Tensor) -> torch.Tensor:
    """rfft2 of a centered kernel at its own size, for reuse across many
    :func:`convolve_same_prefft` calls (batched over leading dims)."""
    return _centered_kernel_fft(kernel, kernel.shape[-2:])


def convolve_same_prefft(image: torch.Tensor,
                         ker_f: torch.Tensor) -> torch.Tensor:
    """Circular centered convolution at the image's size with a kernel
    spectrum from :func:`prepare_kernel_fft`."""
    h, w = image.shape[-2:]
    return torch.fft.irfft2(torch.fft.rfft2(image) * ker_f, s=(h, w)).to(
        image.dtype)


def padded_convolve(
    image: torch.Tensor,
    kernel: torch.Tensor,
    padding: float = 1.1,
    padded_shape: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Zero-padded centered convolution returning the input-sized result.

    Equivalent of ``schaapcommon::math::PaddedConvolution`` and of the
    untrim/convolve/trim of ``cpp/algorithms/subminor_loop.cc:195-218``.
    ``padded_shape`` overrides the automatically chosen 7-smooth size.
    """
    h, w = image.shape[-2:]
    if padded_shape is None:
        ph = calculate_good_fft_size(int(padding * h))
        pw = calculate_good_fft_size(int(padding * w))
    else:
        ph, pw = padded_shape
    out = convolve_same(untrim(image, ph, pw), untrim(kernel, ph, pw))
    return trim(out, h, w)
