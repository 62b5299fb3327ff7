"""Centered trim and untrim of image planes.

Port of ``radler_tpu.ops.convolution.untrim`` / ``trim``.  The FFT
convolution of that module comes with the Clark slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
