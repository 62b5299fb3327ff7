"""Masked / bordered peak (argmax) search.

Port of ``radler_tpu.ops.peak_finder`` (``cpp/math/peak_finder.{h,cc}``).
Semantics preserved from the reference:

* ``allow_negative`` compares absolute values but returns the signed value.
* Borders shrink the search window on each side; a border given as a ratio is
  rounded like the reference (``round(width * border_ratio)``).
* A peak is "found" only if its comparison value exceeds ``FLT_MIN``
  (``cpp/math/peak_finder.cc:25``): an all-zero or all-negative (when
  negatives are disallowed) image yields no peak.
* Ties resolve to the first row-major occurrence: ``torch.argmax`` returns
  the first maximum, like ``jnp.argmax``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

FLT_MIN = float(np.finfo(np.float32).tiny)


class PeakResult(NamedTuple):
    """Peak-search result; every field is a 0-d tensor on the image's
    device, so no value reaches the host until the caller asks."""

    value: torch.Tensor  # signed peak value (float32)
    x: torch.Tensor  # int64
    y: torch.Tensor  # int64
    found: torch.Tensor  # bool


def border_from_ratio(width: int, height: int, border_ratio: float):
    return int(round(width * border_ratio)), int(round(height * border_ratio))


def window_mask(
    height: int,
    width: int,
    horizontal_border: int,
    vertical_border: int,
    start_y: int = 0,
    end_y: Optional[int] = None,
) -> np.ndarray:
    """Static bool mask of the searchable window (``peak_finder.cc:28-32``):
    True on :func:`window_bounds`' rectangle."""
    y0, y1, x0, x1 = window_bounds(height, width, horizontal_border,
                                   vertical_border, start_y, end_y)
    mask = np.zeros((height, width), dtype=bool)
    mask[y0:y1, x0:x1] = True
    return mask


def window_bounds(
    height: int,
    width: int,
    horizontal_border: int,
    vertical_border: int,
    start_y: int = 0,
    end_y: Optional[int] = None,
) -> Tuple[int, int, int, int]:
    """The searchable window's rows ``[y0, y1)`` and columns ``[x0, x1)``
    as ``(y0, y1, x0, x1)`` (``peak_finder.cc:28-32``); a border wider than
    half the image gives an empty range, never a negative one."""
    if end_y is None:
        end_y = height
    x0 = horizontal_border
    x1 = max(width - horizontal_border, x0)
    y0 = max(start_y, vertical_border)
    y1 = max(min(end_y, height - vertical_border), y0)
    return y0, y1, x0, x1


def find_peak(
    image: torch.Tensor,
    allow_negative: bool,
    horizontal_border: int = 0,
    vertical_border: int = 0,
    mask=None,
) -> PeakResult:
    """Find the (masked, bordered) peak of a 2-D image.

    Equivalent of ``math::peak_finder::Find`` / ``FindWithMask``; ``mask``
    is an optional NumPy bool array.
    """
    height, width = image.shape
    value = image.abs() if allow_negative else image
    masked = value.reshape(-1)
    if horizontal_border or vertical_border or mask is not None:
        valid = window_mask(height, width, horizontal_border, vertical_border)
        if mask is not None:
            valid = valid & np.asarray(mask, bool)
        masked = torch.where(
            torch.as_tensor(valid, device=image.device).reshape(-1),
            masked,
            torch.tensor(-np.inf, device=image.device),
        )
    flat_idx = torch.argmax(masked)
    return PeakResult(
        value=image.reshape(-1)[flat_idx],
        x=flat_idx % width,
        y=flat_idx // width,
        found=masked[flat_idx] > FLT_MIN,
    )


def masked_peaks(images: torch.Tensor, valid: torch.Tensor,
                 allow_negative: bool):
    """Each plane's windowed argmax of ``images`` (``[n, H, W]``), the first
    index among equal maxima: of the absolute values with
    ``allow_negative``, else of the signed ones, over ``valid`` (bool,
    broadcast against the planes).  Returns ``(best, signed, idx)``, each
    ``[n]``: the compared value (``-inf`` for an empty window), the signed
    value there and its flat index within the plane."""
    n = images.shape[0]
    cmp = images.abs() if allow_negative else images
    masked = torch.where(valid, cmp, -math.inf).reshape(n, -1)
    idx = torch.argmax(masked, dim=1, keepdim=True)
    best = torch.gather(masked, 1, idx)[:, 0]
    signed = torch.gather(images.reshape(n, -1), 1, idx)[:, 0]
    return best, signed, idx[:, 0]
