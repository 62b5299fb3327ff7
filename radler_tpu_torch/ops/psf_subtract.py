"""PSF shift and PSF subtraction.

Port of ``radler_tpu.ops.psf_subtract`` (``cpp/algorithms/simple_clean.cc``):
the PSF is shifted to the component position by an index gather with the
out-of-image region zeroed, which gives exactly the clipped patch semantics
of ``simple_clean::PartialSubtractImage``.  The position may be a Python int
or a 0-d tensor on the image's device, so a loop can subtract at a peak that
was found on the device without reading it back.
"""

from __future__ import annotations

from typing import Optional

import torch


def shift_psf(psf: torch.Tensor, x, y, row_offset: int = 0,
              n_rows: Optional[int] = None) -> torch.Tensor:
    """Shift centered PSFs ``[..., H, W]`` so their center lands on (x, y),
    zeroing pixels that fall outside.

    Output[py, px] = psf[py - y + H//2, px - x + W//2] where the index is in
    bounds, else 0 (``cpp/algorithms/simple_clean.cc:61-96``).  With
    ``row_offset`` and ``n_rows`` only the image rows ``row_offset ..
    row_offset + n_rows - 1`` are returned: a row shard's window.
    """
    h, w = psf.shape[-2:]
    n_rows = h if n_rows is None else n_rows
    rows = torch.arange(n_rows, device=psf.device) + row_offset - y + h // 2
    cols = torch.arange(w, device=psf.device) - x + w // 2
    valid = ((rows >= 0) & (rows < h))[:, None] & ((cols >= 0) & (cols < w))[
        None, :
    ]
    gathered = psf[..., rows.clamp(0, h - 1), :][..., cols.clamp(0, w - 1)]
    return torch.where(valid, gathered, torch.zeros((), device=psf.device))


def subtract_psf_from_cube(
    cube: torch.Tensor,
    psfs: torch.Tensor,
    psf_indices: torch.Tensor,
    x,
    y,
    factors: torch.Tensor,
    row_offset: int = 0,
) -> torch.Tensor:
    """``cube[i] - factors[i] * psfs[psf_indices[i]]`` shifted to (x, y).

    Equivalent of the per-image ``tools.SubtractImage`` loop in
    ``cpp/algorithms/generic_clean.cc:188-196`` over the ``[n_images, H, W]``
    cube.  ``psfs`` is ``[n_channels, H, W]``.  A row shard passes its rows
    ``[n_images, H_loc, W]`` and their first image row ``row_offset``; the
    PSFs stay at the full image size.
    """
    shifted = shift_psf(psfs, x, y, row_offset, cube.shape[-2])
    per_image = shifted[psf_indices]  # [n_images, H, W]
    return cube - factors[:, None, None] * per_image
