"""PSF shift and PSF subtraction.

Port of ``radler_tpu.ops.psf_subtract`` (``cpp/algorithms/simple_clean.cc``):
the PSF is shifted to the component position by an index gather with the
out-of-image region zeroed, which gives exactly the clipped patch semantics
of ``simple_clean::PartialSubtractImage``.  The position may be a Python int
or a 0-d tensor on the image's device, so a loop can subtract at a peak that
was found on the device without reading it back.
"""

from __future__ import annotations

import torch


def shift_psf(psf: torch.Tensor, x, y) -> torch.Tensor:
    """Shift centered PSFs ``[..., H, W]`` so their center lands on (x, y),
    zeroing pixels that fall outside.

    Output[py, px] = psf[py - y + H//2, px - x + W//2] where the index is in
    bounds, else 0 (``cpp/algorithms/simple_clean.cc:61-96``).
    """
    h, w = psf.shape[-2:]
    rows = torch.arange(h, device=psf.device) - y + h // 2
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
) -> torch.Tensor:
    """``cube[i] - factors[i] * psfs[psf_indices[i]]`` shifted to (x, y).

    Equivalent of the per-image ``tools.SubtractImage`` loop in
    ``cpp/algorithms/generic_clean.cc:188-196`` over the ``[n_images, H, W]``
    cube.  ``psfs`` is ``[n_channels, H, W]``.
    """
    shifted = shift_psf(psfs, x, y)  # [n_channels, H, W]
    per_image = shifted[psf_indices]  # [n_images, H, W]
    return cube - factors[:, None, None] * per_image
