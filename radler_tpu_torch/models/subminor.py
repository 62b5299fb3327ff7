"""Clark-style subminor loop on the set of candidate pixels.

Port of ``radler_tpu.models.subminor`` (``cpp/algorithms/subminor_loop.{h,cc}``).
The reference gathers every pixel above the threshold into a vector and
iterates a scalar argmax/subtract loop over it; here the candidate set is an
``[N, K]`` tensor pair (residual and model at the K candidates) and the whole
loop is one call of :func:`radler_tpu_torch.kernels.subminor_loop.subminor_loop`:
one CUDA launch on the card, its plain PyTorch version on the CPU.  The final
residual correction, the sparse model convolved with the PSF and subtracted
from the full residual (``subminor_loop.cc:195-218``), is one batched padded
FFT convolution (:func:`correct_residual`, which multiscale's dense route
calls with its component image).

K is the exact number of selected pixels: the JAX package rounded it up to
capacity buckets to bound its jit cache, which nothing here has, and masked
the padding entries.  So every candidate is valid and there is no mask.  The
TPU's routing machinery (the interaction-matrix budget, its self-calibrated
rates and the local-maximum depth estimate that fed them) is not carried.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..image_set import CubeMeta, linear_integration_coefficients
from ..kernels.subminor_loop import SubminorParams, read_result, subminor_loop
from ..ops.convolution import padded_convolve
from ..ops.peak_finder import window_mask
from ..settings import SpectralFittingMode
from ..utils.fft_size import calculate_good_fft_size


def correct_residual(
    residual_cube: torch.Tensor,
    model_full: torch.Tensor,
    psfs: torch.Tensor,
    padded_height: int,
    padded_width: int,
    n_channels: int,
) -> torch.Tensor:
    """``residual - model ⊛ psf`` for every plane of the ``[N, H, W]``
    cubes, in one batched padded FFT convolution with the ``[C, H, W]``
    PSFs (plane n uses PSF ``n // (N / C)``; ``subminor_loop.cc:195-218``)."""
    n, h, w = residual_cube.shape
    conv = padded_convolve(
        model_full.reshape(n_channels, n // n_channels, h, w),
        psfs[:, None],
        padded_shape=(padded_height, padded_width),
    )
    return residual_cube - conv.reshape(n, h, w)


def select_candidates(
    residual_cube: torch.Tensor,
    meta: CubeMeta,
    rms_factor: Optional[torch.Tensor],
    window: torch.Tensor,
    threshold: float,
    allow_negative: bool,
) -> torch.Tensor:
    """The flat indices, in raster order, of the candidate pixels
    (``subminor_loop.cc:143-184``): the linear integration of the ``[N, H,
    W]`` cube, times the rms factor, its magnitude when negatives are
    allowed, at or above ``threshold`` (as float32) inside the ``[H, W]``
    bool ``window``.  ``torch.nonzero`` reads the count to the host."""
    coef = torch.as_tensor(linear_integration_coefficients(meta),
                           device=residual_cube.device)
    value = torch.einsum("i,ihw->hw", coef, residual_cube)
    if rms_factor is not None:
        value = value * rms_factor
    if allow_negative:
        value = value.abs()
    selectable = (value >= float(np.float32(threshold))) & window
    return torch.nonzero(selectable.reshape(-1))[:, 0]


def fit_arguments(fitter, meta: CubeMeta, device):
    """B2's spectral fit for ``fitter``: ``(proj, fit)``, the polynomial
    fit's ``[C, C]`` projection on ``device``, or ``fit(cv, x, y)`` for any
    other active fit (the plain version applies it; the kernel cannot), or
    neither."""
    if fitter is None or not fitter.is_active:
        return None, None
    if fitter.mode == SpectralFittingMode.POLYNOMIAL:
        return torch.as_tensor(np.asarray(fitter._projection, np.float32),
                               device=device), None
    C, P = meta.n_channels, meta.n_polarizations

    def fit(cv, x, y):
        return fitter.fit_and_evaluate(cv.view(C, P), x, y).reshape(-1)

    return None, fit


class SubMinorLoop:
    """Host-side orchestration of one subminor run."""

    def __init__(
        self, width: int, height: int, padded_width: int, padded_height: int
    ):
        self.width = width
        self.height = height
        self.padded_width = padded_width
        self.padded_height = padded_height
        self.threshold = 0.0
        self.gain = 0.0
        self.horizontal_border = 0
        self.vertical_border = 0
        self.current_iteration = 0
        self.max_iterations = 0
        self.allow_negative_components = True
        self.stop_on_negative_component = False
        self.mask: Optional[np.ndarray] = None
        self.rms_factor_image: Optional[torch.Tensor] = None
        self.divergence_limit = 0.0

        # Candidate state, set by find_peak_positions and run.
        self._flat: Optional[torch.Tensor] = None  # [K] int64 flat pixel
        self._xs: Optional[torch.Tensor] = None  # [K] int32
        self._ys: Optional[torch.Tensor] = None  # [K] int32
        self._residual_k: Optional[torch.Tensor] = None  # [N, K]
        self._model_k: Optional[torch.Tensor] = None  # [N, K]
        self._rms_k: Optional[torch.Tensor] = None  # [K]
        self._meta: Optional[CubeMeta] = None
        self._count: Optional[int] = None

    # -- configuration mirrors (subminor_loop.h:122-172) -------------------
    def set_threshold(self, threshold: float, considered_pixel_threshold: float):
        # The reference never reads the second threshold: selection uses
        # ``threshold`` (``subminor_loop.cc:167``).
        self.threshold = threshold

    def set_iteration_info(self, current_iteration: int, max_iterations: int):
        self.current_iteration = current_iteration
        self.max_iterations = max_iterations

    def set_gain(self, gain: float):
        self.gain = gain

    def set_clean_borders(self, horizontal: int, vertical: int):
        self.horizontal_border = horizontal
        self.vertical_border = vertical

    # -- the run -----------------------------------------------------------
    def find_peak_positions(
        self, residual_cube: torch.Tensor, meta: CubeMeta
    ) -> int:
        """Select every candidate pixel >= threshold within the borders and
        the mask (``subminor_loop.cc:143-184``), in row-major order, and
        gather the candidate state.  Returns the number selected; the only
        host read is the count that ``torch.nonzero`` needs."""
        dev = residual_cube.device
        n = residual_cube.shape[0]
        # The reference's border loop never clamps yiStart against start_y=0
        # (subminor_loop.cc:151-154), equivalent to the plain window.
        window = window_mask(
            self.height, self.width, self.horizontal_border, self.vertical_border
        )
        if self.mask is not None:
            window = window & np.asarray(self.mask, bool)
        flat = select_candidates(
            residual_cube, meta, self.rms_factor_image,
            torch.as_tensor(window, device=dev), self.threshold,
            self.allow_negative_components)
        count = int(flat.numel())
        self._count = count
        if count == 0:
            return 0
        self._flat = flat
        self._xs = (flat % self.width).to(torch.int32)
        self._ys = (flat // self.width).to(torch.int32)
        self._residual_k = residual_cube.reshape(n, -1)[:, flat].contiguous()
        self._rms_k = (
            self.rms_factor_image.reshape(-1)[flat].contiguous()
            if self.rms_factor_image is not None
            else None
        )
        return count

    def run(
        self,
        residual_cube: torch.Tensor,
        meta: CubeMeta,
        psfs: torch.Tensor,
        fitter=None,
    ) -> Tuple[bool, Optional[float]]:
        """``SubMinorLoop::Run``: returns (diverging, final peak or None).

        ``psfs`` are the ``[C, H, W]`` PSFs at image size (the
        twice-convolved ones for multiscale).  One kernel launch on CUDA
        tensors and one host read of its result."""
        self._meta = meta
        count = self._count
        if count is None:
            count = self.find_peak_positions(residual_cube, meta)
        if count == 0:
            return False, None
        dev = residual_cube.device
        coef = torch.as_tensor(linear_integration_coefficients(meta), device=dev)
        proj, fit_fn = fit_arguments(fitter, meta, dev)
        model_k = torch.zeros_like(self._residual_k)
        out = subminor_loop(
            self._residual_k,
            model_k,
            self._rms_k,
            self._xs,
            self._ys,
            psfs.contiguous(),
            coef,
            proj,
            SubminorParams.make(
                self.threshold,
                self.gain,
                self.current_iteration,
                self.max_iterations,
                self.divergence_limit,
                self.allow_negative_components,
                self.stop_on_negative_component,
            ),
            n_polarizations=meta.n_polarizations,
            fit=fit_fn,
        )
        self._model_k = model_k
        iteration, value, diverging = read_result(out)
        self.current_iteration = iteration
        return diverging, value

    # -- post-run ----------------------------------------------------------
    def full_model_cube(self) -> torch.Tensor:
        """Scatter the sparse model onto full images, all planes at once
        (``SubMinorLoop::GetFullIndividualModel``)."""
        n = self._model_k.shape[0]
        full = torch.zeros(
            (n, self.height * self.width),
            dtype=torch.float32,
            device=self._model_k.device,
        )
        full.index_copy_(1, self._flat, self._model_k)
        return full.view(n, self.height, self.width)

    def correct_residual_dirty(
        self, residual_cube: torch.Tensor, single_convolved_psfs: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Subtract (sparse model ⊛ PSF) from the residual, every plane in
        one batched padded FFT convolution; returns (new_residual,
        full_model_cube)."""
        full_model = self.full_model_cube()
        new_residual = correct_residual(
            residual_cube, full_model, single_convolved_psfs,
            self.padded_height, self.padded_width, self._meta.n_channels,
        )
        return new_residual, full_model

    def _nonzero_positions(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host (xs, ys, values [N, n]) of the candidates with a non-zero
        model value in any plane."""
        nonzero = torch.any(self._model_k != 0.0, dim=0)
        xs = self._xs[nonzero].cpu().numpy()
        ys = self._ys[nonzero].cpu().numpy()
        return xs, ys, self._model_k[:, nonzero].cpu().numpy()

    def update_auto_mask(self, mask: np.ndarray) -> None:
        """OR positions with non-zero model values into ``mask``
        (``subminor_loop.cc:220-228``)."""
        xs, ys, _ = self._nonzero_positions()
        mask[ys, xs] = True

    def update_component_list(self, component_list, scale_index: int) -> None:
        """``subminor_loop.cc:230-246``."""
        xs, ys, values = self._nonzero_positions()
        for j in range(xs.shape[0]):
            component_list.add(int(xs[j]), int(ys[j]), scale_index, values[:, j])


def choose_padded_size(width: int, height: int, padding: float) -> Tuple[int, int]:
    """Padded convolution size (height, width) for the residual correction:
    the reference's even ``ceil(padding * dim)`` (``generic_clean.cc:63-66``)
    rounded up to the next 7-smooth size."""
    return (
        calculate_good_fft_size(int(np.ceil(padding * height))),
        calculate_good_fft_size(int(np.ceil(padding * width))),
    )
