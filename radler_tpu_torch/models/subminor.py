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

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..image_set import CubeMeta, linear_integration_coefficients
from ..kernels.subminor_loop import (
    FIT_FORCED_TERMS,
    FIT_LOG_POLYNOMIAL,
    SubminorFit,
    SubminorParams,
    projection_fit,
    read_result,
    subminor_loop,
)
from ..ops.convolution import padded_convolve
from ..ops.peak_finder import window_bounds
from ..settings import SpectralFittingMode
from ..utils.device_consts import device_const
from ..utils.fft_size import calculate_good_fft_size
from ..utils.profiling import annotate


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
    mask: Union[torch.Tensor, np.ndarray, None],
    threshold: float,
    allow_negative: bool,
    borders: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """The flat indices, in raster order, of the candidate pixels
    (``subminor_loop.cc:143-184``): the linear integration of the ``[N, H,
    W]`` cube, times the rms factor, its magnitude when negatives are
    allowed, at or above ``threshold`` (as float32) inside the window that
    the ``(horizontal, vertical)`` ``borders`` leave (``window_bounds``)
    and, where ``mask`` is not None, where the ``[H, W]`` bool ``mask`` (a
    tensor, or a NumPy array that is copied to the device a call) is True.
    The window is a slice of the value plane, so no array of the image's
    size is made for it.  ``torch.nonzero`` reads the count to the host.

    ``select_candidates.calls`` counts the calls and
    ``select_candidates.host_masks`` those that copied a NumPy mask."""
    select_candidates.calls += 1
    _, height, width = residual_cube.shape
    dev = residual_cube.device
    y0, y1, x0, x1 = window_bounds(height, width, *borders)
    coef = torch.as_tensor(linear_integration_coefficients(meta), device=dev)
    value = torch.einsum("i,ihw->hw", coef, residual_cube)[y0:y1, x0:x1]
    if rms_factor is not None:
        value = value * rms_factor[y0:y1, x0:x1]
    if allow_negative:
        value = value.abs()
    selectable = value >= float(np.float32(threshold))
    if mask is not None:
        if not isinstance(mask, torch.Tensor):
            select_candidates.host_masks += 1
            # Copied anew each call: multiscale's scale masks change in
            # place between passes (``update_auto_mask``).
            mask = torch.from_numpy(np.ascontiguousarray(
                np.asarray(mask, bool)[y0:y1, x0:x1]))
        else:
            mask = mask[y0:y1, x0:x1]
        selectable &= mask.to(dev)
    yx = torch.nonzero(selectable)
    return (yx[:, 0] + y0) * width + (yx[:, 1] + x0)


select_candidates.calls = 0
select_candidates.host_masks = 0


def fit_arguments(fitter, device, xs: torch.Tensor,
                  ys: torch.Tensor) -> Optional[SubminorFit]:
    """B2's spectral fit for ``fitter`` on ``device``, or None without an
    active fit: the polynomial fit's ``[C, C]`` projection, the
    log-polynomial fit's constants, or the forced-term fit's constants with
    the term vectors gathered at the candidates ``(xs, ys)`` (``[K]``
    int32, in the coordinates of the fitter's term images, as
    ``_forced_fit`` indexes them)."""
    if fitter is None or not fitter.is_active:
        return None
    if fitter.mode == SpectralFittingMode.POLYNOMIAL:
        return projection_fit(device_const(fitter._projection, device))
    if fitter.mode == SpectralFittingMode.LOG_POLYNOMIAL:
        fit_m, design, mean_weights = fitter.log_polynomial_constants(device)
        return SubminorFit(FIT_LOG_POLYNOMIAL, fit_matrix=fit_m,
                           design=design, mean_weights=mean_weights)
    if fitter.mode == SpectralFittingMode.FORCED_TERMS:
        images = fitter._forced_terms
        if images is None:
            raise RuntimeError("Forced terms have not been set")
        weights, powers = fitter.forced_constants(images.shape[0], device)
        terms = images.to(device=device, dtype=torch.float32)[
            :, ys.long(), xs.long()].contiguous()
        return SubminorFit(FIT_FORCED_TERMS, weights=weights, powers=powers,
                           terms=terms)
    return None


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
        with annotate("clark.select"):
            return self._find_peak_positions(residual_cube, meta)

    def _find_peak_positions(self, residual_cube: torch.Tensor,
                             meta: CubeMeta) -> int:
        n = residual_cube.shape[0]
        # The reference's border loop never clamps yiStart against start_y=0
        # (subminor_loop.cc:151-154), equivalent to the plain window.
        flat = select_candidates(
            residual_cube, meta, self.rms_factor_image, self.mask,
            self.threshold, self.allow_negative_components,
            (self.horizontal_border, self.vertical_border))
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
        with annotate("clark.b2"):
            coef = torch.as_tensor(linear_integration_coefficients(meta),
                                   device=dev)
            fit = fit_arguments(fitter, dev, self._xs, self._ys)
            model_k = torch.zeros_like(self._residual_k)
            # Through the module's name, so that a wrapper put in its place
            # sees every call.
            out = subminor_loop(
                self._residual_k,
                model_k,
                self._rms_k,
                self._xs,
                self._ys,
                psfs.contiguous(),
                coef,
                fit,
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
