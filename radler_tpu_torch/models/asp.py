"""Adaptive Scale Pixel (ASP) deconvolution (Bhatnagar & Cornwell 2004).

Port of ``radler_tpu.models.asp`` (``cpp/algorithms/asp_algorithm.{h,cc}``):
multiscale's dominant-scale selection, then each iteration either removes a
point source (``DeconvolvePointSource``, ``asp_algorithm.cc:231-254``) or
fits a 2-D Gaussian at the peak, deconvolves the beam from the fitted
ellipse, measures each plane's amplitude through convolution peaks, fits
the spectrum and subtracts the drawn component convolved with the PSFs
(``DeconvolveGaussian``, ``asp_algorithm.cc:256-371``).

The scale search is multiscale's (:class:`~radler_tpu_torch.models.
multiscale.MultiScaleAlgorithm`); the image updates are FFTs on the run's
device (no kernel of their own: the JAX package runs them outside any
Pallas kernel).  The Gaussian fits are small least-squares solves on the
host (:mod:`radler_tpu_torch.ops.gaussian_fit`), which read only the fit's
window, so only that window is copied from the device; the Gaussians are
drawn on the host in NumPy, as in the JAX package.  The JAX package
row-shards ASP's cube on a device mesh, a placement only; every shard of
the port's mesh lies on the one device, so ASP runs there as on one
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..image_set import CubeMeta, get_integrated_psf, get_linear_integrated
from ..ops.convolution import convolve_same, padded_convolve
from ..ops.gaussian_fit import (
    Ellipse,
    deconvolve_gaussian,
    draw_gaussian,
    fit_2d_gaussian_centred,
    fit_2d_gaussian_full,
    full_fit_box,
)
from ..ops.psf_subtract import subtract_psf_from_cube
from ..settings import MultiscaleSettings
from ..utils import logging as log
from ..utils.fft_size import get_convolution_size
from .base import DeconvolutionResult
from .multiscale import (
    MultiScaleAlgorithm,
    initialize_scales,
    select_maximum_scale,
)


class AspAlgorithm(MultiScaleAlgorithm):
    """Multiscale's scale bank and peak search, with ASP's processing of
    each component."""

    def __init__(self, settings: MultiscaleSettings, beam_size: float,
                 pixel_scale_x: float, pixel_scale_y: float):
        super().__init__(settings, beam_size, pixel_scale_x, pixel_scale_y,
                         False)

    def execute_major_iteration(self, dirty_set, model_set,
                                psfs: torch.Tensor) -> DeconvolutionResult:
        meta: CubeMeta = dirty_set.meta
        width, height = dirty_set.width, dirty_set.height
        if self.stop_on_negative_components:
            self.allow_negative_components = True
        # Masks and borders may have changed between major iterations.
        self._valid_stack_cache = None
        initialize_scales(
            self.scale_infos,
            self.beam_size_in_pixels,
            min(width, height),
            self.ms_settings.shape,
            self.ms_settings.max_scales,
            self.ms_settings.scale_list,
        )
        if (self.rms_factor_image is not None
                and tuple(self.rms_factor_image.shape) != (height, width)):
            raise RuntimeError("Error in RMS factor image dimensions!")

        integrated_psf = get_integrated_psf(psfs, meta)
        psf_parameters = fit_2d_gaussian_centred(
            integrated_psf.cpu().numpy(), self.beam_size_in_pixels)
        # The scales' PSF peaks, bias factors and gains (the reference's
        # per-channel convolved PSFs are not read again).
        self._convolve_psfs(integrated_psf)
        psf_indices = torch.as_tensor(meta.psf_indices, device=psfs.device)

        self._find_active_scale_convolved_maxima(
            get_linear_integrated(dirty_set.data, meta), report_rms=False)
        result = DeconvolutionResult()
        scale_with_peak = select_maximum_scale(self.scale_infos)
        if scale_with_peak is None:
            log.warn("No peak found during ASP cleaning! Aborting.")
            result.another_iteration_required = False
            return result

        entry = self.scale_infos[scale_with_peak]
        is_final_threshold = False
        m_gain_threshold = abs(
            entry.max_unnormalized_image_value * entry.bias_factor
        ) * (1.0 - self.major_loop_gain)
        m_gain_threshold = max(m_gain_threshold,
                               self.major_iteration_threshold)
        first_threshold = m_gain_threshold
        if self.threshold > first_threshold:
            first_threshold = self.threshold
            is_final_threshold = True

        def peak_of(index: int) -> float:
            e = self.scale_infos[index]
            return e.max_unnormalized_image_value * e.bias_factor

        def unnormalized(index: int) -> float:
            return self.scale_infos[index].max_unnormalized_image_value

        while (
            self.iteration_number < self.max_iterations
            and abs(peak_of(scale_with_peak)) > first_threshold
            and (not self.stop_on_negative_components
                 or unnormalized(scale_with_peak) >= 0.0)
        ):
            entry = self.scale_infos[scale_with_peak]
            # The peak of the scale-convolved integration (the
            # scale-convolved cube's integration: both are linear).
            integrated = get_linear_integrated(dirty_set.data, meta)
            self._find_peak_direct(
                self._scale_convolve(integrated, entry.scale),
                scale_with_peak)

            self.iteration_number += 1
            self._find_active_scale_convolved_maxima(integrated,
                                                     report_rms=False)
            scale_with_peak = select_maximum_scale(self.scale_infos)
            if scale_with_peak is None:
                log.warn("No peak found in main loop of ASP cleaning!")
                result.another_iteration_required = False
                return result
            entry = self.scale_infos[scale_with_peak]
            log.info(
                f"Iteration {self.iteration_number}, scale "
                f"{round(entry.scale)} px : {peak_of(scale_with_peak):.6g}"
                f" at {entry.max_image_value_x},{entry.max_image_value_y}"
            )
            if entry.scale == 0.0:
                self._deconvolve_point_source(
                    entry.max_image_value_x, entry.max_image_value_y,
                    dirty_set, model_set, psfs, meta, psf_indices)
            else:
                # The fit reads the unconvolved integration (the
                # reference's FindScaleConvolvedMaxima leaves it in the
                # scratch DeconvolveGaussian reads, asp_algorithm.cc:379,
                # 292-297).
                self._deconvolve_gaussian(entry, dirty_set, model_set, psfs,
                                          integrated, psf_parameters, meta,
                                          psf_indices)

        max_iter_reached = self.iteration_number >= self.max_iterations
        negative_reached = (self.stop_on_negative_components
                            and unnormalized(scale_with_peak) < 0.0)
        result.another_iteration_required = (
            not max_iter_reached and not is_final_threshold
            and not negative_reached
        )
        result.final_peak_value = peak_of(scale_with_peak)
        return result

    # ------------------------------------------------------------------
    def _deconvolve_point_source(self, x: int, y: int, dirty_set, model_set,
                                 psfs: torch.Tensor, meta: CubeMeta,
                                 psf_indices: torch.Tensor) -> None:
        """``asp_algorithm.cc:231-254``."""
        component_values = dirty_set.data[:, y, x]
        fitter = self.spectral_fitter
        if fitter is not None and fitter.is_active:
            component_values = fitter.fit_and_evaluate(
                component_values.reshape(meta.n_channels,
                                         meta.n_polarizations),
                x, y).reshape(-1)
        component_values = component_values * self.minor_loop_gain
        model_set.data[:, y, x] += component_values
        dirty_set.data = subtract_psf_from_cube(
            dirty_set.data, psfs, psf_indices, x, y, component_values)

    def _deconvolve_gaussian(self, entry, dirty_set, model_set,
                             psfs: torch.Tensor, integrated: torch.Tensor,
                             psf_parameters: Ellipse, meta: CubeMeta,
                             psf_indices: torch.Tensor) -> None:
        """``asp_algorithm.cc:256-371``."""
        width, height = dirty_set.width, dirty_set.height
        x0 = float(entry.max_image_value_x)
        y0 = float(entry.max_image_value_y)
        x1, y1, x2, y2 = full_fit_box(width, height, x0, y0, entry.scale,
                                      entry.scale)
        fit_a, fit_x, fit_y, gaussian = fit_2d_gaussian_full(
            integrated[y1:y2, x1:x2].cpu().numpy(),
            entry.max_unnormalized_image_value * entry.bias_factor,
            x0, y0, entry.scale, entry.scale, 0.0, origin=(x1, y1))
        log.debug(
            f"ASP fit: x={fit_x}, y={fit_y}, a={fit_a}, maj={gaussian.major},"
            f" min={gaussian.minor}, pa={gaussian.position_angle}"
        )
        # The reference's std::clamp(0, width-1, round(fit_x)) has its
        # arguments swapped; this is its evident intent.
        peak_x = int(np.clip(round(fit_x), 0, width - 1))
        peak_y = int(np.clip(round(fit_y), 0, height - 1))

        gaussian = deconvolve_gaussian(gaussian, psf_parameters)
        if not math.isfinite(gaussian.major):
            # Smaller than the PSF: a point source.
            self._deconvolve_point_source(peak_x, peak_y, dirty_set,
                                          model_set, psfs, meta, psf_indices)
            return
        gaussian.position_angle *= -1.0  # asp_algorithm.cc:292

        dev = dirty_set.data.device
        # The deconvolved Gaussian at unit peak, centered: each channel's
        # PSF peak and each plane's peak through it.
        kernel = torch.as_tensor(draw_gaussian(
            np.zeros((height, width), np.float32), width // 2, height // 2,
            gaussian, 1.0), device=dev)
        psf_peaks = convolve_same(psfs, kernel)[:, height // 2, width // 2]
        component_peaks = convolve_same(dirty_set.data,
                                        kernel)[:, peak_y, peak_x]
        component_values = component_peaks / psf_peaks.index_select(
            0, psf_indices)
        fitter = self.spectral_fitter
        if fitter is not None and fitter.is_active:
            component_values = fitter.fit_and_evaluate(
                component_values.reshape(meta.n_channels,
                                         meta.n_polarizations),
                peak_x, peak_y).reshape(-1)
        values = component_values * self.minor_loop_gain
        component = torch.as_tensor(draw_gaussian(
            np.zeros((height, width), np.float32), fit_x, fit_y, gaussian,
            1.0), device=dev)
        model_set.data = model_set.data + values[:, None, None] * component
        # The component convolved with each channel's PSF, padded for the
        # largest scale, subtracted from each plane.
        padded = (
            get_convolution_size(self.scale_infos[-1].scale, height,
                                 self.ms_settings.convolution_padding),
            get_convolution_size(self.scale_infos[-1].scale, width,
                                 self.ms_settings.convolution_padding),
        )
        conv = padded_convolve(component[None], psfs, padded_shape=padded)
        dirty_set.data = dirty_set.data - values[:, None, None] * (
            conv.index_select(0, psf_indices))
