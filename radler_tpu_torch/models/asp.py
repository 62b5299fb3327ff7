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
drawn on the host in NumPy, as in the JAX package.

On a mesh of several groups the cube's rows spread over the cards by the
JAX package's rule (``models/asp.py:72-90``: over ``"tile"``, padded
where the rows do not divide; :func:`radler_tpu_torch.parallel.rows.
tile_rows`): each part of the residual and the model lies on its card for
the major iteration, the scale-maxima bank and each component's cube
convolution run as slab FFTs (:func:`radler_tpu_torch.parallel.rows.
convolve_rows`), the peak searches as each part's argmax combined on the
lead, the subtractions on each part's rows, and a fit's window is copied
to the host from the parts whose rows it covers.  The component's
convolution with the PSFs, at the padded size of the largest scale, runs
on the lead and is subtracted from each part's rows.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..image_set import CubeMeta, get_integrated_psf, get_linear_integrated
from ..ops.convolution import (
    convolve_same,
    padded_convolve,
    prepare_kernel_fft,
)
from ..ops.gaussian_fit import (
    Ellipse,
    deconvolve_gaussian,
    draw_gaussian,
    fit_2d_gaussian_centred,
    fit_2d_gaussian_full,
    full_fit_box,
)
from ..ops.peak_finder import FLT_MIN, masked_peaks, window_mask
from ..ops.psf_subtract import subtract_psf_from_cube
from ..parallel.rows import (
    RowCache,
    Rows,
    SlabSpectrum,
    convolve_rows,
    full,
    tile_rows,
)
from ..settings import MultiscaleSettings
from ..utils import logging as log
from ..utils.fft_size import get_convolution_size
from .base import DeconvolutionResult
from .multiscale import (
    MultiScaleAlgorithm,
    initialize_scales,
    maxima_blob,
    scale_peaks,
    select_maximum_scale,
)


def _integrated(data, meta: CubeMeta):
    """The linear integration of a cube, spread or not."""
    if isinstance(data, Rows):
        return data.map(get_linear_integrated, meta)
    return get_linear_integrated(data, meta)


def scale_maxima_rows(integrated: Rows, bank: Optional[SlabSpectrum],
                      valid: Rows, rms_factor: Optional[Rows],
                      perm: torch.Tensor,
                      allow_negative: bool) -> torch.Tensor:
    """:func:`~radler_tpu_torch.models.multiscale.scale_maxima` of a spread
    image: the bank's convolutions as slab FFTs, then each part's
    :func:`~radler_tpu_torch.models.multiscale.scale_peaks` and sums of
    squares; on the lead, the first part with each scale's maximum
    (:meth:`Rows.peaks`), and the RMS from the sums added in part order.
    Returns the same ``[6, S]`` float64 tensor."""
    height, width = integrated.shape
    conv = (convolve_rows(integrated.map(lambda p: p[None]), bank)
            if bank is not None else None)
    squares = []

    def search(part, part_conv, ok, rms):
        sources = (part[None] if part_conv is None
                   else torch.cat([part[None], part_conv]))
        images = sources.index_select(0, perm.to(part.device))
        squares.append(torch.sum(images * images, dim=(1, 2)).to(
            integrated.lead))
        best, signed, idx, normalized = scale_peaks(images, ok, rms,
                                                    allow_negative)
        return best, idx, signed, normalized

    best, flat, signed, normalized = integrated.peaks(search, conv, valid,
                                                      rms_factor)
    total = squares[0]
    for part in squares[1:]:
        total = total + part
    return maxima_blob(best, flat, signed, normalized,
                       torch.sqrt(total / (height * width)), width)


def update_rows(cube: Rows, values: torch.Tensor, image: torch.Tensor,
                sign: float) -> None:
    """``cube += sign * values[:, None, None] * image`` on each part's
    rows, ``image`` (on the lead) copied there by rows."""
    for p, part in enumerate(cube.parts):
        r0, r1 = cube.layout.rows(p)
        term = (values.to(part.device)[:, None, None]
                * image[..., r0:r1, :].to(part.device))
        cube.parts[p] = part + term if sign > 0 else part - term


class AspAlgorithm(MultiScaleAlgorithm):
    """Multiscale's scale bank and peak search, with ASP's processing of
    each component."""

    def __init__(self, settings: MultiscaleSettings, beam_size: float,
                 pixel_scale_x: float, pixel_scale_y: float):
        super().__init__(settings, beam_size, pixel_scale_x, pixel_scale_y,
                         False)
        self._rows = RowCache()

    def clone(self) -> "AspAlgorithm":
        c = super().clone()
        c._rows = RowCache()
        return c

    def execute_major_iteration(self, dirty_set, model_set,
                                psfs: torch.Tensor) -> DeconvolutionResult:
        layout = (None if self.device_mesh is None
                  else tile_rows(self.device_mesh, dirty_set.height))
        if layout is None:
            return self._execute(dirty_set, model_set, psfs)
        # The cubes spread by rows for the major iteration, and come back
        # to the lead at its end.
        dirty_set.data = Rows.scatter(dirty_set.data, layout)
        model_set.data = Rows.scatter(model_set.data, layout)
        self._psfs_on = [psfs.to(d) for d in layout.devices]
        try:
            return self._execute(dirty_set, model_set, psfs)
        finally:
            dirty_set.data = full(dirty_set.data)
            model_set.data = full(model_set.data)
            self._psfs_on = None

    def _execute(self, dirty_set, model_set,
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
            _integrated(dirty_set.data, meta), report_rms=False)
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
            integrated = _integrated(dirty_set.data, meta)
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

    # -- the spread cube's steps ------------------------------------------
    def _scale_maxima(self, integrated, bank_f, valid, perm):
        if not isinstance(integrated, Rows):
            return super()._scale_maxima(integrated, bank_f, valid, perm)
        layout = integrated.layout
        return scale_maxima_rows(
            integrated,
            self._rows.spectrum(bank_f, layout) if bank_f.shape[0] else None,
            self._rows.rows(valid, layout),
            self._rows.rows(self.rms_factor_image, layout), perm,
            self.allow_negative_components)

    def _scale_convolve(self, images, scale: float):
        if not isinstance(images, Rows) or scale == 0.0:
            return super()._scale_convolve(images, scale)
        h, w = images.shape[-2:]
        return convolve_rows(images, self._rows.spectrum(
            self._kernel_fft(scale, h, w, images.lead), images.layout))

    def _find_peak_direct(self, image, scale_index: int) -> None:
        """``multiscale_algorithm.cc:700-748`` on a spread image: each
        part's windowed argmax, the first part with the maximum, one host
        read."""
        if not isinstance(image, Rows):
            return super()._find_peak_direct(image, scale_index)
        entry = self.scale_infos[scale_index]
        h, w = image.shape
        lead = image.lead
        valid = window_mask(h, w, int(round(w * self.clean_border_ratio)),
                            int(round(h * self.clean_border_ratio)))
        mask = (self.scale_masks[scale_index]
                if self.use_per_scale_masks and self.scale_masks
                else self.clean_mask)
        if mask is not None:
            valid = valid & np.asarray(mask, bool)
        valid = Rows.scatter(torch.as_tensor(valid, device=lead),
                             image.layout)
        allow_negative = self.allow_negative_components

        def search(part, ok, rms):
            weighted = part * rms if rms is not None else part
            best, signed, idx = masked_peaks(weighted[None], ok[None],
                                             allow_negative)
            at = (rms.reshape(-1).index_select(0, idx) if rms is not None
                  else torch.ones_like(signed))
            return best, idx, signed, at

        best, flat, value, rms_at = image.peaks(
            search, valid, self._rows.rows(self.rms_factor_image,
                                           image.layout))
        self._set_peak(entry, *torch.stack([
            value.double(), (flat % w).double(), (flat // w).double(),
            (best > FLT_MIN).double(), rms_at.double()])[:, 0].tolist())

    # ------------------------------------------------------------------
    def _deconvolve_point_source(self, x: int, y: int, dirty_set, model_set,
                                 psfs: torch.Tensor, meta: CubeMeta,
                                 psf_indices: torch.Tensor) -> None:
        """``asp_algorithm.cc:231-254``."""
        if isinstance(dirty_set.data, Rows):
            return self._point_source_rows(x, y, dirty_set, model_set, meta,
                                           psf_indices)
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

    def _point_source_rows(self, x: int, y: int, dirty_set, model_set,
                           meta: CubeMeta, psf_indices: torch.Tensor) -> None:
        """:meth:`_deconvolve_point_source` on spread cubes: the values
        read from the part that holds row y, each part's rows subtracted
        on its card."""
        dirty, model = dirty_set.data, model_set.data
        component_values = dirty.pixel(y, x).to(dirty.lead)
        fitter = self.spectral_fitter
        if fitter is not None and fitter.is_active:
            component_values = fitter.fit_and_evaluate(
                component_values.reshape(meta.n_channels,
                                         meta.n_polarizations),
                x, y).reshape(-1)
        component_values = component_values * self.minor_loop_gain
        p = model.owner(y)
        model.pixel(y, x).add_(component_values.to(model.parts[p].device))
        for p, part in enumerate(dirty.parts):
            dev = part.device
            dirty.parts[p] = subtract_psf_from_cube(
                part, self._psfs_on[p], psf_indices.to(dev), x, y,
                component_values.to(dev), row_offset=dirty.layout.rows(p)[0])

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
        spread = isinstance(dirty_set.data, Rows)
        window = (integrated.box(y1, x1, y2 - y1, x2 - x1, device="cpu")
                  if spread else integrated[y1:y2, x1:x2].cpu())
        fit_a, fit_x, fit_y, gaussian = fit_2d_gaussian_full(
            window.numpy(),
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

        dev = psfs.device
        # The deconvolved Gaussian at unit peak, centered: each channel's
        # PSF peak and each plane's peak through it.
        kernel = torch.as_tensor(draw_gaussian(
            np.zeros((height, width), np.float32), width // 2, height // 2,
            gaussian, 1.0), device=dev)
        psf_peaks = convolve_same(psfs, kernel)[:, height // 2, width // 2]
        if spread:
            component_peaks = convolve_rows(
                dirty_set.data,
                SlabSpectrum(prepare_kernel_fft(kernel), dirty_set.data.layout)
            ).pixel(peak_y, peak_x).to(dev)
        else:
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
        # The component convolved with each channel's PSF, padded for the
        # largest scale, subtracted from each plane.
        padded = (
            get_convolution_size(self.scale_infos[-1].scale, height,
                                 self.ms_settings.convolution_padding),
            get_convolution_size(self.scale_infos[-1].scale, width,
                                 self.ms_settings.convolution_padding),
        )
        conv = padded_convolve(component[None], psfs,
                               padded_shape=padded).index_select(
                                   0, psf_indices)
        if spread:
            update_rows(model_set.data, values, component, 1.0)
            update_rows(dirty_set.data, values, conv, -1.0)
            return
        model_set.data = model_set.data + values[:, None, None] * component
        dirty_set.data = dirty_set.data - values[:, None, None] * conv

