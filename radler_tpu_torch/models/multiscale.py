"""Multiscale CLEAN (Offringa & Smirnov 2017).

Port of ``radler_tpu.models.multiscale`` (``cpp/algorithms/
multiscale_algorithm.{h,cc}``).  Its two routes are the JAX package's:

* By default (``fast_sub_minor_loop`` set, the working set within
  :data:`FUSED_MEMORY_BUDGET` bytes, ``RADLER_TPU_NO_FUSED_MS`` unset) a major
  iteration runs :func:`~radler_tpu_torch.models.multiscale_fused.
  fused_multiscale_minor_loop`, whose residual stays in the spectral domain
  (:meth:`MultiScaleAlgorithm._execute_fused`), on a device mesh too.
* Otherwise the host-orchestrated path below runs.

The host path:

* The per-scale convolved-peak search is one FFT of the integrated image
  against the whole bank of kernel spectra, followed by per-scale masked
  argmaxes and one host read for every scale (:func:`scale_maxima`).
* The fixed-scale subminor loop runs on the scale-convolved cube with the
  twice-convolved PSFs (``multiscale_algorithm.cc:377-461``): up to
  :data:`DENSE_SUBMINOR_MAX_PIXELS` as the dense masked clean of
  :func:`~radler_tpu_torch.models.multiscale_fused.dense_subminor_loop`
  (the Högbom kernel pair in linear mode), above it as the Clark loop of
  :class:`~radler_tpu_torch.models.subminor.SubMinorLoop` (one B2 launch).
  The JAX package routes the two the same way.
* Scale state (bias factors, activation, per-scale masks and cleaning
  statistics) persists across major iterations, as in the reference.  The
  dense route's auto-mask and component updates accumulate on the device
  and reach the host once per major iteration.

On a facet grid every facet's fused loop runs at once by default
(:meth:`MultiScaleAlgorithm.execute_batched_facets`, the JAX package's
batched facets).  With component optimization set (after auto-masking),
a major iteration refines the tracked components instead
(:meth:`MultiScaleAlgorithm._run_full_component_fitter`).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..component_list import ComponentList
from ..image_set import CubeMeta, get_integrated_psf, get_linear_integrated
from ..ops.component_optimization import gradient_descent_with_variable_psf
from ..ops.convolution import (
    centered_embed_kernel_fft,
    convolve_same_prefft,
    forward_fft2,
    inverse_fft2_real,
    padded_convolve,
    prepare_kernel_fft,
)
from ..ops.multiscale_kernels import (
    add_shape_component,
    embedded_kernel,
    kernel_peak_value,
    make_shape_function,
)
from ..ops.peak_finder import FLT_MIN, find_peak, window_mask
from ..ops.psf_subtract import subtract_psf_from_cube
from ..parallel.mesh import shard_multiscale_inputs
from ..settings import (
    MultiscaleSettings,
    MultiscaleShape,
    OptimizationAlgorithm,
    SpectralFittingMode,
)
from ..utils import logging as log
from ..utils.fft_size import get_convolution_size
from .base import DeconvolutionAlgorithm, DeconvolutionResult
from .multiscale_fused import (
    dense_subminor_loop,
    facet_fused_multiscale_minor_loop,
    fused_multiscale_minor_loop,
    mesh_subminor_eligible,
)
from .subminor import SubMinorLoop, correct_residual

# The largest image (pixels) whose subminor loop is the dense masked clean;
# larger images run the Clark loop on the candidate set.  The JAX package's
# rule (multiscale.py:1686); tests set it to 0 to reach the Clark route.
DENSE_SUBMINOR_MAX_PIXELS = 4096 * 4096

# The fused loop runs when its estimated working set (banks, spectral
# residual, temporaries) stays under this many bytes: the JAX package's
# budget (multiscale.py:824), so that both packages take the same route.
FUSED_MEMORY_BUDGET = 9e9

# The batched facet route runs while its per-facet estimate stays under this
# many bytes: the JAX package's (multiscale.py:1386) on every device, so
# that the port takes the JAX package's route whatever memory the device
# has.
BATCHED_FACETS_BUDGET = 9e9


@dataclasses.dataclass
class ScaleInfo:
    """Mirrors ``MultiScaleAlgorithm::ScaleInfo``."""

    scale: float = 0.0
    kernel_peak: float = 0.0
    psf_peak: float = 0.0
    bias_factor: float = 1.0
    gain: float = 1.0
    is_active: bool = True
    n_components_cleaned: int = 0
    total_flux_cleaned: float = 0.0
    max_unnormalized_image_value: float = 0.0
    max_normalized_image_value: float = 0.0
    max_image_value_x: int = 0
    max_image_value_y: int = 0
    rms: float = -1.0


def initialize_scales(
    scales: List[ScaleInfo],
    beam_size_in_pixels: float,
    min_width_height: int,
    shape: MultiscaleShape,
    max_scales: int,
    scale_list: List[float],
) -> None:
    """Beam-derived geometric scale series {0, 2b, 4b, ...} capped at half the
    image (``multiscale_algorithm.cc:90-131``)."""
    if not scale_list:
        if not scales:
            scale_index = 0
            scale = beam_size_in_pixels * 2.0
            while True:
                entry = ScaleInfo()
                entry.scale = 0.0 if scale_index == 0 else scale
                entry.kernel_peak = kernel_peak_value(
                    scale, min_width_height, shape
                )
                scales.append(entry)
                scale *= 2.0
                scale_index += 1
                if not (
                    scale < min_width_height * 0.5
                    and (max_scales == 0 or scale_index < max_scales)
                ):
                    break
        else:
            while scales and scales[-1].scale >= min_width_height * 0.5:
                scales.pop()
    elif not scales:
        for scale in sorted(scale_list):
            entry = ScaleInfo()
            entry.scale = scale
            entry.kernel_peak = kernel_peak_value(scale, min_width_height, shape)
            scales.append(entry)


def select_maximum_scale(scales: List[ScaleInfo]) -> Optional[int]:
    """Bias-weighted argmax over active scales
    (``multiscale_algorithm.cc:133-151``)."""
    best: Optional[int] = None
    best_val = -1.0
    for i, s in enumerate(scales):
        if s.is_active:
            val = abs(s.max_unnormalized_image_value * s.bias_factor)
            if best is None or val > best_val:
                # Ties keep the lowest scale index: the reference's
                # map::insert keeps the first insertion for a duplicate key.
                best, best_val = i, val
    return best


def _scale_convolved_center_values(convolved: Sequence[torch.Tensor]) -> List[float]:
    """The center pixel of every scale-convolved PSF ``psf ⊛ kernel_s``, in
    one host read (the psf_peak values of ``ConvolvePsfs``,
    ``multiscale_algorithm.cc:44``)."""
    h, w = convolved[0].shape[-2:]
    return torch.stack([cp[h // 2, w // 2] for cp in convolved]).tolist()


def _twice_convolved_stack(psfs: torch.Tensor,
                           kernel_f: Optional[torch.Tensor]) -> torch.Tensor:
    """The ``[C, H, W]`` twice-convolved PSFs of one scale: its
    single-convolved PSFs convolved once more with the scale kernel of
    spectrum ``kernel_f`` (None for scale 0), every channel in one batched
    FFT (the double convolution of ``multiscale_algorithm.cc:331-344``)."""
    if kernel_f is None:
        return psfs.contiguous()
    return convolve_same_prefft(psfs, kernel_f)


def _accum_scale_mask(mask_acc: torch.Tensor, comp: torch.Tensor,
                      s: int) -> None:
    """OR the non-zero footprint of a component cube into ``mask_acc[s]``,
    on the device (the device form of ``SubMinorLoop``'s auto-mask update)."""
    mask_acc[s] |= torch.any(comp != 0.0, dim=0)


def scale_maxima(
    integrated: torch.Tensor,  # [H, W]
    bank_f: torch.Tensor,  # [S_conv, H, W//2+1] kernel spectra (scales != 0)
    valid: torch.Tensor,  # [S, H, W] bool searchable windows
    rms_factor: Optional[torch.Tensor],  # [H, W] or None
    perm: torch.Tensor,  # [S] int64 source slot: 0 = raw, 1 + i = bank[i]
    allow_negative: bool,
) -> torch.Tensor:
    """The scale-bank convolution and every scale's masked argmax in one
    pass (``_scale_maxima_jit`` of the JAX package): one rfft2 of the
    integrated image, one batched irfft2 against the bank, then per scale
    the signed peak value, its position, ``found``, the value divided by
    the rms factor there and the scale's RMS.  Returns them as one
    ``[6, S]`` float64 tensor (value, x, y, found, normalized, rms) for a
    single host read."""
    h, w = integrated.shape
    if bank_f.shape[0]:
        conv = torch.fft.irfft2(torch.fft.rfft2(integrated)[None] * bank_f,
                                s=(h, w))
        sources = torch.cat([integrated[None], conv])
    else:
        sources = integrated[None]
    n = perm.shape[0]
    images = sources.index_select(0, perm)  # [S, H, W], scale_infos order
    weighted = images * rms_factor if rms_factor is not None else images
    cmp = weighted.abs() if allow_negative else weighted
    masked = torch.where(valid, cmp, -math.inf).reshape(n, h * w)
    idx = torch.argmax(masked, dim=1, keepdim=True)
    found = torch.gather(masked, 1, idx)[:, 0] > FLT_MIN
    signed = torch.gather(weighted.reshape(n, h * w), 1, idx)[:, 0]
    idx = idx[:, 0]
    normalized = (
        signed / rms_factor.reshape(-1).index_select(0, idx)
        if rms_factor is not None
        else signed
    )
    rms = torch.sqrt(torch.mean(images * images, dim=(1, 2)))
    return torch.stack([
        signed.double(), (idx % w).double(), (idx // w).double(),
        found.double(), normalized.double(), rms.double(),
    ])


def _same_psfs(kept: torch.Tensor, kept_version: int,
               psfs: torch.Tensor) -> bool:
    """Whether ``psfs`` holds what the kept PSF stack held when banks were
    made from it (one host read unless it is the kept tensor itself)."""
    if kept._version != kept_version:
        return False
    if kept is psfs:
        return True
    return (kept.shape == psfs.shape and kept.device == psfs.device
            and bool(torch.equal(kept, psfs)))


class MultiScaleAlgorithm(DeconvolutionAlgorithm):
    """``cpp/algorithms/multiscale_algorithm.{h,cc}``."""

    def __init__(
        self,
        settings: MultiscaleSettings,
        beam_size: float,
        pixel_scale_x: float,
        pixel_scale_y: float,
        track_components: bool = False,
    ):
        super().__init__()
        self.ms_settings = settings
        pixel_scale = max(pixel_scale_x, pixel_scale_y)
        self.beam_size_in_pixels = (
            beam_size / pixel_scale if pixel_scale > 0.0 else 0.0
        )
        if self.beam_size_in_pixels <= 0.0:
            self.beam_size_in_pixels = 1.0
        self.track_per_scale_masks = False
        self.use_per_scale_masks = False
        self.track_components = track_components
        self.scale_infos: List[ScaleInfo] = []
        self.scale_masks: List[Optional[np.ndarray]] = []
        self._component_list: Optional[ComponentList] = None
        self._kernel_cache: Dict[Tuple, torch.Tensor] = {}
        # The per-scale search windows: fixed within a major iteration,
        # rebuilt at its start.
        self._valid_stack_cache: Optional[torch.Tensor] = None
        # The dense route's auto-mask and component updates accumulate on
        # the device and reach the host once per major iteration (masks are
        # written while tracking and read while using, never both in one
        # major iteration: cpp/radler.cc:170-238).
        self._mask_acc: Optional[torch.Tensor] = None  # [S, H, W] bool
        self._comp_acc: Dict[int, torch.Tensor] = {}  # scale -> [N, H, W]
        # The fused loop's banks, kept while their configuration and PSFs
        # stay the same: (key, psfs, psfs._version, peaks, banks); the
        # batched facets' direction-dependent PSFs keep one a PSF slot, slot
        # 0 here and the others in _slot_banks.
        self._fused_banks: Optional[tuple] = None
        self._slot_banks: Dict[int, tuple] = {}

    # -- plumbing used by ParallelDeconvolution ------------------------
    def set_auto_mask_mode(self, track: bool, use: bool) -> None:
        self.track_per_scale_masks = track
        self.use_per_scale_masks = use

    @property
    def scale_count(self) -> int:
        return len(self.scale_infos)

    def scale_size(self, index: int) -> float:
        return self.scale_infos[index].scale

    def get_scale_mask_count(self) -> int:
        return len(self.scale_masks)

    def set_scale_mask_count(self, n: int) -> None:
        while len(self.scale_masks) < n:
            self.scale_masks.append(None)

    def get_scale_mask(self, index: int) -> np.ndarray:
        return self.scale_masks[index]

    def set_scale_mask(self, index: int, mask: np.ndarray) -> None:
        self.scale_masks[index] = mask

    def get_component_list(self) -> ComponentList:
        return self._component_list

    def clear_component_list(self) -> None:
        # The reference resets the list entirely (``multiscale_algorithm.h:
        # 46``): a fresh one is allocated on the next run.
        self._component_list = None

    def clone(self) -> "MultiScaleAlgorithm":
        """A facet's copy (``multiscale.py:342-353`` of the JAX package) with
        scales, masks, components and every cache of its own: the kernel
        spectra and the fused banks are made for a facet's box, which is not
        the image's, and no tensor is shared with the original."""
        c = super().clone()
        c.scale_infos = []
        c.scale_masks = []
        c._component_list = None
        c._kernel_cache = {}
        c._valid_stack_cache = None
        c._mask_acc = None
        c._comp_acc = {}
        c._fused_banks = None
        c._slot_banks = {}
        return c

    # -- kernels -------------------------------------------------------
    def _kernel_fft(self, scale: float, height: int, width: int,
                    device) -> torch.Tensor:
        """The scale kernel's cached spectrum: the kernels are fixed for a
        run, so each is transformed once (the reference re-runs the kernel
        FFT inside each Convolve call)."""
        key = (round(scale, 6), height, width, self.ms_settings.shape, device)
        if key not in self._kernel_cache:
            kernel = torch.as_tensor(
                embedded_kernel(scale, height, width, self.ms_settings.shape),
                device=device,
            )
            self._kernel_cache[key] = prepare_kernel_fft(kernel)
        return self._kernel_cache[key]

    def _scale_convolve(self, images: torch.Tensor,
                        scale: float) -> torch.Tensor:
        if scale == 0.0:
            return images
        h, w = images.shape[-2:]
        return convolve_same_prefft(
            images, self._kernel_fft(scale, h, w, images.device))

    # -- PSF preparation (``ConvolvePsfs``, multiscale_algorithm.cc:29-88) --
    def _convolve_psfs(self, psf: torch.Tensor) -> List[torch.Tensor]:
        """The integrated ``[H, W]`` PSF convolved with every scale's
        kernel, and from these each scale's PSF peak, bias factor and gain
        (one host read for all scales)."""
        convolved = [self._scale_convolve(psf, e.scale)
                     for e in self.scale_infos]
        self._apply_psf_peaks(_scale_convolved_center_values(convolved))
        return convolved

    def _apply_psf_peaks(self, peaks: Sequence[float]) -> None:
        """Set each scale's psf_peak, bias factor and gain from the
        convolved PSFs' center values (``ConvolvePsfs`` side effects)."""
        first_auto_scale_size = self.beam_size_in_pixels * 2.0
        for entry, psf_peak in zip(self.scale_infos, peaks):
            entry.psf_peak = float(psf_peak)
            if entry.scale == 0.0 or len(self.scale_infos) < 2:
                exp_term = 0.0
            else:
                exp_term = math.log2(entry.scale / first_auto_scale_size)
            entry.bias_factor = self.ms_settings.scale_bias ** (-exp_term)
            entry.gain = self.minor_loop_gain / entry.psf_peak
            entry.is_active = True
            log.info(
                f"- Scale {round(entry.scale)}, bias factor="
                f"{round(entry.bias_factor * 10.0) / 10.0}, "
                f"psfpeak={entry.psf_peak}, gain={entry.gain}"
            )

    # -- peak search over all scales -------------------------------------
    def _scale_valid_stack(self, height: int, width: int,
                           device) -> torch.Tensor:
        """``[S, H, W]`` bool stack of searchable windows per scale: the
        scale-dependent border (``multiscale_algorithm.cc:597-603``) ANDed
        with the per-scale auto-mask or the clean mask.  Cached for the
        major iteration."""
        if self._valid_stack_cache is not None:
            return self._valid_stack_cache
        stack = np.zeros((len(self.scale_infos), height, width), dtype=bool)
        for i, entry in enumerate(self.scale_infos):
            x_border = int(round(width * self.clean_border_ratio))
            y_border = int(round(height * self.clean_border_ratio))
            if entry.scale != 0.0:
                # FindPeakDirect (scale 0) uses the plain border ratio only.
                border_scale = int(math.ceil(entry.scale * 0.5))
                x_border = max(x_border, border_scale)
                y_border = max(y_border, border_scale)
            m = window_mask(height, width, x_border, y_border)
            if self.use_per_scale_masks and self.scale_masks:
                m = m & np.asarray(self.scale_masks[i])
            elif self.clean_mask is not None:
                m = m & np.asarray(self.clean_mask)
            stack[i] = m
        self._valid_stack_cache = torch.as_tensor(stack, device=device)
        return self._valid_stack_cache

    def _find_active_scale_convolved_maxima(
        self, integrated: torch.Tensor, report_rms: bool
    ) -> None:
        """Batched ``FindActiveScaleConvolvedMaxima``
        (``multiscale_algorithm.cc:578-634``) and ``FindSingleScalePeak``
        (``threaded_deconvolution_tools.cc:52-107``) with one host read.
        Inactive scales are refreshed too, as in the JAX package:
        :func:`select_maximum_scale` and :meth:`_activate_scales` filter on
        ``is_active``, so this only makes reactivation use current peaks."""
        h, w = integrated.shape
        dev = integrated.device
        entries = self.scale_infos
        conv_idx = [i for i, s in enumerate(entries) if s.scale != 0.0]
        bank_key = ("bank", h, w, tuple(entries[i].scale for i in conv_idx),
                    dev)
        if bank_key not in self._kernel_cache:
            bank = (
                torch.stack([self._kernel_fft(entries[i].scale, h, w, dev)
                             for i in conv_idx])
                if conv_idx
                else torch.zeros((0, h, w // 2 + 1), dtype=torch.complex64,
                                 device=dev)
            )
            # Source slot of each scale: 0 is the unconvolved image (scale
            # 0), 1.. are the bank's outputs in ``conv_idx`` order.
            perm = np.zeros(len(entries), np.int64)
            for pos, i in enumerate(conv_idx):
                perm[i] = pos + 1
            self._kernel_cache[bank_key] = (
                bank, torch.as_tensor(perm, device=dev))
        bank_f, perm = self._kernel_cache[bank_key]
        out = scale_maxima(
            integrated, bank_f, self._scale_valid_stack(h, w, dev),
            self.rms_factor_image, perm, self.allow_negative_components,
        ).tolist()
        for i, entry in enumerate(entries):
            value, x, y, found, normalized, rms = (row[i] for row in out)
            if report_rms:
                entry.rms = rms
            if found:
                entry.max_unnormalized_image_value = value
                entry.max_normalized_image_value = normalized
                entry.max_image_value_x = int(x)
                entry.max_image_value_y = int(y)
            else:
                entry.max_unnormalized_image_value = 0.0
                entry.max_normalized_image_value = 0.0

    def _activate_scales(self, scale_with_last_peak: int) -> None:
        """``multiscale_algorithm.cc:636-656``."""
        ref = self.scale_infos[scale_with_last_peak]
        threshold = (
            abs(ref.max_unnormalized_image_value)
            * (1.0 - self.minor_loop_gain)
            * ref.bias_factor
        )
        for i, s in enumerate(self.scale_infos):
            s.is_active = (
                i == scale_with_last_peak
                or abs(s.max_unnormalized_image_value) * s.bias_factor
                > threshold
            )

    # -- the major iteration -------------------------------------------
    def execute_major_iteration(
        self, dirty_set, model_set, psfs: torch.Tensor
    ) -> DeconvolutionResult:
        meta: CubeMeta = dirty_set.meta
        width, height = dirty_set.width, dirty_set.height
        if self.stop_on_negative_components:
            self.allow_negative_components = True
        # Masks and borders may have changed between major iterations.
        self._valid_stack_cache = None
        self._mask_acc = None
        self._comp_acc = {}

        initialize_scales(
            self.scale_infos,
            self.beam_size_in_pixels,
            min(width, height),
            self.ms_settings.shape,
            self.ms_settings.max_scales,
            self.ms_settings.scale_list,
        )

        if self.track_per_scale_masks:
            for mask in self.scale_masks:
                if mask is not None and mask.shape != (height, width):
                    raise RuntimeError(
                        "Invalid automask size in multiscale algorithm"
                    )
            while len(self.scale_masks) < len(self.scale_infos):
                self.scale_masks.append(None)
            for i, mask in enumerate(self.scale_masks):
                if mask is None:
                    self.scale_masks[i] = np.zeros((height, width), dtype=bool)
        if self.track_components:
            if self._component_list is None:
                self._component_list = ComponentList(
                    width, height, len(self.scale_infos), dirty_set.n_images
                )
            elif (
                self._component_list.width != width
                or self._component_list.height != height
            ):
                raise RuntimeError("Error in component list dimensions!")

        result = DeconvolutionResult()
        if self.component_optimization_algorithm != OptimizationAlgorithm.CLEAN:
            self._run_full_component_fitter(dirty_set, model_set, psfs)
            return result

        if self._fused_eligible(meta, width, height):
            return self._execute_fused(dirty_set, model_set, psfs, result)

        has_hit_threshold_in_sub_loop = False
        threshold_countdown = max(8, len(self.scale_infos) * 3 // 2)

        # The integrated PSF convolved with every scale gives the scales'
        # peaks and gains; with one channel it is the channel's PSF, and its
        # convolutions are the single-convolved PSFs.  With several, each
        # scale's [C, H, W] single-convolved PSFs are made when the scale is
        # first selected, and its twice-convolved ones likewise.
        integrated_psf = get_integrated_psf(psfs, meta)
        integrated_convolved = self._convolve_psfs(integrated_psf)
        single_convolved: Dict[int, torch.Tensor] = {}
        twice_convolved: Dict[int, torch.Tensor] = {}

        def single_psfs(s: int) -> torch.Tensor:
            if s not in single_convolved:
                single_convolved[s] = (
                    integrated_convolved[s][None]
                    if meta.n_channels == 1
                    else self._scale_convolve(psfs, self.scale_infos[s].scale)
                ).contiguous()
            return single_convolved[s]

        integrated = get_linear_integrated(dirty_set.data, meta)
        self._find_active_scale_convolved_maxima(integrated, report_rms=True)
        scale_with_peak = select_maximum_scale(self.scale_infos)
        if scale_with_peak is None:
            log.warn("No peak found during multi-scale cleaning! Aborting.")
            result.another_iteration_required = False
            return result

        is_final_threshold = False
        peak_entry = self.scale_infos[scale_with_peak]
        initial_peak_value = abs(
            peak_entry.max_unnormalized_image_value * peak_entry.bias_factor
        )
        m_gain_threshold = initial_peak_value * (1.0 - self.major_loop_gain)
        m_gain_threshold = max(m_gain_threshold, self.major_iteration_threshold)
        first_threshold = m_gain_threshold
        if self.threshold > first_threshold:
            first_threshold = self.threshold
            is_final_threshold = True

        diverging = False

        def current_biased_peak() -> float:
            e = self.scale_infos[scale_with_peak]
            return e.max_unnormalized_image_value * e.bias_factor

        while (
            self.iteration_number < self.max_iterations
            and abs(current_biased_peak()) > first_threshold
            and (
                not self.stop_on_negative_components
                or self.scale_infos[scale_with_peak].max_unnormalized_image_value
                >= 0.0
            )
            and threshold_countdown > 0
            and not diverging
        ):
            entry = self.scale_infos[scale_with_peak]
            scale = entry.scale

            # Twice-convolved PSFs and the scale-convolved residual cube
            # (multiscale_algorithm.cc:331-354); the PSF stacks are kept
            # per scale for the whole major iteration.
            if scale_with_peak not in twice_convolved:
                twice_convolved[scale_with_peak] = _twice_convolved_stack(
                    single_psfs(scale_with_peak),
                    None if scale == 0.0 else self._kernel_fft(
                        scale, height, width, psfs.device),
                )
            # The dense subminor loop cleans this cube in place: at scale 0
            # it must not be the residual itself.
            individual_convolved = (
                self._scale_convolve(dirty_set.data, scale)
                if scale != 0.0
                else dirty_set.data.clone()
            )

            sub_gain_threshold = abs(current_biased_peak()) * (
                1.0 - self.ms_settings.sub_minor_loop_gain
            )
            first_sub_threshold = sub_gain_threshold
            if first_threshold > first_sub_threshold:
                first_sub_threshold = first_threshold
                if not has_hit_threshold_in_sub_loop:
                    log.info(
                        "Subminor loop is near minor loop threshold. "
                        "Initiating countdown."
                    )
                    has_hit_threshold_in_sub_loop = True
                threshold_countdown -= 1

            if self.ms_settings.fast_sub_minor_loop:
                diverging = self._run_fast_sub_loop(
                    dirty_set,
                    model_set,
                    meta,
                    single_psfs(scale_with_peak),
                    twice_convolved[scale_with_peak],
                    individual_convolved,
                    scale_with_peak,
                    first_sub_threshold,
                    sub_gain_threshold,
                    initial_peak_value,
                )
                if diverging is None:
                    # The subminor loop found no components (the reference's
                    # error at multiscale_algorithm.cc:417-424).
                    diverging = False
                    break
            else:
                diverging = self._run_slow_sub_loop(
                    dirty_set,
                    model_set,
                    meta,
                    single_psfs(scale_with_peak),
                    twice_convolved[scale_with_peak],
                    individual_convolved,
                    scale_with_peak,
                    first_sub_threshold,
                    initial_peak_value,
                )

            self._activate_scales(scale_with_peak)
            integrated = get_linear_integrated(dirty_set.data, meta)
            self._find_active_scale_convolved_maxima(integrated,
                                                     report_rms=False)
            scale_with_peak = select_maximum_scale(self.scale_infos)
            if scale_with_peak is None:
                log.warn(
                    "No peak found in main loop of multi-scale cleaning! "
                    "Aborting deconvolution."
                )
                self._flush_device_tracking()
                result.another_iteration_required = False
                return result
            log.info(
                f"Iteration {self.iteration_number}, scale "
                f"{round(self.scale_infos[scale_with_peak].scale)} px : "
                f"{current_biased_peak():.6g} at "
                f"{self.scale_infos[scale_with_peak].max_image_value_x},"
                f"{self.scale_infos[scale_with_peak].max_image_value_y}"
            )

        self._flush_device_tracking()

        # Stop-reason reporting (multiscale_algorithm.cc:545-575).
        max_iter_reached = self.iteration_number >= self.max_iterations
        negative_reached = (
            self.stop_on_negative_components
            and self.scale_infos[scale_with_peak].max_unnormalized_image_value
            < 0.0
        )
        result.is_diverging = diverging
        result.another_iteration_required = (
            not max_iter_reached
            and not is_final_threshold
            and not negative_reached
            and not diverging
        )
        result.final_peak_value = current_biased_peak()
        return result

    # -- the fused route (multiscale_fused.py) ----------------------------
    def _fused_eligible(self, meta: CubeMeta, width: int, height: int) -> bool:
        """Whether a major iteration runs the fused loop: the JAX package's
        rule (``multiscale.py:791-824``), so that both packages take the
        same route.  ``RADLER_TPU_NO_FUSED_MS`` selects the host path."""
        if os.environ.get("RADLER_TPU_NO_FUSED_MS"):
            return False
        if not self.ms_settings.fast_sub_minor_loop or not self.scale_infos:
            return False
        S = len(self.scale_infos)
        split, (ph, pw), (phl, pwl) = self._correction_split(width, height)
        N, C = meta.n_images, meta.n_channels
        est = (
            2 * S * C * height * width * 4  # single + twice PSF stacks
            + (S + C) * ph * pw * 8  # kernel + PSF spectra (small size)
            + (S - split + C) * phl * pwl * 8  # large size spectra
            + N * ph * pw * 8  # the spectral residual res_f
            + 2 * N * ph * pw * 8  # spectral-subtract temporaries
            + 2 * max(S, N) * ph * pw * 4  # maxima / cube inverse transients
            + S * height * width  # search windows
            + 6 * N * height * width * 4  # cube copies
        )
        if self.track_per_scale_masks:
            est += S * height * width
        if self.track_components:
            est += 2 * S * N * height * width * 4
        return est < FUSED_MEMORY_BUDGET

    def _correction_split(self, width: int, height: int):
        """Split the ascending scales into a small and a large correction
        size (``multiscale.py:826-868`` of the JAX package).  The reference
        pads each scale's correction to its own convolution size
        (``fft_size_calculations.h:39-50``); the fused loop's spectral
        residual lives at one size, which every outer pass pays, so that
        size is the largest of the prefix of scales whose padded area stays
        within 1.30 times the smallest scale's.  The other scales correct
        at the largest scale's size.

        Returns ``(split, (pa_h, pa_w), (pb_h, pb_w))``: scales
        ``[0, split)`` take the small size, ``[split, S)`` the large one;
        ``split == S`` is one size."""
        pad = self.ms_settings.convolution_padding
        sizes = [
            (get_convolution_size(e.scale, height, pad),
             get_convolution_size(e.scale, width, pad))
            for e in self.scale_infos
        ]
        pb = sizes[-1]
        base = sizes[0][0] * sizes[0][1]
        split = len(sizes)
        for i, (sh, sw) in enumerate(sizes):
            if sh * sw > 1.30 * base:
                split = i
                break
        if split == 0 or split == len(sizes):
            return len(sizes), pb, pb
        return split, sizes[split - 1], pb

    def _compact_kernel_stack(self, width: int, height: int) -> np.ndarray:
        """``[S, kmax, kmax]`` stack of centered scale kernels (scale 0 is a
        centered delta, whose origin-rolled spectrum is exactly flat)."""
        kernels = [
            np.ones((1, 1), np.float32) if e.scale == 0.0
            else make_shape_function(e.scale, min(width, height),
                                     self.ms_settings.shape)
            for e in self.scale_infos
        ]
        kmax = max(k.shape[0] for k in kernels)
        stack = np.zeros((len(kernels), kmax, kmax), np.float32)
        for i, k in enumerate(kernels):
            o = kmax // 2 - k.shape[0] // 2
            stack[i, o:o + k.shape[0], o:o + k.shape[0]] = k
        return stack

    def _prepare_fused_banks(self, meta: CubeMeta, width: int, height: int,
                             psfs: torch.Tensor, slot: int = 0):
        """The fused loop's per-scale banks (``multiscale.py:870-1011`` of
        the JAX package): the scale kernels' and the correction PSFs'
        spectra at both padded sizes, factored (S + C planes, not the
        reference's S x C bank of ``ConvolvePsfs``), the ``[S, C, H, W]``
        twice-convolved PSFs, each scale's PSF peak, bias factor and gain,
        and the split.

        They are kept on the algorithm while the configuration and the
        PSFs stay the same, so a ``Radler`` builds them once: a PSF stack
        hits when it is the kept tensor at the kept version, or an equal
        tensor (``load_and_average_psfs`` makes a new one every perform)
        while the kept one was not changed in place.  The batched facets'
        direction-dependent PSFs keep one bank a ``slot``."""
        split, pa, pb = self._correction_split(width, height)
        key = (width, height, meta, tuple(e.scale for e in self.scale_infos),
               self.ms_settings.shape, self.ms_settings.scale_bias,
               self.minor_loop_gain, split, pa, pb, psfs.device)
        kept = self._fused_banks if slot == 0 else self._slot_banks.get(slot)
        if kept is not None and kept[0] == key and _same_psfs(
                kept[1], kept[2], psfs):
            self._apply_psf_peaks(kept[3])
            return kept[4]
        self._keep_banks(slot, None)
        S = len(self.scale_infos)
        compact = torch.as_tensor(self._compact_kernel_stack(width, height),
                                  device=psfs.device)
        # The integrated PSF convolved with every scale: the peaks, bias
        # factors and gains (ConvolvePsfs), one host read.
        integrated_psf = get_integrated_psf(psfs, meta)
        kimg_f = centered_embed_kernel_fft(compact, (height, width))
        peaks = inverse_fft2_real(
            forward_fft2(integrated_psf)[None] * kimg_f, (height, width)
        )[:, height // 2, width // 2].tolist()
        self._apply_psf_peaks(peaks)
        # The correction PSFs (the integrated PSF for one channel, as the
        # host path's) and [S, C, H, W] twice-convolved PSFs,
        # ifft(fft(psf_c) * kernel_f[s]^2).
        corr_psfs = psfs if meta.n_channels > 1 else integrated_psf[None]
        twice = inverse_fft2_real(
            forward_fft2(corr_psfs)[None, :]
            * (kimg_f[:, None] * kimg_f[:, None]),
            (height, width),
        )
        del kimg_f
        kernel_f = centered_embed_kernel_fft(compact, pa)
        psf_f = centered_embed_kernel_fft(corr_psfs, pa)
        kernel_f_large = psf_f_large = None
        if split < S:
            kernel_f_large = centered_embed_kernel_fft(compact[split:], pb)
            psf_f_large = centered_embed_kernel_fft(corr_psfs, pb)
        bias = np.asarray([e.bias_factor for e in self.scale_infos],
                          np.float32)
        gain_arr = np.asarray([e.gain for e in self.scale_infos], np.float32)
        banks = (kernel_f, twice, psf_f, kernel_f_large, psf_f_large, bias,
                 gain_arr, split, pa, pb)
        self._keep_banks(slot, (key, psfs, psfs._version, peaks, banks))
        return banks

    def _keep_banks(self, slot: int, kept: Optional[tuple]) -> None:
        if slot == 0:
            self._fused_banks = kept
        elif kept is None:
            self._slot_banks.pop(slot, None)
        else:
            self._slot_banks[slot] = kept

    def _execute_fused(self, dirty_set, model_set, psfs: torch.Tensor,
                       result: DeconvolutionResult) -> DeconvolutionResult:
        """One major iteration on the fused route (``_execute_fused`` of
        the JAX package, ``multiscale.py:1071-1332``).  On a device mesh
        the inputs are checked to lie on its device and, where the cube
        divides over it, the dense subminor loop runs partitioned (B4 or
        B1 on row shards)."""
        meta: CubeMeta = dirty_set.meta
        width, height = dirty_set.width, dirty_set.height
        (kernel_f, twice, psf_f, kernel_f_large, psf_f_large, bias, gain_arr,
         split, padded_small, padded_large) = self._prepare_fused_banks(
            meta, width, height, psfs)
        valid_stack = self._scale_valid_stack(height, width, psfs.device)
        fitter = self.spectral_fitter
        if fitter is not None and not fitter.is_active:
            fitter = None
        if (fitter is not None
                and fitter.mode == SpectralFittingMode.FORCED_TERMS
                and fitter._forced_terms is None):
            # As the JAX package's _forced_terms_or_dummy: no flat spectra
            # from absent term images.
            raise RuntimeError("Forced terms have not been set")
        residual, model = dirty_set.data, model_set.data
        rms_factor = self.rms_factor_image
        mesh = self.device_mesh
        if mesh is not None and mesh.size > 1:
            shard_multiscale_inputs(mesh, residual, model, kernel_f, twice,
                                    psf_f, kernel_f_large, psf_f_large,
                                    valid_stack, rms_factor)
        if not mesh_subminor_eligible(mesh, meta, height, fitter):
            mesh = None

        out = fused_multiscale_minor_loop(
            residual, model, kernel_f, twice, psf_f, kernel_f_large,
            psf_f_large, valid_stack, rms_factor, bias, gain_arr,
            self.threshold, self.major_iteration_threshold,
            self.major_loop_gain, self.ms_settings.sub_minor_loop_gain,
            self.minor_loop_gain, self.divergence_limit,
            self.iteration_number, self.max_iterations,
            max(8, len(self.scale_infos) * 3 // 2),
            meta=meta,
            allow_negative=self.allow_negative_components,
            stop_on_negative=self.stop_on_negative_components,
            fitter=fitter, split=split, padded_small=padded_small,
            padded_large=padded_large,
            track_masks=self.track_per_scale_masks,
            track_components=self.track_components, mesh=mesh,
        )
        dirty_set.data = out.residual
        model_set.data = out.model
        self.iteration_number = out.iteration_number
        flux = out.flux_per_scale.tolist()
        for i, entry in enumerate(self.scale_infos):
            entry.n_components_cleaned += out.components_per_scale[i]
            entry.total_flux_cleaned += flux[i]
        # The device accumulators reach the host state once per major
        # iteration, as on the host path.
        if self.track_per_scale_masks:
            self._mask_acc = out.mask_acc
        if self.track_components:
            self._comp_acc = {i: acc for i, acc in out.comp_acc.items()
                              if out.components_per_scale[i] > 0}
        self._flush_device_tracking()
        result.final_peak_value = out.final_biased_peak
        if not out.any_peak_found:
            log.warn("No peak found during multi-scale cleaning! Aborting.")
            result.another_iteration_required = False
            return result
        # Stop-reason reporting (multiscale_algorithm.cc:545-575); a pass
        # that cleaned nothing ends the loop as the host path's error does
        # (multiscale_algorithm.cc:417-424).
        max_iter_reached = self.iteration_number >= self.max_iterations
        negative_reached = (self.stop_on_negative_components
                            and out.final_biased_peak < 0.0)
        result.is_diverging = out.diverging
        result.another_iteration_required = (
            not max_iter_reached
            and not out.is_final_threshold
            and not negative_reached
            and not out.diverging
        )
        if out.no_components:
            log.error(
                "Could not continue multi-scale clean, because the sub-minor "
                "loop failed to find components."
            )
        return result

    # -- batched facets (multiscale.py:1335-1641 of the JAX package) -----
    def batched_facets_eligible(
        self,
        meta: CubeMeta,
        box_w: int,
        box_h: int,
        n_facets: int,
        n_unique_psfs: int = 1,
    ) -> bool:
        """Whether every facet's fused loop runs at once on the common box
        (:meth:`execute_batched_facets`): the JAX package's rule and its
        per-facet estimate, against :data:`BATCHED_FACETS_BUDGET` on every
        device, so that the CPU, the card and the JAX package pick the same
        route."""
        initialize_scales(
            self.scale_infos,
            self.beam_size_in_pixels,
            min(box_w, box_h),
            self.ms_settings.shape,
            self.ms_settings.max_scales,
            self.ms_settings.scale_list,
        )
        if not self._fused_eligible(meta, box_w, box_h):
            return False
        N, C = meta.n_images, meta.n_channels
        S = max(len(self.scale_infos), 1)
        _, (ph, pw), (phl, pwl) = self._correction_split(box_w, box_h)
        per_facet = (
            2 * N * ph * pw * 8  # the spectral residual, twice
            + 2 * N * ph * pw * 8  # spectral-subtract temporaries
            + 2 * N * box_h * box_w * 4  # components
            + max(S, N) * ph * pw * 4  # maxima / cube inverse transients
            + 6 * N * box_h * box_w * 4  # residual, model, PSF copies
        )
        if self.track_per_scale_masks or self.use_per_scale_masks:
            per_facet += 2 * S * box_h * box_w
        if self.track_components:
            per_facet += 2 * S * N * box_h * box_w * 4
        extra = n_facets * per_facet
        if n_unique_psfs > 1:
            extra += n_facets * S * C * box_h * box_w * 4
            extra += n_facets * C * (ph * pw + phl * pwl) * 8
        return extra < BATCHED_FACETS_BUDGET

    def execute_batched_facets(
        self,
        facet_residual: torch.Tensor,  # [F, N, Hb, Wb], updated in place
        facet_model: torch.Tensor,  # [F, N, Hb, Wb], updated in place
        psfs: torch.Tensor,  # [C, Hb, Wb] shared, or [U, C, Hb, Wb]
        facet_boxes,  # (width, height) of each facet, placed top left
        facet_masks: np.ndarray,  # [F, Hb, Wb] bool search masks
        facet_rms: Optional[torch.Tensor],  # [F, Hb, Wb] or None
        major_iteration_threshold: float,
        start_iterations,  # per facet
        find_peak_only: bool,
        meta: CubeMeta,
        facet_forced_terms: Optional[torch.Tensor] = None,  # [F, T-1, ...]
        facet_psf_slot=None,  # [F] index into U (direction-dependent PSFs)
        facet_scale_masks: Optional[np.ndarray] = None,  # [F, S', Hb, Wb]
    ):
        """Every facet's fused loop at once
        (:func:`~radler_tpu_torch.models.multiscale_fused.
        facet_fused_multiscale_minor_loop`), the port of the JAX package's
        vmapped ``execute_batched_facets``: the banks are shared, or, with
        direction-dependent PSFs (``psfs`` 4-D), built a unique PSF (each
        kept in its slot) and picked by ``facet_psf_slot``; each scale's
        search window lies over the facet's true box (the border of
        ``multiscale_algorithm.cc:597-603``) and its mask, ANDed with the
        loaded per-scale masks when they are used.  The peak-only pass
        (``find_peak_only``) runs no iteration and leaves the stacks as
        they were.  Returns ``(results, iterations, lockstep, mask_acc,
        comp_acc)``: a :class:`DeconvolutionResult` and the iteration count
        of each facet, the lockstep iterations of the dense loops, and the
        per-facet accumulators (``[F, S, Hb, Wb]`` bool, and scale -> ``[F,
        N, Hb, Wb]``) of the per-scale masks and components."""
        fitter = self.spectral_fitter
        if fitter is not None and not fitter.is_active:
            fitter = None
        if (fitter is not None
                and fitter.mode == SpectralFittingMode.FORCED_TERMS
                and facet_forced_terms is None):
            raise RuntimeError("Forced terms have not been set")
        n_facets, _, box_h, box_w = facet_residual.shape
        initialize_scales(
            self.scale_infos,
            self.beam_size_in_pixels,
            min(box_w, box_h),
            self.ms_settings.shape,
            self.ms_settings.max_scales,
            self.ms_settings.scale_list,
        )
        S = len(self.scale_infos)
        if psfs.dim() == 4:
            per_slot = [self._prepare_fused_banks(meta, box_w, box_h,
                                                  psfs[u], slot=u)
                        for u in range(psfs.shape[0])]
            slots = [int(u) for u in facet_psf_slot]
        else:
            per_slot = [self._prepare_fused_banks(meta, box_w, box_h, psfs)]
            slots = [0] * n_facets
        (kernel_f, _, _, kernel_f_large, _, _, _, split, padded_small,
         padded_large) = per_slot[-1]

        def stacked(i):
            if per_slot[0][i] is None:
                return None
            if len(per_slot) == 1:
                return per_slot[0][i][None]
            return torch.stack([b[i] for b in per_slot])

        bias = np.stack([per_slot[u][5] for u in slots])  # [F, S]
        gain_arr = np.stack([per_slot[u][6] for u in slots])

        # Each scale's search window over the facet's true box (a
        # rectangle, ``window_mask``'s), ANDed with the facet's mask, made
        # on the device; the padding is never searched.
        dev = facet_residual.device
        stacks = torch.zeros((n_facets, S, box_h, box_w), dtype=torch.bool,
                             device=dev)
        for f, (sw, sh) in enumerate(facet_boxes):
            for i, entry in enumerate(self.scale_infos):
                xb = int(round(sw * self.clean_border_ratio))
                yb = int(round(sh * self.clean_border_ratio))
                if entry.scale != 0.0:
                    border_scale = int(math.ceil(entry.scale * 0.5))
                    xb = max(xb, border_scale)
                    yb = max(yb, border_scale)
                stacks[f, i, yb:max(sh - yb, yb), xb:max(sw - xb, xb)] = True
        stacks &= torch.as_tensor(facet_masks, device=dev)[:, None]
        if self.use_per_scale_masks and facet_scale_masks is not None:
            stacks &= torch.as_tensor(
                np.ascontiguousarray(facet_scale_masks[:, :S]), device=dev)

        starts = [int(v) for v in start_iterations]
        out = facet_fused_multiscale_minor_loop(
            facet_residual, facet_model, kernel_f, stacked(1), stacked(2),
            kernel_f_large, stacked(4), slots, stacks,
            facet_rms, bias, gain_arr, self.threshold,
            major_iteration_threshold, self.major_loop_gain,
            self.ms_settings.sub_minor_loop_gain, self.minor_loop_gain,
            self.divergence_limit, starts,
            starts if find_peak_only else [self.max_iterations] * n_facets,
            max(8, S * 3 // 2),
            meta=meta,
            allow_negative=self.allow_negative_components,
            stop_on_negative=self.stop_on_negative_components,
            fitter=fitter, split=split, padded_small=padded_small,
            padded_large=padded_large,
            boxes=[(sh, sw) for sw, sh in facet_boxes],
            forced_terms=facet_forced_terms,
            track_masks=self.track_per_scale_masks,
            track_components=self.track_components,
        )
        if not find_peak_only:
            facet_residual.copy_(out.residual)
            facet_model.copy_(out.model)
        results = []
        for f in range(n_facets):
            result = DeconvolutionResult()
            peak = out.final_biased_peak[f]
            result.final_peak_value = peak
            if not find_peak_only:
                for i, entry in enumerate(self.scale_infos):
                    entry.n_components_cleaned += int(
                        out.components_per_scale[f, i])
            if out.any_peak_found[f]:
                max_iter_reached = (out.iteration_number[f]
                                    >= self.max_iterations)
                negative_reached = (self.stop_on_negative_components
                                    and peak < 0.0)
                result.is_diverging = out.diverging[f]
                result.another_iteration_required = (
                    not max_iter_reached
                    and not out.is_final_threshold[f]
                    and not negative_reached
                    and not out.diverging[f]
                )
            if out.no_components[f] and not find_peak_only:
                log.error(
                    "Could not continue multi-scale clean in facet %d: the "
                    "sub-minor loop failed to find components." % f
                )
            results.append(result)
        return (results, out.iteration_number, out.lockstep, out.mask_acc,
                out.comp_acc)

    def _flush_device_tracking(self) -> None:
        """Bring the device-accumulated auto-mask and component updates to
        the host state, once per major iteration (``SubMinorLoop``'s update
        hooks, ``subminor_loop.cc:220-246``; duplicate component entries
        merge as ``ComponentList::MergeDuplicates`` would)."""
        if self._mask_acc is not None:
            acc = self._mask_acc.cpu().numpy()
            for i in range(min(len(self.scale_masks), acc.shape[0])):
                self.scale_masks[i] |= acc[i]
            self._mask_acc = None
        for scale_index, comp in sorted(self._comp_acc.items()):
            comp_h = comp.cpu().numpy()
            ys, xs = np.nonzero(np.any(comp_h != 0.0, axis=0))
            for j in range(xs.size):
                self._component_list.add(
                    int(xs[j]), int(ys[j]), scale_index,
                    comp_h[:, ys[j], xs[j]],
                )
        self._comp_acc = {}

    # -- component optimization (multiscale_algorithm.cc:750-931) --------
    def _run_full_component_fitter(self, dirty_set, model_set,
                                   psfs: torch.Tensor) -> None:
        """``RunFullComponentFitter``: every plane's components refined over
        all scales at once, then their spectra fitted."""
        if self._component_list is None:
            raise RuntimeError(
                "Component optimization in multiscale requires a tracked "
                "component list (save_source_list)"
            )
        for image_index in range(dirty_set.n_images):
            self._fit_components_single_image(dirty_set, model_set, psfs,
                                              image_index)
        self.apply_spectral_constraints_to_components(self._component_list)

    def _fit_components_single_image(self, dirty_set, model_set,
                                     psfs: torch.Tensor,
                                     image_index: int) -> None:
        """Joint gradient descent on one plane's components of every scale
        (``multiscale_algorithm.cc:837-918``): each scale's components are
        convolved with its scale-convolved PSF, and all are solved together
        (:func:`~radler_tpu_torch.ops.component_optimization.
        gradient_descent_with_variable_psf`); the component list gains the
        deltas, the model their scale-convolved images and the residual
        loses those convolved with the PSF."""
        meta = dirty_set.meta
        width, height = dirty_set.width, dirty_set.height
        dev = dirty_set.data.device
        psf = psfs[meta.psf_index(image_index)]
        residual = dirty_set.data[image_index]
        model = model_set.data[image_index]
        supports, conv_psfs, active_scales = [], [], []
        for scale_index, entry in enumerate(self.scale_infos):
            positions = self._component_list.get_positions(scale_index)
            if not positions:
                continue
            xs, ys = (torch.as_tensor(v, device=dev) for v in zip(*positions))
            support = torch.zeros((height, width), dtype=torch.float32,
                                  device=dev)
            support[ys, xs] = 1.0
            supports.append(support)
            conv_psfs.append(self._scale_convolve(psf, entry.scale))
            active_scales.append(scale_index)
        if not supports:
            return
        max_scale = self.scale_infos[-1].scale
        padded = (
            get_convolution_size(max_scale, height,
                                 self.ms_settings.convolution_padding),
            get_convolution_size(max_scale, width,
                                 self.ms_settings.convolution_padding),
        )
        deltas = gradient_descent_with_variable_psf(
            supports, residual, conv_psfs, padded_shape=padded)
        for delta, scale_index in zip(deltas, active_scales):
            entry = self.scale_infos[scale_index]
            positions = self._component_list.get_positions(scale_index)
            delta_host = delta.cpu().numpy()
            for i, (px, py) in enumerate(positions):
                _, _, vals = self._component_list.get_component(scale_index,
                                                                i)
                vals[image_index] += float(delta_host[py, px])
            delta_conv = self._scale_convolve(delta, entry.scale)
            model = model + delta_conv
            residual = residual - padded_convolve(delta_conv, psf,
                                                  padded_shape=padded)
        model_set.data[image_index] = model
        dirty_set.data[image_index] = residual

    # -- fast (subminor) path -------------------------------------------
    def _run_fast_sub_loop(
        self,
        dirty_set,
        model_set,
        meta: CubeMeta,
        single_psfs: torch.Tensor,  # [C, H, W]
        twice_convolved_psfs: torch.Tensor,  # [C, H, W]
        individual_convolved: torch.Tensor,  # [N, H, W]
        scale_with_peak: int,
        first_sub_threshold: float,
        sub_gain_threshold: float,
        initial_peak_value: float,
    ):
        """``multiscale_algorithm.cc:377-461``: the subminor loop at the
        selected scale, then the residual correction with the
        single-convolved PSFs and the model add of the scale-convolved
        components.  Returns the diverging flag, or None when the subminor
        loop found no components."""
        height, width = dirty_set.height, dirty_set.width
        entry = self.scale_infos[scale_with_peak]
        sub_start_iteration = self.iteration_number
        conv_w = get_convolution_size(
            entry.scale, width, self.ms_settings.convolution_padding
        )
        conv_h = get_convolution_size(
            entry.scale, height, self.ms_settings.convolution_padding
        )
        if height * width <= DENSE_SUBMINOR_MAX_PIXELS:
            run = self._dense_sub_loop(
                meta, twice_convolved_psfs, individual_convolved,
                scale_with_peak, first_sub_threshold, height, width,
            )
        else:
            run = self._clark_sub_loop(
                meta, twice_convolved_psfs, individual_convolved,
                scale_with_peak, first_sub_threshold, sub_gain_threshold,
                conv_h, conv_w,
            )
        if run is None:
            log.error(
                "Could not continue multi-scale clean, because the sub-minor "
                "loop failed to find components."
            )
            return None
        diverging, value, comp = run
        if self.divergence_limit != 0.0:
            diverging = diverging or (
                abs(value) > initial_peak_value * self.divergence_limit
            )
        entry.n_components_cleaned += self.iteration_number - sub_start_iteration

        dirty_set.data = correct_residual(
            dirty_set.data, comp, single_psfs, conv_h, conv_w, meta.n_channels
        )
        if self.track_per_scale_masks:
            if self._mask_acc is None:
                self._mask_acc = torch.zeros(
                    (len(self.scale_infos), height, width), dtype=torch.bool,
                    device=comp.device,
                )
            _accum_scale_mask(self._mask_acc, comp, scale_with_peak)
        if self.track_components:
            prev = self._comp_acc.get(scale_with_peak)
            self._comp_acc[scale_with_peak] = (
                comp if prev is None else prev + comp
            )
        model_set.data = model_set.data + self._scale_convolve(comp,
                                                               entry.scale)
        return diverging

    def _dense_sub_loop(
        self,
        meta: CubeMeta,
        twice_convolved_psfs: torch.Tensor,
        individual_convolved: torch.Tensor,
        scale_with_peak: int,
        first_sub_threshold: float,
        height: int,
        width: int,
    ):
        """The dense masked clean at the selected scale
        (``_run_fast_sub_loop_dense`` of the JAX package): returns
        (diverging, last peak value, component cube), or None when it
        cleaned nothing."""
        entry = self.scale_infos[scale_with_peak]
        start = self.iteration_number
        # The search weight: the scale's window and mask (the sparse path's
        # selection inputs) times the rms factor.
        weight = self._scale_valid_stack(
            height, width, individual_convolved.device
        )[scale_with_peak].to(torch.float32)
        if self.rms_factor_image is not None:
            weight = weight * self.rms_factor_image
        fitter = (
            self.spectral_fitter
            if self.spectral_fitter is not None and self.spectral_fitter.is_active
            else None
        )
        _, comp, iteration, value, _, diverging = dense_subminor_loop(
            individual_convolved,
            twice_convolved_psfs,
            weight,
            self.rms_factor_image,
            first_sub_threshold / entry.bias_factor,
            entry.gain,
            self.iteration_number,
            self.max_iterations,
            self.divergence_limit,
            (entry.max_unnormalized_image_value, entry.max_image_value_x,
             entry.max_image_value_y, True),
            meta=meta,
            allow_negative=self.allow_negative_components,
            stop_on_negative=self.stop_on_negative_components,
            fitter=fitter,
        )
        self.iteration_number = iteration
        if iteration == start:
            return None
        return diverging, value, comp

    def _clark_sub_loop(
        self,
        meta: CubeMeta,
        twice_convolved_psfs: torch.Tensor,
        individual_convolved: torch.Tensor,
        scale_with_peak: int,
        first_sub_threshold: float,
        sub_gain_threshold: float,
        conv_h: int,
        conv_w: int,
    ):
        """The Clark loop on the candidate set at the selected scale (one
        B2 launch on the card): returns (diverging, last peak value, the
        full component cube), or None when it selected no candidates."""
        height, width = individual_convolved.shape[-2:]
        entry = self.scale_infos[scale_with_peak]
        fitter = self.spectral_fitter
        if (
            individual_convolved.device.type == "cuda"
            and fitter is not None
            and fitter.is_active
            and fitter.mode != SpectralFittingMode.POLYNOMIAL
        ):
            raise NotImplementedError(
                f"the Clark subminor loop with {fitter.mode.name} spectral "
                f"fitting on a {height}x{width} image on the card is not "
                "ported; ROADMAP queue A, item 9 brings it."
            )
        sub = SubMinorLoop(width, height, conv_w, conv_h)
        sub.set_iteration_info(self.iteration_number, self.max_iterations)
        sub.set_threshold(
            first_sub_threshold / entry.bias_factor,
            sub_gain_threshold / entry.bias_factor,
        )
        sub.set_gain(entry.gain)
        sub.divergence_limit = self.divergence_limit
        sub.allow_negative_components = self.allow_negative_components
        sub.stop_on_negative_component = self.stop_on_negative_components
        scale_border = int(math.ceil(entry.scale * 0.5))
        sub.set_clean_borders(
            max(int(round(width * self.clean_border_ratio)), scale_border),
            max(int(round(height * self.clean_border_ratio)), scale_border),
        )
        sub.rms_factor_image = self.rms_factor_image
        if self.use_per_scale_masks and self.scale_masks:
            sub.mask = self.scale_masks[scale_with_peak]
        elif self.clean_mask is not None:
            sub.mask = self.clean_mask
        diverging, peak_value = sub.run(
            individual_convolved, meta, twice_convolved_psfs, fitter
        )
        if peak_value is None:
            return None
        self.iteration_number = sub.current_iteration
        # The JAX package's Clark loop adds no flux to total_flux_cleaned
        # (its SubMinorLoop.flux_cleaned stays 0), and neither does this.
        return diverging, peak_value, sub.full_model_cube()

    # -- slow (per-component) path --------------------------------------
    def _run_slow_sub_loop(
        self,
        dirty_set,
        model_set,
        meta: CubeMeta,
        single_psfs: torch.Tensor,  # [C, H, W]
        twice_convolved_psfs: torch.Tensor,  # [C, H, W]
        individual_convolved: torch.Tensor,
        scale_with_peak: int,
        first_sub_threshold: float,
        initial_peak_value: float,
    ) -> bool:
        """``multiscale_algorithm.cc:463-519``: one component per iteration
        at the fixed scale, with a host read per component."""
        entry = self.scale_infos[scale_with_peak]
        psf_indices = torch.as_tensor(meta.psf_indices,
                                      device=single_psfs.device)
        fitter = self.spectral_fitter
        diverging = False
        while (
            self.iteration_number < self.max_iterations
            and abs(entry.max_unnormalized_image_value * entry.bias_factor)
            > first_sub_threshold
            and (
                not self.stop_on_negative_components
                or entry.max_unnormalized_image_value >= 0.0
            )
            and not diverging
        ):
            x = entry.max_image_value_x
            y = entry.max_image_value_y
            component_values = individual_convolved[:, y, x]
            if fitter is not None and fitter.is_active:
                vals = component_values.reshape(
                    meta.n_channels, meta.n_polarizations
                )
                component_values = fitter.fit_and_evaluate(
                    vals, x, y).reshape(-1)
            component_values = component_values * entry.gain
            dirty_set.data = subtract_psf_from_cube(
                dirty_set.data, single_psfs, psf_indices, x, y,
                component_values,
            )
            individual_convolved = subtract_psf_from_cube(
                individual_convolved, twice_convolved_psfs, psf_indices, x, y,
                component_values,
            )
            host_values = component_values.cpu().numpy()
            model = model_set.data
            if entry.scale == 0.0:
                model[:, y, x] += component_values
            else:
                for img_index in range(meta.n_images):
                    model[img_index] = add_shape_component(
                        model[img_index], entry.scale, x, y,
                        float(host_values[img_index]), self.ms_settings.shape,
                    )
            entry.n_components_cleaned += 1
            entry.total_flux_cleaned += float(host_values.sum())
            if self.track_per_scale_masks:
                self.scale_masks[scale_with_peak][y, x] = True
            if self.track_components:
                self._component_list.add(x, y, scale_with_peak, host_values)

            integrated = get_linear_integrated(individual_convolved, meta)
            self._find_peak_direct(integrated, scale_with_peak)
            abs_peak = abs(
                entry.max_unnormalized_image_value * entry.bias_factor
            )
            if self.divergence_limit != 0.0:
                diverging = abs_peak > initial_peak_value * self.divergence_limit
            self.iteration_number += 1
        return diverging

    def _find_peak_direct(self, image: torch.Tensor, scale_index: int) -> None:
        """``multiscale_algorithm.cc:700-748``, with one host read."""
        entry = self.scale_infos[scale_index]
        h, w = image.shape
        hb = int(round(w * self.clean_border_ratio))
        vb = int(round(h * self.clean_border_ratio))
        rms = self.rms_factor_image
        weighted = image * rms if rms is not None else image
        if self.use_per_scale_masks and self.scale_masks:
            mask = self.scale_masks[scale_index]
        else:
            mask = self.clean_mask
        pk = find_peak(weighted, self.allow_negative_components, hb, vb, mask)
        at_peak = (
            rms.reshape(-1).index_select(0, (pk.y * w + pk.x).view(1))[0]
            if rms is not None
            else torch.ones((), device=image.device)
        )
        value, x, y, found, rms_at = torch.stack([
            pk.value.double(), pk.x.double(), pk.y.double(),
            pk.found.double(), at_peak.double(),
        ]).tolist()
        if found:
            entry.max_unnormalized_image_value = value
            entry.max_normalized_image_value = value / rms_at
            entry.max_image_value_x = int(x)
            entry.max_image_value_y = int(y)
        else:
            entry.max_unnormalized_image_value = 0.0
            entry.max_normalized_image_value = 0.0
