"""IUWT (MORESANE-like) wavelet-sparsity deconvolution.

Port of ``radler_tpu.models.iuwt`` (``cpp/algorithms/iuwt_deconvolution_
algorithm.{h,cc}`` and the facade ``cpp/algorithms/iuwt_deconvolution.h``).
Per structure iteration: decompose the integrated residual, derive per-scale
MAD thresholds, pick the most significant scale and peak with the PSF
response normalization, select a cross-scale structure mask, optionally trim
to a bounding box, solve the masked conjugate-gradient system so that the
masked IUWT of (model ⊛ PSF) matches the masked dirty image, guard against
an RMS increase, refit per-image flux factors, apply the gain-scaled model,
and escalate scales on failure.

The transform, the FFT convolutions, the CG iterations and the reductions
run as torch ops and kernel B3 on the images' device
(:mod:`radler_tpu_torch.ops.iuwt`); connected-component labelling of the
multi-image flux refit runs on the host with ``scipy.ndimage``.  The host
reads the device twice per structure iteration, as the JAX package does
(the stats blob and the CG status), plus the CG's ``done`` flag once per CG
iteration.  Nothing inside a structure iteration copies host data to the
device, except the label map of the multi-image refit: the windows, the
prior mask and the PSF's per-scale RMS are made on the device, or copied
once per run before the structure loop.  The JAX package lays IUWT's rows
over a device mesh (``models/iuwt.py:107-132``), a placement only; every
shard of the port's mesh lies on the one device, so IUWT runs there as on
one device, bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..image_set import get_integrated_psf, get_linear_integrated
from ..ops import iuwt as iuwt_ops
from ..ops.convolution import convolve_same
from ..utils import logging as log
from .base import DeconvolutionAlgorithm, DeconvolutionResult

try:
    from scipy import ndimage as _ndimage
except Exception:  # pragma: no cover
    _ndimage = None


def _apply_structure_update(model_data, dirty_data, structure, psfs, gain,
                            meta):
    """Accepted-structure update (``iuwt_deconvolution_algorithm.cc:862-877``):
    model += gain*structure; dirty -= (gain*structure) ⊛ psf per channel;
    returns the new model, dirty and re-integrated dirty."""
    structure_scaled = structure * gain
    model_data = model_data + structure_scaled
    n, height, width = dirty_data.shape
    c, p = meta.n_channels, meta.n_polarizations
    conv = convolve_same(
        structure_scaled.reshape(c, p, height, width), psfs[:, None, :, :]
    )
    dirty_data = dirty_data - conv.reshape(n, height, width)
    return model_data, dirty_data, get_linear_integrated(dirty_data, meta)


class _IuwtEngine:
    """One ``IuwtDeconvolutionAlgorithm`` run (reference class of the same
    name); holds per-run geometry and the PSF response."""

    def __init__(
        self,
        width: int,
        height: int,
        minor_loop_gain: float,
        major_loop_gain: float,
        clean_border: float,
        allow_negative_components: bool,
        mask: Optional[np.ndarray],
        absolute_threshold: float,
        threshold_sigma_level: float = 4.0,
        tolerance: float = 0.75,
    ):
        self.width = width
        self.height = height
        self.minor_loop_gain = minor_loop_gain
        self.major_loop_gain = major_loop_gain
        self.clean_border = clean_border
        self.mask = mask
        self.absolute_threshold = absolute_threshold
        self.threshold_sigma_level = threshold_sigma_level
        self.tolerance = tolerance
        self.allow_negative = allow_negative_components
        self.psf_rms: Optional[torch.Tensor] = None  # [S] on the device
        self.psf_peak_response: Optional[np.ndarray] = None
        self.psf_peak_response_to_next: Optional[np.ndarray] = None
        self.rmses: Optional[np.ndarray] = None
        # Current bounding box during trimmed recursion.
        self.box = (0, 0, width, height)
        self._mask_on_device: Optional[torch.Tensor] = None
        self._window_cache: Dict[Tuple, torch.Tensor] = {}

    # -- PSF characterization (``MeasureRMSPerScale``) -------------------
    def measure_rms_per_scale(self, psf: torch.Tensor, end_scale: int) -> None:
        stats = iuwt_ops.psf_response_stats(psf, end_scale)
        self.psf_rms = stats[0]
        host = stats.cpu().numpy()  # one read, before the structure loop
        self.psf_peak_response = host[1]
        self.psf_peak_response_to_next = host[2]

    # -- windows -----------------------------------------------------------
    def prepare(self, device) -> None:
        """Copy the user mask to the device once, before the structure
        loop; every window is then made there."""
        if self.mask is not None:
            self._mask_on_device = torch.as_tensor(
                np.asarray(self.mask, bool), device=device)

    def _border_window(self, width: int, height: int, device) -> torch.Tensor:
        """The clean-border window (``GetMaxAbs`` border semantics)."""
        x_border = int(self.clean_border * width)
        y_border = int(self.clean_border * height)
        window = torch.zeros((height, width), dtype=torch.bool, device=device)
        window[y_border:height - y_border, x_border:width - x_border] = True
        return window

    def _search_window(self, width: int, height: int, device) -> torch.Tensor:
        """Border and user-mask search window, cached per shape."""
        key = (width, height)
        if key not in self._window_cache:
            window = self._border_window(width, height, device)
            m = self._mask_on_device
            if m is not None and tuple(m.shape) == (height, width):
                window &= m
            self._window_cache[key] = window
        return self._window_cache[key]

    def _select_window(self, prior: bool, width: int, height: int,
                       device) -> torch.Tensor:
        """Border and prior-mask window for structure selection, cached per
        shape and current box.  The prior mask is the user mask cut to the
        current box, so the box is a sound key."""
        key = ("sel", width, height, self.box, prior)
        if key not in self._window_cache:
            window = self._border_window(width, height, device)
            if prior:
                x1, y1, x2, y2 = self.box
                window &= self._mask_on_device[y1:y2, x1:x2]
            self._window_cache[key] = window
        return self._window_cache[key]

    # -- bounding boxes ----------------------------------------------------
    @staticmethod
    def _adjust_box(
        x1: int, y1: int, x2: int, y2: int, width: int, height: int,
        end_scale: int,
    ) -> Tuple[int, int, int, int]:
        """Pad the box by 50% and enforce a minimum size (``AdjustBox``,
        ``iuwt_deconvolution_algorithm.cc:217-262``), then grow it to a
        power of two as the JAX package does (the reference aligns to /8)."""
        min_box_size = max(
            128, iuwt_ops.min_image_dimension(end_scale) * 3 // 2
        )
        box_width = x2 - x1
        box_height = y2 - y1
        new_x1 = int(x1 - 0.5 * box_width)
        new_x2 = int(x2 + 0.5 * box_width)
        new_y1 = int(y1 - 0.5 * box_height)
        new_y2 = int(y2 + 0.5 * box_height)
        if new_x2 - new_x1 < min_box_size:
            mid = (x1 + x2) // 2
            new_x1 = mid - min_box_size // 2
            new_x2 = mid + min_box_size // 2
        if new_y2 - new_y1 < min_box_size:
            mid = (y1 + y2) // 2
            new_y1 = mid - min_box_size // 2
            new_y2 = mid + min_box_size // 2
        x1 = new_x1 if new_x1 >= 0 else 0
        x2 = new_x2 if new_x2 < width else width
        y1 = new_y1 if new_y1 >= 0 else 0
        y2 = new_y2 if new_y2 < height else height
        x1, x2 = _IuwtEngine._grow_to_pow2(x1, x2, width)
        y1, y2 = _IuwtEngine._grow_to_pow2(y1, y2, height)
        return x1, y1, x2, y2

    @staticmethod
    def _grow_to_pow2(lo: int, hi: int, limit: int) -> Tuple[int, int]:
        """Expand [lo, hi) to the next power-of-two length, kept inside
        [0, limit); the full axis when it cannot fit."""
        size = hi - lo
        target = 1 << max(size - 1, 1).bit_length()
        if target >= limit:
            return 0, limit
        grow = target - size
        lo = max(0, lo - grow // 2)
        hi = lo + target
        if hi > limit:
            hi = limit
            lo = hi - target
        return lo, hi

    # -- structure find+deconvolve ----------------------------------------
    def find_and_deconvolve_structure(
        self,
        dirty: torch.Tensor,
        psf: torch.Tensor,
        psfs: torch.Tensor,  # [C, H, W]
        structure_model_full: torch.Tensor,  # [N, H, W]
        dirty_set,
        cur_end_scale: int,
        cur_min_scale: int,
        max_components: List,
    ) -> Tuple[bool, torch.Tensor]:
        """``FindAndDeconvolveStructure``
        (``iuwt_deconvolution_algorithm.cc:414-498``)."""
        width, height = self.width, self.height
        dev = dirty.device
        max_components.clear()
        S = cur_end_scale
        coeffs, mask_pre, blob_dev, thresholds_dev = (
            iuwt_ops.structure_stats_select(
                dirty,
                self._search_window(width, height, dev),
                self._select_window(self.mask is not None, width, height, dev),
                self.psf_rms[:S],
                float(self.psf_peak_response[1]
                      / self.psf_peak_response_to_next[0]),
                self.threshold_sigma_level,
                self.absolute_threshold,
                self.tolerance,
                cur_min_scale,
                S,
                self.allow_negative,
            )
        )
        blob = blob_dev.cpu().numpy()  # host read 1 of the iteration
        stats = blob[: 5 * S].reshape(5, S)
        area_size = int(blob[5 * S])
        bbox = tuple(int(v) for v in blob[5 * S + 1 : 5 * S + 5])
        max_val_scale = int(blob[5 * S + 5])
        max_val = float(blob[5 * S + 6])
        self.rmses, vals = stats[0], stats[1]
        xs = stats[2].astype(np.int32)
        ys = stats[3].astype(np.int32)
        thresholds = self.rmses * (self.threshold_sigma_level * 4.0 / 5.0)
        for scale in range(cur_end_scale):
            max_components.append(
                {
                    "x": int(xs[scale]),
                    "y": int(ys[scale]),
                    "scale": scale,
                    "val": float(vals[scale]),
                }
            )

        if max_val_scale == -1:
            log.debug("No significant pixel found.")
            return False, structure_model_full
        max_x = int(xs[max_val_scale])
        max_y = int(ys[max_val_scale])
        log.debug(
            f"Most significant pixel: {max_x},{max_y}={max_val} "
            f"({max_val / self.rmses[max_val_scale]} sigma) on scale "
            f"{max_val_scale}"
        )
        if abs(max_val) < thresholds[max_val_scale]:
            log.debug("Most significant pixel is in the noise, stopping.")
            return False, structure_model_full

        return self._fill_and_deconvolve_structure(
            coeffs,
            dirty,
            structure_model_full,
            psf,
            psfs,
            dirty_set,
            cur_end_scale,
            cur_min_scale,
            width,
            height,
            thresholds_dev,
            (max_x, max_y, max_val_scale),
            allow_trimming=True,
            prior=self.mask is not None,
            precomputed=(mask_pre, bbox, area_size),
        )

    def _fill_and_deconvolve_structure(
        self,
        coeffs: torch.Tensor,
        dirty: torch.Tensor,
        structure_model_full: torch.Tensor,
        psf: torch.Tensor,
        psfs: torch.Tensor,
        dirty_set,
        cur_end_scale: int,
        cur_min_scale: int,
        width: int,
        height: int,
        thresholds: torch.Tensor,  # [S] signed, on the device
        max_comp: Tuple[int, int, int],
        allow_trimming: bool,
        prior: bool,
        precomputed=None,  # (mask, raw bbox, area) of structure_stats_select
    ) -> Tuple[bool, torch.Tensor]:
        """``FillAndDeconvolveStructure``
        (``iuwt_deconvolution_algorithm.cc:500-626``)."""
        dev = dirty.device
        if precomputed is not None:
            mask, raw_box, area_size = precomputed
        else:
            mask, area_size = iuwt_ops.select_structures(
                coeffs,
                thresholds[:cur_end_scale],
                self._select_window(prior, width, height, dev),
                cur_min_scale,
            )
            raw_box = None
        if log.is_enabled("debug"):
            log.debug(
                f"Flood-filled area contains {int(area_size)} significant "
                "components."
            )
        if allow_trimming:
            if raw_box is None:
                raw_box = tuple(
                    iuwt_ops.masked_recompose_bbox(
                        coeffs, mask, cur_end_scale).tolist())
            x1, y1, x2, y2 = self._adjust_box(
                *raw_box, width, height, max_comp[2] + 1
            )
        else:
            x1, y1, x2, y2 = 0, 0, width, height
        if allow_trimming and ((x2 - x1) < width or (y2 - y1) < height):
            self.box = (x1, y1, x2, y2)
            new_width, new_height = x2 - x1, y2 - y1
            small_dirty = iuwt_ops.slice_box2(
                dirty, y1, x1, new_height, new_width
            )
            small_psf = self._trim_psf(psf, new_width, new_height)
            max_scale = max(
                iuwt_ops.end_scale(min(new_width, new_height)),
                max_comp[2] + 1,
            )
            if max_scale < cur_end_scale:
                log.debug(
                    f"Bounding box too small for largest scale of "
                    f"{cur_end_scale} -- ignoring scales>={max_scale}."
                )
                cur_end_scale = max_scale
            trimmed_coeffs = iuwt_ops.trim_coeffs_box(
                coeffs, y1, x1, cur_end_scale, new_height, new_width
            )
            trimmed_model = iuwt_ops.slice_box3(
                structure_model_full, y1, x1, new_height, new_width
            )
            success, trimmed_model = self._fill_and_deconvolve_structure(
                trimmed_coeffs,
                small_dirty,
                trimmed_model,
                small_psf,
                psfs,
                dirty_set,
                cur_end_scale,
                cur_min_scale,
                new_width,
                new_height,
                thresholds,
                (max_comp[0] - x1, max_comp[1] - y1, max_comp[2]),
                allow_trimming=False,
                prior=prior,
            )
            padded = iuwt_ops.embed_box3_zeros(
                trimmed_model, y1, x1, height, width
            )
            self.box = (0, 0, width, height)
            return success, padded

        # Un-trimmed path: the masked CG solve and the RMS guard, with one
        # host read for both decisions.
        masked_dirty_scales, masked_dirty = iuwt_ops.masked_dirty_of(
            dirty, mask, cur_end_scale
        )
        structure_model, status = iuwt_ops.conjugate_gradient_guarded(
            masked_dirty_scales,
            mask,
            masked_dirty,
            dirty,
            psf,
            self.minor_loop_gain,
            cur_end_scale,
        )
        # Host read 2 of the iteration.
        succ_f, snr_f, rms_before, rms_after = status.tolist()
        if not bool(succ_f):
            log.debug(f"CG failed to converge (SNR={snr_f}).")
            return False, structure_model_full
        log.debug(f"CG solve finished (SNR={snr_f}).")
        if rms_after > rms_before:
            log.debug(f"RMS got worse: {rms_before} -> {rms_after}")
            return False, structure_model_full

        structure_model_full = self._perform_sub_image_fit_all(
            mask,
            structure_model,
            max_comp,
            structure_model_full,
            psf,
            psfs,
            dirty,
            dirty_set,
            cur_end_scale,
            width,
            height,
        )
        return True, structure_model_full

    @staticmethod
    def _trim_psf(psf: torch.Tensor, new_width: int, new_height: int):
        """``TrimPsf``: the centred trim (``iuwt_deconvolution_algorithm.h``)."""
        h, w = psf.shape
        top = h // 2 - new_height // 2
        left = w // 2 - new_width // 2
        return iuwt_ops.slice_box2(psf, top, left, new_height, new_width)

    # -- per-image flux refits --------------------------------------------
    def _perform_sub_image_fit_all(
        self,
        mask: torch.Tensor,  # [S, H, W] bool
        structure_model: torch.Tensor,
        max_comp: Tuple[int, int, int],
        fitted_model_full: torch.Tensor,  # [N, H_full, W_full]
        psf: torch.Tensor,
        psfs: torch.Tensor,
        dirty: torch.Tensor,
        dirty_set,
        n_scales: int,
        width: int,
        height: int,
    ) -> torch.Tensor:
        """``PerformSubImageFitAll``
        (``iuwt_deconvolution_algorithm.cc:628-671``)."""
        # The box locates this (possibly trimmed) working area inside the
        # full-size dirty_set; fitted_model_full is working-area-sized.
        x1, y1, x2, y2 = self.box
        n_images = fitted_model_full.shape[0]
        if n_images == 1:
            return iuwt_ops.expand_single_plane(structure_model, 1)

        components = self._label_components(
            structure_model, max_comp, n_scales, width, height
        )
        correction_factors = self._fit_components(
            components, mask, structure_model, psf, dirty, n_scales,
            width, height,
        )
        out = torch.zeros_like(fitted_model_full)
        meta = dirty_set.meta
        for img_index in range(n_images):
            sub_psf_full = psfs[meta.psf_indices[img_index]]
            sub_dirty = dirty_set.data[img_index][y1:y2, x1:x2]
            if sub_psf_full.shape != (height, width):
                sub_psf = self._trim_psf(sub_psf_full, width, height)
            else:
                sub_psf = sub_psf_full
            factors = self._fit_components(
                components, mask, structure_model, sub_psf, sub_dirty,
                n_scales, width, height,
            )
            # The fitted model is the structure model scaled per component
            # by factor / integrated_factor (components are disjoint).
            ratio = torch.zeros_like(structure_model)
            for comp, factor, integrated_factor in zip(
                components, factors, correction_factors
            ):
                if (
                    math.isfinite(factor)
                    and math.isfinite(integrated_factor)
                    and integrated_factor != 0.0
                ):
                    ratio = torch.where(
                        comp["area"],
                        float(np.float32(factor / integrated_factor)),
                        ratio,
                    )
            out[img_index] = structure_model * ratio
        return out

    def _label_components(
        self,
        structure_model: torch.Tensor,
        max_comp: Tuple[int, int, int],
        n_scales: int,
        width: int,
        height: int,
    ) -> List[dict]:
        """Connected components of the structure model with adjusted boxes,
        in the reference's raster-seed order (``PerformSubImageFitSingle``,
        ``iuwt_deconvolution_algorithm.cc:673-742``), labelled on the host;
        each component's area is a bool tensor on the device, made from one
        copy of the label map."""
        model_host = structure_model.cpu().numpy()
        peak_level = abs(model_host[max_comp[1], max_comp[0]])
        significant = np.abs(model_host) > peak_level * 1e-4
        if _ndimage is None:
            raise RuntimeError("scipy is required for IUWT component labeling")
        labels, _ = _ndimage.label(significant)
        labels_dev = torch.as_tensor(labels.astype(np.int32),
                                     device=structure_model.device)
        components: List[dict] = []
        seen = set()
        ys_all, xs_all = np.nonzero(significant)
        order = np.argsort(ys_all * width + xs_all, kind="stable")
        for k in order:
            lbl = labels[ys_all[k], xs_all[k]]
            if lbl in seen:
                continue
            seen.add(lbl)
            ys, xs = np.nonzero(labels == lbl)
            bx1, bx2 = int(xs.min()), int(xs.max())
            by1, by2 = int(ys.min()), int(ys.max())
            bx1, by1, bx2, by2 = self._adjust_box(
                bx1, by1, bx2, by2, width, height, n_scales
            )
            components.append(
                {
                    "area": labels_dev == int(lbl),
                    "box": (bx1, by1, bx2, by2),
                    "size": (by2 - by1, bx2 - bx1),
                }
            )
        return components

    def _fit_components(
        self,
        components: List[dict],
        mask: torch.Tensor,
        structure_model: torch.Tensor,
        psf: torch.Tensor,
        sub_dirty: torch.Tensor,
        n_scales: int,
        width: int,
        height: int,
    ) -> List[float]:
        """Per-component flux factors through the masked-IUWT operator
        (``PerformSubImageComponentFitBoxed`` + ``...Fit``,
        ``iuwt_deconvolution_algorithm.cc:744-801``), one batch and one host
        read per box-size bucket."""
        _, masked_dirty = iuwt_ops.masked_dirty_of(sub_dirty, mask, n_scales)
        factors = [0.0] * len(components)
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for idx, comp in enumerate(components):
            buckets.setdefault(comp["size"], []).append(idx)
        for (bh, bw), idxs in buckets.items():
            if (bh, bw) == (height, width):
                psf_trimmed = psf
            else:
                psf_trimmed = self._trim_psf(psf, bw, bh)
            boxes = [components[i]["box"] for i in idxs]
            areas = torch.stack([
                components[i]["area"][b[1]:b[3], b[0]:b[2]]
                for i, b in zip(idxs, boxes)
            ])
            sums = iuwt_ops.component_fit_ratio_batched(
                mask,
                structure_model,
                masked_dirty,
                psf_trimmed,
                areas,
                [b[1] for b in boxes],
                [b[0] for b in boxes],
                n_scales,
                bh,
                bw,
            ).tolist()
            for (model_sum, dirty_sum), i in zip(sums, idxs):
                if (
                    model_sum == 0.0
                    or not math.isfinite(dirty_sum)
                    or not math.isfinite(model_sum)
                ):
                    factors[i] = 0.0
                else:
                    factors[i] = dirty_sum / model_sum
        return factors

    # -- the major iteration ----------------------------------------------
    def perform_major_iteration(
        self,
        iter_counter: int,
        n_iter: int,
        model_set,
        dirty_set,
        psfs: torch.Tensor,
    ) -> Tuple[float, bool, int]:
        """``PerformMajorIteration``
        (``iuwt_deconvolution_algorithm.cc:803-918``).
        Returns (max_value, reached_major_threshold, iter_counter)."""
        reached_major_threshold = False
        if iter_counter == n_iter:
            return 0.0, False, iter_counter
        meta = dirty_set.meta
        width, height = self.width, self.height

        dirty = get_linear_integrated(dirty_set.data, meta)
        psf = get_integrated_psf(psfs, meta).contiguous()
        self.prepare(dirty.device)

        max_scale = iuwt_ops.end_scale(min(width, height))
        cur_end_scale = 2

        log.debug("Measuring PSF...")
        self.measure_rms_per_scale(psf, max_scale)

        structure_model = torch.zeros_like(dirty_set.data)
        max_value = 0.0
        cur_min_scale = 0
        do_continue = True
        initial_components: List[dict] = []
        while True:
            log.debug(f"*** Deconvolution iteration {iter_counter} ***")
            dirty_before = dirty
            max_components: List[dict] = []
            succeeded, new_structure = self.find_and_deconvolve_structure(
                dirty,
                psf,
                psfs,
                structure_model,
                dirty_set,
                cur_end_scale,
                cur_min_scale,
                max_components,
            )
            if succeeded:
                model_set.data, dirty_set.data, dirty = (
                    _apply_structure_update(
                        model_set.data,
                        dirty_set.data,
                        new_structure,
                        psfs,
                        float(np.float32(self.minor_loop_gain)),
                        meta,
                    )
                )

                while len(max_components) > len(initial_components):
                    initial_components.append(
                        max_components[len(initial_components)]
                    )
                max_value = 0.0
                for c in range(len(initial_components)):
                    max_value = max(max_value, max_components[c]["val"])
                    if abs(max_components[c]["val"]) < abs(
                        initial_components[c]["val"]
                    ) * (1.0 - self.major_loop_gain):
                        reached_major_threshold = True
                if reached_major_threshold:
                    # NB: the reference's break skips the counter increment
                    # (iuwt_deconvolution_algorithm.cc:895,915).
                    break
            else:
                if cur_min_scale + 1 < cur_end_scale:
                    cur_min_scale += 1
                    log.debug(f"=> Min scale now {cur_min_scale}")
                else:
                    cur_min_scale = 0
                    if cur_end_scale != max_scale:
                        cur_end_scale += 1
                        log.debug(f"=> Scale now {cur_end_scale}.")
                    else:
                        log.debug(
                            "Max scale reached: finished all scales, quiting."
                        )
                        do_continue = False
                dirty = dirty_before
            iter_counter += 1
            if iter_counter == n_iter or not do_continue:
                break
        return max_value, reached_major_threshold, iter_counter


class IuwtDeconvolution(DeconvolutionAlgorithm):
    """Facade adapting the IUWT engine to the algorithm interface
    (``cpp/algorithms/iuwt_deconvolution.h:19-43``)."""

    def execute_major_iteration(
        self, dirty_set, model_set, psfs: torch.Tensor
    ) -> DeconvolutionResult:
        result = DeconvolutionResult()
        if self.max_iterations <= self.iteration_number:
            # Peak-only pass (the parallel engine's phase 1,
            # ``parallel_deconvolution.cc:582-599``): report the starting
            # peak of the integrated dirty.
            integ = get_linear_integrated(dirty_set.data, dirty_set.meta)
            if self.clean_mask is not None:
                integ = integ * torch.as_tensor(
                    np.asarray(self.clean_mask, np.float32), device=integ.device)
            peak = float(integ.abs().max())
            result.starting_peak_value = peak
            result.final_peak_value = peak
            result.another_iteration_required = False
            return result
        engine = _IuwtEngine(
            dirty_set.width,
            dirty_set.height,
            self.minor_loop_gain,
            self.major_loop_gain,
            self.clean_border_ratio,
            self.allow_negative_components,
            self.clean_mask,
            self.threshold,
        )
        final_peak, another, iters = engine.perform_major_iteration(
            self.iteration_number,
            self.max_iterations,
            model_set,
            dirty_set,
            psfs,
        )
        result.final_peak_value = final_peak
        result.another_iteration_required = another
        self.iteration_number = iters
        if self.iteration_number >= self.max_iterations:
            result.another_iteration_required = False
        return result
