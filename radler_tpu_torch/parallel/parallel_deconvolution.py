"""Facet (sub-image) orchestration layer.

Port of ``radler_tpu.parallel.parallel_deconvolution``
(``cpp/algorithms/parallel_deconvolution.{h,cc}``).  A 1x1 grid runs the
algorithm on the whole image.  A larger grid splits the image along
minimum-flux Dijkstra paths (:mod:`.faceting`) every major iteration and
runs the facets in two phases, a peak-only pass whose largest peak sets the
shared major-iteration threshold and a clean pass to it, with divergence
rollback and a boundary-masked merge.  Two routes, by the JAX package's
rule (:meth:`ParallelDeconvolution._can_batch_facets`):

* batched: generic CLEAN runs every facet's Högbom loop in lockstep on
  stacks padded to a common box (:meth:`GenericClean.execute_batched_facets
  <radler_tpu_torch.models.generic_clean.GenericClean.
  execute_batched_facets>`, B1's facet mode), and multiscale every facet's
  fused loop at once (:meth:`MultiScaleAlgorithm.execute_batched_facets
  <radler_tpu_torch.models.multiscale.MultiScaleAlgorithm.
  execute_batched_facets>`, its dense subminor loops in B1's facet mode);
* serial: each facet's clone of the algorithm runs its own path on the
  facet's box, one facet after another (IUWT, ASP, and generic CLEAN or
  multiscale with ``RADLER_TPU_NO_BATCHED_FACETS`` set or past their
  budgets).

On a device mesh of several groups the batched routes spread the facets
over the groups' devices by the JAX package's rule (``mesh.py:842-886``;
:func:`~radler_tpu_torch.parallel.mesh.facet_groups`): each group runs
its facets' lockstep loop on its card, all cards at once, and the stacks
come back to the lead in facet order, bit for bit the one device's;
``last_lockstep`` is the most lockstep iterations of a card.  On the
serial route each facet's clone keeps the mesh and takes the mesh routes
by the JAX package's rule, applied to the facet's own height.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np
import torch

from ..component_list import ComponentList
from ..image_set import ImageSet
from ..models.base import DeconvolutionAlgorithm
from ..ops.convolution import trim, untrim
from ..settings import AlgorithmType, Settings
from ..work_table import PsfOffset, WorkTable
from .faceting import SubImage, make_sub_images

def nearest_psf_index(psf_offsets: List[PsfOffset], x: int, y: int) -> int:
    """Nearest direction-dependent PSF to a position; first index wins ties
    (``parallel_deconvolution.cc:34-55``)."""
    if not psf_offsets:
        return 0
    best = 0
    best_d = None
    for i, off in enumerate(psf_offsets):
        d = (off.x - x) ** 2 + (off.y - y) ** 2
        if best_d is None or d < best_d:
            best_d = d
            best = i
    return best


def fit_to_box(psfs: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """PSFs trimmed or zero-padded about their center to (height, width),
    contiguous."""
    ph, pw = psfs.shape[-2:]
    if (ph, pw) == (height, width):
        return psfs
    if ph >= height and pw >= width:
        return trim(psfs, height, width).contiguous()
    return untrim(psfs, height, width)


@dataclasses.dataclass
class ParallelDeconvolutionResult:
    """``parallel_deconvolution.h``'s result struct."""

    another_iteration_required: bool = False
    start_peak: Optional[float] = None
    end_peak: Optional[float] = None


class ParallelDeconvolution:
    """Host-side facet controller."""

    def __init__(self, settings: Settings):
        self.settings = settings
        self.algorithms: List[DeconvolutionAlgorithm] = []
        # With more than one facet these are kept here and sliced for each
        # facet; with one they go to the algorithm.
        self._mask: Optional[np.ndarray] = None
        self._rms_image: Optional[torch.Tensor] = None
        self._spectrally_forced_images: Optional[torch.Tensor] = None
        self._track_per_scale_masks = False
        self._use_per_scale_masks = False
        # Full-size per-scale auto-masks of a faceted multiscale run (a 1x1
        # grid keeps its masks in the algorithm); the checkpoint writes them.
        self._scale_masks: List[np.ndarray] = []
        self._component_list: Optional[ComponentList] = None
        # box -> (source PSFs, PSFs resized to the box); see _run_sub_image.
        self._sub_psf_cache: dict = {}
        # What the last faceted major iteration did: its sub-images, route
        # and lockstep iterations (batched route).
        self.last_sub_images: List[SubImage] = []
        self.last_route: Optional[str] = None
        self.last_lockstep = 0

    # -- setup ---------------------------------------------------------
    @property
    def is_initialized(self) -> bool:
        return bool(self.algorithms)

    def set_algorithm(self, algorithm: DeconvolutionAlgorithm) -> None:
        """One clone per facet (``parallel_deconvolution.cc:227-242``)."""
        n = self.settings.parallel.grid_width * self.settings.parallel.grid_height
        self.algorithms = [algorithm]
        for _ in range(1, n):
            self.algorithms.append(algorithm.clone())

    def free_algorithms(self) -> None:
        self.algorithms = []

    @property
    def first_algorithm(self) -> DeconvolutionAlgorithm:
        return self.algorithms[0]

    def max_scale_count_algorithm(self) -> DeconvolutionAlgorithm:
        """``parallel_deconvolution.cc:209-225``: the algorithm with the
        most scales (the first of equals) for multiscale, else the first."""
        if self.settings.algorithm_type == AlgorithmType.MULTISCALE:
            return max(
                self.algorithms, key=lambda a: getattr(a, "scale_count", 0)
            )
        return self.first_algorithm

    def set_rms_factor_image(self, image: Optional[torch.Tensor]) -> None:
        if len(self.algorithms) == 1:
            self.algorithms[0].rms_factor_image = image
        else:
            self._rms_image = image

    def set_threshold(self, threshold: float) -> None:
        for alg in self.algorithms:
            alg.threshold = threshold

    def set_minor_loop_gain(self, gain: float) -> None:
        for alg in self.algorithms:
            alg.minor_loop_gain = gain

    def set_auto_mask_mode(self, track: bool, use: bool) -> None:
        """Multiscale's per-scale auto-masks: track them (phase 1) or
        clean inside them (phase 2)."""
        self._track_per_scale_masks = track
        self._use_per_scale_masks = use
        for alg in self.algorithms:
            alg.set_auto_mask_mode(track, use)

    def set_component_optimization(self, algorithm) -> None:
        for alg in self.algorithms:
            alg.component_optimization_algorithm = algorithm

    def set_clean_mask(self, mask: Optional[np.ndarray]) -> None:
        if len(self.algorithms) == 1:
            self.algorithms[0].clean_mask = mask
        else:
            self._mask = mask

    def set_spectrally_forced_images(self, images: torch.Tensor) -> None:
        if len(self.algorithms) == 1:
            self.algorithms[0].set_spectrally_forced_images(images)
        else:
            self._spectrally_forced_images = images

    # -- component list -------------------------------------------------
    def get_component_list(self, table: WorkTable, device) -> ComponentList:
        """``parallel_deconvolution.cc:184-207``: multiscale's own
        per-scale list (gathered over the facets on a grid); for the
        single-scale algorithms (generic CLEAN, IUWT) every non-zero model
        pixel, loaded onto ``device``, is a component.  Duplicates merge."""
        if self.settings.algorithm_type == AlgorithmType.MULTISCALE:
            if len(self.algorithms) == 1:
                comp_list = self.first_algorithm.get_component_list()
            else:
                comp_list = self._component_list
        else:
            w = self.settings.trimmed_image_width
            h = self.settings.trimmed_image_height
            model_set = ImageSet.from_table(
                table,
                self.settings.squared_joins,
                self.settings.linked_polarizations,
                w,
                h,
                device,
            )
            model_set.load_and_average(False)
            comp_list = ComponentList(w, h, image_set=model_set)
        comp_list.merge_duplicates()
        return comp_list

    # -- execution -------------------------------------------------------
    def execute_major_iteration(
        self,
        data_image: ImageSet,
        model_image: ImageSet,
        psf_images: List[torch.Tensor],
        psf_offsets: List[PsfOffset],
        major_loop_gain: float,
    ) -> ParallelDeconvolutionResult:
        if len(self.algorithms) == 1:
            return self._execute_single_run(
                data_image, model_image, psf_images, psf_offsets, major_loop_gain
            )
        return self._execute_parallel_run(
            data_image, model_image, psf_images, psf_offsets, major_loop_gain
        )

    def _execute_single_run(
        self,
        data_image: ImageSet,
        model_image: ImageSet,
        psf_images: List[torch.Tensor],
        psf_offsets: List[PsfOffset],
        major_loop_gain: float,
    ) -> ParallelDeconvolutionResult:
        """``parallel_deconvolution.cc:510-553``."""
        algorithm = self.algorithms[0]
        psf_index = nearest_psf_index(
            psf_offsets, model_image.width // 2, model_image.height // 2
        )
        psfs = psf_images[psf_index]  # [n_chan, h, w]
        if psfs.shape[-2:] != (data_image.height, data_image.width):
            psfs = untrim(psfs, data_image.height, data_image.width)
        algorithm.major_loop_gain = major_loop_gain
        result = algorithm.execute_major_iteration(data_image, model_image, psfs)
        return ParallelDeconvolutionResult(
            another_iteration_required=result.another_iteration_required,
            start_peak=result.starting_peak_value,
            end_peak=result.final_peak_value,
        )

    def _execute_parallel_run(
        self,
        data_image: ImageSet,
        model_image: ImageSet,
        psf_images: List[torch.Tensor],
        psf_offsets: List[PsfOffset],
        major_loop_gain: float,
    ) -> ParallelDeconvolutionResult:
        """Faceted execution (``parallel_deconvolution.cc:555-654``):
        phase 1 finds every facet's peak (max-reduce), phase 2 cleans every
        facet to the shared threshold, with divergence rollback and the
        boundary-masked merge."""
        width, height = data_image.width, data_image.height
        # The split runs on the host; it reads the integration once.
        integrated = data_image.get_linear_integrated().cpu().numpy()
        sub_images = make_sub_images(integrated, self._mask, self.settings)
        psf_image_indices = [
            nearest_psf_index(
                psf_offsets, s.x + s.width // 2, s.y + s.height // 2
            )
            for s in sub_images
        ]
        self.last_sub_images = sub_images

        if self._can_batch_facets(sub_images, psf_image_indices, data_image):
            self.last_route = "batched"
            return self._execute_batched_run(
                sub_images,
                data_image,
                model_image,
                psf_images,
                psf_image_indices,
                major_loop_gain,
            )
        self.last_route = "serial"
        self.last_lockstep = 0

        result_model = model_image.clone_shape(width, height)

        # Phase 1: peak-only pass over all facets -> global start peak.
        for sub in sub_images:
            self._run_sub_image(
                sub,
                data_image,
                model_image,
                result_model,
                psf_images[psf_image_indices[sub.index]],
                0.0,
                find_peak_only=True,
            )
        start_peak_value = max([0.0] + [s.peak for s in sub_images])
        m_iter_threshold = start_peak_value * (1.0 - major_loop_gain)

        # Phase 2: full deconvolution of each facet to the shared threshold.
        for sub in sub_images:
            self._run_sub_image(
                sub,
                data_image,
                model_image,
                result_model,
                psf_images[psf_image_indices[sub.index]],
                m_iter_threshold,
                find_peak_only=False,
            )
        model_image.data = result_model.data
        return self._finish(sub_images, start_peak_value)

    def _finish(self, sub_images: List[SubImage],
                start_peak_value: float) -> ParallelDeconvolutionResult:
        """Another major iteration is required unless every facet finished
        (``parallel_deconvolution.cc:619-654``), or one reached the
        iteration limit."""
        self._rms_image = None
        sub_images_finished = 0
        reached_max_n_iter = False
        for sub in sub_images:
            if not sub.reached_major_threshold:
                sub_images_finished += 1
            alg = self.algorithms[sub.index]
            if alg.iteration_number >= alg.max_iterations:
                reached_max_n_iter = True
        end_peak_value = max((s.peak for s in sub_images), default=0.0)
        result = ParallelDeconvolutionResult(
            start_peak=start_peak_value, end_peak=end_peak_value
        )
        result.another_iteration_required = sub_images_finished != len(
            sub_images
        )
        if result.another_iteration_required and reached_max_n_iter:
            result.another_iteration_required = False
        return result

    def _converging(self, sub: SubImage, peak_at_start: float,
                    is_diverging: bool) -> bool:
        """Whether a facet's run kept its peak within the divergence limit
        (``parallel_deconvolution.cc:398-419``); a facet that did not is
        rolled back."""
        limit = self.settings.divergence_limit
        return (
            (limit == 0.0 or abs(sub.peak) <= peak_at_start * limit)
            and math.isfinite(sub.peak)
            and not is_diverging
        )

    # -- batched facet execution ------------------------------------------
    def _can_batch_facets(
        self, sub_images: List[SubImage], psf_image_indices, data_image
    ) -> bool:
        """Whether all facets run at once
        (``parallel_deconvolution.py:299-326`` of the JAX package): the
        algorithm must offer it (generic CLEAN and multiscale do) and
        accept the facets' stacks.  ``RADLER_TPU_NO_BATCHED_FACETS`` forces
        the serial route, which has the same semantics, one facet after
        another."""
        if os.environ.get("RADLER_TPU_NO_BATCHED_FACETS"):
            return False
        if self.settings.algorithm_type not in (
            AlgorithmType.MULTISCALE,
            AlgorithmType.GENERIC_CLEAN,
        ):
            return False
        alg = self.algorithms[0]
        if not hasattr(alg, "batched_facets_eligible"):
            return False
        box_h = max(s.height for s in sub_images)
        box_w = max(s.width for s in sub_images)
        return alg.batched_facets_eligible(
            data_image.meta,
            box_w,
            box_h,
            len(sub_images),
            n_unique_psfs=len(set(psf_image_indices)),
        )

    def _execute_batched_run(
        self,
        sub_images: List[SubImage],
        data_image: ImageSet,
        model_image: ImageSet,
        psf_images: List[torch.Tensor],
        psf_image_indices: List[int],
        major_loop_gain: float,
    ) -> ParallelDeconvolutionResult:
        """Both facet phases (``parallel_deconvolution.cc:582-617``) on
        every facet at once (``parallel_deconvolution.py:328-520`` of the
        JAX package): the facets are placed top left in a common box, the
        peak-only pass and the clean pass run them in lockstep, and the
        rollback and the boundary-masked merge work on the stacked outputs.
        Direction-dependent PSFs become one stack a facet, each facet's
        nearest (generic CLEAN), or one stack a unique PSF and each facet's
        slot in it (multiscale, whose banks are made a unique PSF).
        Multiscale's per-scale masks and components ride the loop's
        accumulators and are merged here, once a perform (the serial
        route's ``_load_scale_masks_into``, ``_store_scale_masks_from`` and
        component gathering, ``parallel_deconvolution.cc:359-390,425-479``).
        """
        alg = self.algorithms[0]
        multiscale = self.settings.algorithm_type == AlgorithmType.MULTISCALE
        dev = data_image.device
        n_facets = len(sub_images)
        n = data_image.n_images
        box_h = max(s.height for s in sub_images)
        box_w = max(s.width for s in sub_images)

        def stack(planes):
            return torch.zeros((n_facets, planes, box_h, box_w),
                               dtype=torch.float32, device=dev)

        res_stack, mdl_stack = stack(n), stack(n)
        masks = np.zeros((n_facets, box_h, box_w), dtype=bool)
        boundaries = []
        for f, sub in enumerate(sub_images):
            sh, sw = sub.height, sub.width
            box = (slice(None), slice(sub.y, sub.y + sh),
                   slice(sub.x, sub.x + sw))
            res_stack[f, :, :sh, :sw] = data_image.data[box]
            # Zero the model outside the boundary so shared sources are not
            # added by several facets (parallel_deconvolution.cc:308-313).
            bmask = torch.as_tensor(sub.boundary_mask, device=dev)
            boundaries.append(bmask)
            mdl_stack[f, :, :sh, :sw] = torch.where(
                bmask, model_image.data[box], 0.0)
            masks[f, :sh, :sw] = sub.mask

        def facet_slices(image):
            if image is None:
                return None
            out = stack(image.shape[0])
            for f, sub in enumerate(sub_images):
                out[f, :, : sub.height, : sub.width] = image[
                    :, sub.y : sub.y + sub.height, sub.x : sub.x + sub.width]
            return out

        rms_stack = (None if self._rms_image is None
                     else facet_slices(self._rms_image[None])[:, 0])
        # FORCED-mode spectral fitting: each facet's slice of the term
        # images (the serial route's set_spectrally_forced_images per clone).
        forced_stack = facet_slices(self._spectrally_forced_images)

        unique_indices = sorted(set(psf_image_indices))
        resized = {u: fit_to_box(psf_images[u], box_h, box_w)
                   for u in unique_indices}
        extra = {}
        if len(unique_indices) == 1:
            psfs = resized[unique_indices[0]]
        elif multiscale:
            psfs = torch.stack([resized[u] for u in unique_indices])
            extra["facet_psf_slot"] = [unique_indices.index(i)
                                       for i in psf_image_indices]
        else:
            psfs = torch.stack([resized[i] for i in psf_image_indices])

        # Each facet's box of the per-scale masks: the loop's starting state
        # while tracking, its search restriction while using them.
        track_masks = multiscale and self._track_per_scale_masks
        n_scales = getattr(alg, "scale_count", 0)
        facet_scale_masks = None
        if multiscale and self._scale_masks and (
                track_masks or self._use_per_scale_masks):
            facet_scale_masks = np.zeros(
                (n_facets, max(n_scales, len(self._scale_masks)), box_h,
                 box_w), dtype=bool)
            for f, sub in enumerate(sub_images):
                for i, full in enumerate(self._scale_masks):
                    facet_scale_masks[f, i, :sub.height, :sub.width] = full[
                        sub.y:sub.y + sub.height,
                        sub.x:sub.x + sub.width] & sub.mask
            extra["facet_scale_masks"] = facet_scale_masks

        starts = [self.algorithms[s.index].iteration_number
                  for s in sub_images]
        boxes = [(s.width, s.height) for s in sub_images]

        def run(threshold, peak_only):
            return alg.execute_batched_facets(
                res_stack, mdl_stack, psfs, boxes, masks, rms_stack,
                threshold, starts, peak_only, data_image.meta,
                facet_forced_terms=forced_stack, **extra)

        # Phase 1: peak-only pass (max-reduce over facets).
        peak_results = run(0.0, True)[0]
        start_peak_value = 0.0
        for sub, r in zip(sub_images, peak_results):
            sub.peak = r.final_peak_value
            start_peak_value = max(start_peak_value, sub.peak)
        peaks_at_start = [abs(s.peak) for s in sub_images]
        m_iter_threshold = start_peak_value * (1.0 - major_loop_gain)

        # Phase 2: clean every facet to the shared threshold.
        out = run(m_iter_threshold, False)
        results, iterations, self.last_lockstep = out[:3]
        mask_acc, comp_acc = out[3:] if multiscale else (None, {})

        result_model = model_image.clone_shape(data_image.width,
                                               data_image.height)
        save_components = multiscale and self.settings.save_source_list
        if track_masks and not self._scale_masks:
            self._scale_masks = [
                np.zeros((data_image.height, data_image.width), dtype=bool)
                for _ in range(n_scales)]
        if save_components and self._component_list is None:
            self._component_list = ComponentList(
                data_image.width, data_image.height, n_scales, n)
        mask_acc = mask_acc.cpu().numpy() if track_masks else None
        comp_acc = ({i: acc.cpu().numpy() for i, acc in comp_acc.items()}
                    if save_components else {})
        for f, sub in enumerate(sub_images):
            r = results[f]
            sub.peak = r.final_peak_value
            sub.reached_major_threshold = r.another_iteration_required
            self.algorithms[sub.index].iteration_number = iterations[f]
            sh, sw = sub.height, sub.width
            box = (slice(None), slice(sub.y, sub.y + sh),
                   slice(sub.x, sub.x + sw))
            if self._converging(sub, peaks_at_start[f], r.is_diverging):
                region = data_image.data[box]
                region.copy_(torch.where(boundaries[f],
                                         res_stack[f, :, :sh, :sw], region))
                facet_model = mdl_stack[f, :, :sh, :sw]
                if track_masks:
                    self._merge_scale_masks(sub, mask_acc[f],
                                            facet_scale_masks, f)
                for scale, acc in sorted(comp_acc.items()):
                    comp = acc[f, :, :sh, :sw]
                    ys, xs = np.nonzero(np.any(comp != 0.0, axis=0))
                    for y, x in zip(ys, xs):
                        self._component_list.add(
                            int(x) + sub.x, int(y) + sub.y, scale,
                            comp[:, y, x])
            else:
                # Rollback: keep the pre-iteration model for this facet
                # (parallel_deconvolution.cc:398-419).
                sub.reached_major_threshold = False
                facet_model = torch.where(boundaries[f],
                                          model_image.data[box], 0.0)
            result_model.data[box] += facet_model
        model_image.data = result_model.data
        return self._finish(sub_images, start_peak_value)

    def _merge_scale_masks(self, sub: SubImage, mask_acc: np.ndarray,
                           facet_scale_masks: Optional[np.ndarray],
                           f: int) -> None:
        """A converging facet's per-scale masks from the batched loop
        (``mask_acc`` [S, Hb, Wb], with the masks it started from), merged
        into the full-size masks inside its boundary, as the serial route's
        :meth:`_store_scale_masks_from` does."""
        sh, sw = sub.height, sub.width
        for i in range(min(len(self._scale_masks), mask_acc.shape[0])):
            local = mask_acc[i, :sh, :sw]
            if facet_scale_masks is not None:
                local = local | facet_scale_masks[f, i, :sh, :sw]
            full = self._scale_masks[i][sub.y:sub.y + sh, sub.x:sub.x + sw]
            full[...] = np.where(sub.boundary_mask, local, full)

    # -- serial facet execution --------------------------------------------
    def _run_sub_image(
        self,
        sub: SubImage,
        data_image: ImageSet,
        model_image: ImageSet,
        result_model: ImageSet,
        psfs: torch.Tensor,
        major_iteration_threshold: float,
        find_peak_only: bool,
    ) -> None:
        """One facet's pass (``parallel_deconvolution.cc:294-495``)."""
        algorithm = self.algorithms[sub.index]
        x2, y2 = sub.x + sub.width, sub.y + sub.height
        sub_data = data_image.trim(sub.x, sub.y, x2, y2)
        # Zero the model outside the boundary so shared sources are not
        # added by several facets (parallel_deconvolution.cc:308-313).
        sub_model = model_image.trim_masked(sub.x, sub.y, x2, y2,
                                            sub.boundary_mask)

        # PSFs resized to the facet's box, one resize a box for all clones
        # (so each clone's fused banks compare equal PSFs), kept while the
        # source stack stays the same.
        box = (sub.height, sub.width)
        if psfs.shape[-2:] != box:
            cached = self._sub_psf_cache.get(box)
            if cached is not None and cached[0] is psfs:
                sub_psfs = cached[1]
            else:
                sub_psfs = fit_to_box(psfs, *box)
                if len(self._sub_psf_cache) > 8:
                    self._sub_psf_cache.clear()
                self._sub_psf_cache[box] = (psfs, sub_psfs)
        else:
            sub_psfs = psfs

        algorithm.clean_mask = sub.mask
        if self._rms_image is not None:
            algorithm.rms_factor_image = self._rms_image[
                sub.y : y2, sub.x : x2].contiguous()
        if self._spectrally_forced_images is not None:
            algorithm.set_spectrally_forced_images(
                self._spectrally_forced_images[:, sub.y : y2, sub.x : x2]
                .contiguous())

        max_n_iter = algorithm.max_iterations
        if find_peak_only:
            algorithm.max_iterations = 0
        else:
            algorithm.major_iteration_threshold = major_iteration_threshold

        if self._use_per_scale_masks or self._track_per_scale_masks:
            self._load_scale_masks_into(algorithm, sub)

        peak_at_start = abs(sub.peak)
        result = algorithm.execute_major_iteration(sub_data, sub_model, sub_psfs)
        sub.peak = result.final_peak_value
        sub.reached_major_threshold = result.another_iteration_required

        converging = self._converging(sub, peak_at_start, result.is_diverging)
        if not converging and not find_peak_only:
            sub.reached_major_threshold = False

        algorithm.rms_factor_image = None

        if self._track_per_scale_masks and converging and not find_peak_only:
            self._store_scale_masks_from(algorithm, sub)

        if (
            self.settings.save_source_list
            and self.settings.algorithm_type == AlgorithmType.MULTISCALE
        ):
            if converging:
                if self._component_list is None:
                    self._component_list = ComponentList(
                        data_image.width,
                        data_image.height,
                        algorithm.scale_count,
                        data_image.n_images,
                    )
                self._component_list.add_list(
                    algorithm.get_component_list(), sub.x, sub.y
                )
            algorithm.clear_component_list()

        if find_peak_only:
            algorithm.max_iterations = max_n_iter
        else:
            if converging:
                data_image.copy_masked(sub_data, sub.x, sub.y,
                                       sub.boundary_mask)
            else:
                # Rollback: keep the pre-iteration model for this facet.
                sub_model = model_image.trim_masked(sub.x, sub.y, x2, y2,
                                                    sub.boundary_mask)
            result_model.add_sub_image(sub_model, sub.x, sub.y)

    # -- per-scale mask plumbing (multiscale + faceting) ----------------
    def _load_scale_masks_into(self, algorithm, sub: SubImage) -> None:
        """``parallel_deconvolution.cc:359-390``."""
        if not self._scale_masks:
            return
        algorithm.set_scale_mask_count(
            max(algorithm.get_scale_mask_count(), len(self._scale_masks))
        )
        for i in range(algorithm.get_scale_mask_count()):
            if i < len(self._scale_masks):
                box = self._scale_masks[i][
                    sub.y : sub.y + sub.height, sub.x : sub.x + sub.width
                ]
                algorithm.set_scale_mask(i, box & sub.mask)
            else:
                algorithm.set_scale_mask(
                    i, np.zeros((sub.height, sub.width), dtype=bool)
                )

    def _store_scale_masks_from(self, algorithm, sub: SubImage) -> None:
        """``parallel_deconvolution.cc:425-463``."""
        n_scales = algorithm.scale_count
        if not self._scale_masks:
            h = self.settings.trimmed_image_height
            w = self.settings.trimmed_image_width
            self._scale_masks = [
                np.zeros((h, w), dtype=bool) for _ in range(n_scales)
            ]
        for scale_index in range(n_scales):
            if scale_index < len(self._scale_masks):
                ms_mask = algorithm.get_scale_mask(scale_index)
                box = self._scale_masks[scale_index][
                    sub.y : sub.y + sub.height, sub.x : sub.x + sub.width
                ]
                merged = np.where(sub.boundary_mask, ms_mask, box)
                self._scale_masks[scale_index][
                    sub.y : sub.y + sub.height, sub.x : sub.x + sub.width
                ] = merged
