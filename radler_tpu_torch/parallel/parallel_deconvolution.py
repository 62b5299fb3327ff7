"""Facet (sub-image) orchestration layer.

Port of ``radler_tpu.parallel.parallel_deconvolution``
(``cpp/algorithms/parallel_deconvolution.{h,cc}``) for a 1x1 facet grid: the
single run and the component list.  A larger grid raises until the facet
slice is ported (ROADMAP queue A, item 6).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..component_list import ComponentList
from ..image_set import ImageSet
from ..models.base import DeconvolutionAlgorithm
from ..ops.convolution import untrim
from ..settings import AlgorithmType, Settings
from ..work_table import PsfOffset, WorkTable


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


@dataclasses.dataclass
class ParallelDeconvolutionResult:
    """``parallel_deconvolution.h``'s result struct."""

    another_iteration_required: bool = False
    start_peak: Optional[float] = None
    end_peak: Optional[float] = None


class ParallelDeconvolution:
    """Host-side facet controller."""

    def __init__(self, settings: Settings):
        grid = (settings.parallel.grid_width, settings.parallel.grid_height)
        if grid != (1, 1):
            raise NotImplementedError(
                f"a {grid[0]}x{grid[1]} facet grid (settings.parallel."
                "grid_width/grid_height) is not ported yet; ROADMAP queue A, "
                "item 6 brings facets."
            )
        self.settings = settings
        self.algorithms: List[DeconvolutionAlgorithm] = []
        # Facet-level per-scale auto-masks: the facet slice fills them; a
        # 1x1 grid keeps its masks in the algorithm, so this stays empty
        # (the checkpoint writes it all the same).
        self._scale_masks: List = []

    # -- setup ---------------------------------------------------------
    @property
    def is_initialized(self) -> bool:
        return bool(self.algorithms)

    def set_algorithm(self, algorithm: DeconvolutionAlgorithm) -> None:
        self.algorithms = [algorithm]

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
        self.first_algorithm.rms_factor_image = image

    def set_threshold(self, threshold: float) -> None:
        self.first_algorithm.threshold = threshold

    def set_minor_loop_gain(self, gain: float) -> None:
        self.first_algorithm.minor_loop_gain = gain

    def set_auto_mask_mode(self, track: bool, use: bool) -> None:
        """Multiscale's per-scale auto-masks: track them (phase 1) or
        clean inside them (phase 2)."""
        for alg in self.algorithms:
            alg.set_auto_mask_mode(track, use)

    def set_component_optimization(self, algorithm) -> None:
        self.first_algorithm.component_optimization_algorithm = algorithm

    def set_clean_mask(self, mask) -> None:
        self.first_algorithm.clean_mask = mask

    def set_spectrally_forced_images(self, images: torch.Tensor) -> None:
        self.first_algorithm.set_spectrally_forced_images(images)

    # -- component list -------------------------------------------------
    def get_component_list(self, table: WorkTable, device) -> ComponentList:
        """``parallel_deconvolution.cc:184-207``: multiscale's own
        per-scale list; for the single-scale algorithms (generic CLEAN,
        IUWT) every non-zero model pixel, loaded onto ``device``, is a
        component.  Duplicates merge."""
        if self.settings.algorithm_type == AlgorithmType.MULTISCALE:
            comp_list = self.first_algorithm.get_component_list()
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
        return self._execute_single_run(
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
