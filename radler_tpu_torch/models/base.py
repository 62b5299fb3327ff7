"""Algorithm base: shared knobs, result type, the spectral fitter.

Port of ``radler_tpu.models.base`` (``cpp/algorithms/deconvolution_algorithm.{h,cc}``).
Concrete algorithms update ``[n_images, H, W]`` tensor cubes; the base class
carries host-side configuration (thresholds, gains, masks) and the per-run
iteration counter.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..settings import OptimizationAlgorithm
from ..ops.spectral_fitting import SpectralFitter


@dataclasses.dataclass
class DeconvolutionResult:
    """Mirrors ``cpp/algorithms/deconvolution_algorithm.h:31-58``."""

    starting_peak_value: Optional[float] = None
    final_peak_value: float = 0.0
    another_iteration_required: bool = False
    is_diverging: bool = False


class DeconvolutionAlgorithm:
    """Common settings & state (``deconvolution_algorithm.h:60-210``)."""

    def __init__(self):
        # Defaults mirror ``deconvolution_algorithm.h:189-202``.
        self.threshold: float = 0.0
        self.major_iteration_threshold: float = 0.0
        self.minor_loop_gain: float = 0.1
        self.major_loop_gain: float = 1.0
        self.clean_border_ratio: float = 0.05
        self.max_iterations: int = 500
        self.divergence_limit: float = 4.0
        self.allow_negative_components: bool = True
        self.stop_on_negative_components: bool = False
        self.component_optimization_algorithm = OptimizationAlgorithm.CLEAN
        self.clean_mask: Optional[np.ndarray] = None  # bool [H, W]
        self.rms_factor_image: Optional[torch.Tensor] = None
        self.iteration_number: int = 0
        self.spectral_fitter: Optional[SpectralFitter] = None
        self.n_polarizations: int = 1
        # A ("chan", "tile") mesh (parallel/mesh.py) whose shards the minor
        # loop runs on, or None for the single-device loop.
        self.device_mesh = None

    # -- configuration ----------------------------------------------------
    def set_spectral_fitter(self, fitter: SpectralFitter, n_polarizations: int):
        self.spectral_fitter = fitter
        self.n_polarizations = n_polarizations

    def set_spectrally_forced_images(self, term_images: torch.Tensor):
        self.spectral_fitter.set_forced_terms(term_images)

    def clone(self) -> "DeconvolutionAlgorithm":
        """A copy sharing the configuration (``Clone()``): the facet layer
        gives each sub-image its own iteration state.  Subclasses that keep
        caches reset them, since a shallow copy would share them."""
        return copy.copy(self)

    # -- helpers ----------------------------------------------------------
    def apply_spectral_constraints_to_components(self,
                                                 component_list) -> None:
        """Fit every component's spectrum (``deconvolution_algorithm.cc:
        48-63``), each polarization on its own, on the host (on the term
        images' device with forced terms)."""
        fitter = self.spectral_fitter
        if fitter is None or not fitter.is_active:
            return
        dev = (fitter._forced_terms.device
               if fitter._forced_terms is not None else "cpu")
        n_channels = len(fitter.frequencies)
        for scale_index in range(component_list.n_scales):
            for ci in range(component_list.component_count(scale_index)):
                x, y, values = component_list.get_component(scale_index, ci)
                vals = torch.as_tensor(np.asarray(values, np.float32),
                                       device=dev)
                fitted = fitter.fit_and_evaluate(
                    vals.reshape(n_channels, self.n_polarizations), x, y)
                component_list.set_values(
                    scale_index, ci, fitted.reshape(-1).cpu().numpy())

    # -- interface ---------------------------------------------------------
    def execute_major_iteration(
        self, dirty_set, model_set, psfs
    ) -> DeconvolutionResult:
        """Run one major deconvolution iteration.

        ``dirty_set`` / ``model_set`` are
        :class:`radler_tpu_torch.image_set.ImageSet` (updated in place);
        ``psfs`` is a ``[n_channels, h, w]`` tensor for the selected
        direction's PSFs.
        """
        raise NotImplementedError
