"""Least-squares deconvolution (experimental).

Port of ``radler_tpu.models.ls_deconvolution``
(``cpp/algorithms/ls_deconvolution.{h,cc}``): fit the amplitudes of masked
pixel positions so that the PSF-convolved model matches the dirty image, by
an exact linear solve or a regularized nonlinear iteration.  Like the
reference and the JAX package, no ``Settings`` value reaches it (no
``AlgorithmType`` case, ``cpp/radler.cc:350-375``); it is there for direct
use and testing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.component_optimization import (
    linear_component_solve,
    lm_nonlinear_fit,
)
from .base import DeconvolutionAlgorithm, DeconvolutionResult


class LsDeconvolution(DeconvolutionAlgorithm):
    """Masked least-squares amplitude fit: with ``use_linear_solver`` the
    exact solve at the mask's (or the above-threshold) positions
    (``linearFit``), else the regularized Levenberg-Marquardt fit of
    ``nonLinearFit`` (:func:`~radler_tpu_torch.ops.component_optimization.
    lm_nonlinear_fit`)."""

    def __init__(self, use_linear_solver: bool = True):
        super().__init__()
        self.use_linear_solver = use_linear_solver

    def execute_major_iteration(self, dirty_set, model_set,
                                psfs: torch.Tensor) -> DeconvolutionResult:
        meta = dirty_set.meta
        if not self.use_linear_solver and self.clean_mask is None:
            # nonLinearFit requires a mask (ls_deconvolution.cc:245-246).
            raise RuntimeError("No mask available")
        for i in range(dirty_set.n_images):
            residual = dirty_set.data[i]
            psf = psfs[meta.psf_index(i)]
            if self.clean_mask is not None:
                support = np.asarray(self.clean_mask, bool)
            else:
                # Without a mask, every pixel above 5x the image's RMS.
                rms = torch.sqrt(torch.mean(residual * residual))
                support = (torch.abs(residual) > 5.0 * rms).cpu().numpy()
            if self.use_linear_solver:
                # A negligible seed marks the support's positions for the
                # solver; the amplitudes are solved against the residual.
                seed = torch.as_tensor(support, dtype=torch.float32,
                                       device=residual.device) * np.float32(
                                           1e-30)
                delta, residual = linear_component_solve(seed, residual, psf)
            else:
                delta, residual = lm_nonlinear_fit(support, residual, psf)
            dirty_set.data[i] = residual
            model_set.data[i] += delta
        result = DeconvolutionResult()
        result.another_iteration_required = False
        return result
