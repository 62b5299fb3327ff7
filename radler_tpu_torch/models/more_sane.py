"""External PyMORESANE integration.

Port of ``radler_tpu.models.more_sane`` (``cpp/algorithms/more_sane.{h,cc}``):
per image, after the first major iteration, add the model convolved with the
PSF back to the residual (on the run's device), write the dirty image, the
PSF and the mask as FITS files, run the MORESANE program with the major
iteration's sigma level, and read the model and residual it writes back onto
the run's device.  The program is run as ``python <location> ...``, the
reference's command.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from ..ops.convolution import convolve_same
from ..settings import MoreSaneSettings
from ..utils import logging as log
from ..utils.fits import read_fits_image, write_fits_image
from .base import DeconvolutionAlgorithm, DeconvolutionResult


def to_host(image: torch.Tensor) -> np.ndarray:
    """An image copied from the run's device to the host."""
    return image.cpu().numpy()


def to_device(image: np.ndarray, device) -> torch.Tensor:
    """A host image copied to ``device`` as float32."""
    return torch.as_tensor(np.asarray(image, np.float32), device=device)


class MoreSane(DeconvolutionAlgorithm):
    def __init__(self, settings: MoreSaneSettings, prefix_name: str):
        super().__init__()
        self.ms_settings = settings
        self.prefix_name = prefix_name

    def _execute_single(
        self, residual: torch.Tensor, model: torch.Tensor, psf: torch.Tensor
    ):
        """``more_sane.cc:15-70``."""
        if self.iteration_number != 0:
            log.info("Convolving model with psf and adding back to residual...")
            residual = residual + convolve_same(model, psf)

        output_name = (
            f"{self.prefix_name}-tmp-moresaneoutput{self.iteration_number}"
        )
        dirty_name = f"{self.prefix_name}-tmp-moresaneinput-dirty.fits"
        psf_name = f"{self.prefix_name}-tmp-moresaneinput-psf.fits"
        mask_name = f"{self.prefix_name}-tmp-moresaneinput-mask.fits"
        if self.clean_mask is not None:
            write_fits_image(mask_name,
                             np.asarray(self.clean_mask).astype(np.float32))
        write_fits_image(dirty_name, to_host(residual))
        write_fits_image(psf_name, to_host(psf))

        command = ["python", self.ms_settings.location]
        if not self.allow_negative_components:
            command.append("-ep")
        if self.clean_mask is not None:
            command += ["-m", mask_name]
        if self.ms_settings.arguments:
            command += self.ms_settings.arguments.split()
        command += [dirty_name, psf_name, output_name]
        if self.ms_settings.sigma_levels:
            idx = min(
                self.iteration_number, len(self.ms_settings.sigma_levels) - 1
            )
            command += ["-sl", str(self.ms_settings.sigma_levels[idx])]

        log.info("Running: " + " ".join(command))
        subprocess.run(command, check=True)

        model_out = to_device(read_fits_image(output_name + "_model.fits"),
                              residual.device)
        residual_out = to_device(
            read_fits_image(output_name + "_residual.fits"), residual.device)
        for name in (
            dirty_name,
            psf_name,
            mask_name,
            output_name + "_model.fits",
            output_name + "_residual.fits",
        ):
            try:
                os.unlink(name)
            except OSError:
                pass
        return residual_out, model_out

    def execute_major_iteration(
        self, dirty_set, model_set, psfs: torch.Tensor
    ) -> DeconvolutionResult:
        """``more_sane.cc:72-86``."""
        new_res = []
        new_mod = []
        for i in range(dirty_set.n_images):
            res, mod = self._execute_single(
                dirty_set.data[i],
                model_set.data[i],
                psfs[dirty_set.meta.psf_index(i)],
            )
            new_res.append(res)
            new_mod.append(mod)
        dirty_set.data = torch.stack(new_res)
        model_set.data = torch.stack(new_mod)
        self.iteration_number += 1
        result = DeconvolutionResult()
        result.another_iteration_required = (
            self.iteration_number < self.max_iterations
        )
        return result
