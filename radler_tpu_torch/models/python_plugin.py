"""User-supplied Python deconvolution algorithm.

Port of ``radler_tpu.models.python_plugin``
(``cpp/algorithms/python_deconvolution.{h,cc}``).  The reference embeds a
Python interpreter; here the host is Python, so the user's file is exec'd and
its ``deconvolve(residual, model, psf, meta)`` called with the same contract:

* ``residual``/``model``: float64 NumPy arrays copied from the run's device,
  shaped ``[n_freq, n_pol, height, width]`` (``python_deconvolution.cc:227-291``);
* ``psf``: float64 ``[n_freq, height, width]``;
* ``meta``: an object with ``channels`` (frequency/weight pairs), ``gain``,
  ``iteration_number``, ``major_iter_threshold``, ``max_iterations``,
  ``mgain``, ``final_threshold``, ``square_joined_channels`` and
  ``spectral_fitter`` (with ``fit``/``fit_and_evaluate`` on NumPy arrays);
* it returns a dict with ``residual``, ``model``, ``level`` and ``continue``
  (``python_deconvolution.cc:293-323``), whose arrays go back to the run's
  device as float32.

``meta.square_joined_channels`` stays False, as in the JAX package, which
never sets it.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .base import DeconvolutionAlgorithm, DeconvolutionResult


@dataclasses.dataclass
class PyChannel:
    frequency: float = 0.0
    weight: float = 0.0


class PySpectralFitter:
    """Plugin-facing fitter wrapper (``python_deconvolution.cc:18-116``),
    on NumPy arrays."""

    def __init__(self, fitter):
        self._fitter = fitter

    def fit(self, values, x, y):
        return np.asarray(self._fitter.fit(np.asarray(values), x, y))

    def fit_and_evaluate(self, values, x, y):
        vals = torch.as_tensor(np.asarray(values, np.float32))
        return self._fitter.fit_and_evaluate(vals, x, y).cpu().numpy()


class PyMetaData:
    """``python_deconvolution.cc:118-158``."""

    def __init__(self, fitter):
        self.channels: List[PyChannel] = []
        self.gain = 0.0
        self.iteration_number = 0
        self.major_iter_threshold = 0.0
        self.max_iterations = 0
        self.mgain = 0.0
        self.final_threshold = 0.0
        self.square_joined_channels = False
        self.spectral_fitter = PySpectralFitter(fitter)


def to_host(cube: torch.Tensor) -> np.ndarray:
    """A cube copied from the run's device to the host, as float64."""
    return cube.cpu().numpy().astype(np.float64)


def to_device(cube, shape, device) -> torch.Tensor:
    """A plug-in's array, reshaped to ``shape``, copied to ``device`` as
    float32."""
    host = np.asarray(cube, np.float64).reshape(shape).astype(np.float32)
    return torch.as_tensor(host, device=device)


class PythonDeconvolution(DeconvolutionAlgorithm):
    """Load the user's file and call its ``deconvolve`` per major iteration."""

    def __init__(self, filename: str):
        super().__init__()
        self.filename = filename
        namespace: dict = {}
        with open(filename, "r") as f:
            code = f.read()
        exec(compile(code, filename, "exec"), namespace)
        if "deconvolve" not in namespace:
            raise RuntimeError(
                f"Python file '{filename}' does not define a deconvolve() "
                "function"
            )
        self._deconvolve = namespace["deconvolve"]

    def execute_major_iteration(
        self, dirty_set, model_set, psfs: torch.Tensor
    ) -> DeconvolutionResult:
        meta_cube = dirty_set.meta
        n_freq = meta_cube.n_channels
        n_pol = meta_cube.n_polarizations
        height, width = dirty_set.height, dirty_set.width
        dev = dirty_set.data.device

        residual = to_host(dirty_set.data).reshape(n_freq, n_pol, height,
                                                   width)
        model = to_host(model_set.data).reshape(n_freq, n_pol, height, width)
        psf = to_host(psfs)

        meta = PyMetaData(self.spectral_fitter)
        if self.spectral_fitter is not None:
            for f, w in zip(
                self.spectral_fitter.frequencies, self.spectral_fitter.weights
            ):
                meta.channels.append(PyChannel(float(f), float(w)))
        meta.gain = self.minor_loop_gain
        meta.iteration_number = self.iteration_number
        meta.major_iter_threshold = self.major_iteration_threshold
        meta.max_iterations = self.max_iterations
        meta.mgain = self.major_loop_gain
        meta.final_threshold = self.threshold

        try:
            result = self._deconvolve(residual, model, psf, meta)
        except Exception as e:
            raise RuntimeError(
                "Error occurred while executing python deconvolution "
                f"function: {e}"
            ) from e
        self.iteration_number = meta.iteration_number

        if not isinstance(result, dict):
            raise RuntimeError(
                "In python deconvolution code: Return value of deconvolve() "
                "should be a dictionary"
            )
        for key in ("residual", "model", "level", "continue"):
            if key not in result:
                raise RuntimeError(
                    "In python deconvolution code: Dictionary returned by "
                    "deconvolve() is missing items; should have 'residual', "
                    "'model', 'level' and 'continue'"
                )
        shape = (n_freq * n_pol, height, width)
        dirty_set.data = to_device(result["residual"], shape, dev)
        model_set.data = to_device(result["model"], shape, dev)
        out = DeconvolutionResult()
        out.final_peak_value = float(result["level"])
        out.another_iteration_required = bool(result["continue"])
        return out
