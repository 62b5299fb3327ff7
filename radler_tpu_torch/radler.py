"""Radler: the major-iteration deconvolution controller.

Port of ``radler_tpu.radler`` (``cpp/radler.{h,cc}`` and the Python
convenience constructor of ``python/pyradler.cc``).  The contract is the
reference's: the caller owns the major loop — each :meth:`Radler.perform`
call loads the residual/model through accessors, runs minor iterations until
the major-iteration threshold, writes results back, and returns whether
another major iteration (predict/invert round) is required
(``cpp/radler.h:59-69``).

The device comes from the caller's data: ``torch.Tensor`` images stay on
their device (a CUDA tensor runs the minor loop through the CUDA kernels and
never leaves the card), NumPy images are moved to ``device`` for the run and
written back at its end.  ``device`` defaults to ``"cuda"``: a run on the CPU
(the kernels' plain versions) is asked for with ``device="cpu"``, and without
a CUDA device any other request raises.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import checkpoint
from .settings import (
    AlgorithmType,
    LocalRmsMethod,
    OptimizationAlgorithm,
    Polarization,
    Settings,
    SpectralFittingMode,
)
from .work_table import (
    LoadAndStoreImageAccessor,
    LoadOnlyImageAccessor,
    TensorImageAccessor,
    WorkTable,
    WorkTableEntry,
)
from .image_set import ImageSet, get_linear_integrated
from .component_list import ComponentList
from .models.asp import AspAlgorithm
from .models.base import DeconvolutionAlgorithm
from .models.generic_clean import GenericClean
from .models.iuwt import IuwtDeconvolution
from .models.more_sane import MoreSane
from .models.multiscale import MultiScaleAlgorithm
from .models.python_plugin import PythonDeconvolution
from .ops import rms_image as rms_ops
from .ops.noise import median_and_stddev_from_mad
from .ops.spectral_fitting import create_spectral_fitter
from .parallel import mesh as mesh_module
from .parallel.mesh import Mesh, make_mesh
from .parallel.parallel_deconvolution import ParallelDeconvolution
from .utils import logging as log
from .utils.profiling import annotate

def _check_image(name: str, array, settings: Settings) -> None:
    if isinstance(array, torch.Tensor):
        if array.dtype != torch.float32:
            raise TypeError(f"{name} must be of dtype torch.float32")
    elif array.dtype != np.float32:
        raise TypeError(f"{name} must be of dtype float32")
    if array.ndim not in (2, 3):
        raise RuntimeError(f"{name} must be a 2-D or 3-D array")
    if array.shape[-1] != settings.trimmed_image_width or array.shape[
        -2
    ] != settings.trimmed_image_height:
        raise RuntimeError(f"Mismatch in {name} image size")


def _table_device(table: WorkTable, device) -> torch.device:
    """The device of a table's images: that of its tensors, else ``device``,
    else the card.  Raises when that is a CUDA device and there is none:
    a run never falls back to the CPU."""
    for entry in table.entries[:1]:
        for accessor in (*entry.psf_accessors, entry.residual_accessor):
            image = accessor.load() if accessor is not None else None
            if isinstance(image, torch.Tensor):
                return image.device
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"NumPy images run on {resolved} (device={device!r}), and no "
            "CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return resolved


class Radler:
    """Public deconvolution interface (``cpp/radler.h:27-108``)."""

    def __init__(
        self,
        settings: Settings,
        psf_or_table,
        residual=None,
        model=None,
        beam_size: float = 0.0,
        polarization: Polarization = Polarization.STOKES_I,
        frequencies: Optional[np.ndarray] = None,
        weights: Optional[np.ndarray] = None,
        n_deconvolution_groups: int = 0,
        device=None,
    ):
        with annotate("radler.init"):
            settings.validate()
            self.settings = settings
            self._parallel = ParallelDeconvolution(settings)
            self._image_width = settings.trimmed_image_width
            self._image_height = settings.trimmed_image_height
            self._pixel_scale_x = settings.pixel_scale.x
            self._pixel_scale_y = settings.pixel_scale.y
            self._beam_size = beam_size
            self._auto_mask_is_finished = False
            self._auto_mask: Optional[np.ndarray] = None
            self._auto_mask_finishing_iteration = 0
            self._clean_mask: Optional[np.ndarray] = None
            self._table: Optional[WorkTable] = None

            if isinstance(psf_or_table, WorkTable):
                if residual is not None or model is not None:
                    raise RuntimeError(
                        "Pass either a WorkTable or psf/residual/model arrays"
                    )
                table = psf_or_table
            else:
                psf_in = (
                    psf_or_table
                    if isinstance(psf_or_table, torch.Tensor)
                    else np.asarray(psf_or_table)
                )
                table = self._make_table_from_arrays(
                    psf_in,
                    residual,
                    model,
                    polarization,
                    frequencies,
                    weights,
                    n_deconvolution_groups,
                )
            self._device = _table_device(table, device)
            self._initialize_deconvolution_algorithm(table)

    # ------------------------------------------------------------------
    def _make_table_from_arrays(
        self,
        psf,
        residual,
        model,
        polarization: Polarization,
        frequencies: Optional[np.ndarray],
        weights: Optional[np.ndarray],
        n_deconvolution_groups: int,
    ) -> WorkTable:
        """Array convenience constructor (``python/pyradler.cc:60-151``):
        2-D images make a single-entry table; 3-D stacks make one entry per
        channel, with optional per-channel frequencies/weights."""
        settings = self.settings
        for name, arr in (("PSF", psf), ("residual", residual), ("model", model)):
            _check_image(name, arr, settings)
        if not (psf.ndim == residual.ndim == model.ndim):
            raise RuntimeError("PSF, residual and model must have equal rank")
        if psf.shape != residual.shape or psf.shape != model.shape:
            raise RuntimeError("PSF, residual and model shapes must match")

        if (
            settings.spectral_fitting.mode != SpectralFittingMode.NO_FITTING
            and frequencies is None
        ):
            raise RuntimeError(
                "Frequencies are required when spectral fitting is enabled"
            )

        if psf.ndim == 2:
            psf = psf[None]
            residual = residual[None]
            model = model[None]
        n_channels = psf.shape[0]

        if frequencies is not None:
            frequencies = np.asarray(frequencies)
            if frequencies.ndim != 2 or frequencies.shape != (n_channels, 2):
                raise RuntimeError(
                    "frequencies must be an (n_channels, 2) array of band "
                    "start/end frequencies"
                )
        if weights is not None:
            weights = np.asarray(weights)
            if weights.ndim != 1 or weights.shape[0] != n_channels:
                raise RuntimeError("weights must be an (n_channels,) array")

        table = WorkTable([], n_channels, n_deconvolution_groups)
        for ch in range(n_channels):
            entry = WorkTableEntry()
            entry.polarization = polarization
            entry.original_channel_index = ch
            entry.image_weight = 1.0 if weights is None else float(weights[ch])
            if frequencies is not None:
                entry.band_start_frequency = float(frequencies[ch][0])
                entry.band_end_frequency = float(frequencies[ch][1])
            if isinstance(psf, torch.Tensor):
                # Tensor-resident path: state stays on the tensors' device
                # across major iterations; results are read back via the
                # accessors.
                entry.psf_accessors = [TensorImageAccessor(psf[ch])]
                entry.residual_accessor = TensorImageAccessor(residual[ch])
                entry.model_accessor = TensorImageAccessor(model[ch])
            else:
                entry.psf_accessors = [LoadOnlyImageAccessor(psf[ch])]
                entry.residual_accessor = LoadAndStoreImageAccessor(residual[ch])
                entry.model_accessor = LoadAndStoreImageAccessor(model[ch])
            table.add_entry(entry)
        return table

    # ------------------------------------------------------------------
    def _initialize_deconvolution_algorithm(self, table: WorkTable) -> None:
        """Algorithm factory + configuration (``cpp/radler.cc:333-395``)."""
        self._auto_mask_is_finished = False
        self._auto_mask = None
        self.free_deconvolution_algorithms()
        self._table = table
        if not table.original_groups or not table.original_groups[0]:
            raise RuntimeError("Nothing to clean")
        if not math.isfinite(self._beam_size):
            log.warn("No proper beam size available in deconvolution!")
            self._beam_size = 0.0

        settings = self.settings
        algorithm: DeconvolutionAlgorithm
        if settings.algorithm_type == AlgorithmType.ADAPTIVE_SCALE_PIXEL:
            algorithm = AspAlgorithm(
                settings.multiscale,
                self._beam_size,
                self._pixel_scale_x,
                self._pixel_scale_y,
            )
        elif settings.algorithm_type == AlgorithmType.IUWT:
            algorithm = IuwtDeconvolution()
        elif settings.algorithm_type == AlgorithmType.MORE_SANE:
            algorithm = MoreSane(settings.more_sane, settings.prefix_name)
        elif settings.algorithm_type == AlgorithmType.MULTISCALE:
            algorithm = MultiScaleAlgorithm(
                settings.multiscale,
                self._beam_size,
                self._pixel_scale_x,
                self._pixel_scale_y,
                settings.save_source_list,
            )
        elif settings.algorithm_type == AlgorithmType.PYTHON:
            algorithm = PythonDeconvolution(settings.python.filename)
        else:
            algorithm = GenericClean(
                settings.generic.use_sub_minor_optimization)
        algorithm.max_iterations = settings.minor_iteration_count
        algorithm.threshold = settings.absolute_threshold
        algorithm.minor_loop_gain = settings.minor_loop_gain
        algorithm.major_loop_gain = settings.major_loop_gain
        algorithm.clean_border_ratio = settings.border_ratio
        algorithm.divergence_limit = settings.divergence_limit
        algorithm.allow_negative_components = settings.allow_negative_components
        algorithm.stop_on_negative_components = (
            settings.stop_on_negative_components
        )
        n_polarizations = len(table.original_groups[0])
        algorithm.set_spectral_fitter(
            create_spectral_fitter(settings, table), n_polarizations
        )
        if settings.parallel.use_device_mesh:
            algorithm.device_mesh = self._make_mesh(table)
        self._parallel.set_algorithm(algorithm)

        if settings.spectral_fitting.mode == SpectralFittingMode.FORCED_TERMS:
            self._read_forced_spectrum_images()
        self._read_mask(table)

    def _make_mesh(self, table: WorkTable) -> Mesh:
        """The ("chan", "tile") mesh of ``settings.parallel.n_devices``
        shards, or one shard a visible card when that is 0 (``cpp/radler.cc``'s
        thread pool; ``radler.py:263-269`` of the JAX package), spread over
        the visible cards of the run (:func:`~.parallel.mesh.visible_cards`:
        the run's card first) by :func:`~.parallel.mesh.make_mesh`'s rule.
        A CPU run is one group on the CPU."""
        cards = mesh_module.visible_cards(self._device)
        n = self.settings.parallel.n_devices or len(cards)
        mesh = make_mesh(n, n_channels=len(table.deconvolution_groups),
                         device=cards[0], cards=cards)
        if mesh.groups > 1 and log.is_enabled("info"):
            log.info(f"device mesh: chan {mesh.chan} x tile {mesh.tile} "
                     f"over {[str(d) for d in mesh.devices]}; peer access "
                     f"{mesh_module.peer_access(mesh.devices)}")
        return mesh

    # ------------------------------------------------------------------
    def free_deconvolution_algorithms(self) -> None:
        self._parallel.free_algorithms()
        self._table = None

    @property
    def is_initialized(self) -> bool:
        return self._parallel.is_initialized

    @property
    def iteration_number(self) -> int:
        return self._parallel.first_algorithm.iteration_number

    @property
    def component_list(self) -> ComponentList:
        return self.get_component_list()

    def get_component_list(self) -> ComponentList:
        return self._parallel.get_component_list(self._table, self._device)

    def max_scale_count_algorithm(self) -> DeconvolutionAlgorithm:
        return self._parallel.max_scale_count_algorithm()

    # ------------------------------------------------------------------
    def perform(self, major_iteration_number: int = 0) -> bool:
        """One major deconvolution iteration (``cpp/radler.cc:130-316``).

        Returns ``True`` when the major-iteration threshold was reached and
        the caller should run another predict/invert round.
        """
        with annotate("radler.perform"):
            settings = self.settings
            table = self._table
            assert table is not None
            table.validate_psfs()
            log.info(f" == Deconvolving ({major_iteration_number}) ==")

            def image_set() -> ImageSet:
                return ImageSet.from_table(
                    table,
                    settings.squared_joins,
                    settings.linked_polarizations,
                    self._image_width,
                    self._image_height,
                    self._device,
                )

            residual_set = image_set()
            model_set = image_set()
            with annotate("radler.perform.load"):
                residual_set.load_and_average(True)
                model_set.load_and_average(False)

            with annotate("radler.perform.noise"):
                integrated = get_linear_integrated(residual_set.data,
                                                   residual_set.meta)
                median, stddev = median_and_stddev_from_mad(integrated)
                # One host read for both noise figures.
                median, stddev = torch.stack([median, stddev]).tolist()
            log.info(
                f"Estimated standard deviation of background noise: {stddev:.4g} Jy"
            )
            auto_mask_is_enabled = (
                settings.auto_mask_sigma is not None
                or settings.absolute_auto_mask_threshold is not None
            )
            if auto_mask_is_enabled and self._auto_mask_is_finished:
                # Deeper-cleaning phase: double the gain, drop the RMS weighting
                # (``cpp/radler.cc:172-185``).
                self._parallel.set_minor_loop_gain(
                    min(1.0, settings.minor_loop_gain * 2.0)
                )
                self._parallel.set_rms_factor_image(None)
                if (
                    settings.component_optimization_algorithm
                    != OptimizationAlgorithm.CLEAN
                ):
                    self._parallel.set_component_optimization(
                        settings.component_optimization_algorithm
                    )
            else:
                self._parallel.set_minor_loop_gain(settings.minor_loop_gain)
                rms_image = self._local_rms_image(integrated)
                if rms_image is not None:
                    # The lowest local RMS takes the noise estimate's place in
                    # the thresholds below, as in the JAX package.
                    factor, stddev = rms_ops.make_rms_factor_image(
                        rms_image, settings.local_rms.strength
                    )
                    self._parallel.set_rms_factor_image(factor)

            # Thresholds (``cpp/radler.cc:222-238``).
            threshold_bias = median if settings.squared_joins else 0.0
            if auto_mask_is_enabled and not self._auto_mask_is_finished:
                combined = max(
                    stddev * (settings.auto_mask_sigma or 0.0) + threshold_bias,
                    settings.absolute_auto_mask_threshold or 0.0,
                )
                self._parallel.set_threshold(
                    max(combined, settings.absolute_threshold)
                )
            elif settings.auto_threshold_sigma is not None:
                self._parallel.set_threshold(
                    max(
                        stddev * settings.auto_threshold_sigma + threshold_bias,
                        settings.absolute_threshold,
                    )
                )

            with annotate("radler.perform.load"):
                psf_images = residual_set.load_and_average_psfs()

            if settings.algorithm_type == AlgorithmType.MULTISCALE:
                # Multiscale tracks a mask per scale in the first auto-mask
                # phase and cleans inside them in the second.
                if auto_mask_is_enabled:
                    finished = self._auto_mask_is_finished
                    self._parallel.set_auto_mask_mode(not finished, finished)
            elif auto_mask_is_enabled and self._auto_mask_is_finished:
                if self._auto_mask is None:
                    host_model = model_set.data.cpu().numpy()
                    self._auto_mask = np.any(
                        np.isfinite(host_model) & (host_model != 0.0), axis=0
                    )
                self._parallel.set_clean_mask(self._auto_mask)

            with annotate("radler.algorithm"):
                result = self._parallel.execute_major_iteration(
                    residual_set,
                    model_set,
                    psf_images,
                    table.psf_offsets,
                    settings.major_loop_gain,
                )
            another_iteration_required = result.another_iteration_required

            # Auto-mask phase flip + stop criteria (``cpp/radler.cc:276-311``).
            if (
                not another_iteration_required
                and auto_mask_is_enabled
                and not self._auto_mask_is_finished
            ):
                log.info(
                    "Auto-masking threshold reached; continuing next major "
                    "iteration with deeper threshold and mask."
                )
                self._auto_mask_is_finished = True
                another_iteration_required = True
                self._auto_mask_finishing_iteration = major_iteration_number

            if (
                another_iteration_required
                and settings.major_iteration_count != 0
                and major_iteration_number >= settings.major_iteration_count
            ):
                another_iteration_required = False
                log.info(
                    "Maximum number of major iterations was reached: not "
                    "continuing deconvolution."
                )

            if (
                another_iteration_required
                and self._auto_mask_is_finished
                and major_iteration_number - self._auto_mask_finishing_iteration
                >= settings.major_auto_mask_iteration_count
            ):
                another_iteration_required = False
                log.info(
                    "Auto-mask iteration limit reached: not continuing "
                    "deconvolution."
                )

            if (
                another_iteration_required
                and settings.minor_iteration_count != 0
                and self._parallel.first_algorithm.iteration_number
                >= settings.minor_iteration_count
            ):
                another_iteration_required = False
                log.info(
                    "Maximum number of minor deconvolution iterations was "
                    "reached: not continuing deconvolution."
                )

            with annotate("radler.perform.store"):
                residual_set.assign_and_store_residual()
                model_set.interpolate_and_store_model(
                    self._parallel.first_algorithm.spectral_fitter
                )
            return another_iteration_required

    # ------------------------------------------------------------------
    def save_state(self, path: str) -> None:
        """Checkpoint the cross-major-iteration state (auto-mask phase,
        iteration counters, per-scale masks); see
        :mod:`radler_tpu_torch.checkpoint`."""
        checkpoint.save_state(self, path)

    def load_state(self, path: str) -> None:
        """Resume from a checkpoint written by :meth:`save_state`, here or
        by the JAX package's ``Radler.save_state``."""
        checkpoint.load_state(self, path)

    def _local_rms_image(self, integrated: torch.Tensor):
        """The local-RMS map of ``settings.local_rms``, or None (the
        local-RMS branch of the reference's ``Radler::Perform``): read from a
        FITS file, or made from the integrated residual."""
        local_rms = self.settings.local_rms
        if local_rms.image:
            from .utils.fits import read_fits_image

            return torch.as_tensor(
                np.asarray(read_fits_image(local_rms.image), np.float32),
                device=self._device,
            )
        if local_rms.method == LocalRmsMethod.NONE:
            return None
        make = (
            rms_ops.make_rms_image
            if local_rms.method == LocalRmsMethod.RMS_WINDOW
            else rms_ops.make_with_negativity_limit
        )
        return make(
            integrated,
            local_rms.window,
            self._beam_size,
            self._beam_size,
            0.0,
            self._pixel_scale_x,
            self._pixel_scale_y,
        )

    # ------------------------------------------------------------------
    def _read_forced_spectrum_images(self) -> None:
        """``cpp/radler.cc:410-432``."""
        from .utils.fits import read_fits_cube

        terms = read_fits_cube(self.settings.spectral_fitting.forced_filename)
        if terms.shape[-2:] != (self._image_height, self._image_width):
            raise RuntimeError(
                "The image dimensions of the forced spectrum fits file do not "
                "match the deconvolved image dimensions"
            )
        if terms.shape[0] + 1 != self.settings.spectral_fitting.terms:
            raise RuntimeError(
                "The number of images in the forced spectrum fits file does "
                "not match the number of spectral terms"
            )
        self._parallel.set_spectrally_forced_images(
            torch.as_tensor(
                np.asarray(terms, np.float32), device=self._device
            )
        )

    def _read_mask(self, table: WorkTable) -> None:
        """FITS/CASA/horizon mask ingestion (``cpp/radler.cc:434-527``)."""
        settings = self.settings
        has_mask = False
        if settings.fits_mask:
            from .utils.fits import read_fits_cube

            data = read_fits_cube(settings.fits_mask)
            if data.shape[-2:] != (self._image_height, self._image_width):
                raise RuntimeError(
                    "Specified Fits file mask did not have same dimensions as "
                    "output image!"
                )
            if data.shape[0] == 1:
                mask_plane = data[0]
            elif data.shape[0] == settings.channels_out:
                mask_plane = data[table.front.mask_channel_index]
            else:
                raise RuntimeError(
                    f"The number of frequencies in the specified fits mask "
                    f"({data.shape[0]}) does not match the number of requested "
                    f"output channels ({settings.channels_out})"
                )
            self._clean_mask = mask_plane != 0.0
            has_mask = True
        elif settings.casa_mask:
            from .utils.casa_mask_reader import CasaMaskReader

            reader = CasaMaskReader(settings.casa_mask)
            if (reader.height, reader.width) != (
                self._image_height,
                self._image_width,
            ):
                raise RuntimeError(
                    "Specified CASA mask did not have same dimensions as "
                    "output image!"
                )
            self._clean_mask = reader.read()
            has_mask = True

        if settings.horizon_mask_distance is not None:
            if not has_mask:
                self._clean_mask = np.ones(
                    (self._image_height, self._image_width), dtype=bool
                )
                has_mask = True
            self._apply_horizon_mask()

        if has_mask:
            self._parallel.set_clean_mask(self._clean_mask)

    def _apply_horizon_mask(self) -> None:
        """``cpp/radler.cc:484-524``."""
        from .utils.coordinates import xy_to_lm_grid

        distance = self.settings.horizon_mask_distance
        fov = math.pi / 2.0 - distance
        if fov < 0.0:
            fov = 0.0
        if fov <= math.pi / 2.0:
            fov = math.sin(fov)
        else:
            fov = 1.0 - distance
        fov_sq = fov * fov
        l, m = xy_to_lm_grid(
            self._image_width,
            self._image_height,
            self._pixel_scale_x,
            self._pixel_scale_y,
        )
        self._clean_mask &= (l * l + m * m) < fov_sq
        filename = self.settings.horizon_mask_filename
        if not filename:
            filename = self.settings.prefix_name + "-horizon-mask.fits"
        from .utils.fits import write_fits_image

        write_fits_image(filename, self._clean_mask.astype(np.float32))
