"""Configuration schema for the PyTorch/CUDA Radler port.

Behavioral equivalent of the reference's ``Settings`` struct
(``cpp/settings.h:132-534``) and its enums (``cpp/settings.h:21-130``),
re-expressed as Python dataclasses.  Field names and defaults mirror the
reference so a Radler user can port configs 1:1; the execution engine behind
them is PyTorch with hand-written CUDA kernels rather than threaded C++.
The fields and defaults are the same as ``radler_tpu.settings``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Set


class LocalRmsMethod(enum.Enum):
    """How a local-RMS map is used during peak finding.

    Mirrors ``cpp/settings.h:21-29``.
    """

    NONE = "none"
    RMS_WINDOW = "rms_window"
    RMS_AND_MINIMUM_WINDOW = "rms_and_minimum_window"


class AlgorithmType(enum.Enum):
    """Deconvolution algorithm families (``cpp/settings.h:34-80``)."""

    GENERIC_CLEAN = "generic_clean"
    ADAPTIVE_SCALE_PIXEL = "adaptive_scale_pixel"
    IUWT = "iuwt"
    MORE_SANE = "more_sane"
    MULTISCALE = "multiscale"
    PYTHON = "python"


class MultiscaleShape(enum.Enum):
    """Scale-kernel shape for multiscale clean (``cpp/settings.h:85-101``)."""

    TAPERED_QUADRATIC = "tapered_quadratic_shape"
    GAUSSIAN = "gaussian_shape"


class OptimizationAlgorithm(enum.Enum):
    """Component-value optimization modes (``cpp/settings.h:103-130``)."""

    CLEAN = "clean"
    LINEAR_EQUATION_SOLVER = "linear_equation_solver"
    GRADIENT_DESCENT = "gradient_descent"
    REGULARIZED_GRADIENT_DESCENT = "regularized_gradient_descent"


class SpectralFittingMode(enum.Enum):
    """Spectral fitting modes, equivalent of
    ``schaapcommon::fitters::SpectralFittingMode`` (used at
    ``cpp/settings.h:403-422``)."""

    NO_FITTING = "no_fitting"
    POLYNOMIAL = "polynomial"
    LOG_POLYNOMIAL = "log_polynomial"
    FORCED_TERMS = "forced_terms"


class Polarization(enum.Enum):
    """Polarization labels (equivalent of ``aocommon::PolarizationEnum``)."""

    STOKES_I = "I"
    STOKES_Q = "Q"
    STOKES_U = "U"
    STOKES_V = "V"
    XX = "XX"
    XY = "XY"
    YX = "YX"
    YY = "YY"
    RR = "RR"
    RL = "RL"
    LR = "LR"
    LL = "LL"
    FULL_STOKES = "IQUV"
    INSTRUMENTAL = "instrumental"

    @property
    def is_stokes(self) -> bool:
        return self in (
            Polarization.STOKES_I,
            Polarization.STOKES_Q,
            Polarization.STOKES_U,
            Polarization.STOKES_V,
        )


def has_dual_polarization(pols: Set[Polarization]) -> bool:
    """True for {XX, YY} or {RR, LL} (aocommon ``HasDualPolarization``)."""
    return pols == {Polarization.XX, Polarization.YY} or pols == {
        Polarization.RR,
        Polarization.LL,
    }


def has_full_linear_polarization(pols: Set[Polarization]) -> bool:
    return pols == {Polarization.XX, Polarization.XY, Polarization.YX, Polarization.YY}


def has_full_circular_polarization(pols: Set[Polarization]) -> bool:
    return pols == {Polarization.RR, Polarization.RL, Polarization.LR, Polarization.LL}


@dataclasses.dataclass
class PixelScale:
    x: float = 0.0
    y: float = 0.0


@dataclasses.dataclass
class ParallelSettings:
    """Sub-image (facet) decomposition settings (``cpp/settings.h:172-188``).

    On TPU the facets become shards of a device mesh rather than threads;
    ``max_threads`` is kept for API compatibility and bounds host-side
    concurrency for non-jitted work.
    """

    grid_width: int = 1
    grid_height: int = 1
    max_threads: int = 0  # 0 -> auto

    # TPU-native extension: lay facet tiles out over this many devices of the
    # active mesh (0 = use all available devices).
    n_devices: int = 0

    # TPU-native extension: shard the image cube over a ("chan", "tile")
    # device mesh so the minor loop's joined integration / global argmax run
    # as XLA collectives over ICI (SURVEY.md §2.2's four exchange patterns).
    use_device_mesh: bool = False


@dataclasses.dataclass
class LocalRmsSettings:
    """Local-RMS thresholding settings (``cpp/settings.h:376-398``)."""

    method: LocalRmsMethod = LocalRmsMethod.NONE
    window: float = 25.0
    image: str = ""
    strength: float = 1.0


@dataclasses.dataclass
class SpectralFittingSettings:
    """(``cpp/settings.h:403-422``)"""

    mode: SpectralFittingMode = SpectralFittingMode.NO_FITTING
    terms: int = 0
    forced_filename: str = ""


@dataclasses.dataclass
class PythonSettings:
    """User-plugin algorithm settings (``cpp/settings.h:439-442``)."""

    filename: str = ""


@dataclasses.dataclass
class MoreSaneSettings:
    """External PyMORESANE integration settings (``cpp/settings.h:451-462``)."""

    location: str = ""
    arguments: str = ""
    sigma_levels: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MultiscaleSettings:
    """Multiscale algorithm settings (``cpp/settings.h:465-524``)."""

    fast_sub_minor_loop: bool = True
    sub_minor_loop_gain: float = 0.2
    scale_bias: float = 0.6
    max_scales: int = 0
    convolution_padding: float = 1.1
    scale_list: List[float] = dataclasses.field(default_factory=list)
    shape: MultiscaleShape = MultiscaleShape.TAPERED_QUADRATIC


@dataclasses.dataclass
class GenericSettings:
    """(``cpp/settings.h:527-532``)"""

    use_sub_minor_optimization: bool = True


@dataclasses.dataclass
class Settings:
    """Full deconvolution configuration.

    Mirrors ``radler::Settings`` (``cpp/settings.h:132-534``) field-for-field.
    """

    trimmed_image_width: int = 0
    trimmed_image_height: int = 0
    channels_out: int = 1
    pixel_scale: PixelScale = dataclasses.field(default_factory=PixelScale)
    thread_count: int = 1
    prefix_name: str = "wsclean"
    linked_polarizations: Set[Polarization] = dataclasses.field(default_factory=set)
    parallel: ParallelSettings = dataclasses.field(default_factory=ParallelSettings)
    absolute_threshold: float = 0.0
    minor_loop_gain: float = 0.1
    major_loop_gain: float = 1.0
    auto_threshold_sigma: Optional[float] = None
    auto_mask_sigma: Optional[float] = None
    absolute_auto_mask_threshold: Optional[float] = None
    save_source_list: bool = False
    minor_iteration_count: int = 0
    major_iteration_count: int = 12
    major_auto_mask_iteration_count: int = 2
    allow_negative_components: bool = True
    stop_on_negative_components: bool = False
    squared_joins: bool = False
    spectral_correction: List[float] = dataclasses.field(default_factory=list)
    spectral_correction_frequency: float = 0.0
    border_ratio: float = 0.0
    fits_mask: str = ""
    casa_mask: str = ""
    divergence_limit: float = 4.0
    horizon_mask_distance: Optional[float] = None
    horizon_mask_filename: str = ""
    component_optimization_algorithm: OptimizationAlgorithm = (
        OptimizationAlgorithm.CLEAN
    )
    local_rms: LocalRmsSettings = dataclasses.field(default_factory=LocalRmsSettings)
    spectral_fitting: SpectralFittingSettings = dataclasses.field(
        default_factory=SpectralFittingSettings
    )
    algorithm_type: AlgorithmType = AlgorithmType.GENERIC_CLEAN
    python: PythonSettings = dataclasses.field(default_factory=PythonSettings)
    more_sane: MoreSaneSettings = dataclasses.field(default_factory=MoreSaneSettings)
    multiscale: MultiscaleSettings = dataclasses.field(
        default_factory=MultiscaleSettings
    )
    generic: GenericSettings = dataclasses.field(default_factory=GenericSettings)

    def validate(self) -> None:
        """Constructor-time validation, mirroring ``cpp/radler.cc:95-112``."""
        if (
            self.spectral_fitting.mode == SpectralFittingMode.FORCED_TERMS
            and not self.spectral_fitting.forced_filename
        ):
            raise RuntimeError(
                "Forced fitting filename is required when forced fitting is "
                "enabled."
            )
        if self.parallel.grid_width <= 0:
            raise RuntimeError("parallel.grid_width must be larger than zero")
        if self.parallel.grid_height <= 0:
            raise RuntimeError("parallel.grid_height must be larger than zero")
        if self.thread_count <= 0:
            raise RuntimeError("thread_count must be larger than zero")
