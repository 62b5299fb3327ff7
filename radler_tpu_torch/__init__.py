"""radler_tpu_torch: the PyTorch/CUDA port of radler_tpu.

The same public surface as ``radler_tpu`` (``python/pyradler.cc``), on
``torch.Tensor`` cubes; CUDA tensors run the minor loop through the
hand-written kernels of ``radler_tpu_torch/csrc``::

    import radler_tpu_torch as rd
    settings = rd.Settings()   # generic CLEAN with the Clark subminor loop
    ...
    r = rd.Radler(settings, psf, residual, model, beam_size)
    another_needed = r.perform(0)
"""

from .settings import (
    AlgorithmType,
    LocalRmsMethod,
    MultiscaleShape,
    OptimizationAlgorithm,
    Polarization,
    Settings,
    SpectralFittingMode,
)
from .work_table import (
    ImageAccessor,
    LoadAndStoreImageAccessor,
    LoadOnlyImageAccessor,
    PsfOffset,
    TensorImageAccessor,
    WorkTable,
    WorkTableEntry,
)
from .component_list import ComponentList
from .image_set import ImageSet
from .radler import Radler
from . import checkpoint

__version__ = "0.1.0"

__all__ = [
    "AlgorithmType",
    "ComponentList",
    "ImageAccessor",
    "ImageSet",
    "LoadAndStoreImageAccessor",
    "LoadOnlyImageAccessor",
    "LocalRmsMethod",
    "MultiscaleShape",
    "OptimizationAlgorithm",
    "Polarization",
    "PsfOffset",
    "Radler",
    "Settings",
    "SpectralFittingMode",
    "TensorImageAccessor",
    "WorkTable",
    "WorkTableEntry",
]
