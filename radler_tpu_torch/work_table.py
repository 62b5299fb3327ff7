"""Input description: work table of (channel, polarization) image entries.

Behavioral equivalent of the reference's ``WorkTable`` / ``WorkTableEntry`` /
``PsfOffset`` (``cpp/work_table.{h,cc}``, ``cpp/work_table_entry.h``,
``cpp/psf_offset.h``).  Accessors are plain Python objects wrapping NumPy
arrays; image data crosses the host<->device boundary only at load/store time.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .settings import Polarization


class ImageAccessor:
    """Abstract Load/Store interface (equivalent of ``aocommon::ImageAccessor``)."""

    @property
    def width(self) -> int:
        raise NotImplementedError

    @property
    def height(self) -> int:
        raise NotImplementedError

    def load(self) -> np.ndarray:
        """Return the image as a float32 [H, W] array."""
        raise NotImplementedError

    def store(self, data: np.ndarray) -> None:
        raise NotImplementedError


class LoadOnlyImageAccessor(ImageAccessor):
    """Zero-copy view of a caller array that can only be loaded.

    Equivalent of ``cpp/utils/load_image_accessor.h:28-56``.
    """

    def __init__(self, array: np.ndarray):
        self._array = array

    @property
    def width(self) -> int:
        return self._array.shape[-1]

    @property
    def height(self) -> int:
        return self._array.shape[-2]

    def load(self) -> np.ndarray:
        return self._array

    def store(self, data: np.ndarray) -> None:
        raise RuntimeError("An ImageAccessor is not allowed to store this image")


class LoadAndStoreImageAccessor(LoadOnlyImageAccessor):
    """View of a caller array; stores write back in place so the caller's
    buffer is updated (``cpp/utils/load_and_store_image_accessor.h:27-56``).
    """

    def store(self, data: np.ndarray) -> None:
        self._array[...] = np.asarray(data, dtype=self._array.dtype)


class TensorImageAccessor(ImageAccessor):
    """Tensor-resident accessor: the image stays on its device (GPU memory
    for a CUDA tensor) across major iterations, with no host round-trip at
    the Load/Store boundary.

    Extension of the accessor concept: the reference's contract is in-RAM
    caller buffers (``cpp/radler.h:59-69``); the equivalent for a GPU caller
    is a ``torch.Tensor`` on the card.  ``array`` always holds the most
    recently stored image.
    """

    def __init__(self, array):
        self.array = array

    @property
    def width(self) -> int:
        return self.array.shape[-1]

    @property
    def height(self) -> int:
        return self.array.shape[-2]

    def load(self):
        return self.array

    def store(self, data) -> None:
        self.array = data


@dataclasses.dataclass
class PsfOffset:
    """Center position of a direction-dependent PSF (``cpp/psf_offset.h``)."""

    x: int = 0
    y: int = 0

    def __repr__(self) -> str:  # matches reference's stream format loosely
        return f"PsfOffset: x: {self.x}, y: {self.y}"


@dataclasses.dataclass
class WorkTableEntry:
    """One (channel, polarization) input plane (``cpp/work_table_entry.h``)."""

    index: int = 0
    band_start_frequency: float = 0.0
    band_end_frequency: float = 0.0
    polarization: Polarization = Polarization.STOKES_I
    original_channel_index: int = 0
    original_interval_index: int = 0
    mask_channel_index: int = 0
    image_weight: float = 0.0
    psf_accessors: List[ImageAccessor] = dataclasses.field(default_factory=list)
    model_accessor: Optional[ImageAccessor] = None
    residual_accessor: Optional[ImageAccessor] = None

    @property
    def central_frequency(self) -> float:
        return 0.5 * (self.band_start_frequency + self.band_end_frequency)


class WorkTable:
    """Groups entries by original channel and into deconvolution groups.

    Mirrors ``cpp/work_table.cc:13-44``: ``n_original_groups`` is clamped to a
    minimum of 1; ``n_deconvolution_groups`` of 0 (or > original) means one
    deconvolution group per original channel.  Original group ``i`` maps to
    deconvolution group ``i * n_deconv / n_orig``.
    """

    def __init__(
        self,
        psf_offsets: Sequence[PsfOffset],
        n_original_groups: int,
        n_deconvolution_groups: int,
        channel_index_offset: int = 0,
    ):
        self._entries: List[WorkTableEntry] = []
        self._psf_offsets = list(psf_offsets)
        self._channel_index_offset = channel_index_offset
        n_original = max(n_original_groups, 1)
        if n_deconvolution_groups == 0:
            n_deconv = n_original
        else:
            n_deconv = min(n_original, n_deconvolution_groups)
        self._original_groups: List[List[WorkTableEntry]] = [
            [] for _ in range(n_original)
        ]
        self._deconvolution_groups: List[List[int]] = [[] for _ in range(n_deconv)]
        for i in range(n_original):
            self._deconvolution_groups[i * n_deconv // n_original].append(i)

    # -- accessors ---------------------------------------------------------
    @property
    def original_groups(self) -> List[List[WorkTableEntry]]:
        return self._original_groups

    @property
    def deconvolution_groups(self) -> List[List[int]]:
        return self._deconvolution_groups

    @property
    def psf_offsets(self) -> List[PsfOffset]:
        return self._psf_offsets

    @property
    def channel_index_offset(self) -> int:
        return self._channel_index_offset

    @property
    def entries(self) -> List[WorkTableEntry]:
        return self._entries

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def size(self) -> int:
        return len(self._entries)

    @property
    def front(self) -> WorkTableEntry:
        return self._entries[0]

    def first_original_group(self, deconvolution_index: int) -> List[WorkTableEntry]:
        return self._original_groups[
            self._deconvolution_groups[deconvolution_index][0]
        ]

    def get_original_same_polarization_group(
        self, polarization: Polarization
    ) -> List[WorkTableEntry]:
        return [e for e in self._entries if e.polarization == polarization]

    def add_entry(self, entry: WorkTableEntry) -> None:
        if entry.original_channel_index >= len(self._original_groups):
            raise RuntimeError(
                "WorkTable: entry channel index exceeds number of original groups"
            )
        entry.index = len(self._entries)
        self._entries.append(entry)
        self._original_groups[entry.original_channel_index].append(entry)

    # -- validation --------------------------------------------------------
    def validate_psfs(self) -> None:
        """Check the DD-PSF invariants; mirrors ``cpp/work_table.cc:46-99``."""
        n_psfs = max(1, len(self._psf_offsets))
        if not self._entries:
            return
        front = self.front
        if len(front.psf_accessors) != n_psfs:
            raise RuntimeError(
                f"WorkTable: Expected {n_psfs} PSF accessors in the first "
                f"entry, but found {len(front.psf_accessors)} PSF accessors."
            )
        for group in self._original_groups:
            for i, entry in enumerate(group):
                if i == 0:
                    if len(entry.psf_accessors) != n_psfs:
                        raise RuntimeError(
                            f"WorkTable: Expected {n_psfs} PSF accessors per "
                            f"entry, but found an entry with "
                            f"{len(entry.psf_accessors)} PSF accessors."
                        )
                    for psf_index in range(n_psfs):
                        acc = entry.psf_accessors[psf_index]
                        if acc.width == 0 or acc.height == 0:
                            raise RuntimeError(
                                "WorkTable: Found an entry with an empty image "
                                f"for PSF accessor {psf_index}."
                            )
                        if (
                            acc.width != front.psf_accessors[psf_index].width
                            or acc.height != front.psf_accessors[psf_index].height
                        ):
                            raise RuntimeError(
                                "WorkTable: Found an entry with a different "
                                f"size for PSF accessor {psf_index}."
                            )
                else:
                    if entry.psf_accessors:
                        raise RuntimeError(
                            "WorkTable: Only the first entry for a channel may "
                            "have PSF accessors."
                        )

    def __str__(self) -> str:
        lines = [
            "=== IMAGING TABLE ===",
            f"Original groups       {len(self._original_groups)}",
            f"Deconvolution groups  {len(self._deconvolution_groups)}",
            f"Channel index         {self._channel_index_offset}",
        ]
        if self._entries:
            lines.append("   # Pol Ch Mask Interval Weight Freq(MHz)")
            for e in self._entries:
                lines.append(
                    f"  {e.index:2d} {e.polarization.value:>3s} "
                    f"{e.original_channel_index:2d} {e.mask_channel_index:4d} "
                    f"{e.original_interval_index:8d} {e.image_weight:6g} "
                    f"{round(e.band_start_frequency * 1e-6)}-"
                    f"{round(e.band_end_frequency * 1e-6)}"
                )
        if self._psf_offsets:
            lines.append("=== PSFs ===")
            for p in self._psf_offsets:
                lines.append(str(p))
        return "\n".join(lines) + "\n"
