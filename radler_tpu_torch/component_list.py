"""Sparse component store (sky-model output).

Behavioral equivalent of ``cpp/component_list.{h,cc}``: per-scale lists of
(x, y, per-channel flux) entries with duplicate merging and a WSClean-format
sky-model writer (see :mod:`radler_tpu_torch.utils.write_model`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class ComponentList:
    """Per-scale component positions + per-channel values."""

    MAX_COMPONENTS_BEFORE_MERGE = 100_000

    def __init__(
        self,
        width: int = 0,
        height: int = 0,
        n_scales: int = 0,
        n_frequencies: int = 0,
        image_set=None,
    ):
        self.width = width
        self.height = height
        if image_set is not None:
            # Single-scale constructor (``component_list.h:38-46``): load all
            # non-zero model pixels as scale-0 components.
            self.n_frequencies = image_set.n_images
            self._positions: List[List[Tuple[int, int]]] = [[]]
            self._values: List[List[np.ndarray]] = [[]]
            self._load_from_image_set(image_set, 0)
        else:
            self.n_frequencies = n_frequencies
            self._positions = [[] for _ in range(n_scales)]
            self._values = [[] for _ in range(n_scales)]
        self._components_added_since_last_merge = 0

    # ------------------------------------------------------------------
    @property
    def n_scales(self) -> int:
        return len(self._positions)

    def set_n_scales(self, n_scales: int) -> None:
        while len(self._positions) < n_scales:
            self._positions.append([])
            self._values.append([])

    def component_count(self, scale_index: int) -> int:
        return len(self._positions[scale_index])

    def add(self, x: int, y: int, scale_index: int, values) -> None:
        """``component_list.h:70-77`` (auto-merges at 100k components)."""
        self._values[scale_index].append(
            np.asarray(values, dtype=np.float32).copy()
        )
        self._positions[scale_index].append((int(x), int(y)))
        self._components_added_since_last_merge += 1
        if (
            self._components_added_since_last_merge
            >= self.MAX_COMPONENTS_BEFORE_MERGE
        ):
            self.merge_duplicates()

    def add_list(self, other: "ComponentList", offset_x: int, offset_y: int):
        """Merge a sub-image component list at an offset
        (``component_list.h:79-89``)."""
        assert other.n_frequencies == self.n_frequencies
        if other.n_scales > self.n_scales:
            self.set_n_scales(other.n_scales)
        for scale in range(other.n_scales):
            for (x, y), values in zip(
                other._positions[scale], other._values[scale]
            ):
                self.add(x + offset_x, y + offset_y, scale, values)

    def clear(self) -> None:
        for scale in range(self.n_scales):
            self._positions[scale] = []
            self._values[scale] = []

    def get_component(self, scale_index: int, component_index: int):
        x, y = self._positions[scale_index][component_index]
        return x, y, self._values[scale_index][component_index]

    def get_component_position(self, scale_index: int, index: int):
        return self._positions[scale_index][index]

    def set_values(self, scale_index: int, component_index: int, values):
        self._values[scale_index][component_index] = np.asarray(
            values, dtype=np.float32
        ).copy()

    def multiply_scale_component(
        self, scale_index: int, position_index: int, channel: int, factor: float
    ):
        self._values[scale_index][position_index][channel] *= factor

    def get_positions(self, scale_index: int):
        return self._positions[scale_index]

    # ------------------------------------------------------------------
    def merge_duplicates(self) -> None:
        """Accumulate equal positions (``component_list.h:113-121,222-261``).
        After a merge, components are ordered row-major per scale."""
        if self._components_added_since_last_merge == 0:
            return
        for scale_index in range(self.n_scales):
            self._merge_duplicates_scale(scale_index)
        self._components_added_since_last_merge = 0

    def _merge_duplicates_scale(self, scale_index: int) -> None:
        positions = self._positions[scale_index]
        if not positions:
            return
        values = np.stack(self._values[scale_index])  # [n, F]
        pos = np.asarray(positions, dtype=np.int64)  # [n, 2] (x, y)
        flat = pos[:, 0] + pos[:, 1] * self.width
        images = np.zeros((self.n_frequencies, self.width * self.height))
        for f in range(self.n_frequencies):
            np.add.at(images[f], flat, values[:, f])
        nonzero = np.nonzero(np.any(images != 0.0, axis=0))[0]
        self._positions[scale_index] = [
            (int(p % self.width), int(p // self.width)) for p in nonzero
        ]
        self._values[scale_index] = [
            images[:, p].astype(np.float32) for p in nonzero
        ]

    def _load_from_image_set(self, image_set, scale_index: int) -> None:
        """``cpp/component_list.cc:142-168``."""
        # One device-to-host copy of the (possibly CUDA) model cube.
        host = image_set.data.cpu().numpy()  # [N, H, W]
        nonzero = np.any(host != 0.0, axis=0)
        ys, xs = np.nonzero(nonzero)
        for x, y in zip(xs, ys):
            self._positions[scale_index].append((int(x), int(y)))
            self._values[scale_index].append(
                host[:, y, x].astype(np.float32).copy()
            )

    # ------------------------------------------------------------------
    def write_sources(
        self,
        radler,
        filename: str,
        pixel_scale_x: float,
        pixel_scale_y: float,
        phase_centre_ra: float,
        phase_centre_dec: float,
        l_shift: float = 0.0,
        m_shift: float = 0.0,
    ) -> None:
        """Write a WSClean sky-model file (``cpp/component_list.cc:59-140``)."""
        from .utils.write_model import write_component_list

        algorithm = radler.max_scale_count_algorithm()
        write_component_list(
            self,
            filename,
            algorithm,
            pixel_scale_x,
            pixel_scale_y,
            phase_centre_ra,
            phase_centre_dec,
            l_shift,
            m_shift,
        )
