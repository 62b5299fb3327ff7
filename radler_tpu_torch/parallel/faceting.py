"""Facet decomposition of the image into sub-images.

Port of ``radler_tpu.parallel.faceting`` (``MakeSubImages``,
``cpp/algorithms/parallel_deconvolution.cc:69-168``): the image is split
into a ``grid_width x grid_height`` grid whose boundaries follow
minimum-|flux| Dijkstra paths; each facet gets a *boundary (ownership)
mask*, so that every pixel is cleaned by exactly one facet, and a search
mask that also honours the user's clean mask.  Host NumPy.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from ..settings import Settings
from .dijkstra import DijkstraSplitter, divide


@dataclasses.dataclass
class SubImage:
    index: int = 0
    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0
    mask: Optional[np.ndarray] = None  # search mask (boundary ∧ user mask)
    boundary_mask: Optional[np.ndarray] = None  # ownership mask
    peak: float = 0.0
    reached_major_threshold: bool = False


def make_sub_images(
    image: np.ndarray,
    mask: Optional[np.ndarray],
    settings: Settings,
) -> List[SubImage]:
    height, width = image.shape
    grid_w = settings.parallel.grid_width
    grid_h = settings.parallel.grid_height
    avg_h_size = width // grid_w
    avg_v_size = height // grid_h

    splitter = DijkstraSplitter(width, height)
    # The dividers' searches are independent (disjoint bands; the
    # horizontal ones run as vertical searches of the transposed image, as
    # DijkstraSplitter.divide_horizontally does), so they run at once, each
    # in its own thread: the search releases the interpreter lock.
    vertical_line = np.zeros((height, width), dtype=np.float32)
    horizontal_line_t = np.zeros((width, height), dtype=np.float32)
    image_t = np.ascontiguousarray(image.T, dtype=np.float32)
    jobs = []
    for div_nr in range(1, grid_w):
        split_middle = width * div_nr // grid_w
        jobs.append((image, vertical_line, split_middle - avg_h_size // 4,
                     split_middle + avg_h_size // 4))
    for div_nr in range(1, grid_h):
        split_middle = height * div_nr // grid_h
        jobs.append((image_t, horizontal_line_t,
                     split_middle - avg_v_size // 4,
                     split_middle + avg_v_size // 4))
    if jobs:
        with ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 1)) as pool:
            list(pool.map(lambda job: divide(*job), jobs))

    # Vertical dividers -> vertical areas.
    vertical_areas = []
    for div_nr in range(grid_w):
        mid_x = div_nr * width // grid_w + avg_h_size // 2
        vmask, vx, vwidth = splitter.flood_vertical_area(vertical_line, mid_x)
        vertical_areas.append((vmask[:, vx : vx + vwidth], vx, vwidth))
    dividing_line = np.ascontiguousarray(horizontal_line_t.T)

    sub_images: List[SubImage] = []
    for gy in range(grid_h):
        mid_y = gy * height // grid_h + avg_v_size // 2
        hmask, _, _ = splitter.flood_horizontal_area(dividing_line, mid_y)
        for gx in range(grid_w):
            vmask, vx, vwidth = vertical_areas[gx]
            bounding_mask, sx, sy, sw, sh = splitter.get_bounding_mask(
                vmask, vx, hmask
            )
            sub = SubImage(
                index=len(sub_images), x=sx, y=sy, width=sw, height=sh
            )
            sub.boundary_mask = bounding_mask[sy : sy + sh, sx : sx + sw].copy()
            if mask is not None:
                sub.mask = sub.boundary_mask & mask[sy : sy + sh, sx : sx + sw]
            else:
                sub.mask = sub.boundary_mask.copy()
            sub_images.append(sub)
    return sub_images
