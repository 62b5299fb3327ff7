"""Minimum-flux Dijkstra image splitter (host side).

Port of ``radler_tpu.parallel.dijkstra`` (``cpp/math/dijkstra_splitter.
{h,cc}``): finds paths of minimal summed |flux| through the image so that
facet boundaries avoid sources, floods the dividers into per-area masks and
computes bounding boxes with the even-size correction.

The path search is ``csrc/dijkstra.cc``, built with the host's C++
compiler and called through ctypes: the reference's priority-queue search
(its tie-breaks decide the boxes on images with zero pixels) and the
floods.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

_bound = None


def _lib():
    """The host library with its C signatures declared."""
    global _bound
    if _bound is None:
        from ..kernels import _build

        lib = _build.host_library()
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.radler_divide_vertically.argtypes = [ptr, ptr] + [i32] * 4
        lib.radler_divide_vertically.restype = None
        lib.radler_flood_area.argtypes = [ptr, ptr, i32, i32, i64, i64, i32,
                                          ptr, ptr]
        lib.radler_flood_area.restype = None
        _bound = lib
    return _bound


def divide(image: np.ndarray, output: np.ndarray, x1: int, x2: int) -> None:
    """The minimum-|flux| top-to-bottom path through columns [x1, x2) of
    ``image`` marked with 1.0 in ``output`` (C-contiguous float32, its
    columns [x1, x2) cleared first)."""
    if not (output.flags["C_CONTIGUOUS"] and output.dtype == np.float32):
        raise ValueError("output must be contiguous float32")
    image = np.ascontiguousarray(image, dtype=np.float32)
    height, width = image.shape
    _lib().radler_divide_vertically(
        image.ctypes.data, output.ctypes.data, width, height, x1, x2)


def flood(subdivision: np.ndarray, start: int, vertical: bool
          ) -> Tuple[np.ndarray, int, int]:
    """The area between the dividers (non-zero pixels of ``subdivision``)
    that holds column ``start`` of every row (``vertical``) or row
    ``start`` of every column: each line's run from ``start`` back over
    free pixels and over the divider's run, and on up to the next divider
    pixel.  Returns (mask, first position, width)."""
    subdivision = np.ascontiguousarray(subdivision, dtype=np.float32)
    height, width = subdivision.shape
    mask = np.zeros((height, width), dtype=np.uint8)
    first, end = ctypes.c_int(), ctypes.c_int()
    lines, positions = (height, width) if vertical else (width, height)
    strides = (width, 1) if vertical else (1, width)
    _lib().radler_flood_area(
        subdivision.ctypes.data, mask.ctypes.data, lines, positions,
        *strides, start, ctypes.byref(first), ctypes.byref(end))
    extent = 0 if end.value < first.value else end.value - first.value
    return mask.view(bool), first.value, extent


class DijkstraSplitter:
    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height

    # -- path finding ------------------------------------------------------
    def divide_vertically(
        self, image: np.ndarray, output: np.ndarray, x1: int, x2: int
    ) -> None:
        """Find the minimum-|flux| top-to-bottom path within columns
        [x1, x2) and mark it with 1.0 in ``output``, a C-contiguous float32
        array (``dijkstra_splitter.cc:34-86``)."""
        divide(image, output, x1, x2)

    def divide_horizontally(
        self, image: np.ndarray, output: np.ndarray, y1: int, y2: int
    ) -> None:
        """Transpose of :meth:`divide_vertically`
        (``dijkstra_splitter.cc:88-142``)."""
        sub = DijkstraSplitter(self.height, self.width)
        out_t = np.ascontiguousarray(output.T)
        sub.divide_vertically(np.ascontiguousarray(image.T), out_t, y1, y2)
        output[y1:y2, :] = out_t.T[y1:y2, :]

    # -- flooding ----------------------------------------------------------
    def flood_vertical_area(
        self, subdivision: np.ndarray, subimage_x: int
    ) -> Tuple[np.ndarray, int, int]:
        """Mask of the vertical area containing column ``subimage_x``,
        bounded by divider paths; the left divider is included in the area
        (``dijkstra_splitter.cc:144-180``).  Returns (mask, x, width)."""
        return flood(subdivision, subimage_x, vertical=True)

    def flood_horizontal_area(
        self, subdivision: np.ndarray, subimage_y: int
    ) -> Tuple[np.ndarray, int, int]:
        """``dijkstra_splitter.cc:182-216``.  Returns (mask, y, height)."""
        return flood(subdivision, subimage_y, vertical=False)

    # -- bounding ----------------------------------------------------------
    def get_bounding_mask(
        self,
        vertical_mask: np.ndarray,  # [H, v_width]
        vertical_mask_x: int,
        horizontal_mask: np.ndarray,  # [H, W]
    ) -> Tuple[np.ndarray, int, int, int, int]:
        """Intersection mask + bounding box, with even-size correction
        (``dijkstra_splitter.cc:218-285``).
        Returns (mask[H, W], sub_x, sub_y, subwidth, subheight)."""
        W, H = self.width, self.height
        v_width = vertical_mask.shape[1]
        mask = np.zeros((H, W), dtype=bool)
        region = np.zeros((H, W), dtype=bool)
        region[:, vertical_mask_x : vertical_mask_x + v_width] = vertical_mask
        mask[:, :] = region & horizontal_mask
        xs = np.flatnonzero(mask.any(axis=0))
        if len(xs) == 0:
            return mask, vertical_mask_x + v_width, H, 0, 0
        ys = np.flatnonzero(mask.any(axis=1))
        sub_x, sub_x2 = int(xs[0]), int(xs[-1])
        sub_y, sub_y2 = int(ys[0]), int(ys[-1])
        subwidth = sub_x2 + 1 - sub_x
        subheight = sub_y2 + 1 - sub_y
        # Keep facet sizes even when the full image is even
        # (dijkstra_splitter.cc:257-284).
        if W % 2 == 0 and subwidth % 2 != 0:
            subwidth += 1
            if subwidth + sub_x >= W:
                sub_x -= 1
                mask[sub_y : sub_y + subheight, sub_x] = False
            else:
                mask[sub_y : sub_y + subheight, sub_x + subwidth - 1] = False
        if H % 2 == 0 and subheight % 2 != 0:
            subheight += 1
            if subheight + sub_y >= H:
                sub_y -= 1
                mask[sub_y, sub_x : sub_x + subwidth] = False
            else:
                mask[sub_y + subheight - 1, sub_x : sub_x + subwidth] = False
        return mask, sub_x, sub_y, subwidth, subheight
