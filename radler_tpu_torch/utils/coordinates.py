"""Image coordinate transforms (equivalent of aocommon::ImageCoordinates).

XY <-> LM uses the orthographic (SIN) projection convention of the reference:
l increases to the left (negative x direction), m increases upward (negative
y direction on the stored raster).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def xy_to_lm(
    x: float,
    y: float,
    pixel_scale_x: float,
    pixel_scale_y: float,
    width: int,
    height: int,
) -> Tuple[float, float]:
    l = (width / 2.0 - x) * pixel_scale_x
    m = (height / 2.0 - y) * pixel_scale_y
    return l, m


def lm_to_xy(
    l: float,
    m: float,
    pixel_scale_x: float,
    pixel_scale_y: float,
    width: int,
    height: int,
) -> Tuple[float, float]:
    x = width / 2.0 - l / pixel_scale_x
    y = height / 2.0 - m / pixel_scale_y
    return x, y


def xy_to_lm_grid(
    width: int, height: int, pixel_scale_x: float, pixel_scale_y: float
) -> Tuple[np.ndarray, np.ndarray]:
    xs = np.arange(width, dtype=np.float64)
    ys = np.arange(height, dtype=np.float64)
    l = (width / 2.0 - xs)[None, :] * pixel_scale_x
    m = (height / 2.0 - ys)[:, None] * pixel_scale_y
    return np.broadcast_to(l, (height, width)), np.broadcast_to(
        m, (height, width)
    )


def lm_to_radec(
    l: float, m: float, ra0: float, dec0: float
) -> Tuple[float, float]:
    """Inverse SIN projection about phase centre (ra0, dec0), radians."""
    n = math.sqrt(max(0.0, 1.0 - l * l - m * m))
    cos_dec0 = math.cos(dec0)
    sin_dec0 = math.sin(dec0)
    dec = math.asin(m * cos_dec0 + n * sin_dec0)
    ra = ra0 + math.atan2(l, n * cos_dec0 - m * sin_dec0)
    return ra, dec


def ra_to_string(ra: float) -> str:
    """HH:MM:SS.s representation of a right ascension in radians."""
    hours = math.fmod(ra * 12.0 / math.pi, 24.0)
    if hours < 0:
        hours += 24.0
    h = int(hours)
    minutes = (hours - h) * 60.0
    m = int(minutes)
    s = (minutes - m) * 60.0
    return f"{h:02d}h{m:02d}m{s:08.5f}s"


def dec_to_string(dec: float) -> str:
    """DD.MM.SS.s representation of a declination in radians."""
    sign = "-" if dec < 0 else ""
    degrees = abs(dec) * 180.0 / math.pi
    d = int(degrees)
    minutes = (degrees - d) * 60.0
    m = int(minutes)
    s = (minutes - m) * 60.0
    return f"{sign}{d:02d}d{m:02d}m{s:08.5f}s"
