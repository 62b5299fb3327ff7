"""2-D Gaussian fitting and beam deconvolution.

Port of ``radler_tpu.ops.gaussian_fit`` (host code, NumPy and SciPy, the
port's own copy): the equivalent of the schaapcommon fitters used by the
reference
(``Fit2DGaussianCentred``, ``Fit2DGaussianFull``, ``DeconvolveGaussian``,
``DrawGaussianToXy`` — call sites at ``cpp/algorithms/asp_algorithm.cc:72-73,
262-298`` and ``cpp/algorithms/iuwt_deconvolution_algorithm.cc:48-55``).

Ellipse axes are FWHM in pixels; ``position_angle`` in radians.  Fits run
host-side with ``scipy.optimize.least_squares`` on a window around the peak
(one small per-component solve, like the reference's GSL calls); rendering is
vectorized.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

try:
    from scipy.optimize import least_squares as _least_squares
except ImportError:  # pragma: no cover
    _least_squares = None

_FWHM_TO_SIGMA = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))


@dataclasses.dataclass
class Ellipse:
    """Mirror of ``schaapcommon::math::Ellipse``."""

    major: float = 0.0
    minor: float = 0.0
    position_angle: float = 0.0


def _gaussian_image(
    shape: Tuple[int, int],
    amplitude: float,
    x0: float,
    y0: float,
    major: float,
    minor: float,
    pa: float,
) -> np.ndarray:
    h, w = shape
    ys = np.arange(h)[:, None] - y0
    xs = np.arange(w)[None, :] - x0
    cos_pa, sin_pa = math.cos(pa), math.sin(pa)
    xr = xs * cos_pa - ys * sin_pa
    yr = xs * sin_pa + ys * cos_pa
    s_maj = max(abs(major), 1e-6) * _FWHM_TO_SIGMA
    s_min = max(abs(minor), 1e-6) * _FWHM_TO_SIGMA
    return amplitude * np.exp(
        -0.5 * ((xr / s_maj) ** 2 + (yr / s_min) ** 2)
    )


def draw_gaussian(
    image: np.ndarray,
    x0: float,
    y0: float,
    ellipse: Ellipse,
    amplitude: float,
) -> np.ndarray:
    """Add an elliptical Gaussian to an image (``DrawGaussianToXy``)."""
    return image + _gaussian_image(
        image.shape,
        amplitude,
        x0,
        y0,
        ellipse.major,
        ellipse.minor,
        ellipse.position_angle,
    ).astype(image.dtype)


def _fit_window(
    image: np.ndarray, x0: float, y0: float, half: int
) -> Tuple[np.ndarray, int, int]:
    h, w = image.shape
    x1 = max(int(x0) - half, 0)
    y1 = max(int(y0) - half, 0)
    x2 = min(int(x0) + half + 1, w)
    y2 = min(int(y0) + half + 1, h)
    return image[y1:y2, x1:x2], x1, y1


def fit_2d_gaussian_centred(
    image: np.ndarray, box_scale: float = 2.0
) -> Ellipse:
    """Fit (major, minor, pa) of the central peak with fixed position and
    free amplitude; equivalent of ``Fit2DGaussianCentred``."""
    h, w = image.shape
    cy, cx = h // 2, w // 2
    half = max(int(math.ceil(box_scale * 10.0)), 10)
    window, x1, y1 = _fit_window(image, cx, cy, half)
    wx0, wy0 = cx - x1, cy - y1
    amp0 = float(image[cy, cx]) or 1.0

    def residuals(p):
        a, major, minor, pa = p
        model = _gaussian_image(window.shape, a, wx0, wy0, major, minor, pa)
        return (model - window).ravel()

    if _least_squares is None:
        raise RuntimeError("scipy is required for Gaussian fitting")
    result = _least_squares(
        residuals,
        [amp0, box_scale, box_scale, 0.0],
        method="lm",
        max_nfev=200,
    )
    a, major, minor, pa = result.x
    if abs(minor) > abs(major):
        major, minor = minor, major
        pa += math.pi / 2
    return Ellipse(abs(major), abs(minor), _wrap_pa(pa))


def _full_fit_half(major: float, minor: float) -> int:
    return max(int(math.ceil(max(abs(major), abs(minor), 4.0) * 5.0)), 10)


def full_fit_box(width: int, height: int, x0: float, y0: float,
                 major: float, minor: float) -> Tuple[int, int, int, int]:
    """The window ``(x1, y1, x2, y2)`` of a ``width`` x ``height`` image
    that :func:`fit_2d_gaussian_full` reads for a fit at ``(x0, y0)``: a
    caller whose image lies on a device copies only this window to the
    host."""
    half = _full_fit_half(major, minor)
    return (max(int(x0) - half, 0), max(int(y0) - half, 0),
            min(int(x0) + half + 1, width), min(int(y0) + half + 1, height))


def fit_2d_gaussian_full(
    image: np.ndarray,
    amplitude: float,
    x0: float,
    y0: float,
    major: float,
    minor: float,
    pa: float,
    origin: Tuple[int, int] = (0, 0),
) -> Tuple[float, float, float, Ellipse]:
    """Full 6-parameter fit around a starting guess; equivalent of
    ``Fit2DGaussianFull``.  Returns (amplitude, x, y, ellipse).

    ``image`` may be the window :func:`full_fit_box` gives instead of the
    whole image, with its top-left pixel at ``origin`` (x, y) of the
    image: positions stay the image's, so the fit is the same."""
    half = _full_fit_half(major, minor)
    ox, oy = origin
    window, wx1, wy1 = _fit_window(image, x0 - ox, y0 - oy, half)
    wx1, wy1 = wx1 + ox, wy1 + oy

    def residuals(p):
        a, px, py, pmaj, pmin, ppa = p
        model = _gaussian_image(
            window.shape, a, px - wx1, py - wy1, pmaj, pmin, ppa
        )
        return (model - window).ravel()

    if _least_squares is None:
        raise RuntimeError("scipy is required for Gaussian fitting")
    result = _least_squares(
        residuals,
        [amplitude, x0, y0, major, minor, pa],
        method="lm",
        max_nfev=400,
    )
    a, px, py, pmaj, pmin, ppa = result.x
    if abs(pmin) > abs(pmaj):
        pmaj, pmin = pmin, pmaj
        ppa += math.pi / 2
    return (
        float(a),
        float(px),
        float(py),
        Ellipse(abs(pmaj), abs(pmin), _wrap_pa(ppa)),
    )


def _wrap_pa(pa: float) -> float:
    while pa > math.pi / 2:
        pa -= math.pi
    while pa < -math.pi / 2:
        pa += math.pi
    return pa


def _ellipse_to_covariance(e: Ellipse) -> np.ndarray:
    s_maj = e.major * _FWHM_TO_SIGMA
    s_min = e.minor * _FWHM_TO_SIGMA
    c, s = math.cos(e.position_angle), math.sin(e.position_angle)
    rot = np.array([[c, -s], [s, c]])
    return rot @ np.diag([s_maj**2, s_min**2]) @ rot.T


def deconvolve_gaussian(fitted: Ellipse, beam: Ellipse) -> Ellipse:
    """Remove the beam from a fitted Gaussian; equivalent of
    ``schaapcommon::fitters::DeconvolveGaussian``.  When the fitted source is
    smaller than the beam, ``major`` is NaN (the ASP caller then treats the
    component as a point source, ``asp_algorithm.cc:283-288``)."""
    cov = _ellipse_to_covariance(fitted) - _ellipse_to_covariance(beam)
    eigvals, eigvecs = np.linalg.eigh(cov)
    if eigvals[0] <= 0.0 or eigvals[1] <= 0.0:
        return Ellipse(float("nan"), float("nan"), 0.0)
    s_min, s_maj = math.sqrt(eigvals[0]), math.sqrt(eigvals[1])
    v = eigvecs[:, 1]
    pa = math.atan2(v[1], v[0])
    return Ellipse(
        s_maj / _FWHM_TO_SIGMA, s_min / _FWHM_TO_SIGMA, _wrap_pa(pa)
    )
