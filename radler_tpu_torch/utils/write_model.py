"""WSClean sky-model text writer.

Behavioral equivalent of ``cpp/utils/write_model.h`` and
``ComponentList::Write`` (``cpp/component_list.cc:59-140``): components are
written as POINT or GAUSSIAN rows with polynomial / log-polynomial spectral
terms relative to the fitter's reference frequency.
"""

from __future__ import annotations

import math
from typing import List

from ..settings import SpectralFittingMode
from .coordinates import dec_to_string, lm_to_radec, ra_to_string, xy_to_lm

_FWHM_FACTOR = 2.0 * math.sqrt(2.0 * math.log(2.0))
_RAD_TO_ARCSEC = 180.0 * 60.0 * 60.0 / math.pi


def _ra_string(ra: float) -> str:
    s = ra_to_string(ra)
    return s.replace("h", ":").replace("m", ":").replace("s", "")


def _dec_string(dec: float) -> str:
    s = dec_to_string(dec)
    return s.replace("d", ".").replace("m", ".").replace("s", "")


def _si_terms(terms: List[float]) -> str:
    head = f"{terms[0]:.7g}"
    rest = ",".join(f"{t:.7g}" for t in terms[1:])
    return f"{head},[{rest}]"


def write_component_list(
    component_list,
    filename: str,
    algorithm,
    pixel_scale_x: float,
    pixel_scale_y: float,
    phase_centre_ra: float,
    phase_centre_dec: float,
    l_shift: float = 0.0,
    m_shift: float = 0.0,
) -> None:
    if hasattr(algorithm, "scale_size"):  # the multiscale algorithms
        scale_sizes = [
            algorithm.scale_size(i) for i in range(component_list.n_scales)
        ]
    else:
        scale_sizes = [0.0] * max(component_list.n_scales, 1)
    fitter = algorithm.spectral_fitter
    _write(
        component_list,
        filename,
        fitter,
        scale_sizes,
        pixel_scale_x,
        pixel_scale_y,
        phase_centre_ra,
        phase_centre_dec,
        l_shift,
        m_shift,
    )


def _gaussian_sigma(scale: float) -> float:
    """sigma = 3/16 x scale (``multiscale_transforms.h:127-161``)."""
    return scale * (3.0 / 16.0)


def _write(
    component_list,
    filename: str,
    fitter,
    scale_sizes,
    pixel_scale_x,
    pixel_scale_y,
    phase_centre_ra,
    phase_centre_dec,
    l_shift,
    m_shift,
) -> None:
    if component_list._components_added_since_last_merge != 0:
        raise RuntimeError(
            "ComponentList.write called while there are yet unmerged "
            "components. Run merge_duplicates() first."
        )
    if (
        fitter.mode == SpectralFittingMode.NO_FITTING
        and component_list.n_frequencies > 1
    ):
        raise RuntimeError(
            "Can't write component list without a spectral fitting method."
        )
    use_log_si = fitter.mode in (
        SpectralFittingMode.FORCED_TERMS,
        SpectralFittingMode.LOG_POLYNOMIAL,
    )
    with open(filename, "w") as f:
        f.write(
            "Format = Name, Type, Ra, Dec, I, SpectralIndex, LogarithmicSI, "
            "ReferenceFrequency='"
            f"{fitter.reference_frequency:.17g}', MajorAxis, MinorAxis, "
            "Orientation\n"
        )
        for scale_index in range(component_list.n_scales):
            scale = scale_sizes[scale_index]
            fwhm = _FWHM_FACTOR * _gaussian_sigma(scale)
            scale_fwhm_l = fwhm * pixel_scale_x * _RAD_TO_ARCSEC
            scale_fwhm_m = fwhm * pixel_scale_y * _RAD_TO_ARCSEC
            for ci in range(component_list.component_count(scale_index)):
                x, y, spectrum = component_list.get_component(scale_index, ci)
                if component_list.n_frequencies == 1:
                    terms = [float(spectrum[0])]
                else:
                    terms = [float(t) for t in fitter.fit(spectrum, x, y)]
                l, m = xy_to_lm(
                    x,
                    y,
                    pixel_scale_x,
                    pixel_scale_y,
                    component_list.width,
                    component_list.height,
                )
                l += l_shift
                m += m_shift
                ra, dec = lm_to_radec(l, m, phase_centre_ra, phase_centre_dec)
                name = f"s{scale_index}c{ci}"
                log_str = "true" if use_log_si else "false"
                if scale == 0.0:
                    f.write(
                        f"{name},POINT,{_ra_string(ra)},{_dec_string(dec)},"
                        f"{_si_terms(terms)},{log_str},"
                        f"{fitter.reference_frequency:.17g},,,\n"
                    )
                else:
                    f.write(
                        f"{name},GAUSSIAN,{_ra_string(ra)},{_dec_string(dec)},"
                        f"{_si_terms(terms)},{log_str},"
                        f"{fitter.reference_frequency:.17g},"
                        f"{scale_fwhm_l:.17g},{scale_fwhm_m:.17g},0\n"
                    )
