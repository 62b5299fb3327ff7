"""Joined-channel spectral fitting.

Port of ``radler_tpu.ops.spectral_fitting``, the equivalent of
``schaapcommon::fitters::SpectralFitter`` as used by the reference
(``cpp/radler.cc:318-331``,
``cpp/algorithms/deconvolution_algorithm.cc:29-46``,
``cpp/image_set.cc:209-288``).  The per-component solves become precomputed
projection matrices (polynomial mode) or small closed forms, so a fit inside
the minor loop is one tiny matmul on the device and whole-image
interpolation is one einsum.

Modes:

* ``NO_FITTING``  — identity.
* ``POLYNOMIAL``  — weighted least-squares polynomial in x = nu/nu_ref - 1, a
  linear projection ``fitted = P @ values`` per polarization.
* ``LOG_POLYNOMIAL`` — weighted polynomial of log|y| in log(nu/nu_ref),
  evaluated back through exp; the sign of the weighted mean flux is restored.
* ``FORCED_TERMS`` — the spectral shape is fixed per pixel by caller-provided
  term images; only the amplitude is fitted:
  ``a = sum(w y f) / sum(w f^2)`` with f the forced curve.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..settings import SpectralFittingMode
from ..utils.device_consts import device_const


class SpectralFitter:
    """Fit per-component spectra across deconvolution channels."""

    def __init__(
        self,
        mode: SpectralFittingMode,
        n_terms: int,
        frequencies: Sequence[float],
        weights: Sequence[float],
    ):
        self.mode = mode
        self.n_terms = int(n_terms)
        self.frequencies = np.asarray(frequencies, dtype=np.float64)
        self.weights = np.asarray(weights, dtype=np.float64)
        self._forced_terms: Optional[torch.Tensor] = None  # [n_terms-1, H, W]

        n = len(self.frequencies)
        if n > 0:
            wsum = self.weights.sum()
            if wsum > 0:
                self.reference_frequency = float(
                    (self.frequencies * self.weights).sum() / wsum
                )
            else:
                self.reference_frequency = float(self.frequencies.mean())
        else:
            self.reference_frequency = 0.0

        self._design: Optional[np.ndarray] = None  # [C, T]
        self._fit_matrix: Optional[np.ndarray] = None  # [T, C] (lstsq solve)
        self._projection: Optional[np.ndarray] = None  # [C, C]
        self._x: Optional[np.ndarray] = None  # [C] fitting abscissa
        self._mean_weights = self.weights / max(self.weights.sum(), 1e-300)
        if self.is_active and n > 0:
            terms = min(self.n_terms, n) if self.n_terms > 0 else 0
            if terms > 0:
                x = self._abscissa(self.frequencies)
                design = np.stack([x**t for t in range(terms)], axis=1)  # [C,T]
                w = self.weights if self.weights.sum() > 0 else np.ones(n)
                wd = design * w[:, None]
                gram = design.T @ wd  # [T,T]
                fit_matrix = np.linalg.solve(gram, wd.T)  # [T,C]
                self._x = x
                self._design = design
                self._fit_matrix = fit_matrix
                self._projection = design @ fit_matrix  # [C,C]

    # ------------------------------------------------------------------
    @property
    def is_active(self) -> bool:
        return (
            self.mode != SpectralFittingMode.NO_FITTING
            and self.n_terms > 0
            and len(self.frequencies) > 1
        )

    def _on(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The host constant ``self.<name>`` as float32 on ``like``'s device,
        copied there once: a blocking copy inside the minor loop would wait
        for the device on every iteration."""
        return device_const(getattr(self, name), like.device)

    def _abscissa(self, freq) -> np.ndarray:
        """Fitting abscissa: nu/nu_ref - 1 (linear polynomial, so the 0th
        coefficient is the flux at the reference frequency) or log(nu/nu_ref)
        (log modes)."""
        ratio = np.asarray(freq, dtype=np.float64) / self.reference_frequency
        if self.mode in (
            SpectralFittingMode.LOG_POLYNOMIAL,
            SpectralFittingMode.FORCED_TERMS,
        ):
            return np.log(ratio)
        return ratio - 1.0

    def fit(self, values, x=None, y=None) -> np.ndarray:
        """Return the fitted term coefficients for one spectrum [C] -> [T].

        Equivalent of ``SpectralFitter::Fit``.  For log-polynomial mode the
        0th term is converted back to a linear flux (the sky-model "I"
        column), matching WSClean's component-list convention.
        """
        vals = np.asarray(values, dtype=np.float64)
        if not self.is_active:
            return vals[:1]
        if self.mode == SpectralFittingMode.POLYNOMIAL:
            return self._fit_matrix @ vals
        if self.mode == SpectralFittingMode.LOG_POLYNOMIAL:
            sign = -1.0 if float((self.weights * vals).sum()) < 0 else 1.0
            logs = np.log(np.maximum(np.abs(vals), 1e-36))
            coeffs = self._fit_matrix @ logs
            out = coeffs.copy()
            out[0] = sign * np.exp(coeffs[0])
            return out
        raise RuntimeError("fit() not supported for forced-term mode")

    def set_forced_terms(self, term_images: torch.Tensor) -> None:
        """Spectral-index (etc.) images for FORCED_TERMS mode; shape
        ``[n_terms - 1, H, W]`` (``cpp/radler.cc:410-432``)."""
        self._forced_terms = term_images

    # ------------------------------------------------------------------
    # Tensor application paths
    # ------------------------------------------------------------------
    def fit_and_evaluate(
        self, values: torch.Tensor, x=None, y=None, forced_terms=None
    ) -> torch.Tensor:
        """Replace per-channel ``values`` with the fitted curve.

        ``values`` has shape ``[C]`` or ``[C, P]`` (channels x pols, each
        polarization fitted independently, mirroring
        ``DeconvolutionAlgorithm::PerformSpectralFit``).  ``x``/``y`` are the
        component position (ints or 0-d device tensors), used only in
        FORCED_TERMS mode; a caller may pass the component's term vector
        ``forced_terms`` [T-1] directly instead.
        """
        if not self.is_active:
            return values
        squeeze = values.ndim == 1
        vals = values[:, None] if squeeze else values  # [C, P]
        if self.mode == SpectralFittingMode.POLYNOMIAL:
            out = self._on("_projection", vals) @ vals
        elif self.mode == SpectralFittingMode.LOG_POLYNOMIAL:
            out = self._log_poly_fit(vals)
        elif self.mode == SpectralFittingMode.FORCED_TERMS:
            out = self._forced_fit(vals, x, y, forced_terms)
        else:
            out = vals
        return out[:, 0] if squeeze else out

    def _log_poly_fit(self, vals: torch.Tensor) -> torch.Tensor:
        """vals: [C, P] -> fitted [C, P] through a log-log polynomial."""
        fit_m = self._on("_fit_matrix", vals)  # [T, C]
        design = self._on("_design", vals)  # [C, T]
        mean_flux = torch.einsum("c,cp->p", self._on("_mean_weights", vals),
                                 vals)
        sign = torch.where(mean_flux < 0, -1.0, 1.0).to(vals.dtype)
        logs = torch.log(torch.clamp_min(vals.abs(), float(np.float32(1e-36))))
        coeffs = fit_m @ logs  # [T, P]
        fitted = torch.exp(design @ coeffs)  # [C, P]
        return sign[None, :] * fitted

    def _forced_fit(self, vals: torch.Tensor, x, y, forced_terms=None):
        if forced_terms is not None:
            terms = forced_terms  # [T-1], caller-gathered
        elif self._forced_terms is not None:
            terms = self._forced_terms[:, y, x]  # [T-1]
        else:
            raise RuntimeError("Forced terms have not been set")
        lx = self._on("_x", vals)  # [C]
        powers = torch.stack(
            [lx ** (k + 1) for k in range(terms.shape[0])], dim=0
        )  # [T-1, C]
        curve = torch.exp(torch.einsum("t,tc->c", terms.to(vals.dtype), powers))
        w = self._on("weights", vals)
        denom = torch.einsum("c,c,c->", w, curve, curve)
        amp = torch.einsum("c,c,cp->p", w, curve, vals) / torch.clamp_min(
            denom, float(np.float32(1e-36))
        )
        return curve[:, None] * amp[None, :]

    # ------------------------------------------------------------------
    # Whole-image fitting (model interpolation)
    # ------------------------------------------------------------------
    def fit_image(self, spectra: torch.Tensor) -> torch.Tensor:
        """Fit terms for every pixel; ``spectra`` is [C, H, W] -> [T, H, W].

        Equivalent of the per-pixel Fit loop in ``cpp/image_set.cc:240-268``.
        """
        if not self.is_active:
            raise RuntimeError(
                "Spectral fitting must be enabled to interpolate between "
                "deconvolution and output channels"
            )
        fit_m = self._on("_fit_matrix", spectra)  # [T, C]
        if self.mode == SpectralFittingMode.POLYNOMIAL:
            return torch.einsum("tc,chw->thw", fit_m, spectra)
        if self.mode == SpectralFittingMode.LOG_POLYNOMIAL:
            mean_flux = torch.einsum(
                "c,chw->hw", self._on("_mean_weights", spectra), spectra
            )
            sign = torch.where(mean_flux < 0, -1.0, 1.0).to(spectra.dtype)
            logs = torch.log(
                torch.clamp_min(spectra.abs(), float(np.float32(1e-36)))
            )
            coeffs = torch.einsum("tc,chw->thw", fit_m, logs)
            is_zero = torch.all(spectra == 0.0, dim=0)
            # The sign and a non-zero marker ride as two extra planes.
            return torch.cat(
                [coeffs, sign[None], (~is_zero).to(spectra.dtype)[None]]
            )
        raise RuntimeError("fit_image does not support forced-term fitting")

    def evaluate_image(self, terms: torch.Tensor, frequency: float) -> torch.Tensor:
        """Evaluate fitted terms at a frequency; [T, H, W] -> [H, W]."""
        x = float(self._abscissa(np.asarray([frequency]))[0])
        if self.mode == SpectralFittingMode.POLYNOMIAL:
            powers = [x**t for t in range(terms.shape[0])]
            return torch.einsum(
                "t,thw->hw", device_const(powers, terms.device), terms
            )
        if self.mode == SpectralFittingMode.LOG_POLYNOMIAL:
            coeffs, sign, nonzero = terms[:-2], terms[-2], terms[-1]
            powers = [x**t for t in range(coeffs.shape[0])]
            out = torch.exp(
                torch.einsum(
                    "t,thw->hw", device_const(powers, terms.device), coeffs
                )
            )
            return out * sign * nonzero
        raise RuntimeError("evaluate_image does not support forced-term fitting")


def create_spectral_fitter(settings, table) -> SpectralFitter:
    """Build the fitter from settings + work table (``cpp/radler.cc:318-331``)."""
    from ..image_set import calculate_deconvolution_frequencies

    if settings.spectral_fitting.mode == SpectralFittingMode.NO_FITTING:
        frequencies: np.ndarray = np.zeros(0)
        weights: np.ndarray = np.zeros(0)
    else:
        frequencies, weights = calculate_deconvolution_frequencies(table)
    return SpectralFitter(
        settings.spectral_fitting.mode,
        settings.spectral_fitting.terms,
        frequencies,
        weights,
    )
