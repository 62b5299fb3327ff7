"""Generic CLEAN with the Clark subminor loop, joined channels and a
log-polynomial or polynomial spectral fit (Radler's default algorithm; in
WSClean ``-join-channels -fit-spectral-log-pol``), written out in plain
PyTorch.

One major iteration: the linear join of the residual cube (channel weights
over their sum), its peak and the major threshold; the candidates, every
pixel whose join's magnitude reaches the threshold; Högbom CLEAN over the
candidates alone (the peak of the join, its channel values times the gain
through the spectral fit, the shifted PSFs subtracted at every candidate)
until the peak falls to the threshold, the iteration limit or divergence;
then the model's components convolved with each channel's PSF (zero-padded
to 1.1 times the image, a 7-smooth size) are subtracted from the whole
residual.  Major iterations repeat while the peak stopped at the major
threshold, up to ``major_iteration_count``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .common import (Channels, ceil_padded, f32, find_peak, finished, fma,
                     integrate, padded_convolve)

_TINY = f32(1e-36)


def apply_fit(cv: torch.Tensor, fit: Optional[dict]) -> torch.Tensor:
    """The ``[C]`` component values after the spectral fit (one
    polarization), in the order that fixes the rounding: the polynomial
    fit's projection, or the log-polynomial fit (the sign of the weighted
    mean, the fit matrix times the logs' magnitudes, then the design, then
    exp).  The weighted mean and each term are sums in channel order, done
    side by side as the columns of one chain."""
    if fit is None:
        return cv
    if fit["mode"] == "POLYNOMIAL":
        return integrate(cv[:, None].expand(-1, cv.shape[0]),
                         fit["projection"].T)
    vals = cv[:, None]
    logs = torch.log(torch.clamp_min(vals.abs(), _TINY))
    design = fit["design"]
    T = design.shape[1]
    sums = integrate(torch.cat([vals, logs.expand(-1, T)], dim=1),
                     fit["chain"])  # [1 + T]: the mean, then each term
    sign = torch.where(sums[0] < 0.0, -1.0, 1.0)
    e = None
    for t in range(T):
        d = design[:, t, None]
        coef = sums[1 + t:2 + t]
        e = d * coef if e is None else fma(d, coef[None, :], e)
    return (sign.to(vals.dtype) * torch.exp(e))[:, 0]


class Subminor:
    """Högbom CLEAN over the ``[C, K]`` candidate values (magnitudes of the
    join, negatives allowed), its state held in place on the device: each
    :meth:`step` is one iteration while the ``active`` flag is set and
    changes nothing once it is not, so the loop runs without reading the
    peak back (on the card, as one captured graph replayed)."""

    def __init__(self, residual_k, xs, ys, psfs, coef, fit, threshold,
                 gain, start, limit, divergence_limit):
        C, K = residual_k.shape
        _, self.height, self.width = psfs.shape
        dev = residual_k.device
        self.res, self.xs, self.ys = residual_k, xs, ys
        self.psf_flat = psfs.reshape(C, -1)
        self.coef, self.fit = coef, fit
        self.threshold, self.gain, self.limit = threshold, gain, limit
        self.model = torch.zeros_like(residual_k)
        m, value = self.peak()
        self.m, self.value = m, value
        self.bound = float(np.float32(abs(value.item()))
                           * np.float32(divergence_limit))
        self.check_divergence = divergence_limit != 0.0
        self.iteration = torch.tensor(start, device=dev)
        self.diverging = torch.tensor(False, device=dev)
        self.active = self.going()

    def peak(self):
        s = integrate(self.res, self.coef)
        m = torch.argmax(s.abs()).reshape(1)
        return m, s.index_select(0, m)[0]

    def going(self):
        return ((self.value.abs() > self.threshold)
                & (self.iteration < self.limit) & ~self.diverging)

    def step(self) -> None:
        active, m = self.active, self.m
        cv = apply_fit(self.res.index_select(1, m)[:, 0] * self.gain,
                       self.fit)
        cur = self.model.index_select(1, m)[:, 0]
        self.model.index_copy_(1, m, torch.where(active, cur + cv,
                                                 cur)[:, None])
        h, w = self.height, self.width
        sy = self.ys - self.ys.index_select(0, m) + h // 2
        sx = self.xs - self.xs.index_select(0, m) + w // 2
        inside = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
        src = sy.clamp(0, h - 1) * w + sx.clamp(0, w - 1)
        shifted = torch.where(inside, self.psf_flat.index_select(1, src),
                              0.0).to(cv.dtype)
        self.res.copy_(torch.where(
            active, fma(-shifted, cv[:, None], self.res), self.res))
        m_new, v_new = self.peak()
        diverging = (v_new.abs() > self.bound) & self.check_divergence
        self.iteration.add_(active.long())
        self.m.copy_(torch.where(active, m_new, m))
        self.value.copy_(torch.where(active, v_new, self.value))
        self.diverging.copy_(torch.where(active, diverging, self.diverging))
        self.active.copy_(active & self.going())

    def run(self):
        """Returns (model_k, iterations, last peak, diverging)."""
        step = self.step
        if self.res.device.type == "cuda":
            step = self._graph()
        for i in range(max(self.limit - int(self.iteration), 0)):
            if i % 256 == 0 and not bool(self.active):
                break
            step()
        return (self.model, int(self.iteration), float(self.value.float()),
                bool(self.diverging))

    def _graph(self):
        """:meth:`step` captured once: two warm steps with the flag off
        (which change nothing), then the capture."""
        saved = self.active.clone()
        self.active.fill_(False)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.step()
            self.step()
        torch.cuda.current_stream().wait_stream(side)
        self.active.copy_(saved)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.step()
        self._captured = graph
        return graph.replay


def run(config: dict, psfs: torch.Tensor, field: torch.Tensor,
        frequencies: np.ndarray, weights: np.ndarray,
        dtype: torch.dtype = torch.float32):
    """The run's written-back residual and model ``[C, H, W]`` (float32)
    and its minor-iteration count."""
    s = config["settings"]
    fit_mode = s.get("spectral_fitting.mode", "NO_FITTING")
    channels = Channels(frequencies, weights, fit_mode,
                        s.get("spectral_fitting.terms", 0))
    dev = field.device
    C, H, W = field.shape
    threshold = float(s.get("absolute_threshold", 0.0))
    gain = f32(s.get("minor_loop_gain", 0.1))
    major_gain = float(s.get("major_loop_gain", 1.0))
    limit = int(s["minor_iteration_count"])
    majors = int(s.get("major_iteration_count", 12))
    divergence_limit = f32(4.0)
    coef = channels.on("coefficients", dev).to(dtype)
    fit = None
    if fit_mode in ("LOG_POLYNOMIAL", "POLYNOMIAL") and C > 1:
        fit = {"mode": fit_mode,
               **{k: channels.on(k, dev).to(dtype) for k in
                  ("fit_matrix", "design", "mean_weights", "projection")}}
        fit["chain"] = torch.cat([fit["mean_weights"][:, None],
                                  fit["fit_matrix"].T], dim=1)
    padded = ceil_padded(W, H, 1.1)
    psf = psfs.to(dtype)
    residual = field.to(dtype)
    model = torch.zeros_like(residual)
    iterations = 0
    for major in range(majors + 1):
        integrated = torch.einsum("i,ihw->hw", coef, residual)
        value0, _, _, found = find_peak(integrated)
        if not found or iterations >= limit:
            break
        first = max(threshold, abs(value0) * (1.0 - major_gain))
        major_threshold = abs(value0) * (1.0 - major_gain)
        selectable = integrated.abs() >= f32(first)
        flat = torch.nonzero(selectable.reshape(-1))[:, 0]
        start = iterations
        value = None
        if flat.numel():
            xs = (flat % W).to(torch.int32)
            ys = (flat // W).to(torch.int32)
            model_k, iterations, value, diverging = Subminor(
                residual.reshape(C, -1)[:, flat].contiguous(), xs, ys, psf,
                coef, fit, f32(first), gain, iterations, limit,
                divergence_limit).run()
            full = torch.zeros((C, H * W), dtype=dtype, device=dev)
            full.index_copy_(1, flat, model_k)
            full = full.view(C, H, W)
            conv = padded_convolve(full.reshape(C, 1, H, W), psf[:, None],
                                   padded)
            residual = residual - conv.reshape(C, H, W)
            model = model + full
            if diverging:
                break
        if not finished(value, iterations != start, threshold,
                        major_threshold) or iterations >= limit:
            break
    return residual.float(), model.float(), iterations
