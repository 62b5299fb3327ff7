"""Multiscale CLEAN with joined channels and a polynomial spectral fit, on
its fused route (WSClean's ``-multiscale -join-channels
-fit-spectral-pol``; Radler's ``fast_sub_minor_loop``), written out in plain
PyTorch.

The scales are 0 and 4, 8, 16, ... pixels below half the image (twice the
one-pixel beam, doubling); each scale's kernel is a tapered quadratic,
normalised to unit sum.  The residual cube lives in the Fourier domain at
one padded size.  Each outer pass finds every scale's peak of the joined
residual convolved with the scale's kernel, picks the scale with the
largest biased peak (bias 0.6 per doubling), and cleans the scale-convolved
cube with the twice-convolved PSFs (a Högbom loop over the whole image in
the linear join, the components fitted to the polynomial in coefficient
space) down to the subminor threshold; the components, convolved with the
scale's kernel, go into the model, and their convolution with the PSFs
comes off the residual's spectrum.  Large scales correct at a second, larger
padded size.  The thresholds, countdown and activation are float32
decisions on the host, in the order that fixes their rounding.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from .common import FLT_MIN, Channels, good_fft_size, untrim, kernel_spectrum

f32 = np.float32
CHUNK = 64


# -- scales and kernels -------------------------------------------------------

def scales_for(size: int, beam_px: float = 1.0) -> List[float]:
    """0, then twice the beam doubling, while below half the image: at
    2048^2, 0, 4, 8, ..., 512."""
    out, scale = [], beam_px * 2.0
    while True:
        out.append(0.0 if not out else scale)
        scale *= 2.0
        if not scale < size * 0.5:
            return out


def tapered_quadratic(scale: float) -> np.ndarray:
    """The ``n`` x ``n`` kernel, n = 2 ceil(scale / 2) + 1: (1 - (r /
    scale)^2) times a Hann window of width n + 1, over its sum."""
    n = int(math.ceil(scale * 0.5) * 2.0) + 1
    if scale == 0.0:
        out = np.zeros((n, n), np.float32)
        out[0, 0] = 1.0
        return out
    v = np.arange(n, dtype=np.float64) - 0.5 * (n - 1)
    r = np.sqrt(v[None, :] ** 2 + v[:, None] ** 2)
    hann = np.where(r * 2 <= n + 1,
                    0.5 * (1.0 + np.cos(2.0 * math.pi * r / (n + 1))), 0.0)
    x = r / scale
    out = (hann * np.where(x < 1.0, 1.0 - x * x, 0.0)).astype(np.float32)
    return out / out.sum()


def kernel_stack(scales: List[float]) -> np.ndarray:
    """``[S, k, k]`` centred kernels (scale 0 a centred delta)."""
    kernels = [np.ones((1, 1), np.float32) if s == 0.0
               else tapered_quadratic(s) for s in scales]
    kmax = max(k.shape[0] for k in kernels)
    stack = np.zeros((len(kernels), kmax, kmax), np.float32)
    for i, k in enumerate(kernels):
        o = kmax // 2 - k.shape[0] // 2
        stack[i, o:o + k.shape[0], o:o + k.shape[0]] = k
    return stack


def embedded_spectrum(kernel: torch.Tensor, shape) -> torch.Tensor:
    """The centred kernel placed in ``shape`` and moved to the origin,
    transformed."""
    if tuple(kernel.shape[-2:]) != tuple(shape):
        kernel = untrim(kernel, *shape)
    return kernel_spectrum(kernel, tuple(shape))


def padded_sizes(scales: List[float], height: int, width: int,
                 padding: float = 1.1):
    """(split, small size, large size): the scales whose padded area (of
    ``padding * (1.5 scale + side)``, 7-smooth) stays within 1.3 times
    scale 0's correct at the largest such size, the rest at the largest
    scale's."""
    sizes = [(good_fft_size(int(padding * (1.5 * s + height))),
              good_fft_size(int(padding * (1.5 * s + width))))
             for s in scales]
    pb = sizes[-1]
    base = sizes[0][0] * sizes[0][1]
    split = len(sizes)
    for i, (sh, sw) in enumerate(sizes):
        if sh * sw > 1.30 * base:
            split = i
            break
    if split == 0 or split == len(sizes):
        return len(sizes), pb, pb
    return split, sizes[split - 1], pb


def trimmed_inverse(spec: torch.Tensor, padded, shape) -> torch.Tensor:
    out = torch.fft.irfft2(spec, s=tuple(padded))
    if tuple(shape) == tuple(padded):
        return out
    h, w = out.shape[-2:]
    top, left = h // 2 - shape[0] // 2, w // 2 - shape[1] // 2
    return out[..., top:top + shape[0], left:left + shape[1]]


def padded_forward(x: torch.Tensor, padded) -> torch.Tensor:
    if tuple(x.shape[-2:]) != tuple(padded):
        x = untrim(x, *padded)
    return torch.fft.rfft2(x)


# -- the dense subminor loop --------------------------------------------------

class Dense:
    """A Högbom loop in the linear join over the whole scale-convolved
    cube: at each iteration the components at the peak are the fitted peak
    values times the gain, the shifted twice-convolved PSFs times them come
    off every plane, and the next peak is the first of largest magnitude of
    the join times the scale's search window.  The host reads the state
    every 64 iterations; iterations past the stop change nothing."""

    def __init__(self, res, psfs, weight, lin, fit_m, expand):
        self.res, self.psfs, self.weight = res, psfs, weight
        self.lin, self.fit_m, self.expand = lin, fit_m, expand

    def shifted(self, x, y):
        C, h, w = self.psfs.shape
        rows = torch.arange(h, device=self.psfs.device) - y + h // 2
        cols = torch.arange(w, device=self.psfs.device) - x + w // 2
        valid = (((rows >= 0) & (rows < h))[:, None]
                 & ((cols >= 0) & (cols < w))[None, :])
        gathered = self.psfs[..., rows.clamp(0, h - 1), :][
            ..., cols.clamp(0, w - 1)]
        return torch.where(valid, gathered,
                           torch.zeros((), device=self.psfs.device))

    def join(self):
        n = self.res.shape[0]
        integ = self.res[0] * self.lin[0]
        for i in range(1, n):
            integ = integ + self.res[i] * self.lin[i]
        return integ.reshape(-1)

    def fit(self, raw, gain):
        coef = torch.matmul(self.fit_m, raw.view(-1, 1).to(self.fit_m.dtype))
        values = torch.mv(self.expand, coef.view(-1)).mul_(gain)
        return coef.view(-1), values, coef.view(-1) * gain

    def run(self, comp, peak0, gain, threshold, initial_abs_peak, limit,
            max_iterations, start):
        N, H, W = self.res.shape
        dev = self.res.device
        gain, threshold = float(f32(gain)), float(f32(threshold))
        bound = float(f32(f32(initial_abs_peak)) * f32(limit))
        value0, x0, y0, found0 = peak0
        value0 = float(f32(value0))
        active = (found0 and abs(value0) > threshold
                  and start < max_iterations)
        yx = torch.tensor([y0, x0], device=dev)
        idx = torch.tensor([y0 * W + x0], device=dev)
        act = torch.tensor(active, device=dev)
        diverging = torch.tensor(False, device=dev)
        iteration = torch.tensor(start, device=dev)
        value = torch.tensor([value0], dtype=torch.float32, device=dev)
        raw = self.res[:, y0, x0].clone()
        _, values, coef_gain = self.fit(raw, gain)
        comp_flat = comp.view(comp.shape[0], -1)
        it = start
        while active:
            for _ in range(min(CHUNK, max_iterations - it)):
                comp_flat.index_add_(1, idx, (coef_gain * act)[:, None]
                                     .to(comp.dtype))
                shifted = self.shifted(yx[1], yx[0])
                new = self.res - values.to(self.res.dtype)[:, None, None] \
                    * shifted.to(self.res.dtype)
                self.res.copy_(torch.where(act, new, self.res))
                integ = self.join()
                cmp = (integ * self.weight.reshape(-1)).abs()
                best = torch.argmax(cmp).view(1)
                v_new = integ.index_select(0, best).float()
                f_new = cmp.index_select(0, best)[0] > FLT_MIN
                raw_new = self.res.view(N, -1).index_select(1, best)[:, 0]
                d_new = f_new & (v_new.abs()[0] > bound) if limit != 0.0 \
                    else torch.zeros_like(f_new)
                it_new = iteration + 1
                go = (f_new & (v_new.abs()[0] > threshold)
                      & (it_new < max_iterations) & ~d_new)
                yx = torch.where(act, torch.cat([best // W, best % W]), yx)
                idx = torch.where(act, best, idx)
                diverging = torch.where(act, d_new, diverging)
                iteration = torch.where(act, it_new, iteration)
                value = torch.where(act, v_new, value)
                raw = torch.where(act, raw_new.float(), raw)
                act = torch.where(act, go, act)
                _, values, coef_gain = self.fit(raw, gain)
            it, active = int(iteration), bool(act)
        return int(iteration), float(value[0]), bool(diverging)


# -- the run ------------------------------------------------------------------

def _lowp(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded through ``dtype`` (complex: each part)."""
    if dtype == torch.float32:
        return t
    if t.is_complex():
        return torch.complex(t.real.to(dtype).float(),
                             t.imag.to(dtype).float())
    return t.to(dtype).float()


def run(config: dict, psfs: torch.Tensor, field: torch.Tensor,
        frequencies: np.ndarray, weights: np.ndarray,
        dtype: torch.dtype = torch.float32):
    """The run's written-back residual and model ``[C, H, W]`` (float32)
    and its minor-iteration count; with a lower ``dtype`` the dense loop's
    cube and components, and the residual's spectrum after each
    correction, are held in that type."""
    s = config["settings"]
    C, H, W = field.shape
    dev = field.device
    channels = Channels(frequencies, weights, "POLYNOMIAL",
                        s.get("spectral_fitting.terms", 0))
    gain = float(s.get("minor_loop_gain", 0.1))
    major_gain = float(s.get("major_loop_gain", 1.0))
    threshold = float(s.get("absolute_threshold", 0.0))
    limit_it = int(s["minor_iteration_count"])
    majors = int(s.get("major_iteration_count", 12))
    sub_gain = float(s.get("multiscale.sub_minor_loop_gain", 0.2))
    scale_bias = float(s.get("multiscale.scale_bias", 0.6))
    divergence_limit = 4.0

    scales = scales_for(min(W, H))
    S = len(scales)
    split, pa, pb = padded_sizes(scales, H, W)
    compact = torch.as_tensor(kernel_stack(scales), device=dev)
    w = channels.weights
    integrated_psf = torch.einsum(
        "c,chw->hw", torch.as_tensor((w * (1.0 / w[w != 0].sum()))
                                     .astype(np.float32), device=dev), psfs)
    kimg_f = embedded_spectrum(compact, (H, W))
    peaks = torch.fft.irfft2(torch.fft.rfft2(integrated_psf)[None] * kimg_f,
                             s=(H, W))[:, H // 2, W // 2].tolist()
    bias = np.asarray([1.0 if sc == 0.0 else
                       scale_bias ** (-math.log2(sc / 2.0))
                       for sc in scales], np.float32)
    gain_arr = np.asarray([gain / p for p in peaks], np.float32)
    twice = torch.fft.irfft2(torch.fft.rfft2(psfs)[None, :]
                             * (kimg_f[:, None] * kimg_f[:, None]), s=(H, W))
    del kimg_f
    kernel_f = embedded_spectrum(compact, pa)
    psf_f = embedded_spectrum(psfs, pa)
    if split < S:
        kernel_f_large = embedded_spectrum(compact[split:], pb)
        psf_f_large = embedded_spectrum(psfs, pb)
    valid = np.zeros((S, H, W), bool)
    for i, sc in enumerate(scales):
        b = int(math.ceil(sc * 0.5)) if sc != 0.0 else 0
        valid[i, b:max(H - b, b), b:max(W - b, b)] = True
    valid = torch.as_tensor(valid, device=dev)
    lin = channels.on("coefficients", dev)
    fit_m = channels.on("fit_matrix", dev)
    expand = channels.on("design", dev)

    residual, model = field.clone(), torch.zeros_like(field)
    iterations = 0
    for major in range(majors + 1):
        if iterations >= limit_it:
            break
        out = _major(residual, model, kernel_f, twice, psf_f,
                     kernel_f_large if split < S else None,
                     psf_f_large if split < S else None, valid, bias,
                     gain_arr, threshold, major_gain, sub_gain, gain,
                     divergence_limit, iterations, limit_it,
                     max(8, S * 3 // 2), lin, fit_m, expand, split, pa, pb,
                     dtype)
        residual, model, iterations, another = out
        if not another or iterations >= limit_it:
            break
    return residual, model, iterations


def _maxima(res_f, lin, kernel_f, padded, valid):
    S, (H, W) = kernel_f.shape[0], valid.shape[-2:]
    integ_f = torch.einsum("n,nhw->hw", lin.to(res_f.dtype), res_f)
    conv = trimmed_inverse(integ_f.unsqueeze(-3) * kernel_f, padded, (H, W))
    masked = torch.where(valid, conv.abs(), -math.inf).reshape(S, H * W)
    idx = torch.argmax(masked, dim=-1, keepdim=True)
    found = torch.gather(masked, -1, idx)[..., 0] > FLT_MIN
    vals = torch.where(found, torch.gather(conv.reshape(S, H * W), -1,
                                           idx)[..., 0], 0.0)
    idx = idx[..., 0]
    host = torch.stack([vals.double(), (idx % W).double(),
                        (idx // W).double(), found.double()]).cpu().numpy()
    return (host[0].astype(f32), host[1].astype(np.int64),
            host[2].astype(np.int64), host[3] != 0.0)


def _major(residual, model, kernel_f, twice, psf_f, kernel_f_large,
           psf_f_large, valid, bias, gain_arr, threshold, major_gain,
           sub_gain, minor_gain, divergence_limit, start, max_iterations,
           countdown, lin, fit_m, expand, split, pa, pb, dtype):
    """One major iteration; returns (residual, model, iterations, whether
    another is asked for)."""
    N, H, W = residual.shape
    S = kernel_f.shape[0]
    one = f32(1.0)
    threshold, major_gain = f32(threshold), f32(major_gain)
    sub_gain, minor_gain = f32(sub_gain), f32(minor_gain)
    divergence_limit = f32(divergence_limit)
    res_f = padded_forward(residual, pa)

    vals, xs, ys, found = _maxima(res_f, lin, kernel_f, pa, valid)
    biased0 = np.abs(vals * bias)
    initial_peak = biased0[int(np.argmax(biased0))]
    m_gain_threshold = max(initial_peak * (one - major_gain), f32(0.0))
    first_threshold = max(m_gain_threshold, threshold)
    is_final = bool(threshold > m_gain_threshold)
    any_found0 = bool(found.any())
    mod = model.clone()
    it = int(start)
    active = np.ones(S, bool)
    div = nocomp = False
    while True:
        s = int(np.argmax(np.where(active, np.abs(vals * bias), -np.inf)))
        if not (it < max_iterations
                and abs(vals[s] * bias[s]) > first_threshold
                and countdown > 0 and not div and not nocomp and any_found0):
            break
        biased_peak = abs(vals[s] * bias[s])
        sub_threshold = biased_peak * (one - sub_gain)
        countdown -= int(first_threshold > sub_threshold)
        thr_sub = max(sub_threshold, first_threshold) / bias[s]
        conv_res = trimmed_inverse(res_f * kernel_f[s].unsqueeze(-3), pa,
                                   (H, W)).contiguous()
        comp = torch.zeros((fit_m.shape[0], H, W), device=residual.device)
        dense = Dense(conv_res.to(dtype), twice[s],
                      valid[s].to(torch.float32), lin, fit_m, expand)
        it_before = it
        it, value, sub_div = dense.run(
            comp, (float(vals[s]), int(xs[s]), int(ys[s]), bool(found[s])),
            float(gain_arr[s]), float(thr_sub), abs(float(vals[s])),
            float(divergence_limit), max_iterations, it)
        comp = _lowp(comp, dtype)
        nocomp = it == it_before
        div = bool(sub_div) or bool(
            divergence_limit != 0.0
            and abs(f32(value)) > initial_peak * divergence_limit)
        if s < split:
            comp_f = padded_forward(comp, pa)
            k = kernel_f[s].unsqueeze(-3)
            mod.add_(torch.matmul(expand, trimmed_inverse(
                comp_f * k, pa, (H, W)).reshape(comp.shape[0], -1))
                .reshape(N, H, W))
            res_f.sub_(torch.matmul(expand.to(comp_f.dtype), comp_f.reshape(
                comp.shape[0], -1)).reshape((N,) + comp_f.shape[1:])
                * psf_f * k)
        else:
            comp_f = padded_forward(comp, pb)
            k = kernel_f_large[s - split].unsqueeze(-3)
            mod.add_(torch.matmul(expand, trimmed_inverse(
                comp_f * k, pb, (H, W)).reshape(comp.shape[0], -1))
                .reshape(N, H, W))
            delta = trimmed_inverse(torch.matmul(
                expand.to(comp_f.dtype), comp_f.reshape(comp.shape[0], -1))
                .reshape((N,) + comp_f.shape[1:]) * psf_f_large * k, pb,
                (H, W))
            res_f.sub_(padded_forward(delta, pa))
        res_f = _lowp(res_f, dtype)
        mod = _lowp(mod, dtype)
        act_thr = abs(vals[s]) * (one - minor_gain) * bias[s]
        active = (np.arange(S) == s) | (np.abs(vals * bias) > act_thr)
        vals, xs, ys, found = _maxima(res_f, lin, kernel_f, pa, valid)
    res_out = trimmed_inverse(res_f, pa, (H, W)).contiguous()
    any_peak = any_found0 and bool(found.any())
    another = (any_peak and it < max_iterations and not is_final
               and not div)
    return res_out, mod, it, another
