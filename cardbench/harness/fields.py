"""The one field generator that every traffic mix parameterizes.

A traffic file describes the PSFs and the sky; the configuration gives the
image size and the channels.  :func:`make_fields` draws a pool of fields
from ``--seed`` with a ``torch.Generator`` on the run's device, in a few
large calls, and convolves each channel's sky with its PSF there
(``torch.fft``, circular, at the image size).  The seed draws positions,
amplitudes, sizes and spectral indices; counts and distributions come from
the traffic file.  The PSFs depend on the channels alone, so every field
of a pool shares them.

The shapes follow ``chip_smoke.py``'s generators (``make_spectral_problem``
for point sources with power-law spectra, ``make_diffuse_problem`` for
Gaussian blobs), made on the card instead of in NumPy.

PSF keys (``traffic["psf"]``): ``sigma_px``, ``ring_amplitude``,
``ring_radius_px``, ``ring_sigma_px``; each of ``sigma_scale``,
``ring_radius_scale`` and ``ring_sigma_scale`` is ``"inverse_frequency"``
(times nu_ref / nu), ``"fixed"`` or ``{"per_channel": a}`` (times 1 + a c).

Sky keys (``traffic["sky"]``): ``shape`` (``"point"`` or ``"gaussian"``),
``count`` sources at the size ``count_at_size`` (scaled by area),
``margin_fraction`` of the size kept free at each edge, ``amplitude``
[low, high] (uniform), for Gaussians ``sigma_px`` [low, high] (uniform; each
blob cut at a box of +-max(1, int(4 sigma))), ``spectrum``: ``{"kind":
"power_law", "index_mean", "index_sd"}`` (amplitude at the mean centre
frequency times (nu / nu_ref)^alpha, alpha normal) or ``{"kind":
"per_channel", "step": s}`` (times 1 + s c), and
``polarization_fraction``: each polarization's share of the sky, by the
name of ``radler_tpu_torch.Polarization``'s member.  Each field's n values
of a quantity are its distribution's quantiles at (k + 1/2) / n, dealt to
the sources in an order drawn from the seed: every field and every seed
holds the same set, so the seed moves the sources and not the work.
Positions are drawn uniformly from the seed.

The configuration's ``polarizations`` (member names) are the images of
each channel; a field's planes are channel-major, polarization p of channel
c at c * P + p, each its polarization's share of the channel's sky, as
Radler's work table orders them.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class Fields:
    psfs: torch.Tensor  # [C, H, W] float32
    pool: torch.Tensor  # [F, C * P, H, W] float32 residuals
    frequencies: np.ndarray  # [C, 2] band edges, Hz
    weights: np.ndarray  # [C]
    sources: int  # sources a field


def channel_edges(config: dict) -> np.ndarray:
    """``[C, 2]`` band edges in Hz: each centre of ``channels_mhz`` +- half
    of ``channel_width_mhz``."""
    centres = np.asarray(config["channels_mhz"], np.float64) * 1e6
    half = 0.5 * float(config["channel_width_mhz"]) * 1e6
    return np.stack([centres - half, centres + half], axis=1)


def source_count(sky: dict, size: int) -> int:
    return int(round(sky["count"] * (size / sky["count_at_size"]) ** 2))


def _scale(rule, c: int, ratio: float) -> float:
    """A PSF size's factor in channel ``c`` (``ratio`` = nu_ref / nu)."""
    if rule == "inverse_frequency":
        return ratio
    if rule == "fixed":
        return 1.0
    return 1.0 + float(rule["per_channel"]) * c


def make_psfs(psf: dict, centres: np.ndarray, size: int,
              device) -> torch.Tensor:
    """``[C, H, W]`` PSFs centred on pixel (size // 2, size // 2): a Gaussian
    plus a Gaussian ring, each size scaled per channel by its rule."""
    ref = float(centres.mean())
    d = torch.arange(size, device=device, dtype=torch.float32) - size // 2
    r2 = d[:, None] ** 2 + d[None, :] ** 2
    r = torch.sqrt(r2)
    out = torch.empty((len(centres), size, size), device=device)
    for c, f in enumerate(centres):
        ratio = ref / float(f)
        sigma = psf["sigma_px"] * _scale(psf["sigma_scale"], c, ratio)
        radius = psf["ring_radius_px"] * _scale(psf["ring_radius_scale"], c,
                                                ratio)
        ring = psf["ring_sigma_px"] * _scale(psf["ring_sigma_scale"], c,
                                             ratio)
        out[c] = (torch.exp(-r2 / (2.0 * sigma**2))
                  + psf["ring_amplitude"]
                  * torch.exp(-(r - radius) ** 2 / (2.0 * ring**2)))
    return out


def _draw(kind: str, shape, gen, device) -> torch.Tensor:
    """``shape`` = (F, n) standard uniform (``kind`` "uniform") or normal
    values: each row the n stratified quantiles in an order drawn from
    ``gen``."""
    F, n = shape
    u = (torch.arange(n, device=device, dtype=torch.float64) + 0.5) / n
    q = u if kind == "uniform" else torch.special.ndtri(u)
    order = torch.argsort(torch.rand(shape, generator=gen, device=device),
                          dim=1)
    return q[order]


def _spectra(spectrum: dict, centres: np.ndarray, n_fields: int, n: int,
             gen: torch.Generator, device) -> torch.Tensor:
    """``[F, C, n]`` factors of each source's amplitude in each channel."""
    C = len(centres)
    if spectrum["kind"] == "power_law":
        alpha = (_draw("normal", (n_fields, n), gen, device)
                 [:, None, :] * spectrum["index_sd"]
                 + spectrum["index_mean"])
        ratio = torch.as_tensor(centres / centres.mean(),
                                device=device).reshape(1, C, 1)
        return ratio ** alpha
    if spectrum["kind"] == "per_channel":
        step = 1.0 + spectrum["step"] * torch.arange(
            C, device=device, dtype=torch.float64)
        return step.reshape(1, C, 1).expand(n_fields, C, n)
    raise ValueError(f"unknown spectrum kind {spectrum['kind']!r}")


def _uniform(bounds: List[float], shape, gen, device) -> torch.Tensor:
    lo, hi = bounds
    return _draw("uniform", shape, gen, device) * (hi - lo) + lo


def make_fields(config: dict, traffic: dict, seed: int, device) -> Fields:
    """The cell's pool of ``traffic["fields"]`` fields from ``seed``."""
    device = torch.device(device)
    size = int(config["image_size"])
    edges = channel_edges(config)
    centres = edges.mean(axis=1)
    C = len(centres)
    F = int(traffic["fields"])
    sky = traffic["sky"]
    n = source_count(sky, size)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    margin = int(size * sky["margin_fraction"])
    ys = torch.randint(margin, size - margin, (F, n), generator=gen,
                       device=device)
    xs = torch.randint(margin, size - margin, (F, n), generator=gen,
                       device=device)
    amps = _uniform(sky["amplitude"], (F, n), gen, device)
    if sky["shape"] == "gaussian":
        sigmas = _uniform(sky["sigma_px"], (F, n), gen, device)
    elif sky["shape"] != "point":
        raise ValueError(f"unknown sky shape {sky['shape']!r}")
    flux = amps[:, None, :] * _spectra(sky["spectrum"], centres, F, n, gen,
                                       device)  # [F, C, n]
    shares = [float(sky["polarization_fraction"][p])
              for p in config["polarizations"]]
    P = len(shares)

    psfs = make_psfs(traffic["psf"], centres, size, device)
    psf_f = torch.fft.rfft2(torch.fft.ifftshift(psfs, dim=(-2, -1)))
    pool = torch.empty((F, C * P, size, size), device=device)
    axis = torch.arange(size, device=device, dtype=torch.float64)
    for f in range(F):
        if sky["shape"] == "gaussian":
            # Each blob is separable, so one field-channel plane is one
            # product: [H, n] rows times [n, W] columns.
            m = torch.clamp((4.0 * sigmas[f]).floor(), min=1.0)
            dy = axis[:, None] - ys[f][None, :].double()
            dx = axis[:, None] - xs[f][None, :].double()
            inv = 1.0 / (2.0 * sigmas[f] ** 2)
            gy = torch.where((dy >= -m) & (dy < m), torch.exp(-dy**2 * inv),
                             0.0)
            gx = torch.where((dx >= -m) & (dx < m), torch.exp(-dx**2 * inv),
                             0.0)
        for c in range(C):
            if sky["shape"] == "gaussian":
                plane = ((gy * flux[f, c]) @ gx.T).float()
            else:
                plane = torch.zeros((size, size), device=device)
                plane.index_put_((ys[f], xs[f]), flux[f, c].float(),
                                 accumulate=True)
            seen = torch.fft.irfft2(torch.fft.rfft2(plane) * psf_f[c],
                                    s=(size, size))
            for p, share in enumerate(shares):
                torch.mul(seen, share, out=pool[f, c * P + p])
            del plane, seen
    return Fields(psfs=psfs, pool=pool, frequencies=edges,
                  weights=np.asarray(config["weights"], np.float64),
                  sources=n)
