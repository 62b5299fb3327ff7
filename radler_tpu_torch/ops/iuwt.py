"""Isotropic Undecimated Wavelet Transform (à-trous B3-spline) and the IUWT
deconvolution's device steps.

Port of ``radler_tpu.ops.iuwt`` (``cpp/algorithms/iuwt/iuwt_decomposition.
{h,cc}`` and the device halves of ``iuwt_deconvolution_algorithm.cc``): the
5-tap kernel [1,4,6,4,1]/16 applied separably with tap spacing
``2^scale - 1`` and a zero boundary, the per-scale statistics and structure
selection, the masked conjugate-gradient solve and the component flux fit.

:func:`decompose` sends every scale through
:func:`radler_tpu_torch.kernels.iuwt_atrous.atrous_decompose_lo` (kernel B3
on CUDA tensors, its plain version on CPU tensors), at every image size and
batch: on an NVIDIA H100, B3 beat the shifted adds at every scale
(PERF.md, section 6).  Each function returns tensors on its inputs' device;
the model reads them to the host where the JAX package does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.iuwt_atrous import atrous_decompose_lo, iuwt_convolve
from .convolution import convolve_same, convolve_same_prefft, prepare_kernel_fft
from .noise import mad_sigma_batched


# ---------------------------------------------------------------------------
# The transform
# ---------------------------------------------------------------------------


def decompose(image: torch.Tensor, n_scales: int) -> torch.Tensor:
    """IUWT decomposition (``IuwtDecomposition::DecomposeSt``,
    ``iuwt_decomposition.h:100-119``): returns ``[n_scales + 1, *lead, H, W]``
    where plane s holds w_s = i_s - C(C(i_s)) and the last plane the smooth
    residual.  ``image`` is ``[H, W]`` or ``[B, H, W]``."""
    image = image.contiguous()
    coeffs = image.new_empty((n_scales + 1, *image.shape))
    atrous_decompose_lo(image, n_scales, w=coeffs[:n_scales],
                        smooth=coeffs[n_scales])
    return coeffs


def recompose(
    scales: torch.Tensor, n_scales: int, include_largest: bool
) -> torch.Tensor:
    """Inverse transform (``IuwtDecomposition::Recompose``,
    ``iuwt_decomposition.h:121-148``): smoothing plus coefficient addition
    from the coarsest scale down."""
    output = scales[n_scales] if include_largest else None
    for scale in range(n_scales - 1, -1, -1):
        if output is None:
            output = scales[scale]
        else:
            output = iuwt_convolve(output, scale + 1) + scales[scale]
    return output if output is not None else torch.zeros_like(scales[0])


def apply_mask(scales: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero coefficients outside the per-scale mask and zero the smooth plane
    (``IuwtDecomposition::ApplyMask``, ``iuwt_decomposition.h:162-169``).
    ``mask`` is bool ``[n_scales, ...]``; ``scales`` is
    ``[n_scales + 1, ...]``."""
    n_scales = mask.shape[0]
    masked = torch.where(mask, scales[:n_scales], 0.0)
    return torch.cat([masked, torch.zeros_like(scales[n_scales:])])


# ---------------------------------------------------------------------------
# Statistics and structure selection
# ---------------------------------------------------------------------------


def scale_peak_stats(
    coeffs: torch.Tensor,  # [S, H, W]
    window: torch.Tensor,  # [H, W] bool
    allow_negative: bool = True,
):
    """Per-scale masked argmax (the first index among equal maxima):
    ``(vals, xs, ys)`` with ``vals[s]`` the max over the window of
    ``|coeffs[s]|``, or of the signed value when negatives are not allowed
    (``iuwt_deconvolution_algorithm.cc:112-167``)."""
    n, _, width = coeffs.shape
    value = coeffs.abs() if allow_negative else coeffs
    flat = torch.where(window[None], value, -math.inf).reshape(n, -1)
    idx = torch.argmax(flat, dim=1)
    vals = torch.gather(flat, 1, idx[:, None])[:, 0]
    return vals, (idx % width).int(), (idx // width).int()


def select_structures(
    coeffs: torch.Tensor,  # [S+1, H, W]
    thresholds: torch.Tensor,  # [S] (signed: negative selects two-sided)
    window: torch.Tensor,  # [H, W] bool
    min_scale: int,
):
    """``image_analysis::SelectStructures`` (``image_analysis.cc:217-249``):
    every above-threshold pixel seeds a fill bounded to above-threshold
    pixels, so the selected set is the windowed exceedance set.  Returns
    ``(mask [S, H, W] bool, count)``."""
    n = thresholds.shape[0]
    c = coeffs[:n]
    thr = thresholds[:, None, None]
    exceeds = torch.where(thr >= 0.0, c > thr, (c < thr) | (c > -thr))
    scale_ok = torch.arange(n, device=c.device) >= min_scale
    mask = exceeds & window[None] & scale_ok[:, None, None]
    return mask, mask.sum()


def bounding_box(image: torch.Tensor) -> torch.Tensor:
    """1%-of-max support box (``BoundingBox``,
    ``iuwt_deconvolution_algorithm.cc:180-215``) as an int32 tensor
    ``(x1, y1, x2, y2)``; the full image when no pixel is significant."""
    height, width = image.shape
    a = image.abs()
    significant = a > a.max() * 0.01
    rows = significant.any(dim=1)
    cols = significant.any(dim=0)
    ridx = torch.arange(height, device=image.device)
    cidx = torch.arange(width, device=image.device)
    any_sig = rows.any()
    return torch.stack([
        torch.where(any_sig, torch.where(cols, cidx, width).min(), 0),
        torch.where(any_sig, torch.where(rows, ridx, height).min(), 0),
        torch.where(any_sig, torch.where(cols, cidx, -1).max() + 1, width),
        torch.where(any_sig, torch.where(rows, ridx, -1).max() + 1, height),
    ]).int()


def structure_stats(image: torch.Tensor, window: torch.Tensor, n_scales: int,
                    allow_negative: bool):
    """Decompose, per-scale MAD sigma and windowed argmax: returns
    ``(coeffs, stats [5, S])`` with rows sigma, |val|, x, y and the signed
    value at the peak (the front half of ``FindAndDeconvolveStructure``,
    ``iuwt_deconvolution_algorithm.cc:414-483``).  At 2048 rows and more
    the sigma is estimated from every 4th row, as the JAX package does."""
    coeffs = decompose(image, n_scales)
    planes = coeffs[:n_scales]
    mad_src = planes[:, ::4, :] if image.shape[-2] >= 2048 else planes
    vals, xs, ys = scale_peak_stats(planes, window, allow_negative)
    idx = ys.long() * image.shape[-1] + xs.long()
    signed = torch.gather(planes.reshape(n_scales, -1), 1, idx[:, None])[:, 0]
    stats = torch.stack(
        [mad_sigma_batched(mad_src), vals, xs.float(), ys.float(), signed]
    )
    return coeffs, stats


def psf_response_stats(psf: torch.Tensor, n_scales: int) -> torch.Tensor:
    """``MeasureRMSPerScale`` (``iuwt_deconvolution_algorithm.cc:42-102``):
    ``[3, S]`` = (per-scale RMS of the PSF's wavelet planes, their value at
    the centre, the centre values of the re-decomposed scale-1 plane)."""
    scales = decompose(psf, n_scales)
    h, w = psf.shape
    cy, cx = h // 2, w // 2
    rms_v = torch.sqrt(torch.mean(scales[:n_scales] ** 2, dim=(1, 2)))
    peak = scales[:n_scales, cy, cx]
    peak_next = decompose(scales[1], n_scales)[:n_scales, cy, cx]
    return torch.stack([rms_v, peak, peak_next])


def masked_recompose_bbox(coeffs, mask, n_scales: int) -> torch.Tensor:
    """The bounding box of the masked recomposition."""
    return bounding_box(recompose(apply_mask(coeffs, mask), n_scales, False))


def masked_dirty_of(dirty, mask, n_scales: int):
    """(masked IUWT of ``dirty``, its recomposition)."""
    mds = apply_mask(decompose(dirty, n_scales), mask)
    return mds, recompose(mds, n_scales, False)


def _f32(value) -> float:
    """``value`` rounded to float32, as a Python float."""
    return float(np.float32(value))


def structure_stats_select(
    image: torch.Tensor,  # [H, W] integrated dirty
    window: torch.Tensor,  # [H, W] bool peak-search window
    select_window: torch.Tensor,  # [H, W] bool structure-selection window
    psf_rms: torch.Tensor,  # [S] per-scale PSF wavelet RMS
    scale0_factor: float,  # psf_peak_response[1]/response_to_next[0]
    sigma_level: float,
    absolute_threshold: float,
    tolerance: float,
    min_scale: int,
    n_scales: int,
    allow_negative: bool,
):
    """The front half of ``FindAndDeconvolveStructure`` and the selection of
    ``FillAndDeconvolveStructure`` with one host read: decompose and the
    per-scale stats, the significant-scale choice
    (``iuwt_deconvolution_algorithm.cc:439-483``), the adjusted per-scale
    thresholds, the structure mask (``image_analysis.cc:217-249``) and its
    bounding box.  The mask and box are speculative when no significant
    pixel exists.

    Returns ``(coeffs, mask, blob, thresholds)`` with ``blob`` =
    ``[stats(5*S) | count | x1 y1 x2 y2 | sel signed_max]`` (float32) and
    ``thresholds`` the signed ``[S]`` thresholds of the mask, for the
    trimmed re-selection.  The scalars are rounded to float32, as the JAX
    package takes them."""
    coeffs, stats = structure_stats(image, window, n_scales, allow_negative)
    rmses, vals = stats[0], stats[1]
    # Python scalars reach the device as float32 kernel arguments, not as
    # copies.
    sigma_level = _f32(sigma_level)
    max_val = torch.full_like(vals[0], -1.0)
    sel = torch.full_like(vals[0], -1, dtype=torch.int64)
    for s in range(min_scale, n_scales):
        abs_coef = vals[s] / psf_rms[s]
        ok = (
            (abs_coef > max_val)
            & (vals[s] > rmses[s] * sigma_level)
            & (vals[s] > rmses[s] / rmses[0] * _f32(absolute_threshold))
        )
        if s == 0:
            cand = vals[0] / torch.minimum(psf_rms[0], psf_rms[1]) * _f32(
                scale0_factor)
        else:
            cand = abs_coef
        sel = torch.where(ok, s, sel)
        max_val = torch.where(ok, cand, max_val)
    at_sel = torch.gather(stats[4], 0, sel.clamp(min=0)[None])[0]
    signed_max = torch.where(sel >= 0, at_sel, 0.0)
    factor = _f32(np.float32(sigma_level * np.float32(4.0)) / np.float32(5.0))
    thr = torch.maximum(rmses * factor, _f32(tolerance) * signed_max.abs())
    thr = torch.where(signed_max < 0.0, -thr, thr)
    mask, count = select_structures(coeffs, thr, select_window, min_scale)
    bbox = masked_recompose_bbox(coeffs, mask, n_scales)
    blob = torch.cat([
        stats.reshape(-1),
        count[None].float(),
        bbox.float(),
        torch.stack([sel.float(), signed_max]),
    ])
    return coeffs, mask, blob, thr


# ---------------------------------------------------------------------------
# The masked conjugate-gradient solve
# ---------------------------------------------------------------------------


def conjugate_gradient(
    initial_dirty_scales: torch.Tensor,  # masked IUWT of the dirty [S+1,H,W]
    mask: torch.Tensor,  # [S,H,W] bool
    masked_dirty: torch.Tensor,  # [H,W]
    psf_kernel_image: torch.Tensor,  # [H,W] (kernel centre at H/2, W/2)
    n_scales: int,
    max_iterations: int = 20,
):
    """``RunConjugateGradient`` (``iuwt_deconvolution_algorithm.cc:326-407``)
    with the JAX package's economies: one FFT convolution and one transform
    per iteration (the forward operator is linear, so the model's response
    is accumulated from the gradient's), the PSF spectrum computed once.
    A host loop that reads its ``done`` flag once per iteration.  Returns
    ``(structure_model, status)`` with ``status`` = ``[success, snr]``
    (float32, on the device)."""
    ker_f = prepare_kernel_fft(psf_kernel_image)

    def forward(img):
        conv = convolve_same_prefft(img, ker_f)
        return apply_mask(decompose(conv, n_scales), mask)

    m = initial_dirty_scales
    m_sum = torch.sum(m * m)

    def snr_of(model_scales):
        diff = m - model_scales
        n_sum = torch.sum(diff * diff)
        return torch.where(n_sum != 0.0, m_sum / n_sum, math.inf)

    model = torch.zeros_like(masked_dirty)
    model_fwd = torch.zeros_like(initial_dirty_scales)
    gradient = masked_dirty
    residual = masked_dirty
    snr = torch.zeros((), device=masked_dirty.device)
    done = success = torch.zeros((), dtype=torch.bool,
                                 device=masked_dirty.device)
    it = 0
    while it < max_iterations:
        grad_fwd = forward(gradient)
        scratch = recompose(grad_fwd, n_scales, False)
        gds = torch.vdot(gradient.reshape(-1), scratch.reshape(-1))
        rd = torch.vdot(residual.reshape(-1), residual.reshape(-1))
        fail = (gds == 0.0) | (rd == 0.0)
        step = torch.where(gds != 0.0, rd / gds, 0.0)
        model = model + step * gradient
        model_fwd = model_fwd + step * grad_fwd
        residual2 = residual - step * scratch
        gstep = torch.where(
            rd != 0.0,
            torch.vdot(residual2.reshape(-1), residual2.reshape(-1)) / rd,
            0.0,
        )
        gradient = residual2 + gstep * gradient
        residual = residual2
        prev_snr = snr
        snr = snr_of(model_fwd)
        conv_hi = (snr > 100.0) & (it > 2)
        conv_dec = (snr < prev_snr) & (it > 5) & (snr > 3.0)
        done = fail | conv_hi | conv_dec
        success = ~fail & (conv_hi | conv_dec)
        it += 1
        if bool(done):  # the one host read of each iteration
            break
    # Ran all iterations without an early exit: success iff SNR > 3
    # (``iuwt_deconvolution_algorithm.cc:398-406``).
    success = torch.where(done, success, snr > 3.0)
    return model, torch.stack([success.float(), snr])


def rms_guard(dirty, structure_model, psf, gain: float) -> torch.Tensor:
    """RMS before and after a gain-scaled subtraction
    (``iuwt_deconvolution_algorithm.cc:608-618``): ``[rms_before,
    rms_after]``."""
    conv = convolve_same(structure_model, psf)
    rb = torch.sqrt(torch.mean(dirty * dirty))
    d2 = dirty - gain * conv
    ra = torch.sqrt(torch.mean(d2 * d2))
    return torch.stack([rb, ra])


def conjugate_gradient_guarded(
    initial_dirty_scales: torch.Tensor,  # [S+1, H, W]
    mask: torch.Tensor,  # [S, H, W] bool
    masked_dirty: torch.Tensor,  # [H, W]
    dirty: torch.Tensor,  # [H, W] (for the RMS guard)
    psf_kernel_image: torch.Tensor,  # [H, W]
    gain: float,
    n_scales: int,
    max_iterations: int = 20,
):
    """:func:`conjugate_gradient` then :func:`rms_guard`; returns
    ``(model, [success, snr, rms_before, rms_after])`` for one host read of
    both decisions (``iuwt_deconvolution_algorithm.cc:604-618``)."""
    model, status = conjugate_gradient(
        initial_dirty_scales, mask, masked_dirty, psf_kernel_image,
        n_scales, max_iterations,
    )
    guard = rms_guard(dirty, model, psf_kernel_image, gain)
    return model, torch.cat([status, guard])


# ---------------------------------------------------------------------------
# The component flux fit
# ---------------------------------------------------------------------------


def component_fit_ratio_batched(
    mask: torch.Tensor,  # [S, H, W] bool
    model: torch.Tensor,  # [H, W] structure model
    masked_dirty: torch.Tensor,  # [H, W]
    psf_trimmed: torch.Tensor,  # [bh, bw] (trimmed to the bucket size)
    areas: torch.Tensor,  # [P, bh, bw] bool per-component areas (box-local)
    y1s,  # [P] box origins (host integers)
    x1s,  # [P]
    n_scales: int,
    bh: int,
    bw: int,
) -> torch.Tensor:
    """All components of one box-size bucket as one batch: per component,
    ``PerformSubImageComponentFitBoxed`` + ``...Fit``
    (``iuwt_deconvolution_algorithm.cc:744-801``): slice its box, restrict
    the model to its area, convolve with the trimmed PSF, masked-IUWT it
    and sum model and dirty over the area.  Returns ``[P, 2]``
    (model_sum, dirty_sum)."""
    boxes = [(int(y), int(x)) for y, x in zip(y1s, x1s)]
    m = torch.stack([model[y:y + bh, x:x + bw] for y, x in boxes])
    msk = torch.stack([mask[:, y:y + bh, x:x + bw] for y, x in boxes], dim=1)
    dirty = torch.stack([masked_dirty[y:y + bh, x:x + bw] for y, x in boxes])
    conv = convolve_same(torch.where(areas, m, 0.0), psf_trimmed)
    mm = recompose(apply_mask(decompose(conv, n_scales), msk), n_scales, False)
    return torch.stack([
        torch.where(areas, mm, 0.0).sum(dim=(1, 2)),
        torch.where(areas, dirty, 0.0).sum(dim=(1, 2)),
    ], dim=1)


# ---------------------------------------------------------------------------
# Boxes
# ---------------------------------------------------------------------------


def trim_coeffs_box(coeffs, y1: int, x1: int, end_scale_n: int, new_h: int,
                    new_w: int) -> torch.Tensor:
    """``coeffs[:end_scale, box]`` with a zero smooth plane appended: the
    input of the trimmed recursion of ``FillAndDeconvolveStructure``."""
    sl = coeffs[:end_scale_n, y1:y1 + new_h, x1:x1 + new_w]
    return torch.cat([sl, sl.new_zeros((1, new_h, new_w))])


def slice_box2(img, y1: int, x1: int, h: int, w: int) -> torch.Tensor:
    return img[y1:y1 + h, x1:x1 + w].contiguous()


def slice_box3(img, y1: int, x1: int, h: int, w: int) -> torch.Tensor:
    return img[:, y1:y1 + h, x1:x1 + w].contiguous()


def embed_box3_zeros(small, y1: int, x1: int, full_h: int,
                     full_w: int) -> torch.Tensor:
    """Zero-filled ``[N, full_h, full_w]`` with ``small`` at (y1, x1)."""
    full = small.new_zeros((small.shape[0], full_h, full_w))
    full[:, y1:y1 + small.shape[1], x1:x1 + small.shape[2]] = small
    return full


def expand_single_plane(structure_model, n_planes: int) -> torch.Tensor:
    """``[H, W]`` -> ``[n_planes, H, W]``, plane 0 the model, the rest 0."""
    out = structure_model.new_zeros((n_planes, *structure_model.shape))
    out[0] = structure_model
    return out


def end_scale(max_image_dimension: int) -> int:
    """``max(log2(dim) - 3, 2)`` (``iuwt_decomposition.h:182-184``)."""
    return max(int(math.log2(max_image_dimension)) - 3, 2)


def min_image_dimension(end_scale_value: int) -> int:
    """``iuwt_decomposition.h:186-188``."""
    return 1 << (end_scale_value + 3)
