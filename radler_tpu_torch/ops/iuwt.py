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
from ..parallel.rows import (
    RowCache,
    Rows,
    SlabSpectrum,
    convolve_rows,
    decompose_rows,
    full,
    mesh_rows,
    recompose_rows,
    spread,
)
from .convolution import convolve_same, convolve_same_prefft, prepare_kernel_fft
from .noise import mad_sigma_batched
from .peak_finder import masked_peaks


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
    width = coeffs.shape[-1]
    vals, _, idx = masked_peaks(coeffs, window[None], allow_negative)
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
    a = image.abs()
    significant = a > a.max() * 0.01
    return _box_of(significant.any(dim=1), significant.any(dim=0))


def _box_of(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """:func:`bounding_box` from the rows and the columns that hold a
    significant pixel."""
    height, width = rows.shape[0], cols.shape[0]
    ridx = torch.arange(height, device=rows.device)
    cidx = torch.arange(width, device=rows.device)
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
    vals, signed, idx = masked_peaks(planes, window[None], allow_negative)
    return coeffs, _peak_stats(mad_sigma_batched(mad_src), vals, idx, signed,
                               image.shape[-1])


def _peak_stats(sigma, vals, idx, signed, width: int) -> torch.Tensor:
    """The ``[5, S]`` stats of :func:`structure_stats` from the peaks' flat
    indices."""
    return torch.stack([sigma, vals, (idx % width).int().float(),
                        (idx // width).int().float(), signed])


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
    thr, sel, signed_max = _significant_scale(
        stats, psf_rms, scale0_factor, sigma_level, absolute_threshold,
        tolerance, min_scale, n_scales)
    mask, count = select_structures(coeffs, thr, select_window, min_scale)
    bbox = masked_recompose_bbox(coeffs, mask, n_scales)
    return coeffs, mask, _stats_blob(stats, count, bbox, sel, signed_max), thr


def _significant_scale(stats, psf_rms, scale0_factor, sigma_level,
                       absolute_threshold, tolerance, min_scale, n_scales):
    """The significant-scale choice of :func:`structure_stats_select` from
    the ``[5, S]`` stats: the signed thresholds of the selection, the
    scale (-1: none) and its signed peak."""
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
    return thr, sel, signed_max


def _stats_blob(stats, count, bbox, sel, signed_max) -> torch.Tensor:
    """The one tensor :func:`structure_stats_select` reads to the host."""
    return torch.cat([
        stats.reshape(-1),
        count[None].float(),
        bbox.float(),
        torch.stack([sel.float(), signed_max]),
    ])


# ---------------------------------------------------------------------------
# The masked conjugate-gradient solve
# ---------------------------------------------------------------------------


class ImageSteps:
    """The operations :func:`solve` and :func:`guard` take, on whole images
    on one device: the forward operator (the FFT convolution with the PSF
    spectrum, the decompose, the mask), the recompose, dot products and
    scaled sums."""

    def __init__(self, psf_kernel_image: torch.Tensor, mask: torch.Tensor,
                 n_scales: int):
        self.ker_f = prepare_kernel_fft(psf_kernel_image)
        self.mask, self.n_scales = mask, n_scales
        self.device = psf_kernel_image.device

    def convolve(self, img):
        return convolve_same_prefft(img, self.ker_f)

    def forward(self, img):
        return apply_mask(decompose(self.convolve(img), self.n_scales),
                          self.mask)

    def recompose(self, scales):
        return recompose(scales, self.n_scales, False)

    @staticmethod
    def dot(a, b):
        return torch.vdot(a.reshape(-1), b.reshape(-1))

    @staticmethod
    def sum_sq(x):
        return torch.sum(x * x)

    @staticmethod
    def rms(x):
        return torch.sqrt(torch.mean(x * x))

    @staticmethod
    def sub(x, y):
        return x - y

    @staticmethod
    def add_scaled(x, factor, y):
        return x + factor * y

    @staticmethod
    def sub_scaled(x, factor, y):
        return x - factor * y

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)


def solve(steps, initial_dirty_scales, masked_dirty, max_iterations: int):
    """``RunConjugateGradient`` (``iuwt_deconvolution_algorithm.cc:326-407``)
    on ``steps``' operations (:class:`ImageSteps` or their spread form),
    with the JAX package's economies: one FFT convolution and one
    transform per iteration (the forward operator is linear, so the
    model's response is accumulated from the gradient's).  A host loop
    that reads its ``done`` flag once per iteration.  Returns
    ``(structure_model, [success, snr])`` (float32, on the device)."""
    m = initial_dirty_scales
    m_sum = steps.sum_sq(m)

    def snr_of(model_scales):
        n_sum = steps.sum_sq(steps.sub(m, model_scales))
        return torch.where(n_sum != 0.0, m_sum / n_sum, math.inf)

    model = steps.zeros_like(masked_dirty)
    model_fwd = steps.zeros_like(m)
    gradient = residual = masked_dirty
    snr = torch.zeros((), device=steps.device)
    done = success = torch.zeros((), dtype=torch.bool, device=steps.device)
    it = 0
    while it < max_iterations:
        grad_fwd = steps.forward(gradient)
        scratch = steps.recompose(grad_fwd)
        gds = steps.dot(gradient, scratch)
        rd = steps.dot(residual, residual)
        fail = (gds == 0.0) | (rd == 0.0)
        step = torch.where(gds != 0.0, rd / gds, 0.0)
        model = steps.add_scaled(model, step, gradient)
        model_fwd = steps.add_scaled(model_fwd, step, grad_fwd)
        residual2 = steps.sub_scaled(residual, step, scratch)
        gstep = torch.where(rd != 0.0, steps.dot(residual2, residual2) / rd,
                            0.0)
        gradient = steps.add_scaled(residual2, gstep, gradient)
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


def guard(steps, dirty, structure_model, gain: float) -> torch.Tensor:
    """RMS before and after a gain-scaled subtraction of the model's
    convolution with the PSF (``iuwt_deconvolution_algorithm.cc:608-618``)
    on ``steps``' operations: ``[rms_before, rms_after]``."""
    conv = steps.convolve(structure_model)
    return torch.stack([steps.rms(dirty),
                        steps.rms(steps.sub_scaled(dirty, gain, conv))])


def conjugate_gradient(
    initial_dirty_scales: torch.Tensor,  # masked IUWT of the dirty [S+1,H,W]
    mask: torch.Tensor,  # [S,H,W] bool
    masked_dirty: torch.Tensor,  # [H,W]
    psf_kernel_image: torch.Tensor,  # [H,W] (kernel centre at H/2, W/2)
    n_scales: int,
    max_iterations: int = 20,
):
    """:func:`solve` on one device: ``(structure_model, [success, snr])``."""
    return solve(ImageSteps(psf_kernel_image, mask, n_scales),
                 initial_dirty_scales, masked_dirty, max_iterations)


def rms_guard(dirty, structure_model, psf, gain: float) -> torch.Tensor:
    """:func:`guard` on one device: ``[rms_before, rms_after]``."""
    return guard(ImageSteps(psf, None, 0), dirty, structure_model, gain)


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
    """:func:`solve` then :func:`guard` with one PSF spectrum; returns
    ``(model, [success, snr, rms_before, rms_after])`` for one host read of
    both decisions (``iuwt_deconvolution_algorithm.cc:604-618``)."""
    steps = ImageSteps(psf_kernel_image, mask, n_scales)
    model, status = solve(steps, initial_dirty_scales, masked_dirty,
                          max_iterations)
    return model, torch.cat([status, guard(steps, dirty, model, gain)])


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


# ---------------------------------------------------------------------------
# The same steps on images spread by rows over a mesh's cards
# ---------------------------------------------------------------------------


class SpreadOps:
    """The functions of this module that the IUWT model calls, for images
    spread by rows over ``mesh``'s cards by the JAX package's rule
    (:func:`radler_tpu_torch.parallel.rows.mesh_rows`).  A
    :class:`~radler_tpu_torch.parallel.rows.Rows` image runs each step on
    every part (the decompose in B3's row-block mode, the FFT convolutions
    as slab FFTs, the reductions as partials combined on the lead in part
    order); a plain tensor, an image whose rows the rule leaves on the
    lead, runs this module's function.  The decompose, the masks, the
    stats and the selection keep the single device's bits; the slab FFTs
    and the partial sums round apart from it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._cache = RowCache()

    # -- layout ----------------------------------------------------------
    def spread(self, image: torch.Tensor):
        """``image`` laid out by the rule for its height (or itself)."""
        return spread(image, mesh_rows(self.mesh, image.shape[-2]))

    def _like(self, t, image):
        """A fixed full-size tensor (a window) laid out as ``image``."""
        if not isinstance(image, Rows):
            return t
        return self._cache.rows(t, image.layout)

    def spectrum(self, kernel: torch.Tensor, layout):
        """The slab multiplier of a fixed full-size kernel on the lead
        (its spectrum made once while ``kernel`` lives)."""
        return self._cache.keep(("kernel", id(kernel), layout), kernel,
                                lambda: SlabSpectrum(
                                    prepare_kernel_fft(kernel), layout))

    # -- boxes -------------------------------------------------------------
    def slice_box2(self, img, y1: int, x1: int, h: int, w: int):
        if not isinstance(img, Rows):
            return slice_box2(img, y1, x1, h, w)
        return self.spread(img.box(y1, x1, h, w))

    slice_box3 = slice_box2

    def trim_coeffs_box(self, coeffs, y1: int, x1: int, end_scale_n: int,
                        new_h: int, new_w: int):
        return self.spread(trim_coeffs_box(
            self.box_of(coeffs, y1, x1, new_h, new_w), 0, 0, end_scale_n,
            new_h, new_w))

    @staticmethod
    def box_of(img, y1: int, x1: int, h: int, w: int) -> torch.Tensor:
        """``img[..., box]`` on the lead, a Rows or a tensor."""
        if isinstance(img, Rows):
            return img.box(y1, x1, h, w)
        return img[..., y1:y1 + h, x1:x1 + w]

    def embed_box3_zeros(self, small, y1: int, x1: int, full_h: int,
                         full_w: int):
        return self.spread(embed_box3_zeros(full(small), y1, x1, full_h,
                                            full_w))

    def expand_single_plane(self, structure_model, n_planes: int):
        if not isinstance(structure_model, Rows):
            return expand_single_plane(structure_model, n_planes)
        return structure_model.map(expand_single_plane, n_planes)

    # -- the steps -----------------------------------------------------------
    def structure_stats_select(self, image, window, select_window, psf_rms,
                               scale0_factor, sigma_level, absolute_threshold,
                               tolerance, min_scale, n_scales,
                               allow_negative):
        """:func:`structure_stats_select` of a spread image."""
        if not isinstance(image, Rows):
            return structure_stats_select(
                image, window, select_window, psf_rms, scale0_factor,
                sigma_level, absolute_threshold, tolerance, min_scale,
                n_scales, allow_negative)
        S, lead = n_scales, image.lead
        height, width = image.layout.height, image.parts[0].shape[-1]
        coeffs = decompose_rows(image, S)
        # The MAD's source rows gathered on the lead (every 4th image row
        # from 2048 rows on): the order statistics are exact.
        step = 4 if height >= 2048 else 1
        mad_src = torch.cat([
            c[:S, (-r0) % step::step, :].to(lead)
            for c, (r0, _) in zip(coeffs.parts,
                                  map(image.layout.rows,
                                      range(image.layout.parts)))], dim=-2)

        def search(c, w):
            best, signed, idx = masked_peaks(c[:S], w[None], allow_negative)
            return best, idx, signed

        vals, at, signed = coeffs.peaks(search, self._like(window, image))
        stats = _peak_stats(mad_sigma_batched(mad_src), vals, at, signed,
                            width)
        thr, sel, signed_max = _significant_scale(
            stats, psf_rms, scale0_factor, sigma_level, absolute_threshold,
            tolerance, min_scale, n_scales)
        mask, count = self.select_structures(coeffs, thr, select_window,
                                             min_scale)
        bbox = self.masked_recompose_bbox(coeffs, mask, n_scales)
        return (coeffs, mask, _stats_blob(stats, count, bbox, sel,
                                          signed_max), thr)

    def select_structures(self, coeffs, thresholds, window, min_scale: int):
        if not isinstance(coeffs, Rows):
            return select_structures(coeffs, thresholds, window, min_scale)
        win = self._like(window, coeffs)
        mask = coeffs.map(lambda c, w: select_structures(
            c, thresholds.to(c.device), w, min_scale)[0], win)
        return mask, mask.sum()

    def masked_recompose_bbox(self, coeffs, mask, n_scales: int):
        if not isinstance(coeffs, Rows):
            return masked_recompose_bbox(coeffs, mask, n_scales)
        image = recompose_rows(coeffs.map(apply_mask, mask), n_scales, False)
        a = image.map(torch.abs)
        top = torch.stack([p.max().to(image.lead) for p in a.parts]).max()
        significant = a.map(lambda p: p > top.to(p.device) * 0.01)
        rows = torch.cat([p.any(dim=1).to(image.lead)
                          for p in significant.parts])
        cols = significant.parts[0].any(dim=0)
        for p in significant.parts[1:]:
            cols = cols | p.any(dim=0).to(image.lead)
        return _box_of(rows, cols)

    def masked_dirty_of(self, dirty, mask, n_scales: int):
        if not isinstance(dirty, Rows):
            return masked_dirty_of(dirty, mask, n_scales)
        mds = decompose_rows(dirty, n_scales).map(apply_mask, mask)
        return mds, recompose_rows(mds, n_scales, False)

    def conjugate_gradient_guarded(self, initial_dirty_scales, mask,
                                   masked_dirty, dirty, psf_kernel_image,
                                   gain: float, n_scales: int,
                                   max_iterations: int = 20):
        """:func:`conjugate_gradient_guarded` of spread images
        (:class:`RowSteps`)."""
        if not isinstance(dirty, Rows):
            return conjugate_gradient_guarded(
                initial_dirty_scales, mask, masked_dirty, dirty,
                psf_kernel_image, gain, n_scales, max_iterations)
        steps = RowSteps(self.spectrum(psf_kernel_image, dirty.layout), mask,
                         n_scales, dirty.lead)
        model, status = solve(steps, initial_dirty_scales, masked_dirty,
                              max_iterations)
        return model, torch.cat([status, guard(steps, dirty, model, gain)])


def _on(factor, device):
    """A float, or a 0-d tensor copied to ``device``."""
    return factor.to(device) if torch.is_tensor(factor) else factor


class RowSteps:
    """:class:`ImageSteps` on images spread by rows: the FFT convolutions
    as slab FFTs (``ker``, a :class:`~radler_tpu_torch.parallel.rows.
    SlabSpectrum`), the decompose in B3's row-block mode, the dot products
    as each part's, added on the lead in part order, the scaled sums on
    each part with the factor copied to its device."""

    def __init__(self, ker, mask, n_scales: int, lead: torch.device):
        self.ker, self.mask, self.n_scales = ker, mask, n_scales
        self.device = lead

    def convolve(self, img):
        return convolve_rows(img, self.ker)

    def forward(self, img):
        return decompose_rows(self.convolve(img), self.n_scales).map(
            apply_mask, self.mask)

    def recompose(self, scales):
        return recompose_rows(scales, self.n_scales, False)

    def dot(self, a, b):
        total = torch.vdot(a.parts[0].reshape(-1), b.parts[0].reshape(-1))
        for p, q in zip(a.parts[1:], b.parts[1:]):
            total = total + torch.vdot(p.reshape(-1),
                                       q.reshape(-1)).to(self.device)
        return total

    def sum_sq(self, x):
        return self.dot(x, x)

    def rms(self, x):
        return torch.sqrt(self.dot(x, x)
                          / (x.layout.height * x.parts[0].shape[-1]))

    @staticmethod
    def sub(x, y):
        return x.map(torch.sub, y)

    @staticmethod
    def add_scaled(x, factor, y):
        return x.map(lambda xp, yp: xp + _on(factor, xp.device) * yp, y)

    @staticmethod
    def sub_scaled(x, factor, y):
        return x.map(lambda xp, yp: xp - _on(factor, xp.device) * yp, y)

    @staticmethod
    def zeros_like(x):
        return x.like(0.0)
