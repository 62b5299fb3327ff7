"""Multiscale CLEAN's minor loop with a spectral-domain residual.

Port of ``radler_tpu.models.multiscale_fused``.  The host path
(:mod:`radler_tpu_torch.models.multiscale`) re-transforms the residual on
every outer iteration for the scale maxima and the scale-convolved cube, and
corrects it with inverse transforms.  :func:`fused_multiscale_minor_loop`
restructures that work as the JAX package's single-program loop does:

* **The residual cube lives in the Fourier domain** (``res_f``, at one
  padded size).  The scale maxima are S inverse transforms of the
  integrated spectrum times the kernel spectra (no forward transform), the
  scale-convolved cube N inverse transforms, and the residual correction a
  spectral multiply-subtract with no inverse transform.  Inside the image
  region the residual is the host path's; the padding margin gathers the
  wrapped tails that the reference re-zeroes, outside every search window.
* **The correction spectra are factored**: the spectrum of
  ``kernel_s ⊛ psf_c`` is ``kernel_f[s] * psf_f[c]``, so S + C planes are
  stored instead of S·C.
* **Components are tracked in the spectral fit's coefficient space** when
  the fit is a linear projection (polynomial mode): T·P coefficient planes
  instead of N channel planes, so the correction does T·P forward
  transforms (2 for a 2-term fit of 8 channels, where the host path does 8).
* **Two padded sizes**: the small one serves the scales whose own
  convolution size is close to the smallest scale's; the rarely selected
  large scales correct at the large size in image space and re-sync
  ``res_f``.

The dense subminor loop at a fixed scale is :func:`dense_subminor_loop`, the
Clark subminor loop run as a *dense masked clean* over the scale-convolved
cube (the candidate-set restriction is an optimization, not a semantic
requirement: both subtract the twice-convolved PSF and stop at the same
threshold, ``subminor_loop.h:17-50``).  Each iteration is the Högbom kernel
launch of :mod:`radler_tpu_torch.kernels.hogbom_step` (B1) in its *linear*
integration mode (``SubMinorModel::GetMaxComponent``,
``subminor_loop.cc:13-36``) with the search weight plane, through
:func:`~radler_tpu_torch.kernels.hogbom_step.hogbom_loop`; on a device mesh
it is :func:`~radler_tpu_torch.parallel.mesh.mesh_hogbom_loop` in the same
mode (B4 on every shard with a channel split, B1 on row shards without).

The JAX loop runs on the device as one program.  Here the host drives the
outer loop: it reads the scale maxima once per outer pass (one tensor) and
takes the loop's decisions (the scale, the thresholds, the countdown, the
activation) in float32 NumPy scalars in the JAX package's order, which round
as its device does.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..image_set import CubeMeta, linear_integration_coefficients
from ..kernels.hogbom_step import (
    FacetLoopParams,
    LoopParams,
    drive,
    facet_hogbom_steps,
    hogbom_loop,
)
from ..ops.convolution import forward_fft2_padded, inverse_fft2_real_trimmed
from ..ops.peak_finder import FLT_MIN
from ..parallel.mesh import mesh_hogbom_loop
from ..settings import SpectralFittingMode
from ..utils.device_consts import device_const
from ..utils.profiling import annotate

f32 = np.float32


class FusedMultiscaleResult(NamedTuple):
    residual: torch.Tensor  # [N, H, W]
    model: torch.Tensor  # [N, H, W]
    iteration_number: int
    final_biased_peak: float  # signed: value * bias at the best scale
    final_scale: int
    any_peak_found: bool  # a peak existed at loop exit
    diverging: bool
    no_components: bool  # a subminor pass cleaned nothing
    is_final_threshold: bool  # stopped at the absolute threshold
    components_per_scale: list  # [S] ints
    flux_per_scale: torch.Tensor  # [S] float32, on the device
    mask_acc: Optional[torch.Tensor]  # [S, H, W] bool (track_masks)
    comp_acc: Dict[int, torch.Tensor]  # scale -> [N, H, W] (track_components)


def _coefficient_basis(fitter, meta: CubeMeta) -> Optional[np.ndarray]:
    """Expansion matrix E [N, T*P] with ``component_plane = E @ coef_planes``
    when the fitter is a linear projection (polynomial mode), else None.

    For polynomial fitting ``fitted = design @ (fit_matrix @ values)`` per
    polarization, so accumulated fitted values live in the column space of
    ``design`` [C, T]; plane ``n = c*P + p`` maps to coefficient plane
    ``k = t*P + p`` with weight ``design[c, t]``.
    """
    if (
        fitter is None
        or not fitter.is_active
        or fitter.mode != SpectralFittingMode.POLYNOMIAL
        or fitter._design is None
    ):
        return None
    C, P = meta.n_channels, meta.n_polarizations
    design = np.asarray(fitter._design, np.float32)  # [C, T]
    T = design.shape[1]
    E = np.zeros((C * P, T * P), np.float32)
    for c in range(C):
        for p in range(P):
            for t in range(T):
                E[c * P + p, t * P + p] = design[c, t]
    return E


def dense_subminor_loop(
    conv_res: torch.Tensor,  # [N, H, W] scale-convolved residual, in place
    psfs: torch.Tensor,  # [C, H, W] twice-convolved PSFs at image size
    weight: torch.Tensor,  # [H, W] window x mask x rms weight
    rms_factor: Optional[torch.Tensor],  # [H, W] rms factor, or None
    threshold: float,
    gain: float,
    start_iteration: int,
    max_iterations: int,
    divergence_limit: float,
    peak0: Tuple[float, int, int, bool],  # (value, x, y, found)
    *,
    meta: CubeMeta,
    allow_negative: bool,
    stop_on_negative: bool,
    fitter=None,
    plain: bool = False,
    coefficients: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, int, float, bool, bool]:
    """One dense Clark subminor pass at a fixed scale.

    Each iteration fits the peak values (``fitter.fit_and_evaluate``),
    multiplies them by ``gain`` and adds them into the component cube; the
    step subtracts the shifted PSFs and finds the next peak of the linear
    integration times ``weight``, whose signed value (times the rms factor
    when one is given) is tested against ``threshold`` and against
    ``|value0| * divergence_limit``.  The loop stops at the threshold, at
    ``max_iterations`` or, with ``stop_on_negative``, at a negative peak.
    Returns ``(conv_res, comp, iteration, value, found, diverging)``.

    ``coefficients`` = ``(fit_m, E)`` fits in coefficient space instead and
    returns the ``[T*P, H, W]`` coefficient cube as ``comp`` (the fused
    loop's form).  ``mesh`` runs the pass partitioned over a device mesh.
    CUDA tensors run the kernels (``plain`` runs their plain versions
    instead, for comparison); CPU tensors run the plain versions.
    """
    n_comp = (conv_res.shape[0] if coefficients is None
              else coefficients[1].shape[1])
    comp = torch.zeros((n_comp,) + tuple(conv_res.shape[1:]),
                       dtype=conv_res.dtype, device=conv_res.device)
    params = LoopParams.make(gain, threshold, abs(peak0[0]), divergence_limit,
                             max_iterations, stop_on_negative)
    args = (conv_res, comp, psfs.contiguous(), weight.contiguous(),
            rms_factor.contiguous() if rms_factor is not None else None,
            peak0, params, start_iteration)
    kwargs = dict(
        meta=meta, allow_negative=allow_negative, fitter=fitter, plain=plain,
        integration=("linear", linear_integration_coefficients(meta)),
        coefficients=coefficients,
    )
    if mesh is not None:
        out = mesh_hogbom_loop(mesh, *args, **kwargs)
    else:
        out = hogbom_loop(*args, **kwargs)
    return conv_res, comp, out.iteration, out.value, out.found, out.diverging


def mesh_subminor_eligible(mesh, meta: CubeMeta, height: int,
                           fitter) -> bool:
    """Whether the fused loop's dense subminor runs partitioned over
    ``mesh`` (``multiscale.py:1213-1229`` of the JAX package, without its
    128-lane TPU gate): the planes divide over ``"chan"``, the rows over
    ``"tile"`` into shards of a multiple of 8 rows (the route the JAX
    package takes), and the fit is absent or a linear projection."""
    if mesh is None or mesh.size == 1:
        return False
    return (
        meta.n_images % mesh.chan == 0
        and height % mesh.tile == 0
        and (height // mesh.tile) % 8 == 0
        and (fitter is None or _coefficient_basis(fitter, meta) is not None)
    )


def _select_scale(vals: np.ndarray, active: np.ndarray,
                  bias: np.ndarray) -> int:
    """The bias-weighted argmax over active scales, the first of equal
    maxima (float32)."""
    return int(np.argmax(np.where(active, np.abs(vals * bias), -np.inf)))


# The steps of one outer pass.  Each is a module function, so that a
# profiler can wrap it.


def expand_planes(planes: torch.Tensor, expand: Optional[torch.Tensor],
                  batch_dims: int = 0) -> torch.Tensor:
    """Coefficient planes ``[..., T*P, ...]`` to cube planes ``[..., N,
    ...]`` (``expand @ planes`` along the axis after the first
    ``batch_dims`` ones, the facet axis of the batched facets); the planes
    themselves without a basis."""
    if expand is None:
        return planes
    lead = tuple(planes.shape[:batch_dims])
    flat = planes.reshape(lead + (planes.shape[batch_dims], -1))
    return torch.matmul(expand.to(planes.dtype), flat).reshape(
        lead + (expand.shape[0],) + tuple(planes.shape[batch_dims + 1:]))


def spectral_scale_maxima(res_f: torch.Tensor, lin: torch.Tensor,
                          kernel_f: torch.Tensor, padded: Tuple[int, int],
                          valid_stack: torch.Tensor,
                          rms_factor: Optional[torch.Tensor],
                          allow_negative: bool, read: bool = True):
    """Every scale's masked, weighted peak (``FindActiveScaleConvolved
    Maxima``, ``multiscale_algorithm.cc:578-634``) from the integrated
    spectrum: S inverse transforms and no forward one, then one host read.
    Returns float32 values, x, y and found, each ``[S]`` on the host.

    Batched over facets, ``res_f`` is ``[F, N, ...]``, ``valid_stack``
    ``[F, S, H, W]``, ``rms_factor`` ``[F, H, W]``, and each output ``[F,
    S]``, still one host read.  With ``read`` false it returns the
    ``[4, ...]`` float64 tensor on the device for :func:`maxima_on_host`."""
    S, (H, W) = kernel_f.shape[0], valid_stack.shape[-2:]
    batched = res_f.dim() == 4
    integ_f = torch.einsum("n,fnhw->fhw" if batched else "n,nhw->hw",
                           lin.to(res_f.dtype), res_f)
    conv = inverse_fft2_real_trimmed(integ_f.unsqueeze(-3) * kernel_f,
                                     padded, (H, W))
    weighted = (conv * rms_factor.unsqueeze(-3) if rms_factor is not None
                else conv)
    cmp = weighted.abs() if allow_negative else weighted
    lead = tuple(conv.shape[:-2])
    masked = torch.where(valid_stack, cmp, -math.inf).reshape(lead + (H * W,))
    idx = torch.argmax(masked, dim=-1, keepdim=True)
    found = torch.gather(masked, -1, idx)[..., 0] > FLT_MIN
    vals = torch.where(
        found, torch.gather(weighted.reshape(lead + (H * W,)), -1,
                            idx)[..., 0], 0.0)
    idx = idx[..., 0]
    out = torch.stack([vals.double(), (idx % W).double(),
                       (idx // W).double(), found.double()])
    return maxima_on_host(out) if read else out


def maxima_on_host(maxima: torch.Tensor):
    """:func:`spectral_scale_maxima`'s device tensor, read: float32 values,
    x, y and found."""
    host = maxima.cpu().numpy()
    return (host[0].astype(f32), host[1].astype(np.int64),
            host[2].astype(np.int64), host[3] != 0.0)


def scale_convolved_cube(res_f: torch.Tensor, kernel_f_s: torch.Tensor,
                         padded: Tuple[int, int],
                         shape: Tuple[int, int]) -> torch.Tensor:
    """The scale-convolved residual cube (``multiscale_algorithm.cc:
    345-354``): N inverse transforms and no forward one.  ``kernel_f_s`` is
    the scale's spectrum, or ``[F, ...]`` one a facet for ``[F, N, ...]``
    (each facet at its own scale)."""
    return inverse_fft2_real_trimmed(res_f * kernel_f_s.unsqueeze(-3),
                                     padded, shape).contiguous()


def correct_small(res_f: torch.Tensor, model: torch.Tensor,
                  comp: torch.Tensor, kernel_f_s: torch.Tensor,
                  psf_f_planes: torch.Tensor, padded: Tuple[int, int],
                  expand: Optional[torch.Tensor]) -> None:
    """A small-size scale's correction, in place: the model gains the
    scale-convolved components, and the spectral residual loses their
    convolution with the PSFs, a spectral subtraction (the spectrum of
    ``kernel_s ⊛ psf_c`` is ``kernel_f[s] * psf_f[c]``).  Batched over
    facets, every argument gains a leading facet axis (``kernel_f_s`` and
    ``psf_f_planes`` may stay shared)."""
    batch = model.dim() - 3
    k = kernel_f_s.unsqueeze(-3)
    comp_f = forward_fft2_padded(comp, padded)  # [..., Tn, ...]
    model.add_(expand_planes(inverse_fft2_real_trimmed(
        comp_f * k, padded, model.shape[-2:]), expand, batch))
    res_f.sub_(expand_planes(comp_f, expand, batch) * psf_f_planes * k)


def correct_large(res_f: torch.Tensor, model: torch.Tensor,
                  comp: torch.Tensor, kernel_f_s: torch.Tensor,
                  psf_f_planes: torch.Tensor, padded_small: Tuple[int, int],
                  padded_large: Tuple[int, int],
                  expand: Optional[torch.Tensor]) -> None:
    """A large-size scale's correction, in place: in image space at the
    large size, then the spectral residual re-synced from the delta
    (batched as :func:`correct_small`)."""
    batch = model.dim() - 3
    shape = model.shape[-2:]
    k = kernel_f_s.unsqueeze(-3)
    comp_f = forward_fft2_padded(comp, padded_large)  # [..., Tn, ...]
    model.add_(expand_planes(inverse_fft2_real_trimmed(
        comp_f * k, padded_large, shape), expand, batch))
    delta = inverse_fft2_real_trimmed(
        expand_planes(comp_f, expand, batch) * psf_f_planes * k,
        padded_large, shape)  # [..., N, H, W]
    res_f.sub_(forward_fft2_padded(delta, padded_small))


def fused_multiscale_minor_loop(
    residual: torch.Tensor,  # [N, H, W]
    model: torch.Tensor,  # [N, H, W]
    kernel_f: torch.Tensor,  # [S, Ph, Pw//2+1] scale-kernel spectra, small
    twice_psfs: torch.Tensor,  # [S, C, H, W] twice-convolved PSFs
    psf_f: torch.Tensor,  # [C, Ph, Pw//2+1] PSF spectra, small size
    kernel_f_large: Optional[torch.Tensor],  # [S - split, ...] or None
    psf_f_large: Optional[torch.Tensor],  # [C, PhL, PwL//2+1] or None
    valid_stack: torch.Tensor,  # [S, H, W] bool searchable windows
    rms_factor: Optional[torch.Tensor],  # [H, W] or None
    bias: np.ndarray,  # [S] float32
    gain_arr: np.ndarray,  # [S] float32
    threshold: float,  # the final (absolute) threshold
    major_iteration_threshold: float,
    major_loop_gain: float,
    sub_loop_gain: float,
    minor_loop_gain: float,
    divergence_limit: float,
    start_iteration: int,
    max_iterations: int,
    countdown0: int,
    *,
    meta: CubeMeta,
    allow_negative: bool,
    stop_on_negative: bool,
    fitter,
    split: int,
    padded_small: Tuple[int, int],
    padded_large: Tuple[int, int],
    track_masks: bool = False,
    track_components: bool = False,
    mesh=None,
) -> FusedMultiscaleResult:
    """One major iteration's minor loop (``multiscale_fused.py:476-931`` of
    the JAX package, ``multiscale_algorithm.cc:286-543`` of the reference).

    Scales ``[0, split)`` correct at ``padded_small``, the size of
    ``res_f``; scales ``[split, S)`` at ``padded_large``.  ``mesh`` (from
    :func:`mesh_subminor_eligible`) partitions the dense subminor loop.
    """
    N, H, W = residual.shape
    S = kernel_f.shape[0]
    dev = residual.device
    P = meta.n_polarizations
    lin = device_const(linear_integration_coefficients(meta), dev)
    bias = np.asarray(bias, f32)
    gain_arr = np.asarray(gain_arr, f32)
    threshold, major_iteration_threshold = f32(threshold), f32(
        major_iteration_threshold)
    major_loop_gain, sub_loop_gain = f32(major_loop_gain), f32(sub_loop_gain)
    minor_loop_gain, divergence_limit = f32(minor_loop_gain), f32(
        divergence_limit)
    one = f32(1.0)

    # Coefficient-space component tracking (see the module docstring).
    E_np = _coefficient_basis(fitter, meta)
    coefficients = expand = None
    if E_np is not None:
        expand = device_const(E_np, dev)  # [N, Tn]
        coefficients = (device_const(fitter._fit_matrix, dev), expand)

    # Per-plane PSF spectra (plane n takes channel n // P's PSF).
    psf_idx = torch.arange(N, device=dev) // P

    def per_plane(spectra: torch.Tensor) -> torch.Tensor:
        return spectra if P == 1 else spectra.index_select(0, psf_idx)

    psf_planes = per_plane(psf_f)
    psf_planes_large = per_plane(psf_f_large) if split < S else None

    # The residual cube in the Fourier domain at the small padded size.
    res_f = forward_fft2_padded(residual, padded_small)

    def find_maxima(res_f: torch.Tensor):
        with annotate("multiscale.maxima"):
            return spectral_scale_maxima(res_f, lin, kernel_f, padded_small,
                                         valid_stack, rms_factor,
                                         allow_negative)

    # Thresholds (multiscale_algorithm.cc:286-321), in float32.
    vals, xs, ys, found = find_maxima(res_f)
    biased0 = np.abs(vals * bias)
    initial_peak = biased0[int(np.argmax(biased0))]  # all scales active
    m_gain_threshold = max(initial_peak * (one - major_loop_gain),
                           major_iteration_threshold)
    first_threshold = max(m_gain_threshold, threshold)
    is_final_threshold = bool(threshold > m_gain_threshold)
    any_found0 = bool(found.any())

    mod = model.clone()
    it, countdown = int(start_iteration), int(countdown0)
    active = np.ones(S, bool)
    ncomp = [0] * S
    flux = torch.zeros(S, dtype=torch.float32, device=dev)
    div = nocomp = False
    mask_acc = (torch.zeros((S, H, W), dtype=torch.bool, device=dev)
                if track_masks else None)
    comp_acc: Dict[int, torch.Tensor] = {}

    while True:
        s = _select_scale(vals, active, bias)
        if not (
            it < max_iterations
            and abs(vals[s] * bias[s]) > first_threshold
            and (not stop_on_negative or vals[s] >= 0.0)
            and countdown > 0
            and not div
            and not nocomp
            and any_found0
        ):
            break
        # The pass's host decisions, scale convolution and flux sums are
        # its span's self time.
        with annotate("multiscale.pass"):
            biased_peak = abs(vals[s] * bias[s])
            sub_gain_threshold = biased_peak * (one - sub_loop_gain)
            countdown -= int(first_threshold > sub_gain_threshold)
            thr_sub = max(sub_gain_threshold, first_threshold) / bias[s]

            conv_res = scale_convolved_cube(res_f, kernel_f[s], padded_small,
                                            (H, W))
            weight = valid_stack[s].to(torch.float32)
            if rms_factor is not None:
                weight = weight * rms_factor

            it_before = it
            with annotate("multiscale.dense"):
                _, comp, it, value, _, sub_div = dense_subminor_loop(
                    conv_res, twice_psfs[s], weight, rms_factor,
                    float(thr_sub), float(gain_arr[s]), it, max_iterations,
                    float(divergence_limit),
                    (float(vals[s]), int(xs[s]), int(ys[s]), bool(found[s])),
                    meta=meta, allow_negative=allow_negative,
                    stop_on_negative=stop_on_negative, fitter=fitter,
                    coefficients=coefficients, mesh=mesh,
                )
            nocomp = it == it_before
            div = bool(sub_div) or bool(
                divergence_limit != 0.0
                and abs(f32(value)) > initial_peak * divergence_limit)

            with annotate("multiscale.correct"):
                if s < split:
                    correct_small(res_f, mod, comp, kernel_f[s], psf_planes,
                                  padded_small, expand)
                else:
                    correct_large(res_f, mod, comp, kernel_f_large[s - split],
                                  psf_planes_large, padded_small, padded_large,
                                  expand)

            ncomp[s] += it - it_before
            flux[s] += expand_planes(comp.sum(dim=(1, 2)), expand).sum()
            if track_masks:
                mask_acc[s] |= torch.any(comp != 0.0, dim=0)
            if track_components:
                planes = expand_planes(comp, expand)
                comp_acc[s] = (planes if s not in comp_acc
                               else comp_acc[s] + planes)

            # Scale (de)activation uses the maxima before the refresh
            # (multiscale_algorithm.cc:636-656) ...
            act_thr = abs(vals[s]) * (one - minor_loop_gain) * bias[s]
            active = (np.arange(S) == s) | (np.abs(vals * bias) > act_thr)
            # ... then every scale's maxima are refreshed.
            vals, xs, ys, found = find_maxima(res_f)

    res_out = inverse_fft2_real_trimmed(res_f, padded_small,
                                        (H, W)).contiguous()
    s_final = _select_scale(vals, active, bias)
    return FusedMultiscaleResult(
        residual=res_out,
        model=mod,
        iteration_number=it,
        final_biased_peak=float(vals[s_final] * bias[s_final]),
        final_scale=s_final,
        any_peak_found=any_found0 and bool(found.any()),
        diverging=div,
        no_components=nocomp,
        is_final_threshold=is_final_threshold,
        components_per_scale=ncomp,
        flux_per_scale=flux,
        mask_acc=mask_acc,
        comp_acc=comp_acc,
    )



class FacetFusedResult(NamedTuple):
    """:class:`FusedMultiscaleResult` of F facets: each list holds one entry
    a facet."""

    residual: torch.Tensor  # [F, N, H, W]
    model: torch.Tensor  # [F, N, H, W]
    iteration_number: list
    final_biased_peak: list
    any_peak_found: list
    diverging: list
    no_components: list
    is_final_threshold: list
    components_per_scale: np.ndarray  # [F, S] ints
    mask_acc: Optional[torch.Tensor]  # [F, S, H, W] bool (track_masks)
    comp_acc: Dict[int, torch.Tensor]  # scale -> [F, N, H, W]
    lockstep: int  # the dense loops' lockstep iterations, summed


def _take(t: torch.Tensor, rows) -> torch.Tensor:
    """``t[rows]`` along the first axis: ``t`` itself when ``rows`` is
    every row in order, else a stacked copy (indexing by a host list
    without a host-to-device copy of the indices)."""
    if list(rows) == list(range(t.shape[0])):
        return t
    return torch.stack([t[i] for i in rows])


def _pick(bank: torch.Tensor, keys) -> torch.Tensor:
    """``bank[key]`` shared when every key is the same, else stacked one a
    key."""
    if len(set(keys)) == 1:
        return bank[keys[0]]
    return torch.stack([bank[k] for k in keys])


def facet_fused_multiscale_minor_loop(*args, **kwargs) -> FacetFusedResult:
    """:func:`facet_fused_multiscale_steps` run to its end on one device."""
    return drive(facet_fused_multiscale_steps(*args, **kwargs))


def facet_fused_multiscale_steps(
    residual: torch.Tensor,  # [F, N, H, W]
    model: torch.Tensor,  # [F, N, H, W]
    kernel_f: torch.Tensor,  # [S, Ph, Pw//2+1] scale-kernel spectra, small
    twice_psfs: torch.Tensor,  # [U, S, C, H, W] twice-convolved PSFs
    psf_f: torch.Tensor,  # [U, C, Ph, Pw//2+1] PSF spectra, small size
    kernel_f_large: Optional[torch.Tensor],  # [S - split, ...] or None
    psf_f_large: Optional[torch.Tensor],  # [U, C, PhL, PwL//2+1] or None
    slots,  # [F]: each facet's PSF bank in U
    valid_stack: torch.Tensor,  # [F, S, H, W] bool searchable windows
    rms_factor: Optional[torch.Tensor],  # [F, H, W] or None
    bias: np.ndarray,  # [F, S] float32
    gain_arr: np.ndarray,  # [F, S] float32
    threshold: float,
    major_iteration_threshold: float,
    major_loop_gain: float,
    sub_loop_gain: float,
    minor_loop_gain: float,
    divergence_limit: float,
    start_iterations,  # [F]
    max_iterations,  # [F]
    countdown0: int,
    *,
    meta: CubeMeta,
    allow_negative: bool,
    stop_on_negative: bool,
    fitter,
    split: int,
    padded_small: Tuple[int, int],
    padded_large: Tuple[int, int],
    boxes,  # [F] (rows, columns): each facet's true box, top left
    forced_terms: Optional[torch.Tensor] = None,  # [F, T-1, H, W]
    track_masks: bool = False,
    track_components: bool = False,
) -> FacetFusedResult:
    """:func:`fused_multiscale_minor_loop` on F facets of a common box at
    once, the JAX package's loop vmapped over facets (``multiscale.py:
    1388-1641``): every outer pass reads all facets' scale maxima in one
    host read, takes each facet's decisions in float32 on ``[F]`` and ``[F,
    S]`` arrays in the JAX order, and runs the dense subminor loops of the
    facets still going as one :func:`~radler_tpu_torch.kernels.hogbom_step.
    facet_hogbom_loop` (B1's facet mode in linear mode, each facet at its
    own scale, over its true box).  A facet that has stopped is left out
    of the passes, so its state stays as it was.

    The banks are shared (``U`` = 1) or, with direction-dependent PSFs,
    one a unique PSF, each facet's picked by ``slots``.  The spectral
    residual covers the common box; its padding, outside every search
    window, gathers the wrapped tails as the single cube's margin does.

    A generator, as :func:`~radler_tpu_torch.kernels.hogbom_step.
    facet_hogbom_steps` is: it yields before each host read (the scale
    maxima and the dense loops' states), so that the host keeps several
    cards' loops going; its value is the :class:`FacetFusedResult`."""
    F, N, H, W = residual.shape
    S = kernel_f.shape[0]
    dev = residual.device
    P = meta.n_polarizations
    lin_np = linear_integration_coefficients(meta)
    lin = device_const(lin_np, dev)
    bias = np.asarray(bias, f32).reshape(F, S)
    gain_arr = np.asarray(gain_arr, f32).reshape(F, S)
    threshold, major_iteration_threshold = f32(threshold), f32(
        major_iteration_threshold)
    major_loop_gain, sub_loop_gain = f32(major_loop_gain), f32(sub_loop_gain)
    minor_loop_gain, divergence_limit = f32(minor_loop_gain), f32(
        divergence_limit)
    one = f32(1.0)
    slots = [int(u) for u in slots]
    every = list(range(F))

    E_np = _coefficient_basis(fitter, meta)
    coefficients = expand = None
    loop_fitter = fitter
    if E_np is not None:
        expand = device_const(E_np, dev)
        coefficients = (device_const(fitter._fit_matrix, dev), expand)
        loop_fitter = None
    n_comp = N if expand is None else expand.shape[1]

    psf_idx = torch.arange(N, device=dev) // P

    def per_plane(spectra: torch.Tensor) -> torch.Tensor:
        return spectra if P == 1 else spectra.index_select(-3, psf_idx)

    psf_planes = per_plane(psf_f)  # [U, N, ...]
    psf_planes_large = per_plane(psf_f_large) if split < S else None

    # Every transform and spectral product runs a facet at a time, so that
    # a facet's bits do not depend on the facets beside it and are the
    # same on one device and spread over several: on the CPU a batch's
    # bits depend on its size (pocketfft and the vectorized kernels take
    # some lines in vector lanes and the rest alone, which round apart).
    # On an H100 a batch gives each facet its bits, but a facet at a time
    # holds one facet's FFT transients: 9.75 GB at config 5 against 13.9
    # GB batched, for 0-8.5% more time in the loop's own steps (PERF.md,
    # PR 15).
    res_f = torch.cat([forward_fft2_padded(residual[f:f + 1], padded_small)
                       for f in every])  # [F, N, ...]
    mod = model.clone()
    vals = np.zeros((F, S), f32)
    xs = np.zeros((F, S), np.int64)
    ys = np.zeros((F, S), np.int64)
    found = np.zeros((F, S), bool)

    def find_maxima(facets):
        maxima = torch.cat([spectral_scale_maxima(
            res_f[f:f + 1], lin, kernel_f, padded_small,
            valid_stack[f:f + 1],
            None if rms_factor is None else rms_factor[f:f + 1],
            allow_negative, read=False) for f in facets], dim=1)
        yield
        out = maxima_on_host(maxima)
        for i, f in enumerate(facets):
            vals[f], xs[f], ys[f], found[f] = (o[i] for o in out)

    # Thresholds (multiscale_algorithm.cc:286-321), in float32.
    yield from find_maxima(every)
    biased0 = np.abs(vals * bias)
    initial_peak = biased0[np.arange(F), np.argmax(biased0, axis=1)]
    m_gain_threshold = np.maximum(initial_peak * (one - major_loop_gain),
                                  major_iteration_threshold)
    first_threshold = np.maximum(m_gain_threshold, threshold)
    is_final_threshold = [bool(threshold > m) for m in m_gain_threshold]
    any_found0 = found.any(axis=1)

    it = [int(v) for v in start_iterations]
    max_iterations = [int(v) for v in max_iterations]
    countdown = [int(countdown0)] * F
    active = np.ones((F, S), bool)
    ncomp = np.zeros((F, S), np.int64)
    div, nocomp = [False] * F, [False] * F
    mask_acc = (torch.zeros((F, S, H, W), dtype=torch.bool, device=dev)
                if track_masks else None)
    comp_acc: Dict[int, torch.Tensor] = {}
    integration = ("linear", lin_np)
    lockstep = 0

    while True:
        sel = [_select_scale(vals[f], active[f], bias[f]) for f in every]
        run = [
            f for f in every
            if it[f] < max_iterations[f]
            and abs(vals[f, sel[f]] * bias[f, sel[f]]) > first_threshold[f]
            and (not stop_on_negative or vals[f, sel[f]] >= 0.0)
            and countdown[f] > 0
            and not div[f]
            and not nocomp[f]
            and any_found0[f]
        ]
        if not run:
            break
        scales = [sel[f] for f in run]
        thr_sub = []
        for f, s in zip(run, scales):
            biased_peak = abs(vals[f, s] * bias[f, s])
            sub_gain_threshold = biased_peak * (one - sub_loop_gain)
            countdown[f] -= int(first_threshold[f] > sub_gain_threshold)
            thr_sub.append(max(sub_gain_threshold, first_threshold[f])
                           / bias[f, s])

        conv_res = torch.cat([
            scale_convolved_cube(res_f[f:f + 1], kernel_f[s], padded_small,
                                 (H, W)) for f, s in zip(run, scales)])
        psfs = _pick(twice_psfs, [(slots[f], s) for f, s in zip(run, scales)])
        weight = torch.stack([valid_stack[f, s] for f, s in zip(run, scales)]
                             ).to(torch.float32)
        rms_run = None
        if rms_factor is not None:
            rms_run = _take(rms_factor, run)
            weight = weight * rms_run
        comp = torch.zeros((len(run), n_comp, H, W), dtype=conv_res.dtype,
                           device=dev)
        it_before = [it[f] for f in run]
        loop = yield from facet_hogbom_steps(
            conv_res, comp,
            psfs if psfs.dim() == 3 else psfs.contiguous(),
            weight.contiguous(), rms_run,
            [(float(vals[f, s]), int(xs[f, s]), int(ys[f, s]),
              bool(found[f, s])) for f, s in zip(run, scales)],
            FacetLoopParams.make(
                [gain_arr[f, s] for f, s in zip(run, scales)], thr_sub,
                [abs(vals[f, s]) for f, s in zip(run, scales)],
                divergence_limit, [max_iterations[f] for f in run],
                stop_on_negative, dev),
            it_before,
            meta=meta, allow_negative=allow_negative, fitter=loop_fitter,
            forced_terms=(None if forced_terms is None
                          else _take(forced_terms, run)),
            boxes=torch.tensor([boxes[f] for f in run], dtype=torch.int32),
            integration=integration, coefficients=coefficients,
        )
        lockstep += loop.lockstep
        for i, (f, s) in enumerate(zip(run, scales)):
            out = loop.results[i]
            it[f] = out.iteration
            nocomp[f] = it[f] == it_before[i]
            div[f] = bool(out.diverging) or bool(
                divergence_limit != 0.0
                and abs(f32(out.value)) > initial_peak[f] * divergence_limit)
            ncomp[f, s] += it[f] - it_before[i]

        # The corrections, in place on each facet's views.
        for i, (f, s) in enumerate(zip(run, scales)):
            if s < split:
                correct_small(res_f[f:f + 1], mod[f:f + 1], comp[i:i + 1],
                              kernel_f[s], psf_planes[slots[f]],
                              padded_small, expand)
            else:
                correct_large(res_f[f:f + 1], mod[f:f + 1], comp[i:i + 1],
                              kernel_f_large[s - split],
                              psf_planes_large[slots[f]], padded_small,
                              padded_large, expand)

        if track_masks:
            for i, (f, s) in enumerate(zip(run, scales)):
                mask_acc[f, s] |= torch.any(comp[i] != 0.0, dim=0)
        if track_components:
            planes = expand_planes(comp, expand, 1)
            for i, (f, s) in enumerate(zip(run, scales)):
                if s not in comp_acc:
                    comp_acc[s] = torch.zeros((F, N, H, W), device=dev)
                comp_acc[s][f] += planes[i]

        # Scale (de)activation uses the maxima before the refresh
        # (multiscale_algorithm.cc:636-656) ...
        for f, s in zip(run, scales):
            act_thr = abs(vals[f, s]) * (one - minor_loop_gain) * bias[f, s]
            active[f] = (np.arange(S) == s) | (np.abs(vals[f] * bias[f])
                                               > act_thr)
        # ... then the running facets' maxima are refreshed.
        yield from find_maxima(run)

    res_out = torch.cat([
        inverse_fft2_real_trimmed(res_f[f:f + 1], padded_small, (H, W))
        for f in every]).contiguous()
    s_final = [_select_scale(vals[f], active[f], bias[f]) for f in every]
    return FacetFusedResult(
        residual=res_out,
        model=mod,
        iteration_number=it,
        final_biased_peak=[float(vals[f, s] * bias[f, s])
                           for f, s in zip(every, s_final)],
        any_peak_found=[bool(any_found0[f] and found[f].any())
                        for f in every],
        diverging=div,
        no_components=nocomp,
        is_final_threshold=is_final_threshold,
        components_per_scale=ncomp,
        mask_acc=mask_acc,
        comp_acc=comp_acc,
        lockstep=lockstep,
    )
