"""The Clark subminor loop: CUDA kernel, its plain version, the result.

Port of ``radler_tpu.ops.pallas.subminor_fused`` (the TPU kernel
``_loop_kernel`` behind ``subminor_loop_fused``).  :func:`subminor_loop`
runs the whole ``SubMinorLoop::Run`` while-loop over the ``[N, K]``
candidate state in one launch of ``csrc/subminor_loop.cu`` on CUDA tensors,
and its plain PyTorch version :func:`subminor_loop_reference` on CPU
tensors.  The launch is one thread-block cluster (it needs a card of
compute capability 9.0 or later) whose blocks each keep a slice of the
candidates in shared memory, or, where ``N * K`` is above
``GRID_VALUES``, a cooperative grid of one block a multiprocessor (the
grid route); :func:`cluster_plan` chooses the route, the cluster's size
and the state's place from ``N``, ``K`` and the card's multiprocessor
count (:func:`sm_count`).  Both versions
update ``residual_k`` and ``model_k`` in place and return a
small int32 tensor ``(iteration, diverging, bits of the last peak value)``
on the state's device, which :func:`read_result` brings to the host in one
read.

:func:`subminor_loop_tiles` is the same loop with a tile axis, the device
mesh's Clark subminor: T independent loops over the segments of a
concatenated ``[N, sum K]`` state, one cluster a segment, in one launch
(its plain version :func:`subminor_loop_tiles_reference` runs the plain loop
over each segment in turn).  It returns ``[T, 3]`` results.

Both apply the spectral fit of :class:`SubminorFit` in the loop's body, as
the JAX package's ``_subminor_while`` does: the polynomial fit's constant
projection (all the TPU kernel applied), or the log-polynomial or
forced-term fit, the forced terms gathered at the candidates.

The kernel reads the PSF at image size where the TPU kernel read a prebuilt
``[C, K, K]`` interaction matrix; what bounds it, and its design, are in the
note at the top of the CUDA source.  The plain version performs the same
float32 operations in the same order (each fused multiply-add emulated
exactly by :func:`fma`, ``log`` and ``exp`` the card's own functions on CUDA
tensors), so the two agree bit for bit.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .hogbom_step import _check, _raise_on

# Planes the kernel takes (csrc/subminor_loop.cu kMaxImages).
MAX_IMAGES = 4000
# Output slots, shared with csrc/subminor_loop.cu.
ITERATION, DIVERGING, VALUE_BITS = range(3)
# The most blocks in the kernel's cluster (kMaxCluster; above 8 the size is
# "non-portable", which the entry point allows explicitly).
MAX_CLUSTER = 16
# Threads per block: at most kMaxThreads, and by the plan not under 128.
MAX_THREADS = 1024
MIN_THREADS = 128
# Candidates of a block that the plan gives one thread, whatever the number
# of planes (a thread walks its candidates' planes in sequence).  At 625
# candidates a block, us per iteration at 128, 256, 512 and 1024 threads:
# 3.67, 2.78, 3.05, 3.30 at 1 plane; 6.21, 4.25, 4.19, 4.49 at 4; 8.50,
# 5.37, 5.37, 5.60 at 8.  At 3750 a block, 1024 threads win at every plane
# count (4.4, 6.2, 9.0 us against 4.9, 7.9, 11.5 at 512).  From
# scripts/subminor_k_times.py, NVIDIA H100 80GB HBM3, 700 W.
CANDIDATES_PER_THREAD = 2.5
# Spectral fits of the loop's body, shared with csrc/subminor_loop.cu
# (FitMode); no fit passes 0.
FIT_PROJECTION, FIT_LOG_POLYNOMIAL, FIT_FORCED_TERMS = 1, 2, 3
# Forced terms that travel in a slot with the raw values (kShipTerms): more
# take the exchange without raw values.
SHIP_RAW_MAX_TERMS = 4
# Planes up to which each block's raw values travel with its argmax, so that
# one cluster barrier per iteration is enough (kShipMax).  A cluster of 16
# gains 0.3 to 0.7 us per iteration by it at 1, 4 and 8 planes; on one
# block the two exchanges lie within 0.1 us of each other, either way by
# the candidate set.  Same script and card.
SHIP_RAW_MAX_IMAGES = 8
# Shared memory a block may hold on the card, and what cluster_plan leaves
# of it for the kernel's static part (about 3 KB).
SHARED_BYTES_PER_BLOCK = 232_448
STATIC_SHARED_RESERVE = 4096
# Crossover of the cluster size, in candidate values (planes times
# candidates: the more planes, the longer a thread's walk, and the sooner
# spreading it pays), from scripts/subminor_k_times.py on an NVIDIA H100
# 80GB HBM3 at 700 W, each cluster size at its best thread count.  At 1000
# candidates: 1 plane 2.3 us per iteration on one block, 2.37 on 16; 4
# planes 3.49 and 3.53; 8 planes 4.94 and 4.54.  At 10,000 candidates, 1, 4
# and 8 planes: 2.8, 4.2, 5.4 us on 16 blocks, 3.1, 4.4, 5.7 on 8, 6.7,
# 16.4, 26.3 on one.  So one block up to about 1000 values and 16 above: a
# cluster of 2 to 8 wins nowhere by more than 0.1 us.  At 80 planes the
# walk over the planes (0.3 us a plane) is most of an iteration: 24.6 us on
# 16 blocks at 100 and at 1000 candidates, 22.1 and 43.6 on one; the 2.5 us
# at 100 candidates are left to the rule.
ONE_BLOCK_VALUES = 1024
# Candidate values (planes times candidates) above which the loop leaves
# one cluster for the grid route: one block on each multiprocessor, a grid
# barrier an iteration.  Us per iteration, cluster against grid, at config
# 2's field (its PSF in L2), one plane: 3.64, 3.67 against 4.17, 4.17 at K
# = 30,003; 4.47, 4.42 against 4.32, 4.27 at 60,218.  At the 8192^2 x 4
# field (the PSFs in HBM): one plane 4.43, 4.22 against 4.69, 4.63 at
# 30,000, 5.15, 4.74 against 4.66, 4.77 at 60,218; four planes 6.70, 6.55
# against 5.91, 5.88 already at 30,000; 23.88, 23.83 against 7.86, 7.87 at
# 168,945; 158.17, 158.00 against 17.00, 16.84 at 1,000,000.  The lines
# cross near 50,000 values.  scripts/subminor_k_times.py routes, NVIDIA
# H100 80GB HBM3, 700 W.
GRID_VALUES = 50_000
# Threads of a grid block at least: with one block a multiprocessor, fewer
# leave the gathers' latency unhidden.  At 457 to 1280 candidates a block
# 512 threads were the fastest of 192 to 1024 (at 457 a block: 6.57, 5.96,
# 5.81, 6.05 us at 192, 256, 512, 1024 threads, one plane); from 2273 a
# block the rule's own count (928, 1024) won.  scripts/subminor_k_times.py
# routes, NVIDIA H100 80GB HBM3, 700 W.
GRID_MIN_THREADS = 512
# Words of a block's slot on the grid route (csrc/subminor_loop.cu
# kSlotWords: cmp, idx, val, x, y, 8 raw values, 4 forced terms).
SLOT_WORDS = 17


class SubminorParams(NamedTuple):
    """Scalars of one subminor run, each rounded to float32 as the device
    compares them."""

    threshold: float
    gain: float
    start_iteration: int
    max_iterations: int
    divergence_limit: float
    allow_negative: bool
    stop_on_negative: bool

    @classmethod
    def make(cls, threshold, gain, start_iteration, max_iterations,
             divergence_limit, allow_negative, stop_on_negative
             ) -> "SubminorParams":
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        return cls(f32(threshold), f32(gain), int(start_iteration),
                   int(max_iterations), f32(divergence_limit),
                   bool(allow_negative), bool(stop_on_negative))


class SubminorFit(NamedTuple):
    """The spectral fit B2 applies to the component values ``cv = res[:, m]
    * gain`` of each iteration, per polarization, as float32 tensors on the
    state's device (``None`` for no fit).  ``mode`` is one of:

    * ``FIT_PROJECTION``: ``cv[c] = sum_c' proj[c, c'] cv[c']`` with the
      polynomial fit's ``proj`` ``[C, C]``;
    * ``FIT_LOG_POLYNOMIAL``: with the fit matrix ``fit_matrix`` F ``[T,
      C]``, the design ``design`` D ``[C, T]`` and the normalised weights
      ``mean_weights`` ``[C]``: ``sign = -1`` where ``sum_c w_c cv[c] < 0``
      (else 1), ``coef = F log(max(|cv|, 1e-36))``, ``cv = sign exp(D
      coef)`` (``_log_poly_fit`` of the fitter);
    * ``FIT_FORCED_TERMS``: with the weights ``weights`` ``[C]``, the
      abscissa powers ``powers`` ``[T-1, C]`` and the term vectors
      ``terms`` ``[T-1, K]`` of the K candidates: ``curve = exp(terms[:,
      m] @ powers)``, ``amp = sum_c w_c curve_c cv[c] / max(sum_c w_c
      curve_c^2, 1e-36)``, ``cv = curve amp`` (``_forced_fit``).

    Every sum runs in channel (or term) order, one fused multiply-add per
    step after the first product."""

    mode: int
    proj: Optional[torch.Tensor] = None
    fit_matrix: Optional[torch.Tensor] = None
    design: Optional[torch.Tensor] = None
    mean_weights: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None
    powers: Optional[torch.Tensor] = None
    terms: Optional[torch.Tensor] = None

    @property
    def n_terms(self) -> int:
        """T: the log-polynomial's terms, or the forced terms plus one."""
        if self.mode == FIT_LOG_POLYNOMIAL:
            return self.fit_matrix.shape[0]
        if self.mode == FIT_FORCED_TERMS:
            return self.powers.shape[0] + 1
        return 0

    @property
    def forced_rows(self) -> int:
        """Forced terms a candidate carries in the slice's state."""
        return self.n_terms - 1 if self.mode == FIT_FORCED_TERMS else 0

    def constants(self) -> Optional[torch.Tensor]:
        """The kernel's constants in one float32 vector (the projection
        stays apart, read from global memory): F, D and the normalised
        weights, or the weights and the powers."""
        if self.mode == FIT_LOG_POLYNOMIAL:
            parts = (self.fit_matrix, self.design, self.mean_weights)
        elif self.mode == FIT_FORCED_TERMS:
            parts = (self.weights, self.powers)
        else:
            return None
        return torch.cat([t.reshape(-1) for t in parts])

    def shared_floats(self, n_images: int) -> int:
        """Floats of shared memory the fit takes beside the per-plane
        scalars: its constants, then the scratch of the exchange without
        raw values (the logs of the N values and a sign and T coefficients
        per polarization; the curve and an amplitude per polarization),
        with N bounding the polarizations.  csrc/subminor_loop.cu::
        fit_shared_floats counts the same."""
        t = self.n_terms
        if self.mode == FIT_LOG_POLYNOMIAL:
            c = self.fit_matrix.shape[1]
            return 2 * t * c + c + n_images * (t + 2)
        if self.mode == FIT_FORCED_TERMS:
            c = self.weights.shape[0]
            return t * c + c + n_images
        return 0


def projection_fit(proj: Optional[torch.Tensor]) -> Optional[SubminorFit]:
    """The polynomial fit's ``[C, C]`` projection as a :class:`SubminorFit`
    (``None`` for none)."""
    return None if proj is None else SubminorFit(FIT_PROJECTION, proj=proj)


class ClusterPlan(NamedTuple):
    """How one launch spreads over its blocks: one cluster of
    ``cluster_size`` blocks, or (``grid_blocks`` > 0) the grid route's
    ``grid_blocks`` blocks in one cooperative launch."""

    cluster_size: int  # blocks R, a power of two up to MAX_CLUSTER; 1: grid
    threads: int       # threads per block, a multiple of 32 up to MAX_THREADS
    slice_len: int     # candidates per block; block b owns [b s, (b + 1) s)
    on_chip: bool      # the slices' state lives in shared memory
    ship_raw: bool     # raw values travel with the argmax: one barrier
    shared_bytes: int  # dynamic shared memory per block
    grid_blocks: int = 0  # the grid route's blocks; 0: the cluster route


def sm_count(device) -> int:
    """The multiprocessors of the CUDA card ``device``: the grid route's
    blocks."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def grid_workspace_words(plan: ClusterPlan, n_images: int) -> int:
    """Words of the grid route's workspace (csrc/subminor_loop.cu): the
    slots of both parities, cv and the winner's position."""
    return 2 * SLOT_WORDS * plan.grid_blocks + n_images + 2


def cluster_plan(n_images: int, k: int, *, fit: Optional[SubminorFit] = None,
                 sm_count: Optional[int] = None,
                 grid_blocks: Optional[int] = None,
                 cluster_size: Optional[int] = None,
                 on_chip: Optional[bool] = None,
                 ship_raw: Optional[bool] = None) -> ClusterPlan:
    """The launch plan for ``n_images`` planes and ``k`` candidates under
    the spectral fit ``fit``, on a card of ``sm_count`` multiprocessors.

    The grid route above ``GRID_VALUES`` values when ``sm_count`` is given
    (one block a multiprocessor); else one block up to
    ``ONE_BLOCK_VALUES`` values, and ``MAX_CLUSTER`` above.  Threads by the
    candidates of a block; raw values in the exchange up to
    ``SHIP_RAW_MAX_IMAGES`` planes and ``SHIP_RAW_MAX_TERMS`` forced terms.
    The slices' state (``4 * n_images + 12`` bytes per candidate: residual,
    x, y, rms; and ``4 (T - 1)`` with forced terms) lives in shared memory
    where it fits there beside the per-plane scalars, the fit's constants
    and, on the grid route, the copy of an iteration's slots; else in global
    memory.  ``grid_blocks`` (0: the cluster route), ``cluster_size``,
    ``on_chip`` and ``ship_raw`` override the choice (tests and timings); a
    forced choice that the kernel cannot take raises.
    """
    if n_images < 1 or k < 1:
        raise ValueError(f"cluster_plan: {n_images} planes, {k} candidates")
    if grid_blocks is None:
        grid_blocks = (sm_count if sm_count and n_images * k > GRID_VALUES
                       else 0)
    if cluster_size is None:
        cluster_size = (1 if grid_blocks or n_images * k <= ONE_BLOCK_VALUES
                        else MAX_CLUSTER)
    if not (1 <= cluster_size <= MAX_CLUSTER
            and cluster_size & (cluster_size - 1) == 0):
        raise ValueError(f"cluster_plan: cluster size {cluster_size}")
    if grid_blocks < 0 or (grid_blocks and cluster_size != 1):
        raise ValueError(f"cluster_plan: {grid_blocks} grid blocks in "
                         f"clusters of {cluster_size}")
    slice_len = -(-k // (grid_blocks or cluster_size))
    forced_rows = 0 if fit is None else fit.forced_rows
    fixed = 12 * n_images + 4 * SLOT_WORDS * grid_blocks + (
        0 if fit is None else 4 * fit.shared_floats(n_images))
    state = slice_len * (4 * n_images + 12 + 4 * forced_rows)
    fits = fixed + state + STATIC_SHARED_RESERVE <= SHARED_BYTES_PER_BLOCK
    # About CANDIDATES_PER_THREAD candidates a thread: fewer warps make the
    # block's barrier and reduction cheaper, more hide the gathers.
    warps = math.ceil(slice_len / (32 * CANDIDATES_PER_THREAD))
    least = GRID_MIN_THREADS if grid_blocks else MIN_THREADS
    threads = 32 * min(MAX_THREADS // 32, max(least // 32, warps))
    if on_chip is None:
        on_chip = fits
    elif on_chip and not fits:
        blocks = (f"{grid_blocks} grid blocks" if grid_blocks
                  else f"{cluster_size} blocks")
        raise ValueError(
            f"cluster_plan: {n_images} x {k} values do not fit in the shared "
            f"memory of {blocks}")
    can_ship = (n_images <= SHIP_RAW_MAX_IMAGES
                and forced_rows <= SHIP_RAW_MAX_TERMS)
    if ship_raw is None:
        ship_raw = can_ship
    elif ship_raw and not can_ship:
        raise ValueError(f"cluster_plan: {n_images} planes and {forced_rows} "
                         "forced terms cannot ship raw")
    return ClusterPlan(cluster_size, threads, slice_len, bool(on_chip),
                       bool(ship_raw), fixed + (state if on_chip else 0),
                       grid_blocks)


def _decode(row) -> Tuple[int, float, bool]:
    value = float(np.int32(row[VALUE_BITS]).view(np.float32))
    return row[ITERATION], value, bool(row[DIVERGING])


def read_result(out: torch.Tensor) -> Tuple[int, float, bool]:
    """(iteration, last peak value, diverging) from a run's output tensor,
    in one host read."""
    return _decode(out.tolist())


def read_tile_results(out: torch.Tensor) -> List[Tuple[int, float, bool]]:
    """:func:`read_result` of every tile of a ``[T, 3]`` output, in one host
    read."""
    return [_decode(row) for row in out.tolist()]


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors with one rounding, as CUDA's
    ``__fmaf_rn``.  The product is exact in float64; the float64 sum is
    rounded twice (to float64, then float32), which differs from one
    rounding only when it lies exactly half-way between two float32 values
    while the exact sum does not, so that case is settled by the sum's exact
    error (TwoSum)."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    back = s - p
    err = (p - (s - back)) + (c64 - back)
    r = s.float()
    r64 = r.double()
    toward = torch.where(s > r64, np.inf, -np.inf).to(torch.float32)
    other = torch.nextafter(r, toward)
    tie = (s != r64) & (s == (r64 + other.double()) * 0.5) & (err != 0.0)
    past = (err > 0.0) == (other.double() > r64)
    return torch.where(tie & past, other, r)


def _integrate(planes: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """sum_i planes[i] * coef[i] in plane order, one fused multiply-add per
    plane after the first product."""
    s = planes[0] * coef[0]
    for i in range(1, planes.shape[0]):
        s = fma(planes[i], coef[i], s)
    return s


def _project(cv: torch.Tensor, proj: torch.Tensor, n_pols: int) -> torch.Tensor:
    """The polynomial fit's [C, C] projection per polarization, summed in
    channel order (``subminor_fused.py:169-182``)."""
    n_chan = proj.shape[0]
    out = []
    for c in range(n_chan):
        for p in range(n_pols):
            out.append(_integrate(cv[p::n_pols], proj[c]))
    return torch.stack(out)


_TINY = float(np.float32(1e-36))


def _log_polynomial(vals: torch.Tensor, fit: SubminorFit) -> torch.Tensor:
    """The log-polynomial fit of the ``[C, P]`` values, each polarization
    on its own, in the kernel's order: the weighted mean's sign, the logs,
    ``coef_t = sum_c F[t, c] l_c`` and ``e_c = sum_t D[c, t] coef_t``, then
    ``sign * exp(e)``."""
    sign = torch.where(_integrate(vals, fit.mean_weights) < 0.0, -1.0, 1.0)
    logs = torch.log(torch.clamp_min(vals.abs(), _TINY))
    design = fit.design
    e = None
    for t in range(design.shape[1]):
        coef = _integrate(logs, fit.fit_matrix[t])  # [P]
        d = design[:, t, None]
        e = d * coef if e is None else fma(d, coef[None, :], e)
    return sign.to(vals.dtype) * torch.exp(e)


def _forced_curve(fit: SubminorFit, m) -> torch.Tensor:
    """``exp(sum_k terms[k, m] powers[k])`` over the channels, summed in
    term order."""
    q = torch.zeros_like(fit.weights)
    for t in range(fit.forced_rows):
        term = fit.terms[t, m]
        q = term * fit.powers[t] if t == 0 else fma(term, fit.powers[t], q)
    return torch.exp(q)


def _forced(vals: torch.Tensor, fit: SubminorFit, m) -> torch.Tensor:
    """The forced-term fit of the ``[C, P]`` values at candidate ``m``:
    the amplitude per polarization against the candidate's curve, in the
    kernel's order."""
    curve = _forced_curve(fit, m)
    wc = fit.weights * curve
    num = _integrate(vals, wc)  # [P]
    den = _integrate(curve, wc)
    return curve[:, None] * (num / torch.clamp_min(den, _TINY))[None, :]


def apply_fit(cv: torch.Tensor, fit: Optional[SubminorFit], m,
              n_pols: int) -> torch.Tensor:
    """The ``[N]`` component values ``cv`` after ``fit`` at candidate
    ``m``, with the kernel's operations in its order."""
    if fit is None:
        return cv
    if fit.mode == FIT_PROJECTION:
        return _project(cv, fit.proj, n_pols)
    vals = cv.view(-1, n_pols)
    if fit.mode == FIT_LOG_POLYNOMIAL:
        return _log_polynomial(vals, fit).reshape(-1)
    if fit.mode == FIT_FORCED_TERMS:
        return _forced(vals, fit, m).reshape(-1)
    raise ValueError(f"SubminorFit: unknown mode {fit.mode}")


def subminor_loop_reference(
    residual_k: torch.Tensor,
    model_k: torch.Tensor,
    rms_k: Optional[torch.Tensor],
    xs: torch.Tensor,
    ys: torch.Tensor,
    psfs: torch.Tensor,
    coef: torch.Tensor,
    fit: Optional[SubminorFit],
    params: SubminorParams,
    *,
    n_polarizations: int,
) -> torch.Tensor:
    """Plain version of :func:`subminor_loop`: a torch loop with the
    kernel's operations in its order (each fused multiply-add emulated by
    :func:`fma`), reading the peak value to the host once per iteration."""
    n, _ = residual_k.shape
    n_psf, height, width = psfs.shape
    dev = residual_k.device
    psf_flat = psfs.reshape(n_psf, -1)
    psf_index = torch.arange(n, device=dev) // n_polarizations

    def find_max():
        s = _integrate(residual_k, coef)
        if rms_k is not None:
            s = s * rms_k
        cmp = s.abs() if params.allow_negative else s
        m = torch.argmax(cmp)
        return m, np.float32(s[m].item())

    def go(value, iteration, diverging):
        ok = (abs(value) > params.threshold
              and iteration < params.max_iterations and not diverging)
        return ok and (value >= 0.0 or not params.stop_on_negative)

    m, value = find_max()
    bound = np.float32(abs(value)) * np.float32(params.divergence_limit)
    iteration, diverging = params.start_iteration, False
    while go(value, iteration, diverging):
        cv = apply_fit(residual_k[:, m] * params.gain, fit, m,
                       n_polarizations)
        model_k[:, m] = model_k[:, m] + cv
        sy = ys - ys[m] + height // 2
        sx = xs - xs[m] + width // 2
        inside = (sy >= 0) & (sy < height) & (sx >= 0) & (sx < width)
        src = sy.clamp(0, height - 1) * width + sx.clamp(0, width - 1)
        shifted = torch.where(inside, psf_flat[:, src], 0.0)  # [C, K]
        residual_k.copy_(fma(-shifted[psf_index], cv[:, None], residual_k))
        m, value = find_max()
        iteration += 1
        diverging = params.divergence_limit != 0.0 and abs(value) > bound
    bits = int(np.float32(value).view(np.int32))
    return torch.tensor([iteration, int(diverging), bits], dtype=torch.int32,
                        device=dev)


def subminor_loop_tiles_reference(
    residual_k: torch.Tensor,
    model_k: torch.Tensor,
    rms_k: Optional[torch.Tensor],
    xs: torch.Tensor,
    ys: torch.Tensor,
    psfs: torch.Tensor,
    coef: torch.Tensor,
    fit: Optional[SubminorFit],
    params: SubminorParams,
    counts: Sequence[int],
    *,
    n_polarizations: int,
) -> torch.Tensor:
    """Plain version of :func:`subminor_loop_tiles`:
    :func:`subminor_loop_reference` on each tile's segment in turn (views
    of the state and of the forced terms, the state updated in place).  An
    empty segment stops at once with the value 0, as the kernel's cluster
    does."""
    rows, begin = [], 0
    for count in counts:
        end = begin + int(count)
        if count == 0:
            rows.append(torch.tensor([params.start_iteration, 0, 0],
                                     dtype=torch.int32,
                                     device=residual_k.device))
        else:
            cut = slice(begin, end)
            seg_fit = fit
            if fit is not None and fit.terms is not None:
                seg_fit = fit._replace(terms=fit.terms[:, cut])
            rows.append(subminor_loop_reference(
                residual_k[:, cut], model_k[:, cut],
                None if rms_k is None else rms_k[cut], xs[cut], ys[cut],
                psfs, coef, seg_fit, params,
                n_polarizations=n_polarizations))
        begin = end
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _entry():
    """The kernel's C entry point, with its signature declared."""
    from . import _build

    fn = _build.library().subminor_loop
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = (
        [ptr] * 7 + [i32, ptr, i32, ptr] + [ptr, i32, ptr] + [i32] * 5
        + [f32] * 2 + [i32] * 2 + [f32] + [i32] * 9 + [ptr, ptr]
    )
    fn.restype = i32
    return fn


def _fit_pointers(fit: Optional[SubminorFit], n_chan: int, k: int, dev,
                  name: str):
    """The kernel's fit arguments (mode, constants pointer, T, terms
    pointer) and the packed constants tensor, which the caller keeps alive
    across the launch; the fit's tensors are checked first."""
    if fit is None:
        return 0, None, 0, None, None
    f32 = torch.float32
    if fit.mode == FIT_PROJECTION:
        return (FIT_PROJECTION,
                _check(fit.proj, "fit.proj", dev, (n_chan, n_chan), f32),
                0, None, None)
    t = fit.n_terms
    if fit.mode == FIT_LOG_POLYNOMIAL:
        _check(fit.fit_matrix, "fit.fit_matrix", dev, (t, n_chan), f32)
        _check(fit.design, "fit.design", dev, (n_chan, t), f32)
        _check(fit.mean_weights, "fit.mean_weights", dev, (n_chan,), f32)
        terms = None
    elif fit.mode == FIT_FORCED_TERMS:
        _check(fit.weights, "fit.weights", dev, (n_chan,), f32)
        _check(fit.powers, "fit.powers", dev, (t - 1, n_chan), f32)
        terms = _check(fit.terms, "fit.terms", dev, (t - 1, k), f32)
    else:
        raise ValueError(f"{name}: unknown fit mode {fit.mode}")
    constants = fit.constants()
    return fit.mode, constants.data_ptr(), t, terms, constants


def launch_plan(n_images: int, longest: int, fit: Optional[SubminorFit],
                sms: int, tiles: bool, plan: Optional[ClusterPlan] = None,
                name: str = "subminor_loop") -> ClusterPlan:
    """The plan a launch takes on a card of ``sms`` multiprocessors:
    ``plan`` where given, else :func:`cluster_plan`'s.  The tile axis
    (``tiles``) keeps its clusters, since a grid barrier would join its
    independent loops; a grid plan for it raises."""
    if plan is None:
        plan = cluster_plan(n_images, longest, fit=fit,
                            sm_count=None if tiles else sms)
    if plan.grid_blocks and tiles:
        raise ValueError(f"{name}: the tile axis takes no grid plan")
    return plan


def _launch(residual_k, model_k, rms_k, xs, ys, psfs, coef,
            fit: Optional[SubminorFit], params: SubminorParams,
            n_polarizations: int, offsets: Optional[torch.Tensor],
            n_tiles: int, longest: int, plan: Optional[ClusterPlan],
            name: str) -> torch.Tensor:
    """Check the CUDA tensors and launch the kernel over ``n_tiles``
    segments (``offsets`` None: one segment, the whole state); ``longest``
    is the largest segment, which sizes the plan."""
    n, k = residual_k.shape
    n_psf, height, width = psfs.shape
    if not (0 < n <= MAX_IMAGES and n_psf * n_polarizations == n and k > 0
            and height * width < 2**31):
        raise ValueError(
            f"{name}: bad shapes, state {tuple(residual_k.shape)}, "
            f"psfs {tuple(psfs.shape)}, {n_polarizations} polarizations"
        )
    dev, f32, i32 = residual_k.device, torch.float32, torch.int32
    out = torch.empty((n_tiles, 3) if offsets is not None else 3, dtype=i32,
                      device=dev)
    ptrs = [
        _check(residual_k, "residual_k", dev, (n, k), f32),
        _check(model_k, "model_k", dev, (n, k), f32),
        _check(rms_k, "rms_k", dev, (k,), f32),
        _check(xs, "xs", dev, (k,), i32),
        _check(ys, "ys", dev, (k,), i32),
        _check(psfs, "psfs", dev, (n_psf, height, width), f32),
        _check(coef, "coef", dev, (n,), f32),
    ]
    mode, constants, n_terms, terms, _keep = _fit_pointers(
        fit, n_psf, k, dev, name)
    offsets_ptr = _check(offsets, "offsets", dev, (n_tiles + 1,), i32)
    plan = launch_plan(n, longest, fit, sm_count(dev), offsets is not None,
                       plan, name)
    workspace = None
    if plan.grid_blocks:
        workspace = torch.empty(grid_workspace_words(plan, n), dtype=i32,
                                device=dev)
    launch = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            *ptrs, mode, constants, n_terms, terms, offsets_ptr, n_tiles,
            out.data_ptr(), n, n_polarizations, k, height,
            width, params.threshold, params.gain, params.start_iteration,
            params.max_iterations, params.divergence_limit,
            int(params.allow_negative), int(params.stop_on_negative),
            plan.cluster_size, plan.threads, plan.slice_len,
            int(plan.on_chip), int(plan.ship_raw), plan.shared_bytes,
            plan.grid_blocks,
            None if workspace is None else workspace.data_ptr(), stream,
        )
    _raise_on(err, name)
    return out


def subminor_loop(
    residual_k: torch.Tensor,
    model_k: torch.Tensor,
    rms_k: Optional[torch.Tensor],
    xs: torch.Tensor,
    ys: torch.Tensor,
    psfs: torch.Tensor,
    coef: torch.Tensor,
    fit: Optional[SubminorFit],
    params: SubminorParams,
    *,
    n_polarizations: int,
    _plan: Optional[ClusterPlan] = None,
) -> torch.Tensor:
    """Run the Clark subminor loop over the candidate state in one launch.

    ``residual_k`` and ``model_k`` are ``[N, K]`` float32 (updated in
    place), ``rms_k`` the optional ``[K]`` rms factor, ``xs``/``ys``
    ``[K]`` int32 positions of the candidates, ``psfs`` the
    ``[C, H, W]`` PSFs at image size (plane n uses PSF
    ``n // n_polarizations``), ``coef`` the ``[N]`` linear integration
    coefficients and ``fit`` the optional spectral fit
    (:class:`SubminorFit`).  Returns the output tensor for
    :func:`read_result`.  The launch follows :func:`cluster_plan` on the
    card's multiprocessor count (``_plan`` overrides it, for tests and
    timings); a cluster or a grid that the card cannot schedule raises.
    """
    args = (residual_k, model_k, rms_k, xs, ys, psfs, coef, fit, params)
    if residual_k.device.type == "cpu":
        return subminor_loop_reference(*args, n_polarizations=n_polarizations)
    if residual_k.device.type != "cuda":
        raise ValueError(f"subminor_loop: unsupported device {residual_k.device}")
    out = _launch(*args, n_polarizations, None, 1, residual_k.shape[1],
                  _plan, "subminor_loop")
    subminor_loop.launches += 1
    return out


subminor_loop.launches = 0


def subminor_loop_tiles(
    residual_k: torch.Tensor,
    model_k: torch.Tensor,
    rms_k: Optional[torch.Tensor],
    xs: torch.Tensor,
    ys: torch.Tensor,
    psfs: torch.Tensor,
    coef: torch.Tensor,
    fit: Optional[SubminorFit],
    params: SubminorParams,
    offsets: torch.Tensor,
    counts: Sequence[int],
    *,
    n_polarizations: int,
    _plan: Optional[ClusterPlan] = None,
) -> torch.Tensor:
    """T independent Clark subminor loops in one launch, one cluster a
    tile: tile t cleans the candidates ``[offsets[t], offsets[t + 1])`` of
    the concatenated state (the arguments of :func:`subminor_loop`, with
    ``K`` the total), from the same start, to the same threshold.
    ``offsets`` is the ``[T + 1]`` int32 tensor of segment bounds on the
    state's device and ``counts`` the T segment lengths on the host (they
    size the plan, by the largest).  Returns ``[T, 3]`` int32 results for
    :func:`read_tile_results`.  The forced terms of ``fit`` follow the
    state's segments."""
    args = (residual_k, model_k, rms_k, xs, ys, psfs, coef, fit, params)
    if residual_k.device.type == "cpu":
        return subminor_loop_tiles_reference(
            *args, counts, n_polarizations=n_polarizations)
    if residual_k.device.type != "cuda":
        raise ValueError(
            f"subminor_loop_tiles: unsupported device {residual_k.device}")
    counts = [int(c) for c in counts]
    if sum(counts) != residual_k.shape[1] or min(counts) < 0:
        raise ValueError(
            f"subminor_loop_tiles: segments {counts} do not cover "
            f"{residual_k.shape[1]} candidates")
    out = _launch(*args, n_polarizations, offsets, len(counts), max(counts),
                  _plan, "subminor_loop_tiles")
    subminor_loop_tiles.launches += 1
    subminor_loop_tiles.launches_by_card[residual_k.device.index] += 1
    return out


subminor_loop_tiles.launches = 0
subminor_loop_tiles.launches_by_card = collections.Counter()
