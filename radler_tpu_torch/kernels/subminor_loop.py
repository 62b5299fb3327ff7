"""The Clark subminor loop: CUDA kernel, its plain version, the result.

Port of ``radler_tpu.ops.pallas.subminor_fused`` (the TPU kernel
``_loop_kernel`` behind ``subminor_loop_fused``).  :func:`subminor_loop`
runs the whole ``SubMinorLoop::Run`` while-loop over the ``[N, K]``
candidate state in one launch of ``csrc/subminor_loop.cu`` on CUDA tensors,
and its plain PyTorch version :func:`subminor_loop_reference` on CPU
tensors.  The launch is one thread-block cluster (it needs a card of
compute capability 9.0 or later) whose blocks each keep a slice of the
candidates in shared memory; :func:`cluster_plan` chooses the cluster's
size and the state's place from ``N`` and ``K`` alone.  Both versions
update ``residual_k`` and ``model_k`` in place and return a
small int32 tensor ``(iteration, diverging, bits of the last peak value)``
on the state's device, which :func:`read_result` brings to the host in one
read.

:func:`subminor_loop_tiles` is the same loop with a tile axis, the device
mesh's Clark subminor: T independent loops over the segments of a
concatenated ``[N, sum K]`` state, one cluster a segment, in one launch
(its plain version :func:`subminor_loop_tiles_reference` runs the plain loop
over each segment in turn).  It returns ``[T, 3]`` results.

The kernel reads the PSF at image size where the TPU kernel read a prebuilt
``[C, K, K]`` interaction matrix; what bounds it, and its design, are in the
note at the top of the CUDA source.  The plain version performs the same
float32 operations in the same order (each fused multiply-add emulated
exactly by :func:`fma`), so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

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


class ClusterPlan(NamedTuple):
    """How one launch spreads over its cluster."""

    cluster_size: int  # blocks R, a power of two up to MAX_CLUSTER
    threads: int       # threads per block, a multiple of 32 up to MAX_THREADS
    slice_len: int     # candidates per block; block r owns [r s, (r + 1) s)
    on_chip: bool      # the slices' state lives in shared memory
    ship_raw: bool     # raw values travel with the argmax: one barrier
    shared_bytes: int  # dynamic shared memory per block


def cluster_plan(n_images: int, k: int, *, cluster_size: Optional[int] = None,
                 on_chip: Optional[bool] = None,
                 ship_raw: Optional[bool] = None) -> ClusterPlan:
    """The launch plan for ``n_images`` planes and ``k`` candidates.

    One block up to ``ONE_BLOCK_VALUES`` values, else ``MAX_CLUSTER``;
    threads by the candidates of a block; raw values in the exchange up to
    ``SHIP_RAW_MAX_IMAGES`` planes.
    The slices' state (``4 * n_images + 12`` bytes per candidate: residual,
    x, y, rms) lives in shared memory where it fits there, else in global
    memory.  ``cluster_size``, ``on_chip`` and ``ship_raw``
    override the choice (tests and timings); a forced choice that the
    kernel cannot take raises.
    """
    if n_images < 1 or k < 1:
        raise ValueError(f"cluster_plan: {n_images} planes, {k} candidates")
    if cluster_size is None:
        cluster_size = 1 if n_images * k <= ONE_BLOCK_VALUES else MAX_CLUSTER
    if not (1 <= cluster_size <= MAX_CLUSTER
            and cluster_size & (cluster_size - 1) == 0):
        raise ValueError(f"cluster_plan: cluster size {cluster_size}")
    slice_len = -(-k // cluster_size)
    per_plane = 12 * n_images
    state = slice_len * (4 * n_images + 12)
    fits = (per_plane + state + STATIC_SHARED_RESERVE
            <= SHARED_BYTES_PER_BLOCK)
    # About CANDIDATES_PER_THREAD candidates a thread: fewer warps make the
    # block's barrier and reduction cheaper, more hide the gathers.
    warps = math.ceil(slice_len / (32 * CANDIDATES_PER_THREAD))
    threads = 32 * min(MAX_THREADS // 32, max(MIN_THREADS // 32, warps))
    if on_chip is None:
        on_chip = fits
    elif on_chip and not fits:
        raise ValueError(
            f"cluster_plan: {n_images} x {k} values do not fit in the shared "
            f"memory of {cluster_size} blocks")
    if ship_raw is None:
        ship_raw = n_images <= SHIP_RAW_MAX_IMAGES
    elif ship_raw and n_images > SHIP_RAW_MAX_IMAGES:
        raise ValueError(f"cluster_plan: {n_images} planes cannot ship raw")
    return ClusterPlan(cluster_size, threads, slice_len, bool(on_chip),
                       bool(ship_raw), per_plane + (state if on_chip else 0))


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


def subminor_loop_reference(
    residual_k: torch.Tensor,
    model_k: torch.Tensor,
    rms_k: Optional[torch.Tensor],
    xs: torch.Tensor,
    ys: torch.Tensor,
    psfs: torch.Tensor,
    coef: torch.Tensor,
    proj: Optional[torch.Tensor],
    params: SubminorParams,
    *,
    n_polarizations: int,
    fit: Optional[Callable] = None,
) -> torch.Tensor:
    """Plain version of :func:`subminor_loop`: a torch loop with the
    kernel's operations in its order (each fused multiply-add emulated by
    :func:`fma`), reading the peak value to the host once per iteration.
    ``fit(cv, x, y)``, for CPU tensors only, applies a spectral fit that is
    not a constant projection (log-polynomial, forced terms), as
    ``_subminor_while`` of the JAX package does."""
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
        cv = residual_k[:, m] * params.gain
        if proj is not None:
            cv = _project(cv, proj, n_polarizations)
        elif fit is not None:
            cv = fit(cv, xs[m], ys[m])
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
    proj: Optional[torch.Tensor],
    params: SubminorParams,
    counts: Sequence[int],
    *,
    n_polarizations: int,
    fit: Optional[Callable] = None,
) -> torch.Tensor:
    """Plain version of :func:`subminor_loop_tiles`:
    :func:`subminor_loop_reference` on each tile's segment in turn (views
    of the state, updated in place).  An empty segment stops at once with
    the value 0, as the kernel's cluster does."""
    rows, begin = [], 0
    for count in counts:
        end = begin + int(count)
        if count == 0:
            rows.append(torch.tensor([params.start_iteration, 0, 0],
                                     dtype=torch.int32,
                                     device=residual_k.device))
        else:
            cut = slice(begin, end)
            rows.append(subminor_loop_reference(
                residual_k[:, cut], model_k[:, cut],
                None if rms_k is None else rms_k[cut], xs[cut], ys[cut],
                psfs, coef, proj, params, n_polarizations=n_polarizations,
                fit=fit))
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
        [ptr] * 9 + [i32, ptr] + [i32] * 5 + [f32] * 2 + [i32] * 2 + [f32]
        + [i32] * 8 + [ptr]
    )
    fn.restype = i32
    return fn


def _launch(residual_k, model_k, rms_k, xs, ys, psfs, coef, proj,
            params: SubminorParams, n_polarizations: int,
            offsets: Optional[torch.Tensor], n_tiles: int, longest: int,
            plan: Optional[ClusterPlan], name: str) -> torch.Tensor:
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
        _check(proj, "proj", dev, (n_psf, n_psf), f32),
        _check(offsets, "offsets", dev, (n_tiles + 1,), i32),
    ]
    plan = cluster_plan(n, longest) if plan is None else plan
    launch = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            *ptrs, n_tiles, out.data_ptr(), n, n_polarizations, k, height,
            width, params.threshold, params.gain, params.start_iteration,
            params.max_iterations, params.divergence_limit,
            int(params.allow_negative), int(params.stop_on_negative),
            plan.cluster_size, plan.threads, plan.slice_len,
            int(plan.on_chip), int(plan.ship_raw), plan.shared_bytes, stream,
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
    proj: Optional[torch.Tensor],
    params: SubminorParams,
    *,
    n_polarizations: int,
    fit: Optional[Callable] = None,
    _plan: Optional[ClusterPlan] = None,
) -> torch.Tensor:
    """Run the Clark subminor loop over the candidate state in one launch.

    ``residual_k`` and ``model_k`` are ``[N, K]`` float32 (updated in
    place), ``rms_k`` the optional ``[K]`` rms factor, ``xs``/``ys``
    ``[K]`` int32 positions of the candidates, ``psfs`` the
    ``[C, H, W]`` PSFs at image size (plane n uses PSF
    ``n // n_polarizations``), ``coef`` the ``[N]`` linear integration
    coefficients and ``proj`` the optional ``[C, C]`` polynomial-fit
    projection.  Returns the output tensor for :func:`read_result`.
    The launch follows :func:`cluster_plan` (``_plan`` overrides it, for
    tests and timings); a cluster that the card cannot schedule raises.
    """
    args = (residual_k, model_k, rms_k, xs, ys, psfs, coef, proj, params)
    if residual_k.device.type == "cpu":
        return subminor_loop_reference(*args, n_polarizations=n_polarizations,
                                       fit=fit)
    if residual_k.device.type != "cuda":
        raise ValueError(f"subminor_loop: unsupported device {residual_k.device}")
    if fit is not None:
        raise ValueError(
            "subminor_loop: the kernel applies only a polynomial projection"
        )
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
    proj: Optional[torch.Tensor],
    params: SubminorParams,
    offsets: torch.Tensor,
    counts: Sequence[int],
    *,
    n_polarizations: int,
    fit: Optional[Callable] = None,
    _plan: Optional[ClusterPlan] = None,
) -> torch.Tensor:
    """T independent Clark subminor loops in one launch, one cluster a
    tile: tile t cleans the candidates ``[offsets[t], offsets[t + 1])`` of
    the concatenated state (the arguments of :func:`subminor_loop`, with
    ``K`` the total), from the same start, to the same threshold.
    ``offsets`` is the ``[T + 1]`` int32 tensor of segment bounds on the
    state's device and ``counts`` the T segment lengths on the host (they
    size the plan, by the largest).  Returns ``[T, 3]`` int32 results for
    :func:`read_tile_results`.  A spectral fit that is not the polynomial
    projection (``fit``) runs only in the plain version, on the CPU."""
    args = (residual_k, model_k, rms_k, xs, ys, psfs, coef, proj, params)
    if residual_k.device.type == "cpu":
        return subminor_loop_tiles_reference(
            *args, counts, n_polarizations=n_polarizations, fit=fit)
    if residual_k.device.type != "cuda":
        raise ValueError(
            f"subminor_loop_tiles: unsupported device {residual_k.device}")
    if fit is not None:
        raise NotImplementedError(
            "the mesh Clark subminor loop with a spectral fit other than the "
            "polynomial projection on the card is not ported (B2 bakes only "
            "the projection); ROADMAP queue A, item 9 brings it."
        )
    counts = [int(c) for c in counts]
    if sum(counts) != residual_k.shape[1] or min(counts) < 0:
        raise ValueError(
            f"subminor_loop_tiles: segments {counts} do not cover "
            f"{residual_k.shape[1]} candidates")
    out = _launch(*args, n_polarizations, offsets, len(counts), max(counts),
                  _plan, "subminor_loop_tiles")
    subminor_loop_tiles.launches += 1
    return out


subminor_loop_tiles.launches = 0
