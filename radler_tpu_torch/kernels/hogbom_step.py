"""The Högbom minor iteration: CUDA kernels, their plain versions, the loop.

Port of ``radler_tpu.ops.pallas.hogbom_step`` (the TPU kernel
``_step_kernel`` behind ``fused_clean_step`` and its device loop
``hogbom_loop_pallas``).  One iteration is two launches of
``csrc/hogbom_step.cu``:

* :func:`hogbom_step` adds the component values to the model at the current
  peak, subtracts the shifted PSF from every plane of the residual (in
  place), forms the joined integration, weights it and reduces each block of
  pixels to a partial ``(max, smallest flat index, signed integrated
  value)``.
* :func:`hogbom_select` reduces the partials to the new peak and updates the
  loop state on the device: the signed value at the peak, ``found``, the
  divergence and stop tests, the iteration count and the next component
  values.

What bounds the pair, and how the design meets it, is in the note at the top
of the CUDA source.  Each wrapper runs its plain PyTorch version
(:func:`hogbom_step_reference`, :func:`hogbom_select_reference`) when given
CPU tensors, and launches its kernel (or raises) when given CUDA tensors.
The plain versions perform the same float32 operations in the same order as
the kernels, so the two agree bit for bit.

The loop state is a small int32 tensor on the device (layout below) plus a
float32 value; both kernels return at once when ``state[ACTIVE]`` is 0, so
:func:`hogbom_loop` enqueues ``CHUNK`` iterations at a time and reads the
state back only between chunks.

The batched facet route runs F facets' loops in lockstep through the facet
mode of the same pair (:func:`hogbom_step_facets`,
:func:`hogbom_select_facets`, driven by :func:`facet_hogbom_loop`): one
step launch and one select launch an iteration for all facets, each facet
with its own state, and the PSFs shared or one stack a facet.  The step
runs over each facet's true box (top left in the common box) and never
touches the padding around it.  Its plain version is the single-cube plain
step on each facet's box in turn.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.peak_finder import FLT_MIN
from ..ops.psf_subtract import shift_psf

MODES = ("signed", "linear", "normal", "squared")
# Flat pixels one step block reduces to one partial (256 threads x 16).
PIXELS_PER_BLOCK = 4096
# Facets one facet-step launch takes (csrc/hogbom_step.cu kMaxFacets).
FACETS_PER_LAUNCH = 256
# Iterations enqueued between two host reads of the loop state.
CHUNK = 64
# Loop-state slots (int32), shared with csrc/hogbom_step.cu.
Y, X, FOUND, DIVERGING, ITERATION, ACTIVE, INDEX = range(7)
STATE_SIZE = 8
# The index of a partial that holds no peak.
INT_MAX = 2**31 - 1


def integration_coefficients(meta) -> Tuple[str, np.ndarray, np.ndarray]:
    """(mode, chan_coefs, pol_coefs) reproducing the reference's square
    integration (``image_set.cc:309-421``) inside the kernel."""
    C = meta.n_channels
    w = np.asarray(meta.weights, dtype=np.float64)
    wsum = w[w != 0].sum()
    linked = np.asarray(meta.linked, np.float64)
    if meta.n_images == 1:
        return "signed", np.ones(1, np.float32), np.ones(1, np.float32)
    if meta.squared_joins:
        chan = w * (meta.polarization_norm_factor / wsum) if wsum > 0 else w * 0
        return "squared", chan.astype(np.float32), linked.astype(np.float32)
    if C == 1:
        chan = np.asarray([np.sqrt(meta.polarization_norm_factor)], np.float64)
    else:
        chan = (
            w * (np.sqrt(meta.polarization_norm_factor) / wsum)
            if wsum > 0
            else w * 0
        )
    return "normal", chan.astype(np.float32), linked.astype(np.float32)


def kernel_coefficients(
    mode: str, chan_coefs: np.ndarray, pol_coefs: np.ndarray
) -> np.ndarray:
    """The kernels' coefficient array: one coefficient per cube plane, then
    (normal mode only) one per channel.

    ``chan_coefs`` holds one coefficient per plane in signed and linear
    mode, one per channel otherwise.  The squared-mode plane coefficient is
    the float32 rounding of the float64 product, as the TPU kernel bakes it.
    """
    chan = np.asarray(chan_coefs, np.float32)
    pol = np.asarray(pol_coefs, np.float32)
    if mode in ("signed", "linear"):
        return chan.copy()
    if mode == "normal":
        return np.concatenate([np.tile(pol, chan.size), chan])
    if mode == "squared":
        return np.asarray(
            [float(c) * float(p) for c in chan for p in pol], np.float32
        )
    raise ValueError(f"unknown integration mode {mode!r}")


class LoopParams(NamedTuple):
    """Scalars of one minor loop, each rounded to float32 as the device
    compares them."""

    gain: float
    first_threshold: float
    initial_abs_peak: float
    divergence_limit: float
    max_iterations: int
    stop_on_negative: bool

    @classmethod
    def make(cls, gain, first_threshold, initial_abs_peak, divergence_limit,
             max_iterations, stop_on_negative) -> "LoopParams":
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        return cls(f32(gain), f32(first_threshold), f32(initial_abs_peak),
                   f32(divergence_limit), int(max_iterations),
                   bool(stop_on_negative))


class FacetLoopParams(NamedTuple):
    """Scalars of F lockstep minor loops: the gain, divergence limit and
    stop rule they share, and each facet's first threshold, initial
    |peak| and iteration limit, on the host (rounded to float32) and on the
    device (``limits`` [F, 2], ``max_iterations_device`` [F]).

    With a gain a facet (multiscale's facets clean at their own scales),
    ``gains`` holds them (``[F, 1]`` on the device, ``facet_gains`` on the
    host) and ``gain``, the kernels' shared one, is 1: the loop scales the
    component values by the facet's gain after each select, which rounds
    as the select's own product does."""

    gain: float
    divergence_limit: float
    stop_on_negative: bool
    first_threshold: Tuple[float, ...]
    initial_abs_peak: Tuple[float, ...]
    max_iterations: Tuple[int, ...]
    limits: torch.Tensor
    max_iterations_device: torch.Tensor
    facet_gains: Optional[Tuple[float, ...]] = None
    gains: Optional[torch.Tensor] = None

    @classmethod
    def make(cls, gain, first_thresholds, initial_abs_peaks, divergence_limit,
             max_iterations, stop_on_negative, device) -> "FacetLoopParams":
        """``gain`` is one number for every facet or a sequence of them,
        one a facet."""
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        thresholds = tuple(f32(v) for v in first_thresholds)
        peaks = tuple(f32(v) for v in initial_abs_peaks)
        limits = torch.tensor(list(zip(thresholds, peaks)),
                              dtype=torch.float32).reshape(-1, 2)
        iterations = tuple(int(v) for v in max_iterations)
        facet_gains = gains = None
        if not np.isscalar(gain):
            facet_gains = tuple(f32(g) for g in gain)
            gains = torch.tensor(facet_gains, dtype=torch.float32).view(
                -1, 1).to(device)
            gain = 1.0
        return cls(f32(gain), f32(divergence_limit), bool(stop_on_negative),
                   thresholds, peaks, iterations, limits.to(device),
                   torch.tensor(iterations, dtype=torch.int32, device=device),
                   facet_gains, gains)

    def facet_gain(self, f: int) -> float:
        """Facet ``f``'s gain."""
        return self.gain if self.facet_gains is None else self.facet_gains[f]

    def facet(self, f: int) -> LoopParams:
        """Facet ``f``'s loop as a single-cube :class:`LoopParams`."""
        return LoopParams(self.gain, self.first_threshold[f],
                          self.initial_abs_peak[f], self.divergence_limit,
                          self.max_iterations[f], self.stop_on_negative)


@dataclasses.dataclass
class LoopBuffers:
    """Device-resident loop state between launches (facet mode: a leading
    facet axis on each)."""

    state: torch.Tensor  # int32 [STATE_SIZE]
    value: torch.Tensor  # float32 [1]: signed rms-weighted peak value
    peak: torch.Tensor  # float32 [N]: residual values at the peak
    values: torch.Tensor  # float32 [N]: this iteration's component values

    def facet(self, f: int) -> "LoopBuffers":
        """Views of facet ``f``'s buffers in facet-mode buffers."""
        return LoopBuffers(self.state[f], self.value[f:f + 1], self.peak[f],
                           self.values[f])


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _integrate(planes: torch.Tensor, coefs: torch.Tensor, mode: str,
               n_polarizations: int) -> torch.Tensor:
    """The joined integration, one float32 operation at a time in the
    kernel's order (``hogbom_step.py:134-166`` of the TPU kernel)."""
    n = planes.shape[0]
    per_plane, chan = coefs[:n], coefs[n:]
    if mode == "signed":
        return planes[0] * per_plane[0]
    if mode == "linear":
        integ = planes[0] * per_plane[0]
        for i in range(1, n):
            integ = integ + planes[i] * per_plane[i]
        return integ
    if mode == "squared":
        sq = planes[0] * planes[0] * per_plane[0]
        for i in range(1, n):
            sq = sq + planes[i] * planes[i] * per_plane[i]
        return torch.sqrt(torch.clamp_min(sq, 0.0))
    integ = None
    for c in range(n // n_polarizations):
        if n_polarizations == 1:
            per_chan = planes[c]
        else:
            sq = None
            for p in range(n_polarizations):
                i = c * n_polarizations + p
                term = planes[i] * planes[i] * per_plane[i]
                sq = term if sq is None else sq + term
            per_chan = torch.sqrt(torch.clamp_min(sq, 0.0))
        term = per_chan * chan[c]
        integ = term if integ is None else integ + term
    return integ


def _fold(terms: torch.Tensor) -> torch.Tensor:
    """``terms[0] + terms[1] + ...`` summed left to right along dim 0."""
    acc = terms[0]
    for i in range(1, terms.shape[0]):
        acc = acc + terms[i]
    return acc


def integrate_values(vals: torch.Tensor, mode: str, chan_coefs: torch.Tensor,
                     pol_coefs: torch.Tensor,
                     n_polarizations: int) -> torch.Tensor:
    """The joined integration of one pixel's ``[N]`` values
    (``hogbom_step.py:529-558`` of the JAX package): the mesh loop's signed
    value at a found peak.  ``chan_coefs`` holds one coefficient per plane
    in signed and linear mode, one per channel otherwise.  Left folds in the
    kernels' order, so a chan x tile split with one plane per shard gives
    B1's value bit for bit; squared mode takes B4's products
    ``((v*v)*c)*p`` and the sqrt.  Returns a 0-d tensor."""
    if mode in ("signed", "linear"):
        return _fold(vals * chan_coefs)
    cube = vals.view(-1, n_polarizations)
    if mode == "squared":
        return torch.sqrt(torch.clamp_min(
            _fold((cube * cube * chan_coefs[:, None] * pol_coefs).view(-1)),
            0.0))
    if n_polarizations == 1:
        per_chan = cube[:, 0]
    else:
        per_chan = torch.sqrt(torch.clamp_min(
            _fold((cube * cube * pol_coefs).t()), 0.0))
    return _fold(per_chan * chan_coefs)


def add_at_peak(model: torch.Tensor, values: torch.Tensor,
                local_y: torch.Tensor, x: torch.Tensor,
                active: torch.Tensor) -> None:
    """``model[:, local_y, x] += values`` when ``active`` and the row lies in
    ``model``'s rows (a row shard holds the peak or does not); the kernels'
    fused model update, as device ops."""
    n, height, width = model.shape
    own = active & (local_y >= 0) & (local_y < height)
    at = (local_y.clamp(0, height - 1) * width + x).view(1)
    flat_model = model.view(n, height * width)
    cur = flat_model.index_select(1, at)[:, 0]
    flat_model.index_copy_(1, at, torch.where(own, cur + values, cur)[:, None])


def hogbom_step_reference(
    residual: torch.Tensor,
    model: torch.Tensor,
    psfs: torch.Tensor,
    values: torch.Tensor,
    state: torch.Tensor,
    coefs: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    *,
    mode: str,
    n_polarizations: int,
    allow_negative: bool,
    row_offset: int = 0,
    box: Optional[Tuple[int, int]] = None,
    n_parts: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`hogbom_step`; reads nothing back to the host.

    ``box`` (rows, columns), the facet step's true box at the top left of
    the cube (None: the whole cube), limits the step to it: nothing outside
    it is read or written but the model at the peak.  The partials are runs
    of :data:`PIXELS_PER_BLOCK` box pixels in row-major order, with the
    cube's flat indices; ``n_parts`` pads them with no peak (-inf,
    INT_MAX, 0) past the box's runs."""
    n, height, width = residual.shape
    rows, cols = box if box is not None else (height, width)
    dev = residual.device
    active = state[ACTIVE] != 0
    y, x = state[Y].long(), state[X].long()
    add_at_peak(model, values, y - row_offset, x, active)
    psf_indices = torch.arange(n, device=dev) // n_polarizations
    shifted = shift_psf(psfs, x, y, row_offset, rows)[..., :cols]
    box_res = residual[:, :rows, :cols]
    new = box_res - values[:, None, None] * shifted[psf_indices]
    box_res.copy_(torch.where(active, new, box_res))

    integ = _integrate(box_res, coefs, mode, n_polarizations).reshape(-1)
    weighted = (integ * weight[:rows, :cols].reshape(-1)
                if weight is not None else integ)
    cmp = weighted.abs() if allow_negative else weighted
    pixels = rows * cols
    runs = -(-pixels // PIXELS_PER_BLOCK)
    n_parts = runs if n_parts is None else n_parts
    blocks = F.pad(cmp, (0, n_parts * PIXELS_PER_BLOCK - pixels),
                   value=-np.inf).view(n_parts, -1)
    part_cmp, arg = blocks.max(dim=1)  # first maximum of each block
    q = arg + torch.arange(n_parts, device=dev) * PIXELS_PER_BLOCK
    part_integ = integ[q.clamp(max=pixels - 1)]
    part_idx = (q // cols) * width + q % cols
    tail = torch.arange(n_parts, device=dev) >= runs
    part_cmp = part_cmp.masked_fill(tail, -np.inf)
    part_idx = part_idx.masked_fill(tail, INT_MAX)
    part_integ = part_integ.masked_fill(tail, 0.0)
    return part_cmp, part_idx.to(torch.int32), part_integ


def hogbom_select_reference(
    partials: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    residual: torch.Tensor,
    buffers: LoopBuffers,
    params: LoopParams,
    rms: Optional[torch.Tensor] = None,
) -> None:
    """Plain version of :func:`hogbom_select`; reads nothing back to the
    host."""
    part_cmp, part_idx, part_integ = partials
    n, height, width = residual.shape
    # Blocks hold ascending pixel ranges, so the first block attaining the
    # maximum holds the smallest flat index among equal maxima.
    best = torch.argmax(part_cmp).view(1)
    cmp = part_cmp[best]
    idx = part_idx[best].long()
    value = part_integ[best]
    if rms is not None:
        value = value * rms.reshape(-1)[idx]
    raw = residual.view(n, -1).index_select(1, idx)[:, 0]
    advance_state(buffers, params, cmp > FLT_MIN, value, idx, width, raw)


def advance_state(buffers: LoopBuffers, params: LoopParams,
                  found: torch.Tensor, value: torch.Tensor, idx: torch.Tensor,
                  width: int, raw: torch.Tensor) -> None:
    """The loop body's epilogue once the new peak is known (``found``,
    its signed rms-weighted ``value``, flat ``idx``, all ``[1]``, and the
    ``[N]`` residual values ``raw`` there): the divergence and stop tests,
    the iteration count and the next gain-scaled component values, written
    into ``buffers`` only while ``state[ACTIVE]`` is set."""
    state = buffers.state
    active = state[ACTIVE] != 0
    if params.divergence_limit != 0.0:
        bound = float(
            np.float32(params.initial_abs_peak)
            * np.float32(params.divergence_limit)
        )
        diverging = found & (value.abs() > bound)
    else:
        diverging = torch.zeros_like(found)
    iteration = state[ITERATION:ITERATION + 1] + 1
    go = (
        found
        & (value.abs() > params.first_threshold)
        & (iteration < params.max_iterations)
        & ~diverging
    )
    if params.stop_on_negative:
        go = go & (value >= 0.0)
    new_state = torch.cat([
        t.to(torch.int32)
        for t in (idx // width, idx % width, found, diverging, iteration,
                  go, idx, state[STATE_SIZE - 1:])
    ])
    state.copy_(torch.where(active, new_state, state))
    buffers.value.copy_(torch.where(active, value, buffers.value))
    buffers.peak.copy_(torch.where(active, raw, buffers.peak))
    buffers.values.copy_(torch.where(active, raw * params.gain, buffers.values))


def facet_parts(boxes: Optional[torch.Tensor], height: int, width: int,
                n_facets: int) -> Tuple[Tuple[Tuple[int, int], ...], int]:
    """Each facet's true box ``(rows, columns)`` on the host (the whole
    ``height`` x ``width`` common box when ``boxes`` is None) and the
    partials a facet, ``n_parts``: the most runs of
    :data:`PIXELS_PER_BLOCK` box pixels any facet has."""
    if boxes is None:
        sizes = ((height, width),) * n_facets
    else:
        if boxes.device.type != "cpu" or boxes.dtype != torch.int32:
            raise ValueError("boxes must be an int32 tensor on the CPU: the "
                             "step's grid is sized from them")
        sizes = tuple((int(h), int(w)) for h, w in boxes.tolist())
        if len(sizes) != n_facets or not all(
                1 <= h <= height and 1 <= w <= width for h, w in sizes):
            raise ValueError(f"boxes {sizes} do not fit {n_facets} facets in "
                             f"a {height}x{width} common box")
    n_parts = max(-(-h * w // PIXELS_PER_BLOCK) for h, w in sizes)
    return sizes, n_parts


def hogbom_step_facets_reference(
    residual: torch.Tensor,
    model: torch.Tensor,
    psfs: torch.Tensor,
    values: torch.Tensor,
    state: torch.Tensor,
    coefs: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    *,
    mode: str,
    n_polarizations: int,
    allow_negative: bool,
    boxes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`hogbom_step_facets`: the single-cube plain
    step on each facet's true box in turn; partials ``[F, n_parts]``."""
    n_facets, _, height, width = residual.shape
    sizes, n_parts = facet_parts(boxes, height, width, n_facets)
    shared = psfs.ndim == 3
    parts = [
        hogbom_step_reference(
            residual[f], model[f], psfs if shared else psfs[f], values[f],
            state[f], coefs, None if weight is None else weight[f],
            mode=mode, n_polarizations=n_polarizations,
            allow_negative=allow_negative, box=sizes[f], n_parts=n_parts)
        for f in range(n_facets)
    ]
    return tuple(torch.stack(p) for p in zip(*parts))


def hogbom_select_facets_reference(
    partials: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    residual: torch.Tensor,
    buffers: LoopBuffers,
    params: FacetLoopParams,
    rms: Optional[torch.Tensor] = None,
) -> None:
    """Plain version of :func:`hogbom_select_facets`: the single-cube plain
    select on each facet in turn."""
    for f in range(residual.shape[0]):
        hogbom_select_reference(
            tuple(p[f] for p in partials), residual[f], buffers.facet(f),
            params.facet(f), None if rms is None else rms[f])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_bound_lib = None


def _lib():
    """The kernel library with its C signatures declared."""
    global _bound_lib
    if _bound_lib is None:
        from . import _build

        lib = _build.library()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hogbom_step.argtypes = [ptr] * 10 + [i32] * 10 + [ptr]
        lib.hogbom_step.restype = i32
        lib.hogbom_select.argtypes = (
            [ptr] * 3 + [i32] + [ptr] * 2 + [i32] * 3 + [ptr] * 4
            + [f32] * 4 + [i32] * 2 + [ptr]
        )
        lib.hogbom_select.restype = i32
        lib.hogbom_step_facets.argtypes = (
            [ptr] * 3 + [ctypes.c_longlong] + [ptr] * 8 + [i32] * 9 + [ptr])
        lib.hogbom_step_facets.restype = i32
        lib.hogbom_select_facets.argtypes = (
            [ptr] * 3 + [i32] * 2 + [ptr] * 2 + [i32] * 3 + [ptr] * 6
            + [f32] * 2 + [i32] + [ptr])
        lib.hogbom_select_facets.restype = i32
        _bound_lib = lib
    return _bound_lib


def _check(t: Optional[torch.Tensor], name: str, device, shape, dtype):
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def hogbom_step(
    residual: torch.Tensor,
    model: torch.Tensor,
    psfs: torch.Tensor,
    values: torch.Tensor,
    state: torch.Tensor,
    coefs: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    *,
    mode: str,
    n_polarizations: int,
    allow_negative: bool,
    row_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Add ``values`` to ``model`` at the peak in ``state``, subtract the
    shifted PSFs from ``residual`` (both in place) and return the per-block
    partials ``(cmp, idx, integ)``.  A no-op when ``state[ACTIVE]`` is 0.

    ``residual`` and ``model`` are ``[N, H, W]``, ``psfs`` the un-padded
    ``[C, H_psf, W]`` PSFs (plane n uses PSF ``n // n_polarizations``),
    ``coefs`` the :func:`kernel_coefficients`, ``weight`` the optional
    ``[H, W]`` peak-search weight.  A row shard of a taller image passes
    its first image row as ``row_offset`` and the PSFs at the image's full
    height ``H_psf``; the peak in ``state`` is in image rows, and the
    partials' indices are flat indices within the shard.
    """
    args = (residual, model, psfs, values, state, coefs, weight)
    kw = dict(mode=mode, n_polarizations=n_polarizations,
              allow_negative=allow_negative, row_offset=row_offset)
    if residual.device.type == "cpu":
        return hogbom_step_reference(*args, **kw)
    if residual.device.type != "cuda":
        raise ValueError(f"hogbom_step: unsupported device {residual.device}")
    n, height, width = residual.shape
    n_chan = n // n_polarizations
    psf_height = psfs.shape[1] if psfs.ndim == 3 else -1
    if (n_chan * n_polarizations != n or psf_height * width >= 2**31
            or not 0 <= row_offset <= psf_height - height):
        raise ValueError(
            f"hogbom_step: bad cube shape {tuple(residual.shape)} at row "
            f"{row_offset} of PSFs {tuple(psfs.shape)}")
    if mode == "signed" and n != 1:
        raise ValueError("hogbom_step: signed mode takes one plane")
    n_coefs = n + (n_chan if mode == "normal" else 0)
    dev, f32 = residual.device, torch.float32
    n_parts = -(-height * width // PIXELS_PER_BLOCK)
    part_cmp = torch.empty(n_parts, dtype=f32, device=dev)
    part_idx = torch.empty(n_parts, dtype=torch.int32, device=dev)
    part_integ = torch.empty(n_parts, dtype=f32, device=dev)
    ptrs = [
        _check(residual, "residual", dev, (n, height, width), f32),
        _check(model, "model", dev, (n, height, width), f32),
        _check(psfs, "psfs", dev, (n_chan, psf_height, width), f32),
        _check(weight, "weight", dev, (height, width), f32),
        _check(coefs, "coefs", dev, (n_coefs,), f32),
        _check(values, "values", dev, (n,), f32),
        _check(state, "state", dev, (STATE_SIZE,), torch.int32),
        part_cmp.data_ptr(),
        part_idx.data_ptr(),
        part_integ.data_ptr(),
    ]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hogbom_step(
            *ptrs, n_parts, n, n_polarizations, height, width, psf_height,
            row_offset, PIXELS_PER_BLOCK, MODES.index(mode),
            int(allow_negative), stream,
        )
    _raise_on(err, "hogbom_step")
    hogbom_step.launches += 1
    return part_cmp, part_idx, part_integ


hogbom_step.launches = 0


def hogbom_select(
    partials: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    residual: torch.Tensor,
    buffers: LoopBuffers,
    params: LoopParams,
    rms: Optional[torch.Tensor] = None,
) -> None:
    """Reduce the step's partials to the new peak and update ``buffers``
    (state, value, peak values, next component values) on the device.
    A no-op when ``state[ACTIVE]`` is 0."""
    if residual.device.type == "cpu":
        return hogbom_select_reference(partials, residual, buffers, params, rms)
    if residual.device.type != "cuda":
        raise ValueError(f"hogbom_select: unsupported device {residual.device}")
    part_cmp, part_idx, part_integ = partials
    n, height, width = residual.shape
    n_parts = part_cmp.shape[0]
    dev, f32 = residual.device, torch.float32
    ptrs_in = [
        _check(part_cmp, "part_cmp", dev, (n_parts,), f32),
        _check(part_idx, "part_idx", dev, (n_parts,), torch.int32),
        _check(part_integ, "part_integ", dev, (n_parts,), f32),
    ]
    res_ptr = _check(residual, "residual", dev, (n, height, width), f32)
    rms_ptr = _check(rms, "rms", dev, (height, width), f32)
    ptrs_out = [
        _check(buffers.state, "state", dev, (STATE_SIZE,), torch.int32),
        _check(buffers.value, "value", dev, (1,), f32),
        _check(buffers.peak, "peak", dev, (n,), f32),
        _check(buffers.values, "values", dev, (n,), f32),
    ]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hogbom_select(
            *ptrs_in, n_parts, res_ptr, rms_ptr, n, height, width, *ptrs_out,
            params.gain, params.first_threshold, params.initial_abs_peak,
            params.divergence_limit, params.max_iterations,
            int(params.stop_on_negative), stream,
        )
    _raise_on(err, "hogbom_select")
    hogbom_select.launches += 1


hogbom_select.launches = 0


def hogbom_step_facets(
    residual: torch.Tensor,
    model: torch.Tensor,
    psfs: torch.Tensor,
    values: torch.Tensor,
    state: torch.Tensor,
    coefs: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    *,
    mode: str,
    n_polarizations: int,
    allow_negative: bool,
    boxes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`hogbom_step` for F facets in one launch: ``residual`` and
    ``model`` ``[F, N, H, W]``, ``psfs`` ``[C, H, W]`` shared by every facet
    or ``[F, C, H, W]``, ``values`` ``[F, N]``, ``state`` ``[F,
    STATE_SIZE]``, ``weight`` ``[F, H, W]`` or None; ``boxes``, an int32
    ``[F, 2]`` tensor on the CPU, each facet's true box (rows, columns) at
    the top left of the common box ``H`` x ``W`` (None: the whole box).
    Only the true boxes are read and written.  Returns the partials ``[F,
    n_parts]`` (:func:`facet_parts`), a facet's unused tail as no peak.  A
    facet whose ``state[f, ACTIVE]`` is 0 is left unchanged."""
    args = (residual, model, psfs, values, state, coefs, weight)
    kw = dict(mode=mode, n_polarizations=n_polarizations,
              allow_negative=allow_negative, boxes=boxes)
    if residual.device.type == "cpu":
        return hogbom_step_facets_reference(*args, **kw)
    if residual.device.type != "cuda":
        raise ValueError(
            f"hogbom_step_facets: unsupported device {residual.device}")
    n_facets, n, height, width = residual.shape
    n_chan = n // n_polarizations
    shared = psfs.ndim == 3
    if (n_chan * n_polarizations != n or height * width >= 2**31
            or (mode == "signed" and n != 1)):
        raise ValueError(
            f"hogbom_step_facets: bad cube shape {tuple(residual.shape)}")
    sizes, n_parts = facet_parts(boxes, height, width, n_facets)
    box_table = torch.tensor(sizes, dtype=torch.int32)
    n_coefs = n + (n_chan if mode == "normal" else 0)
    dev, f32 = residual.device, torch.float32
    part_cmp = torch.empty((n_facets, n_parts), dtype=f32, device=dev)
    part_idx = torch.empty((n_facets, n_parts), dtype=torch.int32,
                           device=dev)
    part_integ = torch.empty((n_facets, n_parts), dtype=f32, device=dev)
    psf_shape = (n_chan, height, width) if shared else (
        n_facets, n_chan, height, width)
    cube = (n_facets, n, height, width)
    ptrs = [
        _check(residual, "residual", dev, cube, f32),
        _check(model, "model", dev, cube, f32),
        _check(psfs, "psfs", dev, psf_shape, f32),
        0 if shared else n_chan * height * width,
        _check(weight, "weight", dev, (n_facets, height, width), f32),
        _check(coefs, "coefs", dev, (n_coefs,), f32),
        _check(values, "values", dev, (n_facets, n), f32),
        _check(state, "state", dev, (n_facets, STATE_SIZE), torch.int32),
        part_cmp.data_ptr(),
        part_idx.data_ptr(),
        part_integ.data_ptr(),
        box_table.data_ptr(),
    ]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hogbom_step_facets(
            *ptrs, n_parts, n_facets, n, n_polarizations, height, width,
            PIXELS_PER_BLOCK, MODES.index(mode), int(allow_negative), stream,
        )
    _raise_on(err, "hogbom_step_facets")
    hogbom_step_facets.launches += -(-n_facets // FACETS_PER_LAUNCH)
    return part_cmp, part_idx, part_integ


hogbom_step_facets.launches = 0


def hogbom_select_facets(
    partials: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    residual: torch.Tensor,
    buffers: LoopBuffers,
    params: FacetLoopParams,
    rms: Optional[torch.Tensor] = None,
) -> None:
    """:func:`hogbom_select` for F facets in one launch, one block a facet:
    each facet's partials reduce to its own peak (the smallest flat index
    among equal maxima) and advance its own state; ``buffers`` in facet
    mode, ``rms`` ``[F, H, W]`` or None."""
    if residual.device.type == "cpu":
        return hogbom_select_facets_reference(partials, residual, buffers,
                                              params, rms)
    if residual.device.type != "cuda":
        raise ValueError(
            f"hogbom_select_facets: unsupported device {residual.device}")
    part_cmp, part_idx, part_integ = partials
    n_facets, n, height, width = residual.shape
    n_parts = part_cmp.shape[1]
    dev, f32 = residual.device, torch.float32
    ptrs_in = [
        _check(part_cmp, "part_cmp", dev, (n_facets, n_parts), f32),
        _check(part_idx, "part_idx", dev, (n_facets, n_parts), torch.int32),
        _check(part_integ, "part_integ", dev, (n_facets, n_parts), f32),
    ]
    res_ptr = _check(residual, "residual", dev, (n_facets, n, height, width),
                     f32)
    rms_ptr = _check(rms, "rms", dev, (n_facets, height, width), f32)
    ptrs_out = [
        _check(buffers.state, "state", dev, (n_facets, STATE_SIZE),
               torch.int32),
        _check(buffers.value, "value", dev, (n_facets,), f32),
        _check(buffers.peak, "peak", dev, (n_facets, n), f32),
        _check(buffers.values, "values", dev, (n_facets, n), f32),
        _check(params.limits, "limits", dev, (n_facets, 2), f32),
        _check(params.max_iterations_device, "max_iterations", dev,
               (n_facets,), torch.int32),
    ]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hogbom_select_facets(
            *ptrs_in, n_parts, n_facets, res_ptr, rms_ptr, n, height, width,
            *ptrs_out, params.gain, params.divergence_limit,
            int(params.stop_on_negative), stream,
        )
    _raise_on(err, "hogbom_select_facets")
    hogbom_select_facets.launches += 1


hogbom_select_facets.launches = 0


# ---------------------------------------------------------------------------
# The minor loop
# ---------------------------------------------------------------------------


class LoopResult(NamedTuple):
    iteration: int
    value: float
    found: bool
    diverging: bool


def fitted_values(fitter, raw: torch.Tensor, index: torch.Tensor,
                  gain: float, n_channels: int,
                  n_polarizations: int) -> torch.Tensor:
    """The spectral fit of the raw peak values ``raw`` at the flat pixel
    ``index`` (``[1]``), gain-scaled: the loop body's
    ``fit_and_evaluate(...) * gain``, without a host read (forced terms are
    gathered by ``index_select``, not by indexing with a device scalar)."""
    forced = None
    if fitter._forced_terms is not None:
        terms = fitter._forced_terms
        forced = terms.reshape(terms.shape[0], -1).index_select(
            1, index.long())[:, 0]
    vals = fitter.fit_and_evaluate(raw.view(n_channels, n_polarizations),
                                   forced_terms=forced)
    return vals.reshape(-1) * gain


class CoefficientFit:
    """The fused multiscale loop's spectral fit in coefficient space
    (``multiscale_fused.py:625-636`` of the JAX package), for a loop's
    ``buffers`` and its ``[T*P, H, W]`` coefficient cube ``model``.

    :meth:`refit` fits the raw peak values to ``coef = fit_m @ v`` per
    polarization, then writes the component values ``(expand @ coef) *
    gain`` into ``buffers.values``; :meth:`add` adds ``coef * gain`` to
    ``model`` at the loop state's peak (its flat index ``state[INDEX]``)
    while the state is active.  The buffers and views are made once, so
    that an iteration costs six small launches and no host read: the fit
    between B1's launches is host-bound work, and views made anew each
    iteration cost more than the launches."""

    def __init__(self, fit_m: torch.Tensor, expand: torch.Tensor,
                 buffers: LoopBuffers, model: torch.Tensor, gain: float,
                 n_channels: int, n_polarizations: int):
        self.fit_m, self.expand, self.gain = fit_m, expand, gain
        self.raw = buffers.peak.view(n_channels, n_polarizations)
        self.values = buffers.values
        dev = model.device
        self.coef = torch.empty((fit_m.shape[0], n_polarizations), device=dev)
        self.coef_flat = self.coef.view(-1)
        self.coef_gain = torch.empty_like(self.coef_flat)
        self.masked = torch.empty((self.coef_flat.numel(), 1), device=dev)
        self.model_flat = model.view(model.shape[0], -1)
        self.index = buffers.state[INDEX:INDEX + 1]
        self.active = buffers.state[ACTIVE:ACTIVE + 1]
        self.refit()

    def refit(self) -> None:
        torch.matmul(self.fit_m, self.raw, out=self.coef)
        torch.mv(self.expand, self.coef_flat, out=self.values).mul_(self.gain)
        torch.mul(self.coef_flat, self.gain, out=self.coef_gain)

    def add(self) -> None:
        torch.mul(self.coef_gain, self.active, out=self.masked.view(-1))
        self.model_flat.index_add_(1, self.index, self.masked)


def start_loop(residual: torch.Tensor, peak0: Tuple[float, int, int, bool],
               params: LoopParams, start_iteration: int, *, meta,
               fitter=None) -> Tuple[LoopBuffers, bool]:
    """The loop state at the initial peak ``peak0`` = (value, x, y, found),
    on the residual's device, and whether the first iteration runs (the
    loop condition, evaluated on the host)."""
    width = residual.shape[-1]
    value0, x0, y0, found0 = peak0
    value0 = float(np.float32(value0))
    active0 = (
        found0
        and abs(value0) > params.first_threshold
        and start_iteration < params.max_iterations
        and (value0 >= 0.0 or not params.stop_on_negative)
    )
    dev = residual.device
    state = torch.tensor(
        [y0, x0, int(found0), 0, start_iteration, int(active0),
         y0 * width + x0, 0],
        dtype=torch.int32, device=dev,
    )
    raw = residual[:, y0, x0].clone()
    buffers = LoopBuffers(
        state=state,
        value=torch.tensor([value0], dtype=torch.float32, device=dev),
        peak=raw,
        values=raw * params.gain,
    )
    if fitter is not None:
        buffers.values = fitted_values(
            fitter, raw, state[INDEX:INDEX + 1], params.gain,
            meta.n_channels, meta.n_polarizations)
    return buffers, active0


def run_chunks(iterate, buffers: LoopBuffers, params: LoopParams,
               start_iteration: int, active: bool) -> LoopResult:
    """Call ``iterate()`` (one loop iteration, enqueued on the device and a
    no-op once ``state[ACTIVE]`` is 0) ``CHUNK`` times between two host
    reads of the state, until the loop stops; return its result."""
    iteration = start_iteration
    while active:
        for _ in range(min(CHUNK, params.max_iterations - iteration)):
            iterate()
        host = buffers.state.tolist()
        iteration, active = host[ITERATION], bool(host[ACTIVE])
    host = buffers.state.tolist()
    return LoopResult(
        iteration=host[ITERATION],
        value=float(buffers.value.item()),
        found=bool(host[FOUND]),
        diverging=bool(host[DIVERGING]),
    )


def hogbom_loop(
    residual: torch.Tensor,  # [N, H, W], updated in place
    model: torch.Tensor,  # [N, H, W], updated in place
    psfs: torch.Tensor,  # [C, H, W] centered PSFs at image size
    weight: Optional[torch.Tensor],  # [H, W] mask x border x rms, or None
    rms: Optional[torch.Tensor],  # [H, W] rms factor, or None
    peak0: Tuple[float, int, int, bool],  # (value, x, y, found)
    params: LoopParams,
    start_iteration: int,
    *,
    meta,
    allow_negative: bool,
    fitter=None,
    plain: bool = False,
    integration: Optional[Tuple[str, np.ndarray]] = None,
    coefficients: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> LoopResult:
    """The Högbom minor loop (``generic_clean.cc:163-206``), with the same
    contract as the JAX package's ``hogbom_loop_pallas`` and
    ``_hogbom_loop``.

    On CUDA tensors each iteration is the two kernel launches (``plain``
    runs their plain versions instead, for comparison); on CPU tensors it is
    the plain versions.  Between launches, only device-side torch ops run
    (the spectral fit, when a fitter is active); the host reads the state
    once per ``CHUNK`` iterations.

    ``integration``, a ``(mode, chan_coefs)`` pair, replaces the joined
    integration that ``meta`` implies (:func:`integration_coefficients`):
    multiscale's dense subminor loop runs the linear one whatever the
    cube's polarizations and joins.

    ``coefficients``, a ``(fit_m [T, C], expand [N, T*P])`` pair, tracks the
    components in the spectral fit's coefficient space, as the fused
    multiscale loop does (:class:`CoefficientFit`): ``model`` is then the
    ``[T*P, H, W]`` coefficient cube, which gains ``coef * gain`` at each
    peak, and the kernels' own model update goes to a scratch cube that is
    never read.  ``fitter`` is not used with it.
    """
    dev = residual.device
    if integration is None:
        mode, chan_np, pol_np = integration_coefficients(meta)
    else:
        (mode, chan_np), pol_np = integration, np.ones(1, np.float32)
    coefs = torch.as_tensor(kernel_coefficients(mode, chan_np, pol_np),
                            device=dev)
    step = hogbom_step_reference if plain else hogbom_step
    select = hogbom_select_reference if plain else hogbom_select
    C, P = meta.n_channels, meta.n_polarizations
    buffers, active0 = start_loop(residual, peak0, params, start_iteration,
                                  meta=meta, fitter=fitter)
    kernel_model, coef_fit = model, None
    if coefficients is not None:
        coef_fit = CoefficientFit(*coefficients, buffers, model, params.gain,
                                  C, P)
        kernel_model = torch.empty_like(residual)

    def iterate():
        state = buffers.state
        if coef_fit is not None:
            coef_fit.add()
        partials = step(
            residual, kernel_model, psfs, buffers.values, state, coefs,
            weight, mode=mode, n_polarizations=P,
            allow_negative=allow_negative,
        )
        select(partials, residual, buffers, params, rms)
        if coef_fit is not None:
            coef_fit.refit()
        elif fitter is not None:
            buffers.values.copy_(fitted_values(
                fitter, buffers.peak, state[INDEX:INDEX + 1],
                params.gain, C, P))

    return run_chunks(iterate, buffers, params, start_iteration, active0)


class FacetLoopResult(NamedTuple):
    results: Tuple[LoopResult, ...]  # one a facet
    lockstep: int  # iterations enqueued for all facets together


def facet_fitted_values(fitter, raw: torch.Tensor, index: torch.Tensor,
                        gain, n_channels: int, n_polarizations: int,
                        forced_terms: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """:func:`fitted_values` for F facets at once: ``raw`` ``[F, N]``, the
    flat peak indices ``index`` ``[F]``, the facets' term images
    ``forced_terms`` ``[F, T-1, H, W]`` (FORCED_TERMS mode); ``gain`` is
    one number or ``[F, 1]``, one a facet.  Each
    polarization of each facet is fitted on its own, so the polynomial fits
    take every facet's spectra as columns of one product."""
    n_facets = raw.shape[0]
    if forced_terms is None:
        cols = raw.view(n_facets, n_channels, n_polarizations).transpose(0, 1)
        fitted = fitter.fit_and_evaluate(
            cols.reshape(n_channels, n_facets * n_polarizations))
        fitted = fitted.view(n_channels, n_facets, n_polarizations)
        return fitted.transpose(0, 1).reshape(n_facets, -1) * gain
    terms = forced_terms.reshape(n_facets, forced_terms.shape[1], -1)
    at = index.long().view(n_facets, 1, 1).expand(-1, terms.shape[1], 1)
    gathered = torch.gather(terms, 2, at)[..., 0]  # [F, T-1]
    return torch.stack([
        fitter.fit_and_evaluate(
            raw[f].view(n_channels, n_polarizations),
            forced_terms=gathered[f]).reshape(-1)
        for f in range(n_facets)
    ]) * gain


def facet_hogbom_loop(
    residual: torch.Tensor,  # [F, N, H, W], updated in place
    model: torch.Tensor,  # [F, N, H, W] (or [F, T*P, H, W]), in place
    psfs: torch.Tensor,  # [C, H, W] shared, or [F, C, H, W]
    weight: Optional[torch.Tensor],  # [F, H, W] mask x border x rms, or None
    rms: Optional[torch.Tensor],  # [F, H, W] rms factor, or None
    peaks0,  # per facet (value, x, y, found)
    params: FacetLoopParams,
    start_iterations,  # per facet
    *,
    meta,
    allow_negative: bool,
    fitter=None,
    forced_terms: Optional[torch.Tensor] = None,  # [F, T-1, H, W]
    plain: bool = False,
    boxes: Optional[torch.Tensor] = None,  # int32 [F, 2] (rows, cols), CPU
    integration: Optional[Tuple[str, np.ndarray]] = None,
    coefficients: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> FacetLoopResult:
    """F facets' Högbom minor loops in lockstep: the loop of
    :func:`hogbom_loop` on each facet, with one facet-mode step and select
    launch an iteration for all of them (the JAX package's vmapped
    ``_facet_hogbom_program``, ``generic_clean.py:154``, and its vmapped
    fused multiscale loop's dense subminor, ``multiscale.py:1335-1641``).
    Facets stop on their own; the launches go on, no-ops for stopped
    facets, until the last one stops.  The host reads every facet's state
    once per ``CHUNK`` iterations.  ``boxes`` holds each facet's true box
    at the top left of the common box (None: the whole box); the step never
    touches the padding around it, whose weight must be 0.  ``plain`` runs
    the plain versions on CUDA tensors.

    ``integration`` and ``coefficients`` are :func:`hogbom_loop`'s: the
    integration that replaces the joined one, and the fit in coefficient
    space (``model`` then holds each facet's ``[T*P, H, W]`` coefficient
    cube; each facet's fit is :class:`CoefficientFit` on its own views, so
    that a facet's bits are its single loop's).  ``params`` may give each
    facet its own gain."""
    dev = residual.device
    n_facets = residual.shape[0]
    if integration is None:
        mode, chan_np, pol_np = integration_coefficients(meta)
    else:
        (mode, chan_np), pol_np = integration, np.ones(1, np.float32)
    coefs = torch.as_tensor(kernel_coefficients(mode, chan_np, pol_np),
                            device=dev)
    step = hogbom_step_facets_reference if plain else hogbom_step_facets
    select = hogbom_select_facets_reference if plain else hogbom_select_facets
    C, P = meta.n_channels, meta.n_polarizations
    width = residual.shape[-1]

    host_state, active = [], []
    for f, ((value0, x0, y0, found0), start) in enumerate(
            zip(peaks0, start_iterations)):
        value0 = float(np.float32(value0))
        loop = params.facet(f)
        go = (found0 and abs(value0) > loop.first_threshold
              and start < loop.max_iterations
              and (value0 >= 0.0 or not loop.stop_on_negative))
        active.append(go)
        host_state.append([y0, x0, int(found0), 0, start, int(go),
                           y0 * width + x0, 0])
    state = torch.tensor(host_state, dtype=torch.int32, device=dev)
    raw = torch.stack([residual[f, :, p[2], p[1]]
                       for f, p in enumerate(peaks0)])
    gain = params.gain if params.gains is None else params.gains
    buffers = LoopBuffers(
        state=state,
        value=torch.tensor([float(np.float32(p[0])) for p in peaks0],
                           dtype=torch.float32, device=dev),
        peak=raw,
        values=raw * gain,
    )
    index = state[:, INDEX]
    kernel_model, coef_fits = model, []
    if coefficients is not None:
        coef_fits = [
            CoefficientFit(*coefficients, buffers.facet(f), model[f],
                           params.facet_gain(f), C, P)
            for f in range(n_facets)]
        kernel_model = torch.empty_like(residual)

    def refit():
        if coef_fits:
            for fit in coef_fits:
                fit.refit()
        elif fitter is not None:
            buffers.values.copy_(facet_fitted_values(
                fitter, buffers.peak, index, gain, C, P, forced_terms))
        elif params.gains is not None:
            torch.mul(buffers.peak, params.gains, out=buffers.values)

    if fitter is not None and not coef_fits:
        refit()

    def iterate():
        for fit in coef_fits:
            fit.add()
        partials = step(
            residual, kernel_model, psfs, buffers.values, buffers.state,
            coefs, weight, mode=mode, n_polarizations=P,
            allow_negative=allow_negative, boxes=boxes,
        )
        select(partials, residual, buffers, params, rms)
        refit()

    iterations = list(start_iterations)
    lockstep = 0
    while any(active):
        left = max(params.max_iterations[f] - iterations[f]
                   for f in range(n_facets) if active[f])
        for _ in range(min(CHUNK, left)):
            iterate()
            lockstep += 1
        host = buffers.state.tolist()
        iterations = [h[ITERATION] for h in host]
        active = [bool(h[ACTIVE]) for h in host]
    host = buffers.state.tolist()
    values = buffers.value.tolist()
    return FacetLoopResult(
        results=tuple(
            LoopResult(iteration=h[ITERATION], value=v, found=bool(h[FOUND]),
                       diverging=bool(h[DIVERGING]))
            for h, v in zip(host, values)),
        lockstep=lockstep,
    )
