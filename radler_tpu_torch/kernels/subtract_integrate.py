"""The shard-local Högbom step of the mesh loop: CUDA kernel and plain version.

Port of ``radler_tpu.ops.pallas.hogbom_step``'s TPU kernel
``_subtract_integrate_kernel`` (behind ``fused_subtract_integrate``), which
:func:`radler_tpu_torch.parallel.mesh.mesh_hogbom_loop` runs on every shard
when the mesh splits the cube's planes over its ``"chan"`` axis.  One launch
of ``csrc/subtract_integrate.cu`` adds the component values to the shard's
model at the peak (on the shard that holds its row), subtracts the shifted
PSFs from the shard's residual (in place) and writes the shard's additive
part of the joined integration, which the mesh sums over ``"chan"``.

Conventions are B1's (:mod:`radler_tpu_torch.kernels.hogbom_step`): the
PSFs are un-padded at the full image size, the peak is read in image rows
from the device loop state, the shard passes its first image row, and the
launch is a no-op when ``state[ACTIVE]`` is 0.  :func:`subtract_integrate`
runs :func:`subtract_integrate_reference` for CPU tensors and launches the
kernel (or raises) for CUDA tensors; both perform the same float32
operations in the same order.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ..ops.psf_subtract import subtract_psf_from_cube
from .hogbom_step import (
    ACTIVE,
    MODES,
    STATE_SIZE,
    X,
    Y,
    _check,
    _raise_on,
    add_at_peak,
)


def plane_coefficients(mode: str, chan_coefs: np.ndarray,
                       n_polarizations: int) -> np.ndarray:
    """One channel coefficient per cube plane, the array a shard slices its
    ``coefs`` from (``mesh.py:433-436`` of the JAX package): the
    coefficients themselves in signed mode (one plane) and linear mode (one
    per plane), each channel's repeated over its polarizations otherwise."""
    chan = np.asarray(chan_coefs, np.float32)
    if mode in ("signed", "linear"):
        return chan.copy()
    return np.repeat(chan, n_polarizations)


def integrate_part(planes: torch.Tensor, coefs: torch.Tensor,
                   pol_coefs: torch.Tensor, mode: str,
                   n_polarizations: int) -> torch.Tensor:
    """The additive part of the joined integration of ``planes`` (``[N_loc,
    ...]``), one float32 operation at a time in the TPU kernel's order
    (``hogbom_step.py:410-443``); squared mode stops before the sqrt."""
    n, P = planes.shape[0], n_polarizations
    acc = None
    if mode in ("signed", "linear"):
        for i in range(n):
            term = planes[i] * coefs[i]
            acc = term if acc is None else acc + term
        return acc
    if mode == "squared":
        for i in range(n):
            term = planes[i] * planes[i] * coefs[i - i % P] * pol_coefs[i % P]
            acc = term if acc is None else acc + term
        return acc
    for c in range(n // P):
        if P == 1:
            per_chan = planes[c]
        else:
            sq = None
            for p in range(P):
                i = c * P + p
                term = planes[i] * planes[i] * pol_coefs[p]
                sq = term if sq is None else sq + term
            per_chan = torch.sqrt(torch.clamp_min(sq, 0.0))
        term = per_chan * coefs[c * P]
        acc = term if acc is None else acc + term
    return acc


def subtract_integrate_reference(
    residual: torch.Tensor,
    model: torch.Tensor,
    psfs: torch.Tensor,
    values: torch.Tensor,
    state: torch.Tensor,
    coefs: torch.Tensor,
    pol_coefs: torch.Tensor,
    out: torch.Tensor,
    *,
    mode: str,
    n_polarizations: int,
    row_offset: int = 0,
) -> torch.Tensor:
    """Plain version of :func:`subtract_integrate`; reads nothing back to
    the host."""
    n = residual.shape[0]
    active = state[ACTIVE] != 0
    y, x = state[Y].long(), state[X].long()
    add_at_peak(model, values, y - row_offset, x, active)
    psf_indices = torch.arange(n, device=residual.device) // n_polarizations
    new = subtract_psf_from_cube(residual, psfs, psf_indices, x, y, values,
                                 row_offset)
    residual.copy_(torch.where(active, new, residual))
    part = integrate_part(residual, coefs, pol_coefs, mode, n_polarizations)
    out.copy_(torch.where(active, part, out))
    return out


_bound_entry = None


def _entry():
    """The kernel's C entry point, with its signature declared once."""
    global _bound_entry
    if _bound_entry is None:
        from . import _build

        fn = _build.library().subtract_integrate
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _bound_entry = fn
    return _bound_entry


def subtract_integrate(
    residual: torch.Tensor,
    model: torch.Tensor,
    psfs: torch.Tensor,
    values: torch.Tensor,
    state: torch.Tensor,
    coefs: torch.Tensor,
    pol_coefs: torch.Tensor,
    out: torch.Tensor,
    *,
    mode: str,
    n_polarizations: int,
    row_offset: int = 0,
) -> torch.Tensor:
    """One shard's step: add ``values`` to ``model`` at the peak in
    ``state`` when the shard holds its row, subtract the shifted PSFs from
    ``residual`` (both in place), and write the shard's additive part of the
    joined integration into ``out``, which it returns.  A no-op when
    ``state[ACTIVE]`` is 0 (``out`` keeps what it held).

    ``residual`` and ``model`` are the shard's ``[N_loc, H_loc, W]``, the
    image rows ``row_offset .. row_offset + H_loc - 1``; ``psfs`` the
    shard's un-padded ``[N_loc // n_polarizations, H, W]`` PSFs at the full
    image size; ``values`` its ``[N_loc]`` component values; ``coefs`` its
    ``[N_loc]`` slice of :func:`plane_coefficients`; ``pol_coefs`` the
    ``[n_polarizations]`` polarization coefficients (read in normal and
    squared mode); ``out`` ``[H_loc, W]``.
    """
    args = (residual, model, psfs, values, state, coefs, pol_coefs, out)
    kw = dict(mode=mode, n_polarizations=n_polarizations,
              row_offset=row_offset)
    if residual.device.type == "cpu":
        return subtract_integrate_reference(*args, **kw)
    if residual.device.type != "cuda":
        raise ValueError(
            f"subtract_integrate: unsupported device {residual.device}")
    if residual.ndim != 3 or psfs.ndim != 3:
        raise ValueError(
            f"subtract_integrate: bad shapes {tuple(residual.shape)}, "
            f"{tuple(psfs.shape)}")
    n, height_local, width = residual.shape
    n_chan, height = n // n_polarizations, psfs.shape[1]
    if (n == 0 or n_chan * n_polarizations != n or height_local * width == 0
            or height * width >= 2**31
            or not 0 <= row_offset <= height - height_local):
        raise ValueError(
            f"subtract_integrate: bad shard {tuple(residual.shape)} at row "
            f"{row_offset} of PSFs {tuple(psfs.shape)}")
    if mode == "signed" and n != 1:
        raise ValueError("subtract_integrate: signed mode takes one plane")
    dev, f32 = residual.device, torch.float32
    ptrs = [
        _check(residual, "residual", dev, (n, height_local, width), f32),
        _check(model, "model", dev, (n, height_local, width), f32),
        _check(psfs, "psfs", dev, (n_chan, height, width), f32),
        _check(values, "values", dev, (n,), f32),
        _check(coefs, "coefs", dev, (n,), f32),
        _check(pol_coefs, "pol_coefs", dev, (n_polarizations,), f32),
        _check(state, "state", dev, (STATE_SIZE,), torch.int32),
        _check(out, "out", dev, (height_local, width), f32),
    ]
    launch = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(*ptrs, n, n_polarizations, height_local, width, height,
                     row_offset, MODES.index(mode), stream)
    _raise_on(err, "subtract_integrate")
    subtract_integrate.launches += 1
    subtract_integrate.launches_by_card[dev.index] += 1
    return out


subtract_integrate.launches = 0
subtract_integrate.launches_by_card = collections.Counter()
