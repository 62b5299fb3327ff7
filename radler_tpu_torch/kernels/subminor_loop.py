"""The Clark subminor loop: CUDA kernel, its plain version, the result.

Port of ``radler_tpu.ops.pallas.subminor_fused`` (the TPU kernel
``_loop_kernel`` behind ``subminor_loop_fused``).  :func:`subminor_loop`
runs the whole ``SubMinorLoop::Run`` while-loop over the ``[N, K]``
candidate state in one launch of ``csrc/subminor_loop.cu`` on CUDA tensors,
and its plain PyTorch version :func:`subminor_loop_reference` on CPU
tensors.  Both update ``residual_k`` and ``model_k`` in place and return a
small int32 tensor ``(iteration, diverging, bits of the last peak value)``
on the state's device, which :func:`read_result` brings to the host in one
read.

The kernel reads the PSF at image size where the TPU kernel read a prebuilt
``[C, K, K]`` interaction matrix; what bounds it, and its design, are in the
note at the top of the CUDA source.  The plain version performs the same
float32 operations in the same order (each fused multiply-add emulated
exactly by :func:`fma`), so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .hogbom_step import _check, _raise_on

# Planes the kernel takes (csrc/subminor_loop.cu kMaxImages).
MAX_IMAGES = 4000
# Output slots, shared with csrc/subminor_loop.cu.
ITERATION, DIVERGING, VALUE_BITS = range(3)


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


def read_result(out: torch.Tensor) -> Tuple[int, float, bool]:
    """(iteration, last peak value, diverging) from a run's output tensor,
    in one host read."""
    host = out.tolist()
    value = float(np.int32(host[VALUE_BITS]).view(np.float32))
    return host[ITERATION], value, bool(host[DIVERGING])


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


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _entry():
    """The kernel's C entry point, with its signature declared."""
    from . import _build

    fn = _build.library().subminor_loop
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = (
        [ptr] * 9 + [i32] * 5 + [f32] * 2 + [i32] * 2 + [f32] + [i32] * 2
        + [ptr]
    )
    fn.restype = i32
    return fn


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
) -> torch.Tensor:
    """Run the Clark subminor loop over the candidate state in one launch.

    ``residual_k`` and ``model_k`` are ``[N, K]`` float32 (updated in
    place), ``rms_k`` the optional ``[K]`` rms factor, ``xs``/``ys``
    ``[K]`` int32 positions of the candidates, ``psfs`` the
    ``[C, H, W]`` PSFs at image size (plane n uses PSF
    ``n // n_polarizations``), ``coef`` the ``[N]`` linear integration
    coefficients and ``proj`` the optional ``[C, C]`` polynomial-fit
    projection.  Returns the output tensor for :func:`read_result`.
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
    n, k = residual_k.shape
    n_psf, height, width = psfs.shape
    if not (0 < n <= MAX_IMAGES and n_psf * n_polarizations == n and k > 0
            and height * width < 2**31):
        raise ValueError(
            f"subminor_loop: bad shapes, state {tuple(residual_k.shape)}, "
            f"psfs {tuple(psfs.shape)}, {n_polarizations} polarizations"
        )
    dev, f32, i32 = residual_k.device, torch.float32, torch.int32
    out = torch.empty(3, dtype=i32, device=dev)
    ptrs = [
        _check(residual_k, "residual_k", dev, (n, k), f32),
        _check(model_k, "model_k", dev, (n, k), f32),
        _check(rms_k, "rms_k", dev, (k,), f32),
        _check(xs, "xs", dev, (k,), i32),
        _check(ys, "ys", dev, (k,), i32),
        _check(psfs, "psfs", dev, (n_psf, height, width), f32),
        _check(coef, "coef", dev, (n,), f32),
        _check(proj, "proj", dev, (n_psf, n_psf), f32),
        out.data_ptr(),
    ]
    launch = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            *ptrs, n, n_polarizations, k, height, width, params.threshold,
            params.gain, params.start_iteration, params.max_iterations,
            params.divergence_limit, int(params.allow_negative),
            int(params.stop_on_negative), stream,
        )
    _raise_on(err, "subminor_loop")
    subminor_loop.launches += 1
    return out


subminor_loop.launches = 0
