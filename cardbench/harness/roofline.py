"""The card's published peaks and the work each kernel's algorithm needs.

The counts are of what the algorithm needs, whatever implements it: each
input read once and each output written once (``chip_smoke.py``'s
``bound_ms``, with the 4-byte PSF gathers of ``PERF.md``'s kernel table).
A kernel's roofline share is its bound over its measured time.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA's data sheet for the H100 SXM at its 700 W limit: HBM3 bandwidth,
# float32 outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
}
DEFAULT_PEAK = PEAKS["NVIDIA H100 80GB HBM3"]


def peaks(device_name: str) -> dict:
    return PEAKS.get(device_name, DEFAULT_PEAK)


def bound_s(n_bytes: float, n_flops: float, device_name: str
            ) -> Tuple[float, str]:
    """The least time the card could take, and what bounds it: the larger
    of the bytes over the memory rate and the operations over the float32
    rate."""
    p = peaks(device_name)
    t_bytes = n_bytes / p["bytes_per_s"]
    t_flops = n_flops / p["flops_per_s"]
    return (t_flops, "operations") if t_flops > t_bytes else (t_bytes,
                                                               "bytes")


def b2_work(n_planes: int, k: int, iterations: int,
            fit_bytes: int = 0) -> Tuple[float, float]:
    """(bytes, float32 operations) of one Clark subminor run over ``k``
    candidates in ``n_planes`` planes for ``iterations`` iterations: the
    candidates' values read and written, their model written and their
    positions read once, the fit's constants once, and the ``k * n_planes``
    4-byte PSF values that each iteration gathers (the iterations depend on
    each other in turn, so a PSF stack larger than the L2 is read anew
    each time).  An iteration joins the planes at every candidate and
    subtracts a shifted PSF from each: two multiply-adds a value."""
    state = 3 * n_planes * k * 4 + 2 * k * 4 + fit_bytes
    gathers = iterations * n_planes * k * 4
    return float(state + gathers), float(iterations * 4 * n_planes * k)


def b1_linear_work(n_planes: int, height: int, width: int,
                   iterations: int) -> Tuple[float, float]:
    """(bytes, float32 operations) of ``iterations`` Högbom steps in linear
    mode with a weight plane: each reads and writes every residual plane,
    reads the PSF at every plane and the weight plane; each value takes a
    multiply-add for the subtraction and one for the join, and each pixel
    a product with its weight."""
    pixels = height * width
    n_bytes = (3 * n_planes * pixels + pixels) * 4
    n_flops = (4 * n_planes + 1) * pixels
    return float(iterations * n_bytes), float(iterations * n_flops)
