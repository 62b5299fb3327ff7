"""FFT size selection: 2·3·5·7-smooth even sizes.

Port of ``radler_tpu.utils.fft_size`` (``cpp/utils/fft_size_calculations.h:15-50``).
"""

from __future__ import annotations


def calculate_good_fft_size(minimum_size: int) -> int:
    """Smallest even 7-smooth integer >= minimum_size."""
    if minimum_size <= 2:
        return 2
    best = None
    # Search products 2^a * 3^b * 5^c * 7^d >= minimum_size with a >= 1.
    limit = 2 * minimum_size  # an upper bound: next power of two * 2 suffices
    p2 = 2
    while p2 // 2 < limit:
        p23 = p2
        while p23 < limit * 7:
            p235 = p23
            while p235 < limit * 7:
                p2357 = p235
                while p2357 < limit * 7:
                    if p2357 >= minimum_size and (best is None or p2357 < best):
                        best = p2357
                    p2357 *= 7
                p235 *= 5
            p23 *= 3
        p2 *= 2
    return best


def get_convolution_size(scale: float, image_dim: int, padding: float) -> int:
    """Padded convolution size for a given kernel scale
    (``cpp/utils/fft_size_calculations.h:39-50``): pad relative to the sum
    of 1.5 x scale and the image size, so that sources near the border do
    not wrap around during the FFT convolution."""
    return calculate_good_fft_size(int(padding * (1.5 * scale + image_dim)))
