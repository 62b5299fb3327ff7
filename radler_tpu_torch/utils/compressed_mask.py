"""Run-length-compressed boolean masks.

Port of ``radler_tpu.utils.compressed_mask`` (``cpp/utils/compressed_mask*``):
a full-size boolean mask held as alternating-run counts with a 1/3/9-byte
encoding, with boxed get/set so that the facet layer can exchange
sub-regions.  The codec is NumPy on the host; the JAX package's optional
C++ codec (``native/radler_host.cc``) writes the same bytes and is not
carried.
"""

from __future__ import annotations

import numpy as np


def _compress(mask: np.ndarray):
    flat = np.asarray(mask, dtype=bool).reshape(-1)
    if flat.size == 0:
        return b"", False
    changes = np.flatnonzero(np.diff(flat.view(np.int8)))
    boundaries = np.concatenate([[-1], changes, [flat.size - 1]])
    counts = np.diff(boundaries)
    out = bytearray()
    for c in counts:
        c = int(c)
        if c < 255:
            out.append(c)
        elif c < 65536:
            out.append(255)
            out.append(c % 256)
            out.append(c // 256)
        else:
            out.append(0)
            out += int(c).to_bytes(8, "little")
    return bytes(out), bool(flat[0])


def _decompress(data: bytes, first_value: bool, n: int) -> np.ndarray:
    out = np.empty(n, dtype=bool)
    pos = 0
    written = 0
    value = first_value
    while written < n:
        head = data[pos]
        pos += 1
        if head == 255:
            count = data[pos] + 256 * data[pos + 1]
            pos += 2
        elif head == 0:
            count = int.from_bytes(data[pos : pos + 8], "little")
            pos += 8
        else:
            count = head
        out[written : written + count] = value
        written += count
        value = not value
    return out


class CompressedMask:
    """RLE bool mask with boxed access (``cpp/utils/compressed_mask.h``)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self._data, self._first_value = _compress(
            np.zeros(width * height, dtype=bool)
        )

    def compressed_size(self) -> int:
        return len(self._data) + 1

    # -- full access -------------------------------------------------------
    def get(self) -> np.ndarray:
        flat = _decompress(self._data, self._first_value,
                           self.width * self.height)
        return flat.reshape(self.height, self.width)

    def set(self, mask: np.ndarray) -> None:
        assert mask.shape == (self.height, self.width)
        self._data, self._first_value = _compress(mask)

    # -- boxed access ------------------------------------------------------
    def get_box(self, x: int, y: int, width: int, height: int) -> np.ndarray:
        """``CompressedMask::GetBox`` (``compressed_mask.cc:58-180``)."""
        return self.get()[y : y + height, x : x + width].copy()

    def set_box(
        self, box: np.ndarray, x: int, y: int, width: int, height: int
    ) -> None:
        full = self.get()
        full[y : y + height, x : x + width] = box
        self.set(full)
