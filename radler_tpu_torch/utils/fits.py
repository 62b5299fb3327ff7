"""Minimal pure-Python FITS I/O.

Replaces the reference's CFITSIO dependency (``aocommon::FitsReader`` /
``FitsWriter``) for the cases Radler needs: reading 2-D/3-D float image HDUs
(masks, RMS maps, forced-spectrum terms, test data) and writing simple float32
images.  Only the primary HDU is handled.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

_BLOCK = 2880

_BITPIX_DTYPES = {
    8: np.uint8,
    16: ">i2",
    32: ">i4",
    64: ">i8",
    -32: ">f4",
    -64: ">f8",
}


def _parse_header(f) -> Dict[str, str]:
    header: Dict[str, str] = {}
    while True:
        block = f.read(_BLOCK)
        if len(block) < _BLOCK:
            raise RuntimeError("Truncated FITS header")
        for i in range(0, _BLOCK, 80):
            card = block[i : i + 80].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                return header
            if "=" in card[8:10]:
                value = card[10:].split("/")[0].strip()
                header[key] = value


def _header_value(header: Dict[str, str], key: str, default=None):
    if key not in header:
        if default is not None:
            return default
        raise RuntimeError(f"FITS header misses {key}")
    v = header[key]
    if v.startswith("'"):
        return v.strip("' ")
    if v in ("T", "F"):
        return v == "T"
    return float(v) if ("." in v or "E" in v or "e" in v) else int(v)


def read_fits(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """Read the primary HDU; returns (data with NAXIS order [slowest...fastest],
    header dict)."""
    with open(path, "rb") as f:
        header = _parse_header(f)
        bitpix = int(_header_value(header, "BITPIX"))
        naxis = int(_header_value(header, "NAXIS"))
        shape = [
            int(_header_value(header, f"NAXIS{i}")) for i in range(1, naxis + 1)
        ]
        count = int(np.prod(shape)) if shape else 0
        dtype = np.dtype(_BITPIX_DTYPES[bitpix])
        raw = f.read(count * dtype.itemsize)
        data = np.frombuffer(raw, dtype=dtype, count=count)
        bscale = float(_header_value(header, "BSCALE", 1.0))
        bzero = float(_header_value(header, "BZERO", 0.0))
        data = data.astype(np.float64) * bscale + bzero
        # FITS stores NAXIS1 fastest; reshape to [... , NAXIS2, NAXIS1].
        data = data.reshape(shape[::-1]) if shape else data
        return data, header


def read_fits_image(path: str) -> np.ndarray:
    """First 2-D plane as float32 [H, W]."""
    data, _ = read_fits(path)
    while data.ndim > 2:
        data = data[0]
    return np.ascontiguousarray(data, dtype=np.float32)


def read_fits_cube(path: str) -> np.ndarray:
    """[n_planes, H, W] float32 (degenerate leading axes collapsed)."""
    data, _ = read_fits(path)
    if data.ndim == 2:
        return data[None].astype(np.float32)
    data = data.reshape((-1,) + data.shape[-2:])
    return np.ascontiguousarray(data, dtype=np.float32)


def _card(key: str, value, comment: str = "") -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
        text = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        text = f"{key:<8}= {value:>20d}"
    elif isinstance(value, float):
        text = f"{key:<8}= {value:>20.14E}"
    else:
        text = f"{key:<8}= '{value}'"
    if comment:
        text += f" / {comment}"
    return text[:80].ljust(80).encode("ascii")


def write_fits_image(
    path: str,
    data: np.ndarray,
    pixel_scale_x: float = 0.0,
    pixel_scale_y: float = 0.0,
) -> None:
    """Write a float32 image (or [C,H,W] cube) as the primary HDU."""
    data = np.asarray(data, dtype=np.float32)
    cards = [
        _card("SIMPLE", True),
        _card("BITPIX", -32),
        _card("NAXIS", data.ndim),
    ]
    for i, n in enumerate(data.shape[::-1]):
        cards.append(_card(f"NAXIS{i + 1}", n))
    if pixel_scale_x:
        cards.append(_card("CDELT1", -pixel_scale_x * 180.0 / math.pi))
        cards.append(_card("CDELT2", pixel_scale_y * 180.0 / math.pi))
    cards.append(b"END".ljust(80))
    header = b"".join(cards)
    header += b" " * (-len(header) % _BLOCK)
    payload = data.astype(">f4").tobytes()
    payload += b"\0" * (-len(payload) % _BLOCK)
    with open(path, "wb") as f:
        f.write(header)
        f.write(payload)
