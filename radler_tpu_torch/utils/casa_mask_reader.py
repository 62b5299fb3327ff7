"""CASA image mask reader.

Behavioral equivalent of ``cpp/utils/casa_mask_reader.{h,cc}``: open a
casacore image table, read the ``map`` column's [width, height, npol, nchan]
float cube, and OR all channel/polarization planes into one bool mask
(``casa_mask_reader.cc:12-39``).

The reference links casacore.  This environment has neither casacore nor
python-casacore, so two paths are provided:

1. ``python-casacore`` when importable (full fidelity, any table layout);
2. a minimal, dependency-free parser of the standard on-disk layout that
   casacore's ``PagedImage`` writes (a ``TiledCellStMan`` storage manager):

   * ``table.f<n>`` — the tiled storage manager's header, serialized with
     AipsIO in canonical (big-endian) format.  Every ``IPosition`` object in
     it is written as ``putstart("IPosition", 1)`` + ``uInt nelements`` +
     ``Int`` values, i.e. the byte pattern
     ``\\x00\\x00\\x00\\x09IPosition\\x00\\x00\\x00\\x01`` followed by the
     lengths — which makes the hypercube's ``cubeShape``/``tileShape`` pair
     recoverable without a full AipsIO parser.
   * ``table.f<n>_TSM0`` — the tile data: the hypercube split into
     ``tileShape`` tiles (edge tiles padded), tiles ordered Fortran-style
     over the tile grid, values Fortran-ordered float32 within each tile.

   The candidate (cubeShape, tileShape) pair is validated against the exact
   data-file size — ``prod(ceil(cube/tile)) * prod(tile) * 4`` bytes — so a
   wrong guess cannot silently return garbage.  Mask semantics (pixel != 0)
   are endian-independent for the usual 0/1 mask values; float values are
   additionally sanity-checked to pick the byte order.

Tables that do not match this layout raise a clear error pointing at FITS
conversion (``casaviewer``/``exportfits``), preserving the previous gate.
"""

from __future__ import annotations

import glob
import math
import os
import re
import struct
from typing import List, Optional, Tuple

import numpy as np

_IPOSITION_MAGIC = b"\x00\x00\x00\x09IPosition\x00\x00\x00\x01"
_MAX_RANK = 8


def _scan_ipositions(
    blob: bytes, start: int = 0
) -> List[Tuple[int, ...]]:
    """All IPosition values serialized in an AipsIO blob after ``start``,
    in file order."""
    out: List[Tuple[int, ...]] = []
    for m in re.finditer(re.escape(_IPOSITION_MAGIC), blob[start:]):
        pos = start + m.end()
        if pos + 4 > len(blob):
            continue
        (n,) = struct.unpack_from(">I", blob, pos)
        if n == 0 or n > _MAX_RANK or pos + 4 + 4 * n > len(blob):
            continue
        vals = struct.unpack_from(f">{n}i", blob, pos + 4)
        if all(v > 0 for v in vals):
            out.append(tuple(vals))
    return out


def _tiled_file_size(cube: Tuple[int, ...], tile: Tuple[int, ...]) -> int:
    ntiles = 1
    for c, t in zip(cube, tile):
        ntiles *= -(-c // t)
    return ntiles * int(np.prod(tile)) * 4


def _find_cube_and_tile(
    header: bytes, data_size: int
) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """The (cubeShape, tileShape) pair consistent with the data-file size.

    casacore's ``TSMCube::headerPut`` serializes the hypercube's shape
    followed directly by its tile shape inside a ``putstart("TSMCube", ...)``
    record, so the two IPositions right after the ``TSMCube`` marker are
    taken first (this also disambiguates the tile == cube case, where the
    file size alone cannot distinguish tilings).  Falls back to a global
    pair search over every serialized IPosition.
    """
    marker = header.find(b"TSMCube")
    if marker >= 0:
        after = _scan_ipositions(header, marker)
        if len(after) >= 2:
            cube, tile = after[0], after[1]
            if (
                len(cube) == len(tile)
                and all(t <= c for t, c in zip(tile, cube))
                and _tiled_file_size(cube, tile) == data_size
            ):
                return cube, tile
    ipositions = _scan_ipositions(header)
    for cube in ipositions:
        for tile in ipositions:
            if len(tile) != len(cube):
                continue
            if any(t > c for t, c in zip(tile, cube)):
                continue
            if _tiled_file_size(cube, tile) == data_size:
                return cube, tile
    return None


def _detile(
    raw: bytes, cube: Tuple[int, ...], tile: Tuple[int, ...], dtype: str
) -> np.ndarray:
    """Reassemble a tiled hypercube; returns a C-ordered array with the axes
    REVERSED relative to the casacore IPosition (axis 0 = slowest)."""
    grid = tuple(-(-c // t) for c, t in zip(cube, tile))
    tile_elems = int(np.prod(tile))
    tiles = np.frombuffer(raw, dtype=dtype).reshape(-1, tile_elems)
    out = np.zeros(cube[::-1], np.float32)
    for flat in range(tiles.shape[0]):
        tidx = np.unravel_index(flat, grid, order="F")
        # Fortran-ordered tile == C-ordered array of the reversed shape.
        block = tiles[flat].reshape(tile[::-1]).astype(np.float32)
        slices = []
        clip = []
        for axis in range(len(cube) - 1, -1, -1):
            start = tidx[axis] * tile[axis]
            stop = min(start + tile[axis], cube[axis])
            slices.append(slice(start, stop))
            clip.append(slice(0, stop - start))
        out[tuple(slices)] = block[tuple(clip)]
    return out


class CasaMaskReader:
    """Reads a CASA image table's ``map`` column as a mask cube.

    Mirrors ``radler::utils::CasaMaskReader``: ``width``/``height``/
    ``n_polarizations``/``n_channels`` from the cell shape, and
    :meth:`read` ORs every plane into a [height, width] bool mask.
    """

    def __init__(self, path: str):
        self.path = path
        self._cube: Optional[np.ndarray] = None  # [chan, pol, y, x]
        try:
            self._init_python_casacore(path)
            return
        except ImportError:
            pass
        self._init_minimal(path)

    # -- python-casacore path ---------------------------------------------
    def _init_python_casacore(self, path: str) -> None:
        from casacore.tables import table  # noqa: F401  (optional dep)

        with table(path, ack=False) as t:
            data = t.getcell("map", 0)
        # python-casacore returns C-ordered [nchan, npol, height, width].
        self._cube = np.asarray(data, np.float32)
        if self._cube.ndim != 4:
            raise RuntimeError(
                f"CASA image {path!r}: expected a 4-axis map column, got "
                f"{self._cube.ndim} axes"
            )
        self.n_channels, self.n_polarizations, self.height, self.width = (
            self._cube.shape
        )

    # -- dependency-free path ----------------------------------------------
    def _init_minimal(self, path: str) -> None:
        if not os.path.isdir(path):
            raise RuntimeError(f"CASA image {path!r}: not a table directory")
        data_files = sorted(glob.glob(os.path.join(path, "table.f*_TSM0")))
        if not data_files:
            raise RuntimeError(
                f"CASA image {path!r}: no tiled storage manager data file "
                "(table.f*_TSM0) found; convert the mask to FITS (e.g. with "
                "casa exportfits) and use fits_mask instead"
            )
        data_file = self._pick_map_data_file(path, data_files)
        header_file = data_file[: -len("_TSM0")]
        if not os.path.exists(header_file):
            raise RuntimeError(
                f"CASA image {path!r}: missing TSM header {header_file!r}"
            )
        with open(header_file, "rb") as f:
            header = f.read()
        data_size = os.path.getsize(data_file)
        found = _find_cube_and_tile(header, data_size)
        if found is None:
            raise RuntimeError(
                f"CASA image {path!r}: could not recover a (cube, tile) "
                "shape pair matching the data file; convert the mask to "
                "FITS (e.g. with casa exportfits) and use fits_mask instead"
            )
        cube, tile = found
        if len(cube) != 4:
            raise RuntimeError(
                f"CASA image {path!r}: expected a 4-axis image "
                f"[x, y, pol, chan], found shape {cube}"
            )
        with open(data_file, "rb") as f:
            raw = f.read()
        arr = _detile(raw, cube, tile, ">f4")  # [chan, pol, y, x]
        # The AipsIO metadata is always big-endian but the data file follows
        # the table's endian option; 0/1 masks are endian-independent, and
        # for general values the byte order with the saner magnitudes wins.
        finite = arr[np.isfinite(arr)]
        if finite.size and (np.abs(finite).max() > 1e30 or
                            (finite != 0).any() and
                            np.abs(finite[finite != 0]).max() < 1e-30):
            arr = _detile(raw, cube, tile, "<f4")
        self._cube = arr
        self.width, self.height, self.n_polarizations, self.n_channels = cube

    @staticmethod
    def _pick_map_data_file(path: str, data_files: List[str]) -> str:
        """The TSM data file backing the ``map`` column.

        The reference reads exactly the ``map`` column
        (``casa_mask_reader.cc:14``); a table with several tiled data columns
        must not silently decode the wrong cube.  Each storage manager's
        header (``table.f<n>``) serializes the names of the columns it binds,
        so when more than one candidate exists the one whose header mentions
        ``map`` is chosen; ambiguity falls back to the FITS-conversion error.
        """
        if len(data_files) == 1:
            return data_files[0]
        matches = []
        for data_file in data_files:
            header_file = data_file[: -len("_TSM0")]
            try:
                with open(header_file, "rb") as f:
                    header = f.read()
            except OSError:
                continue
            # AipsIO writes strings as uInt length + bytes; "map" appears as
            # \x00\x00\x00\x03map in the bound-column list.
            if b"\x00\x00\x00\x03map" in header:
                matches.append(data_file)
        if len(matches) == 1:
            return matches[0]
        raise RuntimeError(
            f"CASA image {path!r}: {len(data_files)} tiled storage manager "
            "data files found and the 'map' column binding is ambiguous; "
            "convert the mask to FITS (e.g. with casa exportfits) and use "
            "fits_mask instead"
        )

    def read(self) -> np.ndarray:
        """OR of ``pixel != 0`` over every channel/polarization plane
        (``casa_mask_reader.cc:22-38``), as [height, width] bool."""
        mask = np.zeros((self.height, self.width), bool)
        cube = self._cube.reshape(-1, self.height, self.width)
        for plane in cube:
            mask |= plane != 0.0
        return mask
