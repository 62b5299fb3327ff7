"""The CASA mask reader in both packages: twins of ``tests/test_casa_mask.py``
(``cpp/utils/casa_mask_reader.cc``).

The reader needs no package-specific array type, so each test runs on
``radler_tpu``'s reader and on ``radler_tpu_torch``'s alike, on a fixture
built against casacore's on-disk TiledStMan layout (the JAX test's
fixture code).  Through ``Radler`` the mask restricts cleaning in both
packages, the port on the CPU.  The real-casacore check skips, as the JAX
test does, where python-casacore is not installed.
"""

import importlib
import struct

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(params=["radler_tpu", "radler_tpu_torch"])
def package(request):
    return request.param


def reader_module(package):
    return importlib.import_module(f"{package}.utils.casa_mask_reader")


IPOS_MAGIC = b"\x00\x00\x00\x09IPosition\x00\x00\x00\x01"


def _iposition_bytes(vals):
    return IPOS_MAGIC + struct.pack(f">I{len(vals)}i", len(vals), *vals)


def _tile_pack(cube_arr: np.ndarray, cube, tile) -> bytes:
    """Pack a [chan, pol, y, x] array the way casacore's TiledStMan stores
    it: Fortran-ordered tiles over a Fortran-ordered tile grid, edge tiles
    zero-padded, big-endian float32."""
    grid = tuple(-(-c // t) for c, t in zip(cube, tile))
    ntiles = int(np.prod(grid))
    chunks = []
    for flat in range(ntiles):
        tidx = np.unravel_index(flat, grid, order="F")
        block = np.zeros(tile[::-1], np.float32)
        src = []
        dst = []
        for axis in range(len(cube) - 1, -1, -1):
            start = tidx[axis] * tile[axis]
            stop = min(start + tile[axis], cube[axis])
            src.append(slice(start, stop))
            dst.append(slice(0, stop - start))
        block[tuple(dst)] = cube_arr[tuple(src)]
        chunks.append(block.astype(">f4").tobytes())
    return b"".join(chunks)


def _write_casa_table(tmp_path, cube_arr, cube, tile):
    table = tmp_path / "mask.image"
    table.mkdir()
    # Header: surrounding AipsIO noise plus the two IPositions (and a decoy
    # whose sizes cannot match the data file).
    header = (
        b"\x00\x00\x00\x0aTiledStMan\x00\x00\x00\x02junkjunk"
        + _iposition_bytes([3, 3])  # decoy ahead of the TSMCube record
        + b"\x00\x00\x00\x07TSMCube\x00\x00\x00\x01filler"
        + _iposition_bytes(list(cube))
        + _iposition_bytes(list(tile))
        + b"trailing"
    )
    (table / "table.f0").write_bytes(header)
    (table / "table.f0_TSM0").write_bytes(_tile_pack(cube_arr, cube, tile))
    (table / "table.dat").write_bytes(b"\x00\x00\x00\x05Table")
    return str(table)


def test_scan_ipositions(package):
    blob = b"xx" + _iposition_bytes([12, 10, 1, 2]) + _iposition_bytes([5, 4])
    assert reader_module(package)._scan_ipositions(blob) == [
        (12, 10, 1, 2), (5, 4)]


def test_casa_mask_roundtrip(package, tmp_path):
    # cube axes are casacore order [x, y, pol, chan].
    cube = (12, 10, 2, 3)
    tile = (5, 4, 1, 2)  # non-dividing tile sizes exercise edge padding
    rng = np.random.default_rng(3)
    cube_arr = np.zeros(cube[::-1], np.float32)  # [chan, pol, y, x]
    expected = np.zeros((cube[1], cube[0]), bool)
    for _ in range(10):
        c, p = rng.integers(0, cube[3]), rng.integers(0, cube[2])
        y, x = rng.integers(0, cube[1]), rng.integers(0, cube[0])
        cube_arr[c, p, y, x] = rng.uniform(0.5, 2.0)
        expected[y, x] = True

    path = _write_casa_table(tmp_path, cube_arr, cube, tile)
    reader = reader_module(package).CasaMaskReader(path)
    assert (reader.width, reader.height) == (cube[0], cube[1])
    assert (reader.n_polarizations, reader.n_channels) == (cube[2], cube[3])
    mask = reader.read()
    np.testing.assert_array_equal(mask, expected)


def test_casa_mask_errors(package, tmp_path):
    CasaMaskReader = reader_module(package).CasaMaskReader
    with pytest.raises(RuntimeError, match="not a table directory"):
        CasaMaskReader(str(tmp_path / "missing.image"))

    empty = tmp_path / "empty.image"
    empty.mkdir()
    with pytest.raises(RuntimeError, match="FITS"):
        CasaMaskReader(str(empty))

    # A header whose IPositions cannot explain the data-file size must not
    # silently return garbage.
    bad = tmp_path / "bad.image"
    bad.mkdir()
    (bad / "table.f0").write_bytes(_iposition_bytes([4, 4, 1, 1]))
    (bad / "table.f0_TSM0").write_bytes(b"\x00" * 100)
    with pytest.raises(RuntimeError, match="could not recover"):
        CasaMaskReader(str(bad))


def test_casa_mask_through_radler(package, tmp_path):
    """settings.casa_mask through the public API (``cpp/radler.cc:434-527``):
    cleaning is restricted to masked pixels."""
    rd = importlib.import_module(package)
    size = 64
    cube = (size, size, 1, 1)
    tile = (16, 16, 1, 1)
    cube_arr = np.zeros(cube[::-1], np.float32)
    cube_arr[0, 0, 20, 24] = 1.0  # only this pixel may be cleaned
    path = _write_casa_table(tmp_path, cube_arr, cube, tile)

    psf = np.zeros((size, size), np.float32)
    psf[size // 2, size // 2] = 1.0
    residual = np.zeros((size, size), np.float32)
    residual[20, 24] = 1.0
    residual[40, 40] = 2.0  # outside the mask: must stay
    model = np.zeros_like(residual)

    s = rd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.minor_iteration_count = 300
    s.absolute_threshold = 1e-8
    s.casa_mask = path
    device = {"device": "cpu"} if package == "radler_tpu_torch" else {}
    r = rd.Radler(s, psf, residual, model, 0.0, **device)
    r.perform(0)
    assert abs(residual[20, 24]) < 1e-6
    assert residual[40, 40] == pytest.approx(2.0)
    assert model[20, 24] == pytest.approx(1.0, abs=1e-4)
    assert model[40, 40] == 0.0


def test_casa_mask_against_real_casacore(package, tmp_path):
    """Ground truth where python-casacore is importable: a table written by
    real casacore, read by the dependency-free parser."""
    casacore_images = pytest.importorskip("casacore.images")
    CasaMaskReader = reader_module(package).CasaMaskReader

    shape = [3, 2, 10, 12]  # casacore order [nchan, npol, ny, nx]
    rng = np.random.default_rng(11)
    data = np.zeros(shape, np.float32)
    for _ in range(12):
        c = rng.integers(0, shape[0])
        p = rng.integers(0, shape[1])
        y = rng.integers(0, shape[2])
        x = rng.integers(0, shape[3])
        data[c, p, y, x] = 1.0
    path = str(tmp_path / "real.image")
    im = casacore_images.image(path, shape=shape)
    im.putdata(data)
    del im  # flush

    # Force the dependency-free path (the reader prefers python-casacore).
    reader = CasaMaskReader.__new__(CasaMaskReader)
    reader.path = path
    reader._cube = None
    reader._init_minimal(path)
    mask = reader.read()
    expected = np.any(data != 0.0, axis=(0, 1))
    np.testing.assert_array_equal(mask, expected)
