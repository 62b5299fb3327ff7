"""The port's facet splitter against the JAX package's, on the CPU.

Twins of ``tests/test_dijkstra.py`` (the reference's
``cpp/math/test/test_dijkstra_splitter.cc`` scenarios): each runs the same
NumPy input through ``radler_tpu.parallel`` and ``radler_tpu_torch.parallel``
and holds the port to the JAX package exactly (equal paths, areas, boxes
and masks), then checks the scenario's own property; and the divider
search on random bands of fields with and without ties.  The split is
host code in both packages, and ties (zero pixels, equal sums) decide the
boxes, so nothing here has a tolerance.
"""

import numpy as np
import pytest

import radler_tpu as jrd
from radler_tpu.parallel.dijkstra import DijkstraSplitter as JaxSplitter
from radler_tpu.parallel.faceting import make_sub_images as jax_sub_images

from radler_tpu_torch.interop import settings_from_reference
from radler_tpu_torch.parallel.dijkstra import DijkstraSplitter, divide
from radler_tpu_torch.parallel.faceting import make_sub_images


def divide_both(img, vertical, lo, hi):
    h, w = img.shape
    outs = []
    for cls in (JaxSplitter, DijkstraSplitter):
        out = np.zeros((h, w), np.float32)
        splitter = cls(w, h)
        if vertical:
            splitter.divide_vertically(img, out, lo, hi)
        else:
            splitter.divide_horizontally(img, out, lo, hi)
        outs.append(out)
    np.testing.assert_array_equal(outs[1], outs[0])
    return outs[1]


def sub_images_both(img, grid, mask=None):
    """Both packages' sub-images of ``img`` on a ``grid`` (w, h); asserts
    them equal and returns the port's."""
    s = jrd.Settings()
    s.parallel.grid_width, s.parallel.grid_height = grid
    ref = jax_sub_images(img, mask, s)
    port = make_sub_images(img, mask, settings_from_reference(s))
    assert len(port) == len(ref)
    for a, b in zip(ref, port):
        assert (b.index, b.x, b.y, b.width, b.height) == (
            a.index, a.x, a.y, a.width, a.height)
        np.testing.assert_array_equal(b.boundary_mask, a.boundary_mask)
        np.testing.assert_array_equal(b.mask, a.mask)
    return port


def test_vertical_path_avoids_flux():
    w = h = 40
    img = np.zeros((h, w), np.float32)
    img[:, 18:22] = 10.0  # expensive column band
    img[:, 24] = 0.0  # free corridor at x=24
    out = divide_both(img, True, 12, 28)
    xs = np.nonzero(out)[1]
    assert (out.sum(axis=1) >= 1).all()  # one path pixel per row
    assert not set(range(18, 22)) & set(xs.tolist())


def test_vertical_path_on_zero_image_stays_connected():
    w = h = 32
    out = divide_both(np.zeros((h, w), np.float32), True, 8, 24)
    ys, xs = np.nonzero(out)
    assert set(ys.tolist()) == set(range(h))
    order = np.argsort(ys)
    assert (np.abs(np.diff(xs[order])) <= 1).all()


def test_horizontal_path():
    w = h = 32
    img = np.zeros((h, w), np.float32)
    img[14:18, :] = 5.0
    img[20, :] = 0.0
    out = divide_both(img, False, 10, 26)
    ys = np.nonzero(out)[0]
    assert not set(range(14, 18)) & set(ys.tolist())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flood_areas_match_jax(seed):
    """Both floods on a single divider column (the JAX test's case) and on
    random divider pixels, from every column and every row."""
    w = h = 32
    division = np.zeros((h, w), np.float32)
    division[:, 16] = 1.0
    port = DijkstraSplitter(w, h)
    mask_l, x_l, w_l = port.flood_vertical_area(division, 8)
    # The divider column belongs to the area on its right
    # (dijkstra_splitter.cc:160-165).
    assert x_l == 0 and w_l == 16
    mask_r, x_r, w_r = port.flood_vertical_area(division, 24)
    assert x_r == 16 and x_r + w_r == w
    rng = np.random.default_rng(seed)
    h, w = 23, 37
    division = (rng.random((h, w)) < 0.15).astype(np.float32)
    ref, port = JaxSplitter(w, h), DijkstraSplitter(w, h)
    for x in range(w):
        a, b = ref.flood_vertical_area(division, x), port.flood_vertical_area(
            division, x)
        np.testing.assert_array_equal(b[0], a[0])
        assert b[1:] == a[1:]
    for y in range(h):
        a, b = ref.flood_horizontal_area(division, y), (
            port.flood_horizontal_area(division, y))
        np.testing.assert_array_equal(b[0], a[0])
        assert b[1:] == a[1:]


def test_make_sub_images_partition():
    """Every pixel is owned by exactly one facet boundary mask."""
    w = h = 64
    rng = np.random.default_rng(0)
    img = (rng.random((h, w)) * 0.01).astype(np.float32)
    img[20, 20] = 5.0
    img[40, 50] = 3.0
    subs = sub_images_both(img, (2, 2))
    assert len(subs) == 4
    coverage = np.zeros((h, w), np.int32)
    for s in subs:
        coverage[s.y : s.y + s.height, s.x : s.x + s.width] += (
            s.boundary_mask.astype(np.int32)
        )
    assert (coverage == 1).all()


def test_even_size_correction():
    """Facet boxes stay even-sized when the image is even
    (dijkstra_splitter.cc:257-284)."""
    subs = sub_images_both(np.zeros((64, 64), np.float32), (3, 3))
    for s in subs:
        assert s.width % 2 == 0
        assert s.height % 2 == 0


@pytest.mark.parametrize("grid", [(2, 2), (3, 3), (2, 3), (5, 5)])
@pytest.mark.parametrize("field", ["ties", "sparse", "noise"])
def test_sub_images_match_jax_with_near_equal_costs(field, grid):
    """Fields whose paths tie or nearly tie: a few quantized levels (many
    paths of exactly equal cost), sparse sources on zeros, and noise; odd
    and even sizes, with and without a user mask."""
    rng = np.random.default_rng([len(field), *grid])
    for h, w in ((96, 96), (81, 110)):
        if field == "ties":
            img = (rng.integers(0, 3, (h, w)) * 0.5).astype(np.float32)
        elif field == "sparse":
            img = np.where(rng.random((h, w)) < 0.05,
                           rng.uniform(-1, 1, (h, w)), 0).astype(np.float32)
        else:
            img = rng.normal(size=(h, w)).astype(np.float32)
        sub_images_both(img, grid)
        sub_images_both(img, grid, mask=rng.random((h, w)) < 0.7)


@pytest.mark.parametrize("kind", ["noise", "offset", "sparse", "levels",
                                  "decay"])
def test_divider_matches_jax_on_random_bands(kind):
    """The divider through a random band of columns against the JAX
    splitter's, on 40 random fields of each kind: tie-free noise, noise on
    a large offset (sums that round alike), sparse sources on zeros and a
    few quantized levels (ties decide the path), and values that underflow
    towards zero.  Columns outside the band stay as they were."""
    rng = np.random.default_rng(["noise", "offset", "sparse", "levels",
                                 "decay"].index(kind))
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(8, 70, 2))
        if kind == "noise":
            img = rng.normal(size=(h, w))
        elif kind == "offset":
            img = 3.0 + 1e-6 * rng.normal(size=(h, w))
        elif kind == "sparse":
            img = np.where(rng.random((h, w)) < 0.5, rng.normal(size=(h, w)),
                           0.0)
        elif kind == "levels":
            img = rng.integers(0, 4, (h, w)) * 0.25
        else:
            img = np.exp(-rng.random((h, w)) * 120.0)
        img = img.astype(np.float32)
        x1 = int(rng.integers(0, w - 2))
        x2 = int(rng.integers(x1 + 1, w + 1))
        out, ref = (np.full((h, w), 7.0, np.float32) for _ in range(2))
        divide(img, out, x1, x2)
        JaxSplitter(w, h).divide_vertically(img, ref, x1, x2)
        np.testing.assert_array_equal(out, ref)
        assert (out[:, :x1] == 7.0).all() and (out[:, x2:] == 7.0).all()
