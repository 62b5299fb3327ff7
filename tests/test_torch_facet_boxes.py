"""B1's facet step over each facet's true box, on the CPU (plain versions).

The batched facet route places each facet's true box at the top left of a
common box and gives the step the boxes: it reads and writes nothing
outside them, and its partials are runs of box pixels with common-box flat
indices, a facet's runs past its own box holding no peak.  Against the
same step over the whole common box with the weight 0 outside the boxes
(the route before the boxes were passed), everything inside the boxes is
bit for bit the same: the residual, the model, each facet's largest
partial and the selected state.  The kernel is held to this plain version
bit for bit on the card (``test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

from radler_tpu_torch.image_set import CubeMeta
from radler_tpu_torch.kernels import hogbom_step as hs

torch.set_num_threads(1)

HEIGHT, WIDTH = 70, 90
# Full box; the inactive facet 1; one pixel wide; full width; ragged.
BOXES = [(70, 90), (66, 83), (60, 1), (30, 90), (65, 77)]
INACTIVE = 1


def facet_case(mode, shared, seed=0, boxes=BOXES):
    """Cubes [F, N, H, W] with a few bright pixels in each true box, the
    weight 0 outside the boxes and random values in the padding, PSFs,
    coefficients and each facet's loop state at its brightest searchable
    pixel (facet 1 inactive)."""
    rng = np.random.default_rng(seed)
    n_facets = len(boxes)
    C, P = (2, 2) if mode == "squared" else (3, 1)
    meta = CubeMeta(C, P, tuple(rng.uniform(0.5, 2.0, C)), (True,) * P, 1.0,
                    mode == "squared", tuple(1e8 + 1e7 * c for c in range(C)))
    if mode == "linear":
        chan = rng.uniform(0.2, 1.0, C * P).astype(np.float32)
        pol = np.ones(1, np.float32)
    else:
        _, chan, pol = hs.integration_coefficients(meta)
    res = rng.normal(scale=0.01,
                     size=(n_facets, C * P, HEIGHT, WIDTH)).astype(np.float32)
    weight = rng.uniform(0.5, 1.0, (n_facets, HEIGHT, WIDTH)).astype(
        np.float32)
    for f, (rows, cols) in enumerate(boxes):
        for _ in range(5):
            y, x = rng.integers(0, rows), rng.integers(0, cols)
            res[f, :, y, x] += rng.uniform(0.5, 2.0, C * P).astype(np.float32)
        weight[f, rows:, :] = 0.0
        weight[f, :, cols:] = 0.0
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
    r2 = (yy - HEIGHT // 2) ** 2.0 + (xx - WIDTH // 2) ** 2.0
    psfs = np.stack([
        np.stack([np.exp(-r2 / (2.0 * (1.5 + 0.3 * c + 0.2 * f) ** 2))
                  for c in range(C)]) for f in range(n_facets)
    ]).astype(np.float32)
    states = []
    for f, (rows, cols) in enumerate(boxes):
        box = np.abs(res[f, 0, :rows, :cols]) * weight[f, :rows, :cols]
        y, x = divmod(int(np.argmax(box)), cols)
        states.append([y, x, 1, 0, 0, int(f != INACTIVE), y * WIDTH + x, 0])
    t = torch.as_tensor
    state = t(np.asarray(states, np.int32))
    raw = torch.stack([t(res[f, :, s[0], s[1]]) for f, s in enumerate(states)])
    return dict(
        meta=meta, mode=mode, P=P, res=t(res), weight=t(weight),
        psfs=t(psfs[0]) if shared else t(psfs), state=state, raw=raw,
        coefs=t(hs.kernel_coefficients(mode, chan, pol)),
        boxes=torch.tensor(boxes, dtype=torch.int32),
    )


def inside(boxes, shape):
    """A bool mask [F, H, W] of the true boxes."""
    mask = torch.zeros(shape, dtype=torch.bool)
    for f, (rows, cols) in enumerate(boxes):
        mask[f, :rows, :cols] = True
    return mask


def run_steps(c, res, boxes, iterations=3):
    """``iterations`` facet steps, each with its select, from ``c``'s
    state; returns the model, the last partials and the buffers."""
    n_facets = res.shape[0]
    model = torch.zeros_like(res)
    params = hs.FacetLoopParams.make(
        0.1, [0.0] * n_facets, [10.0] * n_facets, 4.0, [100] * n_facets,
        False, "cpu")
    buffers = hs.LoopBuffers(c["state"].clone(), torch.zeros(n_facets),
                             c["raw"].clone(), c["raw"] * params.gain)
    for _ in range(iterations):
        partials = hs.hogbom_step_facets(
            res, model, c["psfs"], buffers.values, buffers.state, c["coefs"],
            c["weight"], mode=c["mode"], n_polarizations=c["P"],
            allow_negative=True, boxes=boxes, buffers=buffers,
            params=params, rms=c["weight"])
    return model, partials, buffers


def bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("pixels_per_block", [hs.PIXELS_PER_BLOCK, 512])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-facet"])
@pytest.mark.parametrize("mode", ["squared", "linear"])
def test_true_boxes_match_the_common_box(mode, shared, pixels_per_block,
                                         monkeypatch):
    """Inside the true boxes the step with ``boxes`` gives the bits of the
    step over the common box whose weight is 0 outside them; the padding,
    NaN beforehand, is left as it was; each facet's partials past its own
    runs hold no peak."""
    monkeypatch.setattr(hs, "PIXELS_PER_BLOCK", pixels_per_block)
    c = facet_case(mode, shared)
    box = inside(BOXES, (len(BOXES), HEIGHT, WIDTH))
    pad = ~box[:, None].expand_as(c["res"])

    common = c["res"].clone()
    m_common, p_common, b_common = run_steps(c, common, None)
    boxed = c["res"].clone()
    boxed[pad] = float("nan")
    before = boxed.clone()
    m_boxed, p_boxed, b_boxed = run_steps(c, boxed, c["boxes"])

    keep = ~pad
    assert torch.equal(bits(boxed[keep]), bits(common[keep]))
    assert torch.equal(bits(boxed[pad]), bits(before[pad]))
    assert torch.equal(m_boxed, m_common)
    for name in ("state", "value", "peak", "values"):
        assert torch.equal(getattr(b_boxed, name), getattr(b_common, name))
    assert torch.equal(b_boxed.state[INACTIVE], c["state"][INACTIVE])
    assert int(b_boxed.state[0, hs.ITERATION]) == 3

    cmp_b, idx_b, integ_b = p_boxed
    cmp_c, _, _ = p_common
    active = [f for f in range(len(BOXES)) if f != INACTIVE]
    assert torch.equal(cmp_b.max(dim=1).values[active],
                       cmp_c.max(dim=1).values[active])
    n_parts = max(-(-r * w // pixels_per_block) for r, w in BOXES)
    assert cmp_b.shape == (len(BOXES), n_parts)
    for f, (rows, cols) in enumerate(BOXES):
        runs = -(-rows * cols // pixels_per_block)
        assert bool((cmp_b[f, runs:] == -np.inf).all())
        assert bool((idx_b[f, runs:] == hs.INT_MAX).all())
        assert bool((integ_b[f, runs:] == 0.0).all())
        # Indices are common-box flat indices inside the box.
        y, x = idx_b[f, :runs].long() // WIDTH, idx_b[f, :runs].long() % WIDTH
        assert bool(((y < rows) & (x < cols)).all())
    assert any(-(-r * w // pixels_per_block) < n_parts for r, w in BOXES)


def test_full_boxes_are_the_common_box():
    """Boxes that fill the common box give the step without boxes, bit for
    bit, partials included."""
    c = facet_case("squared", True, seed=3)
    full = torch.tensor([(HEIGHT, WIDTH)] * len(BOXES), dtype=torch.int32)
    a, b = c["res"].clone(), c["res"].clone()
    out_a = run_steps(c, a, None)
    out_b = run_steps(c, b, full)
    assert torch.equal(a, b) and torch.equal(out_a[0], out_b[0])
    for x, y in zip(out_a[1], out_b[1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", [
    [(0, 5)] * 5, [(HEIGHT + 1, 5)] * 5, [(5, WIDTH + 1)] * 5, [(5, 5)] * 4,
], ids=["empty", "too-tall", "too-wide", "too-few"])
def test_boxes_outside_the_common_box_are_refused(bad):
    c = facet_case("linear", True)
    with pytest.raises(ValueError):
        run_steps(c, c["res"].clone(), torch.tensor(bad, dtype=torch.int32))


def test_boxes_must_be_int32_on_the_host():
    c = facet_case("linear", True)
    with pytest.raises(ValueError):
        run_steps(c, c["res"].clone(), torch.tensor(BOXES))  # int64


def loop_case(seed, negative_facet=None):
    """Three facets of a 1-plane cube (signed integration) in a common box,
    the third with no peak, for the lockstep loop; ``negative_facet``'s
    true box holds only negative values."""
    boxes = [(40, 52), (33, 1), (28, 47)]
    c = facet_case("linear", True, seed=seed, boxes=boxes)
    meta = CubeMeta(1, 1, (1.0,), (True,), 1.0, False, (1e8,))
    res = c["res"][:, :1].clone()
    if negative_facet is not None:
        rows, cols = boxes[negative_facet]
        res[negative_facet, :, :rows, :cols] = (
            -res[negative_facet, :, :rows, :cols].abs() - 0.5)
    peaks = []
    for f, (rows, cols) in enumerate(boxes):
        box = res[f, 0, :rows, :cols] * c["weight"][f, :rows, :cols]
        y, x = divmod(int(torch.argmax(box)), cols)
        peaks.append((float(res[f, 0, y, x]), x, y, True))
    return res, c, meta, peaks, boxes


@pytest.mark.parametrize("seed", [1, 2])
def test_negative_box_stops_as_over_the_common_box(seed):
    """A facet whose true box holds only negative values, with negatives
    not allowed: its loop stops with no peak found, at the same iteration
    over its true box as over the common box (where the padding's zero
    weight gave its largest value), and the other facets run alike."""
    res, c, meta, peaks, boxes = loop_case(seed, negative_facet=1)
    outs = []
    for boxed in (False, True):
        r, m = res.clone(), torch.zeros_like(res)
        params = hs.FacetLoopParams.make(0.1, [0.02] * 3, [3.0] * 3, 0.0,
                                         [200] * 3, False, "cpu")
        out = hs.facet_hogbom_loop(
            r, m, c["psfs"][:1], c["weight"], None, peaks, params, [0] * 3,
            meta=meta, allow_negative=False,
            boxes=torch.tensor(boxes, dtype=torch.int32) if boxed else None)
        outs.append((out, r, m))
    (common, r_c, m_c), (boxed, r_b, m_b) = outs
    box = inside(boxes, r_c[:, 0].shape)[:, None]
    assert torch.equal(r_c[box], r_b[box]) and torch.equal(m_c, m_b)
    for a, b in zip(common.results, boxed.results):
        assert a.iteration == b.iteration and a.found == b.found
    assert not boxed.results[1].found
    assert boxed.results[1].iteration == common.results[1].iteration
    assert boxed.results[0].iteration > 1


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-facet"])
def test_facet_step_bytes_count_each_psf_pixel_read(shared):
    """``chip_smoke.facet_step_bytes``, the facet step's least bytes: the
    residual planes read and written and the weight read over the true
    boxes, and each PSF pixel that a facet's shifted window reaches once
    (shared PSFs) or once a facet (per-facet PSFs), counted here pixel by
    pixel."""
    import chip_smoke as cs

    height, width, n_planes, n_chan = 30, 41, 3, 2
    boxes = [(30, 41), (12, 5), (1, 41), (29, 1)]
    peaks = [(0, 0), (11, 4), (0, 40), (28, 0)]
    reached = []
    for (rows, cols), (y, x) in zip(boxes, peaks):
        reached.append({(r + height // 2 - y, c + width // 2 - x)
                        for r in range(rows) for c in range(cols)
                        if 0 <= r + height // 2 - y < height
                        and 0 <= c + width // 2 - x < width})
    psf_pixels = (len(set().union(*reached)) if shared
                  else sum(len(r) for r in reached))
    pixels = sum(r * c for r, c in boxes)
    for use_weight in (False, True):
        expect = ((2 * n_planes + use_weight) * pixels
                  + n_chan * psf_pixels) * 4
        assert cs.facet_step_bytes(boxes, peaks, height, width, n_planes,
                                   n_chan, shared, use_weight) == expect
