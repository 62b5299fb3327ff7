"""B1's step with its select folded in, on the CPU (plain versions).

On the card one launch does a whole Högbom iteration: the step, then, in
its last block to finish, the select.  Its plain version is the step's
plain version followed by the select's.  Here the wrappers, given CPU
tensors and the select's arguments (``buffers``, ``params``, ``rms``),
are held bit for bit to that pair called explicitly, in every integration
mode, with and without a weight plane and an rms factor, with negatives
allowed and not, on an inactive state (which leaves every tensor alone),
on equal maxima in two blocks (the smallest flat index wins, as the JAX
package's Pallas kernel picks it) and on an all-zero cube holding -0.0;
and the facet mode likewise, over true boxes, with a stopped facet and a
gain a facet.  The kernel is held to the same pair on the card
(``test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from radler_tpu.ops.pallas.hogbom_step import fused_clean_step, pad_psfs
from radler_tpu_torch.image_set import CubeMeta, linear_integration_coefficients
from radler_tpu_torch.kernels import hogbom_step as hs

torch.set_num_threads(1)

# Two step blocks of PIXELS_PER_BLOCK pixels.
HEIGHT, WIDTH = 64, 128

# (mode, channels, polarizations, squared joins)
MODES = [
    ("signed", 1, 1, False),
    ("linear", 3, 1, False),
    ("normal", 2, 2, False),
    ("squared", 2, 2, True),
]


def make_case(case, seed=0):
    """A residual cube with sources on noise, Gaussian PSFs a channel, a
    weight plane, an rms factor, the kernel coefficients and a loop state
    at the brightest pixel of plane 0."""
    mode, C, P, squared = case
    rng = np.random.default_rng(seed)
    meta = CubeMeta(C, P, tuple(rng.uniform(0.5, 2.0, C)), (True,) * P, 1.0,
                    squared, tuple(1e8 + 1e7 * c for c in range(C)))
    if mode == "linear":
        chan, pol = linear_integration_coefficients(meta), np.ones(1)
    else:
        got, chan, pol = hs.integration_coefficients(meta)
        assert got == mode
    n = C * P
    res = rng.normal(scale=0.01, size=(n, HEIGHT, WIDTH)).astype(np.float32)
    for _ in range(6):
        y, x = rng.integers(0, HEIGHT), rng.integers(0, WIDTH)
        res[:, y, x] += rng.uniform(-2.0, 2.0, n).astype(np.float32)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
    r2 = (yy - HEIGHT // 2) ** 2.0 + (xx - WIDTH // 2) ** 2.0
    psfs = np.stack([np.exp(-r2 / (2.0 * (1.5 + 0.3 * c) ** 2))
                     for c in range(C)]).astype(np.float32)
    t = torch.as_tensor
    return dict(
        mode=mode, P=P, res=t(res), psfs=t(psfs),
        weight=t(rng.uniform(0.0, 1.0, (HEIGHT, WIDTH)).astype(np.float32)),
        rms=t(rng.uniform(0.5, 1.5, (HEIGHT, WIDTH)).astype(np.float32)),
        coefs=t(hs.kernel_coefficients(mode, chan, pol)),
        peak=divmod(int(np.argmax(np.abs(res[0]))), WIDTH),
    )


def start(res, peak, gain, active=True):
    y, x = peak
    raw = res[:, y, x].clone()
    state = torch.tensor([y, x, 1, 0, 3, int(active), y * WIDTH + x, 0],
                         dtype=torch.int32)
    return hs.LoopBuffers(state, torch.full((1,), 0.25), raw.clone(),
                          raw * gain)


def run(c, fused, params, use_weight, use_rms, allow_negative, active=True,
        iterations=3):
    """``iterations`` iterations of the fused wrapper, or of the explicit
    plain pair; returns the residual, the model, the buffers and the last
    partials."""
    res = c["res"].clone()
    model = torch.zeros_like(res)
    buffers = start(res, c["peak"], params.gain, active)
    weight = c["weight"] if use_weight else None
    rms = c["rms"] if use_rms else None
    kw = dict(mode=c["mode"], n_polarizations=c["P"],
              allow_negative=allow_negative)
    for _ in range(iterations):
        args = (res, model, c["psfs"], buffers.values, buffers.state,
                c["coefs"], weight)
        if fused:
            partials = hs.hogbom_step(*args, **kw, buffers=buffers,
                                      params=params, rms=rms)
        else:
            partials = hs.hogbom_step_reference(*args, **kw)
            hs.hogbom_select_reference(partials, res, buffers, params, rms)
    return res, model, buffers, partials


def assert_same(a, b):
    """Bit for bit: residual, model, every buffer and the partials."""
    ra, ma, ba, pa = a
    rb, mb, bb, pb = b
    assert torch.equal(ra.view(torch.int32), rb.view(torch.int32))
    assert torch.equal(ma.view(torch.int32), mb.view(torch.int32))
    for name in ("state", "value", "peak", "values"):
        x, y = getattr(ba, name), getattr(bb, name)
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), name
    for x, y in zip(pa, pb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("allow_negative", [True, False],
                         ids=["negatives", "positive"])
@pytest.mark.parametrize("use_rms", [False, True], ids=["-", "rms"])
@pytest.mark.parametrize("use_weight", [False, True], ids=["-", "weight"])
@pytest.mark.parametrize("case", MODES, ids=lambda c: c[0])
def test_fused_step_is_the_plain_pair(case, use_weight, use_rms,
                                      allow_negative):
    c = make_case(case, seed=len(case[0]))
    params = hs.LoopParams.make(0.2, 0.0, 5.0, 4.0, 100, False)
    fused = run(c, True, params, use_weight, use_rms, allow_negative)
    pair = run(c, False, params, use_weight, use_rms, allow_negative)
    assert_same(fused, pair)
    assert int(fused[2].state[hs.ITERATION]) == 6  # started at 3
    assert fused[1].any()


@pytest.mark.parametrize("case", MODES, ids=lambda c: c[0])
def test_fused_step_on_an_inactive_state_changes_nothing(case):
    c = make_case(case, seed=3)
    params = hs.LoopParams.make(0.2, 0.0, 5.0, 4.0, 100, False)
    res, model, buffers, _ = run(c, True, params, True, True, True,
                                 active=False)
    fresh = start(c["res"], c["peak"], params.gain, active=False)
    assert torch.equal(res, c["res"]) and not model.any()
    for name in ("state", "value", "peak", "values"):
        assert torch.equal(getattr(buffers, name), getattr(fresh, name))
    assert_same((res, model, buffers, ()), run(c, False, params, True, True,
                                               True, active=False))


def jax_peak(res, weight, mode, c, allow_negative):
    """The flat index the JAX package's Pallas step (interpreted) picks
    after a zero-valued subtraction."""
    _, idx, _ = fused_clean_step(
        jnp.asarray(res.numpy()),
        pad_psfs(jnp.asarray(c["psfs"].numpy()[
            np.arange(res.shape[0]) // c["P"]])),
        jnp.zeros(res.shape[0], jnp.float32),
        jnp.asarray(weight.numpy()), jnp.int32(0), jnp.int32(0),
        block_rows=32, allow_negative=allow_negative,
        integration_mode=mode, chan_coefs=tuple(
            float(v) for v in c["chan"]),
        pol_coefs=tuple(float(v) for v in c["pol"]),
        use_weight=True, interpret=True)
    return int(idx)


@pytest.mark.parametrize("allow_negative", [True, False],
                         ids=["negatives", "positive"])
def test_equal_maxima_in_two_blocks_take_the_smallest_index(allow_negative):
    """Equal maxima in both blocks and twice in the second: the smallest
    flat index wins, in the fused wrapper, the plain pair and the JAX
    package's kernel."""
    c = make_case(("signed", 1, 1, False), seed=4)
    res = torch.full((1, HEIGHT, WIDTH), 0.001)
    first = hs.PIXELS_PER_BLOCK - 7  # block 0's last row
    for at in (first + 4096 - 100, first, first + 3000):
        res.view(-1)[at] = 3.0
    c["res"] = res
    weight = torch.ones(HEIGHT, WIDTH)
    params = hs.LoopParams.make(0.1, 0.0, 5.0, 0.0, 100, False)
    outs = []
    for fused in (True, False):
        r, m = res.clone(), torch.zeros_like(res)
        b = start(r, (0, 0), 0.0)  # component values 0: no change
        args = (r, m, c["psfs"], b.values, b.state, c["coefs"], weight)
        kw = dict(mode="signed", n_polarizations=1,
                  allow_negative=allow_negative)
        if fused:
            p = hs.hogbom_step(*args, **kw, buffers=b, params=params)
        else:
            p = hs.hogbom_step_reference(*args, **kw)
            hs.hogbom_select_reference(p, r, b, params)
        outs.append((r, m, b, p))
    assert_same(*outs)
    state = outs[0][2].state
    assert int(state[hs.INDEX]) == first
    assert (int(state[hs.Y]), int(state[hs.X])) == divmod(first, WIDTH)
    c["chan"], c["pol"] = np.ones(1), np.ones(1)
    assert jax_peak(res, weight, "signed", c, allow_negative) == first


@pytest.mark.parametrize("allow_negative", [True, False],
                         ids=["negatives", "positive"])
@pytest.mark.parametrize("case", MODES, ids=lambda c: c[0])
def test_all_zero_cube_with_negative_zeros(case, allow_negative):
    """A cube of +0.0 and -0.0: every pixel ties at 0, so the peak is flat
    index 0 with found = 0 and the loop stops, in both versions (and at
    index 0 in the JAX package's kernel)."""
    c = make_case(case, seed=5)
    n = c["res"].shape[0]
    signs = torch.as_tensor(np.random.default_rng(6).integers(
        0, 2, (n, HEIGHT, WIDTH)).astype(bool))
    c["res"] = torch.where(signs, torch.tensor(-0.0), torch.tensor(0.0))
    c["peak"] = (5, 9)
    params = hs.LoopParams.make(0.1, 0.0, 5.0, 0.0, 100, False)
    fused = run(c, True, params, True, False, allow_negative, iterations=1)
    pair = run(c, False, params, True, False, allow_negative, iterations=1)
    assert_same(fused, pair)
    state = fused[2].state.tolist()
    assert state[hs.INDEX] == 0 and state[hs.FOUND] == 0
    assert state[hs.ACTIVE] == 0
    if case[0] == "signed":
        c["chan"], c["pol"] = np.ones(1), np.ones(1)
        assert jax_peak(c["res"], c["weight"], "signed", c,
                        allow_negative) == 0


def test_select_needs_the_buffers_own_values_and_state():
    c = make_case(MODES[0])
    params = hs.LoopParams.make(0.1, 0.0, 5.0, 0.0, 100, False)
    b = start(c["res"], c["peak"], params.gain)
    kw = dict(mode="signed", n_polarizations=1, allow_negative=True)
    with pytest.raises(ValueError):
        hs.hogbom_step(c["res"].clone(), torch.zeros_like(c["res"]),
                       c["psfs"], b.values.clone(), b.state, c["coefs"],
                       **kw, buffers=b, params=params)
    with pytest.raises(ValueError):
        hs.hogbom_step(c["res"].clone(), torch.zeros_like(c["res"]),
                       c["psfs"], b.values, b.state, c["coefs"], **kw,
                       params=params)


# Facet mode: ragged true boxes in the common box, facet 1 stopped.
BOXES = [(64, 128), (40, 77), (33, 1), (50, 120)]
STOPPED = 1


def facet_case(case, shared, seed=0):
    """F facets' cubes in the common box, their true boxes, per-facet or
    shared PSFs, a weight and an rms plane a facet (the weight 0 outside
    the boxes) and each facet's state at its brightest box pixel."""
    cases = [make_case(case, seed + f) for f in range(len(BOXES))]
    c = dict(cases[0])
    c["res"] = torch.stack([k["res"] for k in cases])
    c["psfs"] = (cases[0]["psfs"] if shared
                 else torch.stack([k["psfs"] for k in cases]))
    c["weight"] = torch.stack([k["weight"] for k in cases])
    c["rms"] = torch.stack([k["rms"] for k in cases])
    states = []
    for f, (rows, cols) in enumerate(BOXES):
        c["weight"][f, rows:] = 0.0
        c["weight"][f, :, cols:] = 0.0
        box = c["res"][f, 0, :rows, :cols].abs()
        y, x = divmod(int(torch.argmax(box)), cols)
        states.append([y, x, 1, 0, 0, int(f != STOPPED), y * WIDTH + x, 0])
    c["state"] = torch.tensor(states, dtype=torch.int32)
    c["boxes"] = torch.tensor(BOXES, dtype=torch.int32)
    return c


def run_facets(c, fused, params, use_weight, use_rms, iterations=3):
    res = c["res"].clone()
    model = torch.zeros_like(res)
    state = c["state"].clone()
    raw = res[torch.arange(len(BOXES)), :, state[:, 0].long(),
              state[:, 1].long()]
    buffers = hs.LoopBuffers(state, torch.zeros(len(BOXES)), raw.clone(),
                             raw * params.gains)
    weight = c["weight"] if use_weight else None
    rms = c["rms"] if use_rms else None
    kw = dict(mode=c["mode"], n_polarizations=c["P"], allow_negative=True,
              boxes=c["boxes"])
    for _ in range(iterations):
        args = (res, model, c["psfs"], buffers.values, buffers.state,
                c["coefs"], weight)
        if fused:
            partials = hs.hogbom_step_facets(*args, **kw, buffers=buffers,
                                             params=params, rms=rms)
        else:
            partials = hs.hogbom_step_facets_reference(*args, **kw)
            hs.hogbom_select_facets_reference(partials, res, buffers,
                                              params, rms)
        # A gain a facet: the loop scales the values after each select.
        torch.mul(buffers.peak, params.gains, out=buffers.values)
    return res, model, buffers, partials


@pytest.mark.parametrize("use_rms", [False, True], ids=["-", "rms"])
@pytest.mark.parametrize("use_weight", [False, True], ids=["-", "weight"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-facet"])
@pytest.mark.parametrize("case", MODES, ids=lambda c: c[0])
def test_fused_facet_step_is_the_plain_pair(case, shared, use_weight,
                                            use_rms):
    c = facet_case(case, shared)
    params = hs.FacetLoopParams.make(
        [0.1, 0.2, 0.05, 0.15], [0.0, 0.0, 0.0, 0.3], [5.0] * 4, 4.0,
        [100, 100, 2, 100], False, "cpu")
    fused = run_facets(c, True, params, use_weight, use_rms)
    pair = run_facets(c, False, params, use_weight, use_rms)
    assert_same(fused, pair)
    res, model, buffers, _ = fused
    assert torch.equal(res[STOPPED], c["res"][STOPPED])
    assert not model[STOPPED].any()
    assert torch.equal(buffers.state[STOPPED], c["state"][STOPPED])
    iterations = buffers.state[:, hs.ITERATION].tolist()
    assert iterations[0] == 3 and iterations[STOPPED] == 0
    assert iterations[2] == 2  # facet 2's limit
    for f, (rows, cols) in enumerate(BOXES):
        outside = torch.ones(HEIGHT, WIDTH, dtype=torch.bool)
        outside[:rows, :cols] = False
        assert torch.equal(res[f][:, outside], c["res"][f][:, outside])
