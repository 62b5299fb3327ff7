"""The grid route of the Clark subminor kernel (B2) on the CPU: its launch
plan, and a plain emulation of its exchange against the plain loop and
against the JAX package.

On the card the grid route runs one block a multiprocessor; each block
reduces its slice of the candidates to its best (the largest comparison
value, then the smallest index), writes it as a slot, and after a grid
barrier every block reduces the G slots the same way and computes the
component from the winner's raw values.  :func:`grid_loop` does the same
in plain PyTorch, slice by slice, so the tests below show that the
partition into slices changes no bit of the result: it is held bit for bit
to ``subminor_loop_reference`` (the kernel's plain version, which the CUDA
kernel matches bit for bit on the card) with no fit, the projection, the
log-polynomial and the forced-term fit, over ties on both sides of a slice
boundary, negative values, an rms factor and each stop.

Against the JAX package's XLA loop (``_subminor_while``,
``radler_tpu/models/subminor.py:112``) the contract of
``tests/test_torch_subminor_fits.py``: equal iteration counts and
divergence, the residual within 2e-6 absolute, the model within 1e-4 of its
peak (the two packages sum the fits' channel sums and the integration in
other orders).
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu.image_set import CubeMeta as JaxMeta
from radler_tpu.image_set import linear_integration_coefficients
from radler_tpu.models import subminor as jsm
from radler_tpu.ops.spectral_fitting import SpectralFitter as JaxFitter
from radler_tpu_torch.kernels import subminor_loop as sl
from radler_tpu_torch.models import subminor as sm
from radler_tpu_torch.ops.spectral_fitting import SpectralFitter

torch.set_num_threads(1)

SIZE = 48
RESIDUAL_ATOL = 2e-6
MODEL_PEAK_RTOL = 1e-4
FITS = ("NO_FITTING", "POLYNOMIAL", "LOG_POLYNOMIAL", "FORCED_TERMS")
# An H100's multiprocessors, as torch.cuda.get_device_properties gives
# them; the plan's tests pass the count as the wrapper does.
SMS = 132


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_images", [1, 4, 8, 9, 80])
def test_plan_takes_the_grid_above_the_crossover(n_images):
    """At or below GRID_VALUES candidate values a cluster, above it the grid
    of one block a multiprocessor; without a multiprocessor count (the CPU,
    the tile axis) always a cluster."""
    below = sl.GRID_VALUES // n_images
    above = below + 1
    at = sl.cluster_plan(n_images, below, sm_count=SMS)
    assert at.grid_blocks == 0
    assert at == sl.cluster_plan(n_images, below)
    grid = sl.cluster_plan(n_images, above, sm_count=SMS)
    assert grid.grid_blocks == SMS and grid.cluster_size == 1
    assert grid.slice_len == -(-above // SMS)
    assert (grid.slice_len - 1) * SMS < above <= grid.slice_len * SMS
    assert sl.cluster_plan(n_images, above).grid_blocks == 0
    assert grid.ship_raw == (n_images <= sl.SHIP_RAW_MAX_IMAGES)


def test_plan_of_the_spectral_cells():
    """The 8192^2 x 4 spectral-fit performs' candidate set (K = 168,945 at
    4 planes) takes the grid with its state in shared memory, and so does
    config 2's (K = 60,218, one plane: just above the crossover); the tile
    axis's config 2 tiles (about 7500 each) keep a cluster of 16."""
    fit = sl.SubminorFit(sl.FIT_LOG_POLYNOMIAL,
                         fit_matrix=torch.zeros(2, 4),
                         design=torch.zeros(4, 2),
                         mean_weights=torch.zeros(4))
    plan = sl.cluster_plan(4, 168_945, fit=fit, sm_count=SMS)
    assert plan.grid_blocks == SMS and plan.on_chip and plan.ship_raw
    assert plan.slice_len == 1280 and plan.threads == 512
    config2 = sl.cluster_plan(1, 60_218, sm_count=SMS)
    assert config2.grid_blocks == SMS and config2.on_chip
    assert config2.slice_len == 457 and config2.threads == 512
    tile = sl.launch_plan(1, 7_528, None, SMS, True)
    assert tile.grid_blocks == 0 and tile.cluster_size == 16


@pytest.mark.parametrize("n_images,forced_rows", [(1, 0), (4, 1), (9, 0),
                                                  (80, 0)])
def test_grid_capacity_is_checked_at_its_blocks(n_images, forced_rows):
    """The state lives in shared memory exactly while a slice of K / G
    candidates fits beside the per-plane scalars, the fit's floats and the
    copy of G slots: the largest such K stays on chip, one slice more
    goes to global memory, and a forced on-chip plan beyond raises."""
    fit = None
    if forced_rows:
        fit = sl.SubminorFit(sl.FIT_FORCED_TERMS, weights=torch.zeros(4),
                             powers=torch.zeros(forced_rows, 4),
                             terms=torch.zeros(forced_rows, 1))
    fixed = (12 * n_images + 4 * sl.SLOT_WORDS * SMS
             + (0 if fit is None else 4 * fit.shared_floats(n_images)))
    per = 4 * n_images + 12 + 4 * forced_rows
    room = sl.SHARED_BYTES_PER_BLOCK - sl.STATIC_SHARED_RESERVE - fixed
    most = SMS * (room // per)
    plan = sl.cluster_plan(n_images, most, fit=fit, grid_blocks=SMS)
    assert plan.on_chip and plan.shared_bytes == fixed + (room // per) * per
    beyond = sl.cluster_plan(n_images, most + SMS, fit=fit, grid_blocks=SMS)
    assert not beyond.on_chip and beyond.shared_bytes == fixed
    with pytest.raises(ValueError):
        sl.cluster_plan(n_images, most + SMS, fit=fit, grid_blocks=SMS,
                        on_chip=True)
    # The same K on a cluster of 16 blocks does not fit: the grid's reach.
    assert not sl.cluster_plan(n_images, most, fit=fit,
                               cluster_size=16).on_chip


def test_tile_axis_never_takes_the_grid():
    """The tile axis keeps its clusters whatever N * K; a grid plan forced
    on it raises, and a single segment takes the grid."""
    n, longest = 4, 500_000
    tiles = sl.launch_plan(n, longest, None, SMS, True)
    assert tiles.grid_blocks == 0 and tiles.cluster_size == 16
    single = sl.launch_plan(n, longest, None, SMS, False)
    assert single.grid_blocks == SMS
    with pytest.raises(ValueError):
        sl.launch_plan(n, longest, None, SMS, True, single)
    assert sl.launch_plan(n, longest, None, SMS, False, tiles) == tiles


def test_forced_grid_plans():
    """Forced grid blocks, global memory and the exchange without raw
    values; a grid in clusters, negative blocks and raw values for too many
    planes raise.  A grid block has at least GRID_MIN_THREADS threads."""
    plan = sl.cluster_plan(4, 20_000, grid_blocks=2 * SMS)
    assert plan.grid_blocks == 2 * SMS and plan.slice_len == 76
    assert plan.threads == sl.GRID_MIN_THREADS
    assert sl.cluster_plan(4, 2000, cluster_size=16).threads == sl.MIN_THREADS
    assert not sl.cluster_plan(4, 20_000, grid_blocks=SMS,
                               on_chip=False).on_chip
    assert not sl.cluster_plan(4, 20_000, grid_blocks=SMS,
                               ship_raw=False).ship_raw
    with pytest.raises(ValueError):
        sl.cluster_plan(4, 20_000, grid_blocks=SMS, cluster_size=4)
    with pytest.raises(ValueError):
        sl.cluster_plan(9, 20_000, grid_blocks=SMS, ship_raw=True)
    with pytest.raises(ValueError):
        sl.cluster_plan(4, 20_000, grid_blocks=-1)
    words = sl.grid_workspace_words(plan, 4)
    assert words == 2 * sl.SLOT_WORDS * 2 * SMS + 4 + 2


# ---------------------------------------------------------------------------
# The grid's exchange in plain PyTorch
# ---------------------------------------------------------------------------


def slots_of(cmp, s, slice_len):
    """Every block's slot: over its slice [g L, (g + 1) L) the largest cmp,
    then the smallest index of it, and the value there; an empty or ragged
    slice is padded with -inf."""
    k = cmp.shape[0]
    n_slices = -(-k // slice_len)
    padded = torch.full((n_slices * slice_len,), -math.inf)
    padded[:k] = cmp
    rows = padded.view(n_slices, slice_len)
    top = rows.max(dim=1).values
    first = (rows == top[:, None]).to(torch.int8).argmax(dim=1)
    idx = torch.arange(n_slices) * slice_len + first
    return top, idx, s[idx.clamp(max=k - 1)]


def grid_loop(residual_k, model_k, rms_k, xs, ys, psfs, coef, fit, params,
              *, n_polarizations, slice_len):
    """The grid route's loop: each slice of ``slice_len`` candidates gives
    its best as a slot, the slots are reduced to the winner the same way,
    cv comes from the winner's raw values through the fit; then the
    subtraction and integration of the plain loop.  Updates the state in
    place and returns (iteration, diverging, bits of the last value)."""
    n, k = residual_k.shape
    n_psf, height, width = psfs.shape
    psf_flat = psfs.reshape(n_psf, -1)
    psf_index = torch.arange(n) // n_polarizations

    def find_max():
        s = sl._integrate(residual_k, coef)
        if rms_k is not None:
            s = s * rms_k
        cmp = s.abs() if params.allow_negative else s
        # The slots reduced as every block reduces them: the largest cmp,
        # then the smallest index.
        top, idx, val = slots_of(cmp, s, slice_len)
        m = int(idx[top == top.max()].min())
        return m, np.float32(val[int(m // slice_len)])

    def go(value, iteration, diverging):
        ok = (abs(value) > params.threshold
              and iteration < params.max_iterations and not diverging)
        return ok and (value >= 0.0 or not params.stop_on_negative)

    m, value = find_max()
    bound = np.float32(abs(value)) * np.float32(params.divergence_limit)
    iteration, diverging = params.start_iteration, False
    while go(value, iteration, diverging):
        raw = residual_k[:, m].clone()  # the slot's raw values
        cv = sl.apply_fit(raw * params.gain, fit, m, n_polarizations)
        model_k[:, m] = model_k[:, m] + cv
        sy = ys - ys[m] + height // 2
        sx = xs - xs[m] + width // 2
        inside = (sy >= 0) & (sy < height) & (sx >= 0) & (sx < width)
        src = sy.clamp(0, height - 1) * width + sx.clamp(0, width - 1)
        shifted = torch.where(inside, psf_flat[:, src], 0.0)
        residual_k.copy_(sl.fma(-shifted[psf_index], cv[:, None], residual_k))
        m, value = find_max()
        iteration += 1
        diverging = params.divergence_limit != 0.0 and abs(value) > bound
    return iteration, diverging, int(np.float32(value).view(np.int32))


def frequencies(n_chan):
    return np.array([[1.1e8 + 2e7 * c, 1.3e8 + 2e7 * c]
                     for c in range(n_chan)])


def make_state(n_chan, n_pols, seed, *, negative=False, ties=(),
               slice_len=None, bad_psf=False):
    """Point sources with their own spectral index under Gaussian PSFs
    whose width scales with 1/nu, on noise; every pixel is a candidate
    (K = SIZE^2, raster order).  ``ties`` lists candidate indices given the
    same (largest) value, a negative one first when ``negative``; with
    ``bad_psf`` the PSF is negated and scaled so the loop diverges.
    Returns the torch state, the spectral-index map and the frequencies."""
    rng = np.random.default_rng(seed)
    freqs = frequencies(n_chan)
    nu = freqs.mean(axis=1)
    ratio = nu / nu.mean()
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    r2 = (yy - SIZE // 2) ** 2.0 + (xx - SIZE // 2) ** 2.0
    psfs = np.stack([np.exp(-r2 * ratio[c] ** 2 / (2 * 1.8 ** 2))
                     for c in range(n_chan)]).astype(np.float32)
    if bad_psf:
        psfs *= np.float32(-2.5)
    index_map = rng.normal(-0.7, 0.2, (1, SIZE, SIZE)).astype(np.float32)
    sky = np.zeros((n_chan, SIZE, SIZE))
    for _ in range(10):
        y, x = rng.integers(4, SIZE - 4, 2)
        a = rng.uniform(0.3, 1.0) * (-1.0 if negative and rng.random() < 0.4
                                     else 1.0)
        sky[:, y, x] += a * ratio ** index_map[0, y, x]
    planes = []
    for c in range(n_chan):
        plane = np.real(np.fft.ifft2(np.fft.fft2(sky[c]) * np.fft.fft2(
            np.fft.ifftshift(np.abs(psfs[c])))))
        for p in range(n_pols):
            planes.append(plane * (1.0 - 0.3 * p))
    cube = np.stack(planes).astype(np.float32)
    cube += rng.normal(scale=0.002, size=cube.shape).astype(np.float32)
    res = cube.reshape(n_chan * n_pols, -1).copy()
    if ties:
        top = np.float32(1.5 * np.abs(res).max())
        for t, j in enumerate(ties):
            sign = -1.0 if negative and t == 0 else 1.0
            res[:, j] = np.float32(sign) * top * (1.0 + 0.1 * np.arange(
                res.shape[0], dtype=np.float32)) / np.float32(n_chan)
    flat = np.arange(SIZE * SIZE)
    state = dict(
        res=torch.as_tensor(res),
        xs=torch.as_tensor((flat % SIZE).astype(np.int32)),
        ys=torch.as_tensor((flat // SIZE).astype(np.int32)),
        psfs=torch.as_tensor(psfs),
        rms=torch.as_tensor((0.6 + 0.8 * (xx + yy) / (2.0 * SIZE)).astype(
            np.float32).reshape(-1)),
    )
    return state, index_map, freqs


def fitters(mode, freqs, index_map, n_chan):
    """The JAX and the port's fitter of ``mode`` (2 terms; None for
    NO_FITTING), the forced terms set from ``index_map``."""
    if mode == "NO_FITTING":
        return None, None
    nu = tuple(freqs.mean(axis=1))
    weights = (1.0,) * n_chan
    jfit = JaxFitter(getattr(jrd.SpectralFittingMode, mode), 2, nu, weights)
    tfit = SpectralFitter(getattr(rd.SpectralFittingMode, mode), 2, nu,
                          weights)
    if mode == "FORCED_TERMS":
        jfit.set_forced_terms(jnp.asarray(index_map))
        tfit.set_forced_terms(torch.as_tensor(index_map))
    return jfit, tfit


def port_fit(mode, tfit, state):
    if tfit is None:
        return None
    if mode == "POLYNOMIAL":
        return sl.projection_fit(torch.as_tensor(
            np.asarray(tfit._projection, np.float32)))
    return sm.fit_arguments(tfit, "cpu", state["xs"], state["ys"])


def coefficients(n_chan, n_pols, freqs):
    meta = JaxMeta(n_chan, n_pols, (1.0,) * n_chan, (True,) * n_pols, 1.0,
                   False, tuple(freqs.mean(axis=1)))
    return np.asarray(linear_integration_coefficients(meta), np.float32)


def run_both(state, coef, fit, params, n_pols, slice_len):
    """The plain loop and the grid emulation on copies of the state:
    ((iteration, diverging, bits), residual, model) each."""
    runs = []
    for grid in (False, True):
        res = state["res"].clone()
        model = torch.zeros_like(res)
        args = (res, model, state["rms_k"], state["xs"], state["ys"],
                state["psfs"], coef, fit, params)
        if grid:
            out = grid_loop(*args, n_polarizations=n_pols,
                            slice_len=slice_len)
        else:
            row = sl.subminor_loop_reference(*args, n_polarizations=n_pols)
            out = (int(row[0]), bool(row[1]), int(row[2]))
        runs.append((out, res, model))
    return runs


def assert_bit_equal(runs):
    (out_p, res_p, mod_p), (out_g, res_g, mod_g) = runs
    assert out_g == out_p
    assert torch.equal(res_g, res_p) and torch.equal(mod_g, mod_p)


# The stops: (threshold as a fraction of the peak, max iterations,
# divergence limit, stop on negative, bad PSF).
STOPS = {
    "threshold": (0.3, 500, 4.0, False, False),
    "iterations": (0.0, 37, 4.0, False, False),
    "divergence": (0.0, 300, 1.5, False, True),
    "negative": (0.0, 300, 0.0, True, False),
}


@pytest.mark.parametrize("slice_len", [1, 7, 64, 1000])
@pytest.mark.parametrize("fit_mode", FITS)
def test_grid_exchange_bit_equal_to_plain(fit_mode, slice_len):
    """Each fit, 3 channels x 2 polarizations, negatives allowed, an rms
    factor, to the threshold: the grid's exchange gives the plain loop's
    bits at every slice length (one candidate a block up to a few blocks,
    the last slice ragged)."""
    n_chan, n_pols = 3, 2
    state, index_map, freqs = make_state(n_chan, n_pols, seed=3,
                                         negative=True)
    state["rms_k"] = state["rms"]
    _, tfit = fitters(fit_mode, freqs, index_map, n_chan)
    fit = port_fit(fit_mode, tfit, state)
    coef = torch.as_tensor(coefficients(n_chan, n_pols, freqs))
    peak = float(state["res"].abs().max())
    params = sl.SubminorParams.make(0.2 * peak, 0.1, 0, 300, 4.0, True,
                                    False)
    runs = run_both(state, coef, fit, params, n_pols, slice_len)
    assert_bit_equal(runs)
    assert runs[0][0][0] > 20
    assert runs[0][2].sum(0).min() < 0  # a negative component was taken


@pytest.mark.parametrize("stop", list(STOPS))
@pytest.mark.parametrize("fit_mode", ["NO_FITTING", "FORCED_TERMS"])
def test_grid_exchange_stops_like_plain(fit_mode, stop):
    """The threshold, max-iteration, divergence and stop-on-negative exits,
    at 13 candidates a block: equal counts, flags, values and state."""
    frac, max_it, divergence, stop_neg, bad_psf = STOPS[stop]
    n_chan, n_pols = 2, 1
    state, index_map, freqs = make_state(n_chan, n_pols, seed=5,
                                         negative=True, bad_psf=bad_psf)
    state["rms_k"] = None
    _, tfit = fitters(fit_mode, freqs, index_map, n_chan)
    fit = port_fit(fit_mode, tfit, state)
    coef = torch.as_tensor(coefficients(n_chan, n_pols, freqs))
    peak = float(state["res"].abs().max())
    params = sl.SubminorParams.make(frac * peak, 0.1, 2, max_it, divergence,
                                    True, stop_neg)
    runs = run_both(state, coef, fit, params, n_pols, 13)
    assert_bit_equal(runs)
    iteration, diverging, bits = runs[0][0]
    value = float(np.int32(bits).view(np.float32))
    if stop == "iterations":
        assert iteration == max_it
    elif stop == "divergence":
        assert diverging
    elif stop == "negative":
        assert value < 0 and iteration < max_it
    else:
        assert abs(value) <= params.threshold and iteration > 2


@pytest.mark.parametrize("negative", [False, True],
                         ids=["positive-tie", "signed-tie"])
@pytest.mark.parametrize("fit_mode", FITS)
def test_grid_exchange_ties_across_slice_boundaries(fit_mode, negative):
    """Equal largest values on both sides of slice boundaries (the last of
    one slice, the first of the next, one further on; with ``negative`` the
    first of them negative, equal in magnitude): the smallest index wins in
    every iteration, as in the plain loop."""
    n_chan, n_pols = 2, 2
    slice_len = 50
    ties = (slice_len - 1, slice_len, 3 * slice_len + 7)
    state, index_map, freqs = make_state(n_chan, n_pols, seed=9,
                                         negative=negative, ties=ties)
    state["rms_k"] = None
    _, tfit = fitters(fit_mode, freqs, index_map, n_chan)
    fit = port_fit(fit_mode, tfit, state)
    coef = torch.as_tensor(coefficients(n_chan, n_pols, freqs))
    params = sl.SubminorParams.make(0.0, 0.1, 0, 25, 0.0, True, False)
    runs = run_both(state, coef, fit, params, n_pols, slice_len)
    assert_bit_equal(runs)
    # The first component went to the smallest of the tied indices.
    model = runs[0][2]
    assert model[:, ties[0]].abs().sum() > 0
    assert runs[0][0][0] == 25


@pytest.mark.parametrize("fit_mode", FITS)
def test_grid_exchange_matches_jax_loop(fit_mode):
    """The same candidate set through the JAX package's XLA loop and the
    grid emulation (slices of 100 candidates, an rms factor, negatives
    allowed): equal iterations and divergence, the state within the
    contract."""
    n_chan, n_pols = 3, 1
    state, index_map, freqs = make_state(n_chan, n_pols, seed=11,
                                         negative=True)
    state["rms_k"] = state["rms"]
    jfit, tfit = fitters(fit_mode, freqs, index_map, n_chan)
    fit = port_fit(fit_mode, tfit, state)
    coef = coefficients(n_chan, n_pols, freqs)
    peak = float(state["res"].abs().max())
    threshold, gain, max_iters, divergence = 0.1 * peak, 0.1, 400, 4.0
    res_j, mod_j, it_j, val_j, div_j = jsm._subminor_while(
        jnp.asarray(state["res"].numpy()),
        jnp.zeros(tuple(state["res"].shape), jnp.float32),
        jnp.asarray(state["rms"].numpy()),
        jnp.ones(SIZE * SIZE, bool), jnp.asarray(state["xs"].numpy()),
        jnp.asarray(state["ys"].numpy()), jnp.asarray(state["psfs"].numpy()),
        jnp.asarray(coef), jnp.float32(threshold), jnp.float32(gain),
        jnp.int32(0), jnp.int32(max_iters), jnp.float32(divergence),
        allow_negative=True, stop_on_negative=False, fitter=jfit,
        n_channels=n_chan, n_polarizations=n_pols, height=SIZE, width=SIZE)
    res = state["res"].clone()
    model = torch.zeros_like(res)
    params = sl.SubminorParams.make(threshold, gain, 0, max_iters,
                                    divergence, True, False)
    iteration, diverging, _ = grid_loop(
        res, model, state["rms_k"], state["xs"], state["ys"], state["psfs"],
        torch.as_tensor(coef), fit, params, n_polarizations=n_pols,
        slice_len=100)
    assert iteration == int(it_j) > 20
    assert diverging == bool(div_j)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_j),
                               atol=RESIDUAL_ATOL, rtol=0)
    mod_j = np.asarray(mod_j)
    assert np.abs(model.numpy() - mod_j).max() <= (
        MODEL_PEAK_RTOL * np.abs(mod_j).max())
