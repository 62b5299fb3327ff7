"""The port's Högbom step and loop against the JAX package's.

The port's CPU path runs the plain PyTorch versions of the CUDA kernels
(``radler_tpu_torch.kernels.hogbom_step``); the JAX side runs its Pallas
kernel in interpret mode, as ``tests/test_ops.py`` does, and its jnp loop.
Inputs are made with NumPy from a seed and handed to both.

Tolerances: residual within 1e-6 absolute and model within 1e-6 absolute or
relative (float32 values of order 1 to 10, where the two packages may sum in
a different order), peak indices and iteration counts exact.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from radler_tpu.image_set import CubeMeta as JaxCubeMeta
from radler_tpu.image_set import linear_integration_coefficients
from radler_tpu.models.generic_clean import _hogbom_loop
from radler_tpu.ops.pallas.hogbom_step import (
    fused_clean_step,
    hogbom_loop_pallas,
    integration_coefficients as jax_integration_coefficients,
    pad_psfs,
)
from radler_tpu_torch.interop import cube_meta_from_reference
from radler_tpu_torch.kernels import hogbom_step as hs
from radler_tpu_torch.ops.peak_finder import window_mask

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

SIZE = 128
ATOL = 1e-6

# (mode, n_channels, n_polarizations, squared_joins); linear mode is the
# plane-weighted sum the multiscale loop peaks on.
CASES = [
    ("signed", 1, 1, False),
    ("linear", 4, 1, False),
    ("linear", 8, 1, False),
    ("normal", 4, 1, False),
    ("normal", 2, 4, False),
    ("squared", 4, 1, True),
    ("squared", 2, 4, True),
    ("normal", 1, 4, False),
]


def make_meta(n_channels, n_polarizations, squared, seed=0):
    rng = np.random.default_rng(seed)
    weights = tuple(float(w) for w in rng.uniform(0.5, 2.0, n_channels))
    if n_channels > 2:
        weights = weights[:-1] + (0.0,)  # a zero-weight channel
    return JaxCubeMeta(
        n_channels=n_channels,
        n_polarizations=n_polarizations,
        weights=weights,
        linked=(True,) * n_polarizations,
        polarization_norm_factor=1.0,
        squared_joins=squared,
        frequencies=tuple(1e8 + 1e7 * c for c in range(n_channels)),
    )


def coefficients(mode, meta):
    if mode == "linear":
        return "linear", linear_integration_coefficients(meta), np.ones(1)
    got, chan, pol = jax_integration_coefficients(meta)
    assert got == mode
    return mode, chan, pol


def make_cube(meta, seed, size=SIZE, n_sources=6):
    """Residual with a few bright sources on noise, and Gaussian PSFs that
    differ per channel."""
    rng = np.random.default_rng(seed)
    n = meta.n_images
    res = rng.normal(scale=0.01, size=(n, size, size)).astype(np.float32)
    for _ in range(n_sources):
        y, x = rng.integers(4, size - 4, 2)
        res[:, y, x] += rng.uniform(0.5, 2.0, n).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psfs = np.stack(
        [np.exp(-r2 / (2.0 * (1.5 + 0.3 * c) ** 2)) for c in range(meta.n_channels)]
    ).astype(np.float32)
    return res, psfs


def port_buffers(n, y, x, values):
    state = torch.tensor([y, x, 1, 0, 0, 1, y * SIZE + x, 0], dtype=torch.int32)
    vals = torch.tensor(values)  # a copy: the select rewrites it
    return hs.LoopBuffers(
        state=state,
        value=torch.zeros(1),
        peak=torch.zeros(n),
        values=vals,
    )


@pytest.mark.parametrize("use_weight", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_step_matches_pallas_interpret(case, use_weight):
    mode, C, P, squared = case
    meta = make_meta(C, P, squared, seed=C * 10 + P)
    mode, chan, pol = coefficients(mode, meta)
    res, psfs = make_cube(meta, seed=C + P)
    rng = np.random.default_rng(7)
    values = rng.uniform(-0.5, 1.0, meta.n_images).astype(np.float32)
    weight = rng.uniform(0.0, 1.0, (SIZE, SIZE)).astype(np.float32)
    y, x = 37, 101

    new_res, idx, cmp = fused_clean_step(
        jnp.asarray(res),
        pad_psfs(jnp.asarray(psfs[meta.psf_indices])),
        jnp.asarray(values),
        jnp.asarray(weight),
        jnp.int32(y),
        jnp.int32(x),
        block_rows=32,
        allow_negative=True,
        integration_mode=mode,
        chan_coefs=tuple(float(v) for v in chan),
        pol_coefs=tuple(float(v) for v in pol),
        use_weight=use_weight,
        interpret=True,
    )

    residual = torch.as_tensor(res.copy())
    model = torch.zeros_like(residual)
    buffers = port_buffers(meta.n_images, y, x, values)
    params = hs.LoopParams.make(0.1, 0.0, 1.0, 0.0, 10, False)
    partials = hs.hogbom_step(
        residual,
        model,
        torch.as_tensor(psfs),
        buffers.values,
        buffers.state,
        torch.as_tensor(hs.kernel_coefficients(mode, chan, pol)),
        torch.as_tensor(weight) if use_weight else None,
        mode=mode,
        n_polarizations=P,
        allow_negative=True,
        buffers=buffers,
        params=params,
    )

    np.testing.assert_allclose(residual.numpy(), np.asarray(new_res), atol=ATOL)
    assert int(buffers.state[hs.INDEX]) == int(idx)
    np.testing.assert_allclose(
        float(partials[0].max()), float(cmp), rtol=1e-6, atol=ATOL
    )
    # The model gained the component values at (y, x) and nowhere else.
    expected_model = np.zeros_like(res)
    expected_model[:, y, x] = values
    np.testing.assert_array_equal(model.numpy(), expected_model)


def run_port_loop(meta, res, psfs, weight, peak0, params, allow_negative,
                  start=0):
    residual = torch.as_tensor(res.copy())
    model = torch.zeros_like(residual)
    out = hs.hogbom_loop(
        residual,
        model,
        torch.as_tensor(psfs),
        None if weight is None else torch.as_tensor(weight),
        None,
        peak0,
        params,
        start,
        meta=cube_meta_from_reference(meta),
        allow_negative=allow_negative,
    )
    return residual.numpy(), model.numpy(), out


def initial_peak(meta, res, window=None):
    """The loop's first peak: the argmax of the integrated image inside the
    search window, as the JAX loops take it from their caller."""
    from radler_tpu.image_set import get_square_integrated

    integ = np.asarray(get_square_integrated(jnp.asarray(res), meta))
    cmp = np.abs(integ) if window is None else np.where(window, np.abs(integ), -1)
    flat = int(np.argmax(cmp))
    y, x = divmod(flat, SIZE)
    return float(integ[y, x]), x, y, True


LOOP_CASES = [
    ("signed", 1, 1, False, 0),
    ("normal", 2, 4, False, 0),
    ("squared", 2, 4, True, 6),
    ("normal", 4, 1, False, 6),
]


@pytest.mark.parametrize(
    "case", LOOP_CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-border{c[4]}"
)
def test_loop_matches_jax_loops(case):
    mode, C, P, squared, border = case
    meta = make_meta(C, P, squared, seed=3)
    res, psfs = make_cube(meta, seed=11, n_sources=10)
    window = window_mask(SIZE, SIZE, border, border)
    value0, x0, y0, found0 = initial_peak(meta, res, window)
    gain, threshold, limit, max_it = 0.2, 0.05, 0.0, 150
    use_weight = border > 0
    weight = window.astype(np.float32) if use_weight else None
    ones = jnp.ones((SIZE, SIZE), jnp.float32)
    common = (
        jnp.float32(value0), jnp.int32(x0), jnp.int32(y0), jnp.asarray(found0),
        jnp.float32(threshold), jnp.float32(gain), jnp.float32(abs(value0)),
        jnp.float32(limit), jnp.int32(0), jnp.int32(max_it),
    )
    res_p, mod_p, it_p, val_p, *_ = hogbom_loop_pallas(
        jnp.asarray(res), jnp.zeros_like(jnp.asarray(res)),
        pad_psfs(jnp.asarray(psfs[meta.psf_indices])),
        jnp.asarray(weight) if use_weight else ones, ones, *common,
        meta=meta, allow_negative=True, stop_on_negative=False, fitter=None,
        block_rows=32, use_weight=use_weight, interpret=True,
    )
    res_j, mod_j, it_j, *_ = _hogbom_loop(
        jnp.asarray(res), jnp.zeros_like(jnp.asarray(res)), jnp.asarray(psfs),
        ones, jnp.ones((SIZE, SIZE), bool), *common,
        meta=meta, allow_negative=True, stop_on_negative=False, fitter=None,
        border_h=border, border_v=border, use_rms=False, use_mask=False,
    )
    params = hs.LoopParams.make(gain, threshold, abs(value0), limit, max_it,
                                False)
    res_t, mod_t, out = run_port_loop(
        meta, res, psfs, weight, (value0, x0, y0, found0), params, True
    )
    assert out.iteration == int(it_p) == int(it_j)
    assert 0 < out.iteration
    for ref_res, ref_mod in ((res_p, mod_p), (res_j, mod_j)):
        np.testing.assert_allclose(res_t, np.asarray(ref_res), atol=ATOL)
        np.testing.assert_allclose(
            mod_t, np.asarray(ref_mod), rtol=ATOL, atol=ATOL
        )
    np.testing.assert_allclose(out.value, float(val_p), atol=ATOL)


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_chunked_loop_equals_exact_stop(monkeypatch, chunk):
    """Iterations enqueued after the stop are no-ops: a loop that reads the
    state back every CHUNK iterations ends in the same state, bit for bit,
    as one that reads it after every iteration."""
    meta = make_meta(2, 4, False, seed=5)
    res, psfs = make_cube(meta, seed=2, n_sources=4)
    value0, x0, y0, found0 = initial_peak(meta, res)
    params = hs.LoopParams.make(0.3, 1.5, abs(value0), 0.0, 500, False)
    runs = []
    for k in (1, chunk * hs.CHUNK + 1):
        monkeypatch.setattr(hs, "CHUNK", k)
        runs.append(
            run_port_loop(meta, res, psfs, None, (value0, x0, y0, found0),
                          params, True)
        )
    (res_a, mod_a, out_a), (res_b, mod_b, out_b) = runs
    assert out_a == out_b
    assert out_a.iteration < params.max_iterations  # stopped on threshold
    np.testing.assert_array_equal(res_a, res_b)
    np.testing.assert_array_equal(mod_a, mod_b)


def test_loop_stops_on_divergence_and_negative():
    meta = make_meta(1, 1, False)
    res, psfs = make_cube(meta, seed=4)
    value0, x0, y0, found0 = initial_peak(meta, res)
    # A negative gain makes the peak grow: the divergence test stops it.
    params = hs.LoopParams.make(-0.5, 0.0, abs(value0), 1.5, 100, False)
    _, _, out = run_port_loop(meta, res, psfs, None, (value0, x0, y0, found0),
                              params, True)
    assert out.diverging and out.iteration < 100
    # stop_on_negative stops at the first negative peak value.
    neg = -np.abs(res)
    value0, x0, y0, found0 = initial_peak(meta, neg)
    params = hs.LoopParams.make(0.1, 0.0, abs(value0), 0.0, 100, True)
    _, model, out = run_port_loop(meta, neg, psfs, None,
                                  (value0, x0, y0, found0), params, True)
    assert out.iteration == 0 and not model.any()


def test_kernel_coefficients_layout():
    chan = np.asarray([0.25, 0.75], np.float32)
    pol = np.asarray([1.0, 0.0, 1.0], np.float32)
    np.testing.assert_array_equal(
        hs.kernel_coefficients("normal", chan, pol),
        np.asarray([1, 0, 1, 1, 0, 1, 0.25, 0.75], np.float32),
    )
    np.testing.assert_array_equal(
        hs.kernel_coefficients("squared", chan, pol),
        np.asarray([0.25, 0, 0.25, 0.75, 0, 0.75], np.float32),
    )
    with pytest.raises(ValueError):
        hs.kernel_coefficients("bogus", chan, pol)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    """CPU tensors take the plain version; launch counts move only when a
    kernel is launched."""
    before = (hs.hogbom_step.launches, hs.hogbom_step_facets.launches)
    meta = make_meta(1, 1, False)
    res, psfs = make_cube(meta, seed=9)
    value0, x0, y0, found0 = initial_peak(meta, res)
    params = hs.LoopParams.make(0.1, 0.0, abs(value0), 0.0, 5, False)
    run_port_loop(meta, res, psfs, None, (value0, x0, y0, found0), params, True)
    assert (hs.hogbom_step.launches,
            hs.hogbom_step_facets.launches) == before


@pytest.mark.parametrize(
    "fit_mode", ["POLYNOMIAL", "LOG_POLYNOMIAL", "FORCED_TERMS"]
)
def test_loop_with_spectral_fit_matches_jax(fit_mode):
    """The spectral fit between launches (the loop body's
    ``fit_and_evaluate``), against the JAX jnp loop.  Within 1e-5: the
    fit's small float32 matmuls, logs and exps may round differently in the
    two packages."""
    from radler_tpu.ops.spectral_fitting import SpectralFitter as JaxFitter
    from radler_tpu.settings import SpectralFittingMode as JaxMode
    from radler_tpu_torch.ops.spectral_fitting import SpectralFitter
    from radler_tpu_torch.settings import SpectralFittingMode

    meta = make_meta(4, 1, False, seed=8)
    res, psfs = make_cube(meta, seed=13, n_sources=8)
    freqs = np.asarray(meta.frequencies)
    weights = np.asarray(meta.weights)
    jfit = JaxFitter(getattr(JaxMode, fit_mode), 2, freqs, weights)
    tfit = SpectralFitter(getattr(SpectralFittingMode, fit_mode), 2, freqs,
                          weights)
    if fit_mode == "FORCED_TERMS":
        terms = np.random.default_rng(2).normal(
            scale=0.3, size=(1, SIZE, SIZE)).astype(np.float32)
        jfit.set_forced_terms(jnp.asarray(terms))
        tfit.set_forced_terms(torch.as_tensor(terms))
    value0, x0, y0, found0 = initial_peak(meta, res)
    gain, threshold, max_it = 0.2, 0.05, 120
    ones = jnp.ones((SIZE, SIZE), jnp.float32)
    res_j, mod_j, it_j, *_ = _hogbom_loop(
        jnp.asarray(res), jnp.zeros_like(jnp.asarray(res)), jnp.asarray(psfs),
        ones, jnp.ones((SIZE, SIZE), bool),
        jnp.float32(value0), jnp.int32(x0), jnp.int32(y0), jnp.asarray(found0),
        jnp.float32(threshold), jnp.float32(gain), jnp.float32(abs(value0)),
        jnp.float32(0.0), jnp.int32(0), jnp.int32(max_it),
        meta=meta, allow_negative=True, stop_on_negative=False, fitter=jfit,
        border_h=0, border_v=0, use_rms=False, use_mask=False,
    )
    residual = torch.as_tensor(res.copy())
    model = torch.zeros_like(residual)
    out = hs.hogbom_loop(
        residual, model, torch.as_tensor(psfs), None, None,
        (value0, x0, y0, found0),
        hs.LoopParams.make(gain, threshold, abs(value0), 0.0, max_it, False),
        0, meta=cube_meta_from_reference(meta), allow_negative=True,
        fitter=tfit,
    )
    assert out.iteration == int(it_j) > 10
    np.testing.assert_allclose(residual.numpy(), np.asarray(res_j), atol=1e-5)
    np.testing.assert_allclose(model.numpy(), np.asarray(mod_j), rtol=1e-5,
                               atol=1e-5)
