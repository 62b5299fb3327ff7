"""The port's ops against the JAX package's: peak finder, PSF shift and
subtraction, MAD noise, spectral fitter, trim/untrim.

Inputs are made with NumPy from a seed and handed to both packages.
Tolerances: peak positions and found flags exact; the MAD noise bit-equal
(both pick the same order statistics); shifts, subtraction and trims exact
(no arithmetic reordering); the spectral fitter within 1e-5 relative (small
float32 matmuls that may sum in another order).
"""

from collections import OrderedDict

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from radler_tpu.ops import noise as jnoise
from radler_tpu.ops import peak_finder as jpeak
from radler_tpu.ops import psf_subtract as jsub
from radler_tpu.ops import spectral_fitting as jfit
from radler_tpu.ops.convolution import trim as jtrim, untrim as juntrim
from radler_tpu.settings import SpectralFittingMode as JaxMode
from radler_tpu_torch.ops import noise, peak_finder, psf_subtract
from radler_tpu_torch.ops import spectral_fitting
from radler_tpu_torch.ops.convolution import trim, untrim
from radler_tpu_torch.settings import SpectralFittingMode
from radler_tpu_torch.utils import device_consts

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)


def rng_image(seed, shape=(37, 53)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("allow_negative", [True, False])
@pytest.mark.parametrize("borders", [(0, 0), (5, 3), (30, 30)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_find_peak_matches_jax(allow_negative, borders, with_mask):
    image = rng_image(1)
    image[10, 20] = image[30, 4] = 9.0  # a tie: the first row-major wins
    mask = None
    if with_mask:
        mask = np.random.default_rng(2).uniform(size=image.shape) > 0.3
    j = jpeak.find_peak(jnp.asarray(image), allow_negative, *borders, mask)
    t = peak_finder.find_peak(torch.as_tensor(image), allow_negative,
                              *borders, mask)
    assert bool(t.found) == bool(j.found)
    if bool(j.found):
        assert (int(t.x), int(t.y)) == (int(j.x), int(j.y))
        assert float(t.value) == float(j.value)


def test_find_peak_nothing_found():
    image = -np.abs(rng_image(3))
    t = peak_finder.find_peak(torch.as_tensor(image), False)
    assert not bool(t.found)
    zeros = peak_finder.find_peak(torch.zeros(8, 8), True)
    assert not bool(zeros.found)


def test_window_mask_and_border_match_jax():
    for args in ((40, 50, 4, 7), (10, 10, 6, 6), (16, 20, 0, 0, 3, 12)):
        np.testing.assert_array_equal(
            peak_finder.window_mask(*args), jpeak.window_mask(*args)
        )
    assert peak_finder.border_from_ratio(130, 70, 0.05) == (
        jpeak.border_from_ratio(130, 70, 0.05)
    )


@pytest.mark.parametrize("xy", [(0, 0), (26, 18), (52, 36), (3, 30), (50, 1)])
def test_shift_and_subtract_match_jax(xy):
    x, y = xy
    psfs = np.stack([rng_image(4), rng_image(5)])
    cube = np.stack([rng_image(6), rng_image(7), rng_image(8), rng_image(9)])
    factors = np.asarray([0.3, -0.2, 0.7, 0.1], np.float32)
    idx = np.asarray([0, 0, 1, 1])
    np.testing.assert_array_equal(
        psf_subtract.shift_psf(torch.as_tensor(psfs), x, y).numpy(),
        np.asarray(jsub.shift_psf(jnp.asarray(psfs), x, y)),
    )
    # Device-side positions give the same shift as Python ints.
    np.testing.assert_array_equal(
        psf_subtract.shift_psf(
            torch.as_tensor(psfs), torch.tensor(x), torch.tensor(y)
        ).numpy(),
        psf_subtract.shift_psf(torch.as_tensor(psfs), x, y).numpy(),
    )
    np.testing.assert_array_equal(
        psf_subtract.subtract_psf_from_cube(
            torch.as_tensor(cube), torch.as_tensor(psfs), torch.as_tensor(idx),
            x, y, torch.as_tensor(factors),
        ).numpy(),
        np.asarray(
            jsub.subtract_psf_from_cube(
                jnp.asarray(cube), jnp.asarray(psfs), jnp.asarray(idx), x, y,
                jnp.asarray(factors),
            )
        ),
    )


@pytest.mark.parametrize(
    "shape, n_nonfinite",
    [((64, 64), 0), ((63, 65), 0), ((1, 1), 0), ((2, 1), 0), ((40, 30), 37),
     ((8, 8), 64)],
)
def test_mad_noise_bit_equal_to_jax(shape, n_nonfinite):
    rng = np.random.default_rng(shape[0] * 100 + n_nonfinite)
    image = (rng.standard_t(3, size=shape) * 0.1 + 0.02).astype(np.float32)
    flat = image.reshape(-1)
    bad = rng.choice(flat.size, n_nonfinite, replace=False)
    flat[bad] = np.where(np.arange(n_nonfinite) % 2, np.nan, np.inf)
    jm, js = jnoise.median_and_stddev_from_mad(jnp.asarray(image))
    tm, ts = noise.median_and_stddev_from_mad(torch.as_tensor(image))
    assert np.float32(tm).tobytes() == np.asarray(jm).tobytes()
    assert np.float32(ts).tobytes() == np.asarray(js).tobytes()


def test_mad_noise_of_the_bench_residual_bit_equal():
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from bench import make_problem

    _, residual = make_problem(128, 20, seed=7)
    jm, js = jnoise.median_and_stddev_from_mad(jnp.asarray(residual))
    tm, ts = noise.median_and_stddev_from_mad(torch.as_tensor(residual))
    assert (float(tm), float(ts)) == (float(jm), float(js))


def fitters(mode_name, n_terms=3, n_chan=5):
    freqs = np.linspace(1.0e8, 1.8e8, n_chan)
    weights = np.asarray([1.0, 0.5, 2.0, 1.5, 1.0][:n_chan])
    return (
        jfit.SpectralFitter(getattr(JaxMode, mode_name), n_terms, freqs,
                            weights),
        spectral_fitting.SpectralFitter(
            getattr(SpectralFittingMode, mode_name), n_terms, freqs, weights
        ),
    )


@pytest.mark.parametrize(
    "mode_name", ["NO_FITTING", "POLYNOMIAL", "LOG_POLYNOMIAL"]
)
def test_spectral_fitter_matches_jax(mode_name):
    jf, tf = fitters(mode_name)
    assert tf.is_active == jf.is_active
    assert tf.reference_frequency == jf.reference_frequency
    rng = np.random.default_rng(11)
    values = rng.uniform(0.2, 2.0, (5, 2)).astype(np.float32)
    values[:, 1] *= -1.0  # a negative spectrum keeps its sign
    np.testing.assert_allclose(
        tf.fit_and_evaluate(torch.as_tensor(values)).numpy(),
        np.asarray(jf.fit_and_evaluate(jnp.asarray(values))),
        rtol=1e-5,
    )
    np.testing.assert_allclose(tf.fit(values[:, 0]), jf.fit(values[:, 0]))
    if tf.is_active:
        spectra = rng.uniform(0.1, 1.0, (5, 6, 7)).astype(np.float32)
        spectra[:, 2, 3] = 0.0
        terms_t = tf.fit_image(torch.as_tensor(spectra))
        terms_j = jf.fit_image(jnp.asarray(spectra))
        np.testing.assert_allclose(terms_t.numpy(), np.asarray(terms_j),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            tf.evaluate_image(terms_t, 1.25e8).numpy(),
            np.asarray(jf.evaluate_image(terms_j, 1.25e8)),
            rtol=1e-5, atol=1e-6,
        )


def test_forced_terms_fit_matches_jax():
    jf, tf = fitters("FORCED_TERMS", n_terms=3)
    terms = np.random.default_rng(12).normal(
        scale=0.5, size=(2, 6, 7)).astype(np.float32)
    jf.set_forced_terms(jnp.asarray(terms))
    tf.set_forced_terms(torch.as_tensor(terms))
    values = np.random.default_rng(13).uniform(
        0.2, 2.0, (5, 1)).astype(np.float32)
    np.testing.assert_allclose(
        tf.fit_and_evaluate(torch.as_tensor(values), 4, 2).numpy(),
        np.asarray(jf.fit_and_evaluate(jnp.asarray(values), 4, 2)),
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        tf.fit_and_evaluate(
            torch.as_tensor(values), forced_terms=torch.as_tensor(terms[:, 2, 4])
        ).numpy(),
        np.asarray(jf.fit_and_evaluate(jnp.asarray(values), 4, 2)),
        rtol=1e-5,
    )


@pytest.mark.parametrize(
    "mode_name", ["POLYNOMIAL", "LOG_POLYNOMIAL", "FORCED_TERMS"]
)
def test_fitter_copies_its_constants_once(monkeypatch, mode_name):
    """The fit runs between the kernel launches of every minor iteration;
    its host constants reach the device once, not in every call (a blocking
    copy would wait for the device each time)."""
    _, tf = fitters(mode_name)
    if mode_name == "FORCED_TERMS":
        tf.set_forced_terms(torch.ones(2, 6, 7))
    copies = []
    real = device_consts._upload
    monkeypatch.setattr(device_consts, "_cache", OrderedDict())
    monkeypatch.setattr(device_consts, "_upload",
                        lambda *a: copies.append(a) or real(*a))
    values = torch.ones(5, 2)
    first = tf.fit_and_evaluate(values, 4, 2)
    n_first = len(copies)
    for _ in range(3):
        again = tf.fit_and_evaluate(values, 4, 2)
    assert n_first > 0 and len(copies) == n_first
    assert torch.equal(first, again)


@pytest.mark.parametrize("shape", [(6, 8), (7, 9), (2, 5, 6)])
def test_trim_untrim_match_jax(shape):
    image = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    for h, w in ((16, 16), (11, 13)):
        np.testing.assert_array_equal(
            untrim(torch.as_tensor(image), h, w).numpy(),
            np.asarray(juntrim(jnp.asarray(image), h, w)),
        )
    np.testing.assert_array_equal(
        trim(torch.as_tensor(image), 3, 4).numpy(),
        np.asarray(jtrim(jnp.asarray(image), 3, 4)),
    )
