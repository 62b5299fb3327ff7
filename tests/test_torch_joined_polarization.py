"""Joined-polarization / multi-frequency deconvolution: port against JAX.

Mirrors ``tests/test_joined_polarization.py``: a 4-Stokes x 2-channel cube
through the public WorkTable API, a linked-polarization subset, squared
channel joins, and a zero-weight channel, each run through both packages'
``Radler.perform`` from one ``radler_tpu.Settings``.

Tolerances: iteration counts and ``perform()`` results exact; residuals
within 2e-6 absolute and models within 1e-4 absolute (the ROADMAP's parity
contract), plus the original test's own checks on the port.
"""

import numpy as np
import pytest
import torch

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu_torch.interop import settings_from_reference

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

SIZE = 64
PIXEL_SCALE = 1.0 / 60.0 * (np.pi / 180.0)


def delta_psf(width=1):
    psf = np.zeros((SIZE, SIZE), np.float32)
    psf[SIZE // 2, SIZE // 2] = 1.0
    if width > 1:
        psf[SIZE // 2, SIZE // 2 + 1] = 0.3
        psf[SIZE // 2 + 1, SIZE // 2] = 0.2
    return psf


def jax_settings(iterations, threshold=1e-6):
    s = jrd.Settings()
    s.trimmed_image_width = SIZE
    s.trimmed_image_height = SIZE
    s.pixel_scale.x = PIXEL_SCALE
    s.pixel_scale.y = PIXEL_SCALE
    s.minor_iteration_count = iterations
    s.absolute_threshold = threshold
    s.generic.use_sub_minor_optimization = False
    return s


def run_table(package, settings, pol_names, images, psf, weights=None):
    """Build a work table of ``images[(ch, pol_name)]`` in ``package``, run
    one perform, return (again, iterations, residuals, models)."""
    n_chan = 1 + max(ch for ch, _ in images)
    residuals, models = {}, {}
    table = package.WorkTable([], n_chan, n_chan)
    for ch in range(n_chan):
        for i, name in enumerate(pol_names):
            residuals[(ch, name)] = images[(ch, name)].copy()
            models[(ch, name)] = np.zeros((SIZE, SIZE), np.float32)
            e = package.WorkTableEntry()
            e.polarization = getattr(package.Polarization, name)
            e.original_channel_index = ch
            e.image_weight = 1.0 if weights is None else weights[ch]
            e.band_start_frequency = 1.0e8 + ch * 1e7
            e.band_end_frequency = 1.1e8 + ch * 1e7
            if i == 0:
                e.psf_accessors = [package.LoadOnlyImageAccessor(psf)]
            e.residual_accessor = package.LoadAndStoreImageAccessor(
                residuals[(ch, name)]
            )
            e.model_accessor = package.LoadAndStoreImageAccessor(
                models[(ch, name)]
            )
            table.add_entry(e)
    device = {"device": "cpu"} if package is rd else {}
    r = package.Radler(settings, table, beam_size=0.0, **device)
    again = r.perform(0)
    return again, r.iteration_number, residuals, models


def run_both(settings, pol_names, images, psf, weights=None):
    jax_out = run_table(jrd, settings, pol_names, images, psf, weights)
    port_out = run_table(
        rd, settings_from_reference(settings), pol_names, images, psf, weights
    )
    assert port_out[:2] == jax_out[:2]
    for key in images:
        np.testing.assert_allclose(port_out[2][key], jax_out[2][key],
                                   atol=2e-6)
        np.testing.assert_allclose(port_out[3][key], jax_out[3][key],
                                   atol=1e-4)
    return port_out


IQUV = ["STOKES_I", "STOKES_Q", "STOKES_U", "STOKES_V"]


@pytest.mark.parametrize("squared", [False, True])
def test_iquv_two_channels(squared):
    flux = {
        (0, "STOKES_I"): 2.0, (0, "STOKES_Q"): 0.5, (0, "STOKES_U"): -0.3,
        (0, "STOKES_V"): 0.1, (1, "STOKES_I"): 1.5, (1, "STOKES_Q"): 0.4,
        (1, "STOKES_U"): -0.2, (1, "STOKES_V"): 0.05,
    }
    images = {}
    for key, value in flux.items():
        img = np.zeros((SIZE, SIZE), np.float32)
        img[20, 41] = value
        images[key] = img
    s = jax_settings(200)
    s.squared_joins = squared
    _, _, residuals, models = run_both(s, IQUV, images, delta_psf())
    for key, value in flux.items():
        np.testing.assert_allclose(models[key][20, 41], value, atol=1e-4)
        np.testing.assert_allclose(residuals[key], 0.0, atol=1e-5)


def test_iquv_extended_psf_many_sources():
    """Noise plus several IQUV sources with a non-delta PSF: many
    iterations of the normal (sqrt-sum-of-squares) integration."""
    rng = np.random.default_rng(3)
    psf = delta_psf(width=2)
    images = {}
    positions = rng.integers(5, SIZE - 5, (6, 2))
    for ch in range(2):
        for name in IQUV:
            img = rng.normal(scale=0.01, size=(SIZE, SIZE)).astype(np.float32)
            for y, x in positions:
                img[y, x] += rng.uniform(-1.0, 2.0)
            images[(ch, name)] = img
    again, iterations, _, _ = run_both(
        jax_settings(300, threshold=0.03), IQUV, images, psf
    )
    assert iterations > 20


def test_linked_polarization_subset():
    """Only linked polarizations drive the peak search; unlinked planes are
    still updated with their own values (settings.h:160-166)."""
    res_xx = np.zeros((SIZE, SIZE), np.float32)
    res_yy = np.zeros((SIZE, SIZE), np.float32)
    res_xx[10, 12] = 1.0
    res_yy[10, 12] = 0.5
    res_yy[40, 40] = 3.0  # a YY-only artifact that must not drive cleaning
    images = {(0, "XX"): res_xx, (0, "YY"): res_yy}
    s = jax_settings(100)
    s.linked_polarizations = {jrd.Polarization.XX}
    _, _, residuals, models = run_both(s, ["XX", "YY"], images, delta_psf())
    assert models[(0, "XX")][10, 12] == pytest.approx(1.0, abs=1e-4)
    assert models[(0, "YY")][10, 12] == pytest.approx(0.5, abs=1e-4)
    assert models[(0, "YY")][40, 40] == 0.0
    assert residuals[(0, "YY")][40, 40] == pytest.approx(3.0)


def test_zero_weight_channel_does_not_poison_clean():
    """A weight-0 channel (whose plane may hold NaNs) must not poison the
    joined peak search (image_set.cc:423-462 skip-if-zero semantics)."""
    c0 = np.zeros((SIZE, SIZE), np.float32)
    c0[12, 17] = 2.0
    c1 = np.full((SIZE, SIZE), np.nan, np.float32)
    images = {(0, "STOKES_I"): c0, (1, "STOKES_I"): c1}
    # The NaN channel's residual is stored back as each package averages
    # it; compare the finite channel and the models.
    outs = [
        run_table(pkg, st, ["STOKES_I"], images, delta_psf(), [1.0, 0.0])
        for pkg, st in (
            (jrd, jax_settings(100)),
            (rd, settings_from_reference(jax_settings(100))),
        )
    ]
    (again_j, it_j, res_j, mod_j), (again_t, it_t, res_t, mod_t) = outs
    assert (again_t, it_t) == (again_j, it_j)
    key = (0, "STOKES_I")
    np.testing.assert_allclose(res_t[key], res_j[key], atol=2e-6)
    assert mod_t[key][12, 17] == pytest.approx(2.0, abs=1e-4)
    assert abs(res_t[key][12, 17]) < 1e-4
    for key in images:
        np.testing.assert_allclose(mod_t[key], mod_j[key], atol=1e-4)
        assert np.isfinite(mod_t[key]).all()


@pytest.mark.parametrize("mode", ["POLYNOMIAL", "LOG_POLYNOMIAL"])
def test_spectral_fitting_joined_channels(mode):
    """Four channels with a power-law spectrum, fitted in the minor loop."""
    freqs = [1.0e8 + c * 2e7 for c in range(4)]
    images = {}
    for ch, f in enumerate(freqs):
        img = np.zeros((SIZE, SIZE), np.float32)
        img[30, 22] = 2.0 * (f / 1.3e8) ** -0.7
        img[11, 50] = 0.7 * (f / 1.3e8) ** 0.4
        images[(ch, "STOKES_I")] = img
    s = jax_settings(300)
    s.spectral_fitting.mode = getattr(jrd.SpectralFittingMode, mode)
    s.spectral_fitting.terms = 2
    _, iterations, _, models = run_both(s, ["STOKES_I"], images, delta_psf())
    assert iterations > 0
    assert models[(0, "STOKES_I")][30, 22] > 1.0
