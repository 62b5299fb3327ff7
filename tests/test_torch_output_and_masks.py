"""Sky-model output, forced-term fitting, channel interpolation and masks in
both packages: twins of ``tests/test_checkpoint_and_output.py``'s
``test_write_sources``, ``test_forced_spectrum_fitting`` and
``test_forced_fitting_requires_filename``, and of the three tests of
``tests/test_interpolation_and_masks.py``.

Each test runs on ``radler_tpu`` and on ``radler_tpu_torch`` (the port on
the CPU, ``device="cpu"``) with the same inputs and the JAX tests' own
checks.  The forced-spectrum twin runs the Clark default, whose loop
applies the forced-term fit in its body (B2's plain version here), and
holds the port's residual and model against the JAX package's run on the
same inputs.
"""

import importlib
import os

import numpy as np
import pytest

SIZE = 64
PIXEL_SCALE = 1.0 / 60.0 * (np.pi / 180.0)


@pytest.fixture(params=["radler_tpu", "radler_tpu_torch"])
def package(request):
    return request.param


def module(package, name=None):
    return importlib.import_module(
        package if name is None else f"{package}.{name}")


def radler(package, *args, **kwargs):
    rd = module(package)
    if package == "radler_tpu_torch":
        kwargs["device"] = "cpu"
    return rd.Radler(*args, **kwargs)


def make_settings(package, minor_iterations=500, threshold=1e-7):
    rd = module(package)
    s = rd.Settings()
    s.trimmed_image_width = SIZE
    s.trimmed_image_height = SIZE
    s.pixel_scale.x = PIXEL_SCALE
    s.pixel_scale.y = PIXEL_SCALE
    s.minor_iteration_count = minor_iterations
    s.absolute_threshold = threshold
    return s


def cross_psf():
    ps = np.array(
        [[0.0, 0.4, 0.0], [0.25, 1.0, 0.5], [0.0, 0.6, 0.0]], np.float32
    )
    psf = np.zeros((SIZE, SIZE), np.float32)
    psf[31:34, 31:34] = ps
    return psf, ps


def delta_psf(n=None):
    psf = np.zeros((SIZE, SIZE), np.float32)
    psf[SIZE // 2, SIZE // 2] = 1.0
    return psf if n is None else np.repeat(psf[None], n, 0)


# -- tests/test_checkpoint_and_output.py --------------------------------------


def test_write_sources(package, tmp_path):
    """Sky-model writer (``cpp/component_list.cc:59-140`` equivalent)."""
    psf, ps = cross_psf()
    residual = np.zeros((SIZE, SIZE), np.float32)
    residual[31:34, 31:34] = 2.0 * ps
    model = np.zeros_like(residual)
    s = make_settings(package)
    s.save_source_list = True
    r = radler(package, s, psf, residual, model, 0.0)
    r.perform(0)
    comp_list = r.component_list
    assert comp_list.component_count(0) >= 1
    path = str(tmp_path / "sources.txt")
    comp_list.write_sources(
        r, path, PIXEL_SCALE, PIXEL_SCALE, 0.3, 0.4, 0.0, 0.0
    )
    with open(path) as f:
        lines = f.read().strip().splitlines()
    assert lines[0].startswith("Format = Name, Type, Ra, Dec, I")
    assert any(",POINT," in line for line in lines[1:])
    # The brightest component carries (nearly) all the flux.
    fluxes = [float(line.split(",")[4]) for line in lines[1:]]
    assert max(fluxes) == pytest.approx(2.0, rel=0.15)


def forced_spectrum_run(package, tmp_path):
    """``test_forced_spectrum_fitting``'s perform on ``package``: returns
    (residual, model, iterations, perform()'s result, the channels'
    centres)."""
    rd = module(package)
    write_fits_image = module(package, "utils.fits").write_fits_image

    C = 3
    psf = np.zeros((C, SIZE, SIZE), np.float32)
    psf[:, SIZE // 2, SIZE // 2] = 1.0
    freqs = np.array([[1.0e8, 1.1e8], [1.2e8, 1.3e8], [1.4e8, 1.5e8]])
    centers = freqs.mean(axis=1)
    ref = centers.mean()
    residual = np.zeros((C, SIZE, SIZE), np.float32)
    for c in range(C):
        residual[c, 20, 30] = FORCED_AMP * (centers[c] / ref) ** FORCED_ALPHA
    model = np.zeros_like(residual)

    terms_path = str(tmp_path / f"forced_{package}.fits")
    write_fits_image(
        terms_path, np.full((1, SIZE, SIZE), FORCED_ALPHA, np.float32)
    )
    s = make_settings(package)
    assert s.generic.use_sub_minor_optimization
    s.spectral_fitting.mode = rd.SpectralFittingMode.FORCED_TERMS
    s.spectral_fitting.terms = 2
    s.spectral_fitting.forced_filename = terms_path
    r = radler(
        package,
        s,
        psf,
        residual,
        model,
        0.0,
        rd.Polarization.STOKES_I,
        frequencies=freqs,
        weights=np.ones(C),
    )
    again = r.perform(0)
    return residual, model, r.iteration_number, again, centers


FORCED_ALPHA = -0.7
FORCED_AMP = 2.0
# The parity contract between the packages: the residual within 2e-6
# absolute, the model within 1e-4 of its peak.
FORCED_RESIDUAL_ATOL = 2e-6
FORCED_MODEL_RTOL = 1e-4


def test_forced_spectrum_fitting(package, tmp_path):
    """kForcedTerms: spectral shape fixed by a terms image, amplitude fitted
    (``cpp/radler.cc:410-432`` + spectral_fitting.py FORCED_TERMS), through
    the Clark loop.  The port's run is also held against the JAX package's
    on the same inputs."""
    residual, model, _, again, centers = forced_spectrum_run(
        package, tmp_path)
    np.testing.assert_allclose(residual, 0.0, atol=1e-5)
    # The model spectrum follows the forced power law exactly.
    ratio = model[2, 20, 30] / model[0, 20, 30]
    expected = (centers[2] / centers[0]) ** FORCED_ALPHA
    assert ratio == pytest.approx(expected, rel=1e-3)
    if package == "radler_tpu_torch":
        # By about 140 iterations both runs have cleaned the source to the
        # float32 floor (|residual| 7e-7, above the 1e-7 threshold); what
        # follows cleans rounding noise, and where it stops (159 or 160
        # iterations) is a rounding decision, so the count is not held.
        jax_residual, jax_model, _, jax_again, _ = forced_spectrum_run(
            "radler_tpu", tmp_path)
        assert again == jax_again
        np.testing.assert_allclose(residual, jax_residual, rtol=0,
                                   atol=FORCED_RESIDUAL_ATOL)
        np.testing.assert_allclose(
            model, jax_model, rtol=0,
            atol=FORCED_MODEL_RTOL * np.abs(jax_model).max())


def test_forced_fitting_requires_filename(package):
    rd = module(package)
    s = make_settings(package)
    s.spectral_fitting.mode = rd.SpectralFittingMode.FORCED_TERMS
    s.spectral_fitting.terms = 2
    with pytest.raises(RuntimeError, match="Forced fitting filename"):
        s.validate()


# -- tests/test_interpolation_and_masks.py ------------------------------------


def test_deconvolution_group_interpolation(package):
    """4 original channels joined into 2 deconvolution groups: the output
    model per original channel comes from evaluating the spectral fit at
    that channel's frequency."""
    rd = module(package)
    C = 4
    freqs = np.stack(
        [np.linspace(1.0e8, 1.6e8, C), np.linspace(1.1e8, 1.7e8, C)], axis=1
    )
    centers = freqs.mean(axis=1)
    amp = 2.0
    residual = np.zeros((C, SIZE, SIZE), np.float32)
    # Linear spectrum so a 2-term polynomial fit is exact.
    slope = 0.5
    s = make_settings(package, 300, 1e-6)
    s.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    for c in range(C):
        residual[c, 20, 30] = amp + slope * (centers[c] / centers.mean() - 1.0)
    model = np.zeros_like(residual)
    r = radler(
        package,
        s,
        delta_psf(C),
        residual,
        model,
        0.0,
        rd.Polarization.STOKES_I,
        frequencies=freqs,
        weights=np.ones(C),
        n_deconvolution_groups=2,
    )
    r.perform(0)
    for c in range(C):
        expected = amp + slope * (centers[c] / centers.mean() - 1.0)
        assert model[c, 20, 30] == pytest.approx(expected, rel=0.02), c
    np.testing.assert_allclose(residual, 0.0, atol=1e-4)


def test_fits_mask(package, tmp_path):
    write_fits_image = module(package, "utils.fits").write_fits_image

    mask = np.zeros((SIZE, SIZE), np.float32)
    mask[10, 10] = 1.0
    mask_path = str(tmp_path / "mask.fits")
    write_fits_image(mask_path, mask)

    residual = np.zeros((SIZE, SIZE), np.float32)
    residual[10, 10] = 1.0
    residual[40, 40] = 5.0  # outside the mask: must not be cleaned
    model = np.zeros_like(residual)
    s = make_settings(package, 300, 1e-6)
    s.fits_mask = mask_path
    r = radler(package, s, delta_psf(), residual, model, 0.0)
    r.perform(0)
    assert model[10, 10] == pytest.approx(1.0, abs=1e-4)
    assert model[40, 40] == 0.0
    assert residual[40, 40] == pytest.approx(5.0)


def test_horizon_mask(package, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the horizon mask is written to the prefix
    residual = np.zeros((SIZE, SIZE), np.float32)
    residual[SIZE // 2, SIZE // 2] = 1.0  # at phase centre: inside horizon
    residual[1, 1] = 5.0  # far corner
    model = np.zeros_like(residual)
    s = make_settings(package, 300, 1e-6)
    # Large pixel scale so the corner is beyond the horizon distance.
    s.pixel_scale.x = s.pixel_scale.y = np.deg2rad(2.0)
    s.horizon_mask_distance = 0.5  # radians
    r = radler(package, s, delta_psf(), residual, model, 0.0)
    r.perform(0)
    assert model[SIZE // 2, SIZE // 2] == pytest.approx(1.0, abs=1e-4)
    assert model[1, 1] == 0.0
    assert os.path.exists("wsclean-horizon-mask.fits")
