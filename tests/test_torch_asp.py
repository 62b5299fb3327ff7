"""ASP (``AlgorithmType.ADAPTIVE_SCALE_PIXEL``) in the port against the JAX
package, on the CPU, and the Gaussian fits it rests on.

The same NumPy-seeded inputs go through ``radler_tpu`` (JAX on the CPU) and
``radler_tpu_torch`` (``device="cpu"``).  Tolerances, with their reasons:

* the point-source contract (``test_asp_point_source``): residual within
  5e-6 absolute (that test's bound), model peak 2.5 within 1e-4, and the
  port within 2e-6 of the JAX run (the parity contract; the two agree bit
  for bit on this field);
* the fits: :mod:`radler_tpu_torch.ops.gaussian_fit` is a copy of the JAX
  package's NumPy and SciPy code, so its results are the same numbers; a
  fit on the window that ``full_fit_box`` cuts is the fit on the whole
  image, bit for bit;
* multi-channel fields: ASP's Gaussian fits amplify the last bit of their
  input (the JAX package's own run on its input times float32(1 + 1e-7)
  moves by 2.7e-6 to 9e-3 of ``max(1, |res|max)`` on 128^2 point fields),
  so each field states its bound and the reading behind it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import radler_tpu as jrd
import radler_tpu.ops.gaussian_fit as jax_fit

import radler_tpu_torch as rd
import radler_tpu_torch.ops.gaussian_fit as port_fit
from radler_tpu_torch.interop import settings_from_reference

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

FREQS = np.array([[1.0e8, 1.1e8], [1.1e8, 1.2e8]])


def run(package, s, psf, residual, **kwargs):
    """One perform; returns (iterations, residual, model)."""
    res, model = residual.copy(), np.zeros_like(residual)
    if package is rd:
        r = rd.Radler(settings_from_reference(s), psf, res, model, 0.0,
                      device="cpu", **kwargs)
    else:
        r = jrd.Radler(s, psf, res, model, 0.0, **kwargs)
    r.perform(0)
    return r.iteration_number, res, model


def point_source_case():
    """``test_asp_point_source``'s field: one source of 2.5 under a 3x3
    PSF at 64^2."""
    size = 64
    ps = np.array([[0.0, 0.4, 0.0], [0.25, 1.0, 0.5], [0.0, 0.6, 0.0]],
                  np.float32)
    psf = np.zeros((size, size), np.float32)
    psf[31:34, 31:34] = ps
    residual = np.zeros((size, size), np.float32)
    residual[21:24, 26:29] = 2.5 * ps
    s = jrd.Settings()
    s.algorithm_type = jrd.AlgorithmType.ADAPTIVE_SCALE_PIXEL
    s.trimmed_image_width = s.trimmed_image_height = size
    s.pixel_scale.x = s.pixel_scale.y = 1.0 / 60.0 * (np.pi / 180.0)
    s.minor_iteration_count = 600
    s.absolute_threshold = 1e-6
    return s, psf, residual


def channel_psfs(size, n_channels=2):
    """Config 3's PSFs (``chip_smoke.make_diffuse_problem``): a Gaussian
    with a sidelobe ring, widening 4% a channel."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psfs = []
    for c in range(n_channels):
        w = 2.5 * (1.0 + 0.04 * c)
        p = np.exp(-r2 / (2 * w * w))
        p += 0.06 * np.exp(-((np.sqrt(r2) - 14 * (1 + 0.03 * c)) ** 2) / 6)
        psfs.append(p.astype(np.float32))
    return np.stack(psfs)


def convolve(sky, psfs, slope=0.1):
    return np.stack([
        np.fft.irfft2(np.fft.rfft2(sky * (1 + slope * c))
                      * np.fft.rfft2(np.fft.ifftshift(p)), s=sky.shape)
        for c, p in enumerate(psfs)]).astype(np.float32)


def diffuse_case(iterations):
    """Config 3's diffuse emission (``chip_smoke.make_diffuse_problem``'s
    sky) at 128^2 x 2 channels, the 2-term fit, gain 0.1, major gain
    0.85."""
    size = 128
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    sky = np.zeros((size, size), np.float32)
    for _ in range(60):
        cy, cx = rng.integers(size // 8, 7 * size // 8, 2)
        s_ = rng.uniform(1.5, 25)
        a = rng.uniform(0.2, 1.0)
        m = max(1, int(4 * s_))
        y0, y1 = max(0, cy - m), min(size, cy + m)
        x0, x1 = max(0, cx - m), min(size, cx + m)
        sky[y0:y1, x0:x1] += a * np.exp(
            -((yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2)
            / (2 * s_ * s_))
    psfs = channel_psfs(size)
    return fitted_settings(size, iterations), psfs, convolve(sky, psfs)


def fitted_settings(size, iterations):
    s = jrd.Settings()
    s.algorithm_type = jrd.AlgorithmType.ADAPTIVE_SCALE_PIXEL
    s.trimmed_image_width = s.trimmed_image_height = size
    s.minor_iteration_count = iterations
    s.minor_loop_gain, s.major_loop_gain = 0.1, 0.85
    s.spectral_fitting.mode = jrd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    return s


def test_asp_point_source_matches_jax():
    """``test_asp_point_source``: the reference's point-source contract,
    and the port against the JAX run."""
    s, psf, residual = point_source_case()
    jn, jres, jmod = run(jrd, s, psf, residual)
    tn, tres, tmod = run(rd, s, psf, residual)
    assert tn == jn > 0
    np.testing.assert_allclose(tres, 0.0, atol=5e-6)
    assert tmod[22, 27] == pytest.approx(2.5, abs=1e-4)
    np.testing.assert_allclose(tres, jres, atol=2e-6)
    np.testing.assert_allclose(tmod, jmod, atol=1e-4)


def test_asp_diffuse_field_matches_jax():
    """Config 3's diffuse emission at 128^2 x 2 channels with the 2-term
    fit.  The JAX package's ASP diverges on it: each Gaussian component's
    amplitude, the residual's peak through the fitted Gaussian over the
    PSF's, overshoots by about the Gaussian's area (pi sigma^2, some 4000
    at its 85-pixel components), so the residual grows some 350-fold an
    iteration and is not finite after the 14th.  The port does the same:
    after 3 iterations the cubes agree within 2e-6 of max(1, |res|max)
    (9.9e-7 read; the JAX run on its input times float32(1 + 1e-7) moves
    by 6.3e-6), and a full run stops where the JAX run stops, with the
    same non-finite residual."""
    s, psfs, residual = diffuse_case(3)
    jn, jres, jmod = run(jrd, s, psfs, residual, frequencies=FREQS)
    tn, tres, tmod = run(rd, s, psfs, residual, frequencies=FREQS)
    assert tn == jn == 3
    scale = max(1.0, float(np.abs(jres).max()))
    assert np.abs(tres - jres).max() <= 2e-6 * scale
    assert np.abs(tmod - jmod).max() <= 2e-6 * max(1.0,
                                                  float(np.abs(jmod).max()))
    s.minor_iteration_count = 200
    jn, jres, _ = run(jrd, s, psfs, residual, frequencies=FREQS)
    tn, tres, _ = run(rd, s, psfs, residual, frequencies=FREQS)
    assert tn == jn == 14
    assert not np.isfinite(jres).all() and not np.isfinite(tres).all()


def test_asp_point_field_matches_jax():
    """Three point sources at 128^2 x 2 channels (spectra falling 5% a
    channel) with the 2-term fit, to the major iteration's threshold (37
    iterations): ASP's Gaussian and point-source paths with the fit.  The
    JAX run on its input times float32(1 + 1e-7) moves by 2.7e-6 of
    max(1, |res|max), the port by 2.4e-6 (the model by 5.1e-6): held
    within 1e-5 (the card's bound against the CPU)."""
    size = 128
    rng = np.random.default_rng(7)
    sky = np.zeros((size, size))
    ys = rng.integers(size // 8, 7 * size // 8, 3)
    xs = rng.integers(size // 8, 7 * size // 8, 3)
    np.add.at(sky, (ys, xs), rng.uniform(0.2, 1.0, 3))
    psfs = channel_psfs(size)
    residual = convolve(sky, psfs, -0.05)
    s = fitted_settings(size, 80)
    jn, jres, jmod = run(jrd, s, psfs, residual, frequencies=FREQS)
    tn, tres, tmod = run(rd, s, psfs, residual, frequencies=FREQS)
    assert tn == jn == 37
    scale = max(1.0, float(np.abs(jres).max()))
    assert np.abs(tres - jres).max() <= 1e-5 * scale
    assert np.abs(tmod - jmod).max() <= 1e-5 * max(1.0,
                                                  float(np.abs(jmod).max()))
    assert np.isfinite(tres).all() and np.abs(tmod).max() > 0


def test_asp_on_a_mesh_runs_as_on_one_device():
    """ASP on an 8-shard mesh: the JAX package row-shards its cube, a
    placement only; every shard of the port's mesh lies on the one
    device, so the run is the single device's, bit for bit."""
    s, psf, residual = point_source_case()
    s.minor_iteration_count = 40
    one = run(rd, s, psf, residual)
    s.parallel.use_device_mesh = True
    s.parallel.n_devices = 8
    mesh = run(rd, s, psf, residual)
    assert mesh[0] == one[0] == 40
    np.testing.assert_array_equal(mesh[1], one[1])
    np.testing.assert_array_equal(mesh[2], one[2])


def test_asp_on_a_facet_grid_runs_serially():
    """ASP on a 2x2 facet grid takes the serial route, each facet's clone
    on its box (the JAX package batches only multiscale and generic
    CLEAN)."""
    s, _, _ = point_source_case()
    yy, xx = np.mgrid[0:64, 0:64]
    psf = np.exp(-((yy - 32) ** 2 + (xx - 32) ** 2) / 8.0).astype(np.float32)
    residual = 2.5 * np.roll(psf, (-10, -5), axis=(0, 1))
    s.minor_iteration_count = 4
    s.parallel.grid_width = s.parallel.grid_height = 2
    t = rd.Radler(settings_from_reference(s), psf, residual.copy(),
                  np.zeros_like(residual), 0.0, device="cpu")
    t.perform(0)
    assert t._parallel.last_route == "serial"
    assert all(type(a).__name__ == "AspAlgorithm"
               for a in t._parallel.algorithms)
    assert max(a.iteration_number for a in t._parallel.algorithms) > 0


# ---------------------------------------------------------------------------
# The fits
# ---------------------------------------------------------------------------


def blob_image(size=64, seed=3):
    rng = np.random.default_rng(seed)
    image = port_fit.draw_gaussian(
        np.zeros((size, size), np.float32), 30.3, 27.8,
        port_fit.Ellipse(9.0, 5.5, 0.4), 2.0)
    return image + rng.normal(scale=0.01, size=image.shape).astype(
        np.float32)


def test_gaussian_fits_match_jax():
    """The port's copy of the fits gives the JAX package's numbers: the
    centred fit of a PSF, the full fit, the beam deconvolution (a finite
    ellipse, and NaN for a source smaller than the beam) and the drawing."""
    image = blob_image()
    psf = port_fit.draw_gaussian(np.zeros((64, 64), np.float32), 32, 32,
                                 port_fit.Ellipse(4.0, 3.0, -0.3), 1.0)
    values = dataclasses.astuple
    assert values(port_fit.fit_2d_gaussian_centred(psf, 2.0)) == values(
        jax_fit.fit_2d_gaussian_centred(psf, 2.0))
    args = (image, 2.0, 30.0, 28.0, 8.0, 8.0, 0.0)
    got, want = port_fit.fit_2d_gaussian_full(*args), \
        jax_fit.fit_2d_gaussian_full(*args)
    assert got[:3] == want[:3] and values(got[3]) == values(want[3])
    assert got[3].major == pytest.approx(9.0, rel=0.05)
    beam = port_fit.Ellipse(4.0, 3.0, -0.3)
    assert values(port_fit.deconvolve_gaussian(got[3], beam)) == values(
        jax_fit.deconvolve_gaussian(want[3], jax_fit.Ellipse(4.0, 3.0, -0.3)))
    assert np.isnan(port_fit.deconvolve_gaussian(
        port_fit.Ellipse(3.0, 2.0, 0.0), beam).major)
    np.testing.assert_array_equal(
        port_fit.draw_gaussian(np.zeros((40, 50), np.float32), 11.5, 20.2,
                               beam, 1.5),
        jax_fit.draw_gaussian(np.zeros((40, 50), np.float32), 11.5, 20.2,
                              jax_fit.Ellipse(4.0, 3.0, -0.3), 1.5))


@pytest.mark.parametrize("at", [(30.0, 28.0), (3.0, 60.0), (62.0, 1.0)])
def test_full_fit_on_its_window_is_the_whole_image_fit(at):
    """ASP copies only the fit's window from the device: the fit on the
    window ``full_fit_box`` cuts, placed by ``origin``, is the fit on the
    whole image, bit for bit, inside the image and at its edges."""
    image = blob_image()
    x0, y0 = at
    whole = port_fit.fit_2d_gaussian_full(image, 2.0, x0, y0, 4.0, 4.0, 0.0)
    x1, y1, x2, y2 = port_fit.full_fit_box(64, 64, x0, y0, 4.0, 4.0)
    assert (x2 - x1) * (y2 - y1) < 41 * 41 + 1 < 64 * 64
    window = port_fit.fit_2d_gaussian_full(
        image[y1:y2, x1:x2].copy(), 2.0, x0, y0, 4.0, 4.0, 0.0,
        origin=(x1, y1))
    assert window == whole


@pytest.mark.parametrize("algorithm", ["MORE_SANE", "PYTHON"])
def test_the_host_plugins_still_raise(algorithm, tmp_path, monkeypatch):
    """MORE_SANE and PYTHON, the host plug-ins, which the port refused
    until it ported them (ROADMAP queue A, item 7), run on the
    point-source field through both packages, and the cubes they hand back
    agree bit for bit (a stand-in MORESANE program; a NumPy plug-in)."""
    from tests.test_torch_more_sane import write_stand_in
    from tests.test_torch_python_plugin import PEAK_MOVER

    monkeypatch.chdir(tmp_path)
    s, psf, residual = point_source_case()
    s.algorithm_type = getattr(jrd.AlgorithmType, algorithm)
    s.more_sane.location = str(write_stand_in(tmp_path))
    plugin = tmp_path / "plugin.py"
    plugin.write_text(PEAK_MOVER)
    s.python.filename = str(plugin)
    out = []
    for package, settings, device in (
        (rd, settings_from_reference(s), {"device": "cpu"}),
        (jrd, s, {}),
    ):
        res, mod = residual.copy(), np.zeros_like(residual)
        r = package.Radler(settings, psf, res, mod, 0.0, **device)
        out.append((r.perform(0), r.iteration_number, res, mod))
    assert out[0][:2] == out[1][:2] and out[0][1] == 1
    assert np.abs(out[0][3]).max() > 0
    np.testing.assert_array_equal(out[0][2], out[1][2])
    np.testing.assert_array_equal(out[0][3], out[1][3])
