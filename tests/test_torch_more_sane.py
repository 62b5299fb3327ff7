"""The port's MORE_SANE plug-in against the JAX package's.

Twins ``tests/test_more_sane.py::test_more_sane_roundtrip`` for
``radler_tpu_torch``.  A stand-in for the MORESANE program (never the real
one) reads the dirty image with the port's ``utils/fits.py``, keeps every
pixel above 0.5 as model flux and writes the model and the residual back;
both packages run it, from the same settings, on the same images.  The
FITS files hold float32 and the stand-in's arithmetic is exact, so the two
packages' cubes agree bit for bit; after the first major iteration the model
convolved with the PSF is added back on the run's device (an FFT in each
package), where the results agree within 1e-6.
"""

import os
import pathlib
import textwrap

import numpy as np
import pytest
import torch

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu_torch.interop import settings_from_reference

torch.set_num_threads(1)

SIZE = 32
REPO = str(pathlib.Path(__file__).resolve().parents[1])

STAND_IN = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    from radler_tpu_torch.utils.fits import read_fits_image, write_fits_image

    args = sys.argv[1:]
    sigma = None
    if "-sl" in args:
        i = args.index("-sl")
        sigma = float(args[i + 1])
        del args[i : i + 2]
    dirty_name, psf_name, output_name = args[-3:]
    dirty = read_fits_image(dirty_name)
    # "Deconvolve": claim everything above 0.5 as model flux.
    model = dirty * (dirty > 0.5)
    write_fits_image(output_name + "_model.fits", model)
    write_fits_image(output_name + "_residual.fits", dirty - model)
    with open(output_name + ".log", "w") as f:
        f.write(f"sigma={{sigma}} args={{' '.join(sys.argv[1:])}}\\n")
    """
)


def write_stand_in(directory: pathlib.Path) -> pathlib.Path:
    """The stand-in program in ``directory``; returns its path."""
    script = directory / "fake_moresane.py"
    script.write_text(STAND_IN.format(repo=REPO))
    return script


def make_images():
    psf = np.zeros((SIZE, SIZE), np.float32)
    psf[SIZE // 2, SIZE // 2] = 1.0
    psf[SIZE // 2, SIZE // 2 + 1] = 0.3
    residual = np.zeros((SIZE, SIZE), np.float32)
    residual[10, 12] = 2.0
    residual[20, 5] = 0.25  # below the stand-in's 0.5 cut: stays
    return psf, residual


def make_settings(script, sigma_levels=(3.0, 2.0)):
    s = jrd.Settings()
    s.algorithm_type = jrd.AlgorithmType.MORE_SANE
    s.trimmed_image_width = SIZE
    s.trimmed_image_height = SIZE
    s.pixel_scale.x = s.pixel_scale.y = 1.0 / 60.0 * (np.pi / 180.0)
    s.major_iteration_count = 1
    s.more_sane.location = str(script)
    s.more_sane.sigma_levels = list(sigma_levels)
    return s


def run(package, jax_settings, psf, residual, n_major=1, mask=None):
    """``n_major`` performs; returns (results, residual, model)."""
    res = residual.copy()
    mod = np.zeros_like(res)
    if package is jrd:
        r = jrd.Radler(jax_settings, psf, res, mod, 0.0)
    else:
        r = rd.Radler(settings_from_reference(jax_settings), psf, res, mod,
                      0.0, device="cpu")
    if mask is not None:
        r._parallel.set_clean_mask(mask)
    again = [r.perform(i) for i in range(n_major)]
    return again, r.iteration_number, res, mod


def test_more_sane_roundtrip(tmp_path, monkeypatch):
    """``test_more_sane.py``'s round trip through the port, and the JAX
    package's on the same images: equal cubes, the first sigma level, the
    temporary files gone."""
    monkeypatch.chdir(tmp_path)
    settings = make_settings(write_stand_in(tmp_path))
    psf, residual = make_images()
    _, _, res, mod = port = run(rd, settings, psf, residual)
    assert mod[10, 12] == pytest.approx(2.0)
    assert mod[20, 5] == 0.0
    assert res[10, 12] == pytest.approx(0.0)
    assert res[20, 5] == pytest.approx(0.25)
    log = (tmp_path / "wsclean-tmp-moresaneoutput0.log").read_text()
    assert "sigma=3.0" in log
    assert not os.path.exists("wsclean-tmp-moresaneinput-dirty.fits")
    assert not os.path.exists("wsclean-tmp-moresaneoutput0_model.fits")
    jax = run(jrd, settings, psf, residual)
    assert port[:2] == jax[:2]
    np.testing.assert_array_equal(res, jax[2])
    np.testing.assert_array_equal(mod, jax[3])


def test_more_sane_second_major_adds_the_model_back(tmp_path, monkeypatch):
    """Two major iterations with a mask and negatives excluded: the second
    adds the model convolved with the PSF back (on the run's device) and
    takes the second sigma level; the command carries ``-ep`` and ``-m``.
    Against the JAX package within 1e-6."""
    monkeypatch.chdir(tmp_path)
    settings = make_settings(write_stand_in(tmp_path))
    settings.major_iteration_count = 2
    settings.minor_iteration_count = 5
    settings.allow_negative_components = False
    mask = np.ones((SIZE, SIZE), bool)
    mask[:4] = False
    psf, residual = make_images()
    port = run(rd, settings, psf, residual, n_major=2, mask=mask)
    log = (tmp_path / "wsclean-tmp-moresaneoutput1.log").read_text()
    assert "sigma=2.0" in log and "-ep" in log and "-m " in log
    jax = run(jrd, settings, psf, residual, n_major=2, mask=mask)
    assert port[0] == jax[0] == [True, True]
    assert port[1] == jax[1] == 2
    np.testing.assert_allclose(port[2], jax[2], atol=1e-6, rtol=0)
    np.testing.assert_allclose(port[3], jax[3], atol=1e-6, rtol=0)
    # The add-back restored the source with its PSF's 0.3 side pixel,
    # which the second run claims too.
    assert port[3][10, 12] == pytest.approx(2.0, abs=1e-5)
    assert port[3][10, 13] == pytest.approx(0.6, abs=1e-5)
