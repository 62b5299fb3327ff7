"""The port's PYTHON plug-in against the JAX package's.

Twins ``tests/test_algorithms.py::test_python_plugin`` and
``test_plugin_error_paths`` for ``radler_tpu_torch``, and runs both
packages on one plug-in file and one problem.  The plug-in gets float64
NumPy copies of the cubes, so a plug-in's arithmetic is the same in both
packages and the cubes they hand back agree bit for bit; the spectral
fitter's ``fit_and_evaluate`` runs each package's own fit (float32), within
1e-6 of each other.
"""

import textwrap

import numpy as np
import pytest
import torch

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu_torch.interop import settings_from_reference

torch.set_num_threads(1)

PEAK_MOVER = textwrap.dedent(
    """
    import numpy as np

    def deconvolve(residual, model, psf, meta):
        # Trivial algorithm: move the peak into the model.
        nfreq, npol, h, w = residual.shape
        for f in range(nfreq):
            for p in range(npol):
                idx = np.abs(residual[f, p]).argmax()
                y, x = divmod(idx, w)
                model[f, p, y, x] += residual[f, p, y, x]
                residual[f, p, y, x] = 0.0
        meta.iteration_number += 1
        return {
            "residual": residual,
            "model": model,
            "level": float(np.abs(residual).max()),
            "continue": False,
        }
    """
)

# Högbom on the joined channels in NumPy, with the spectral fit of the
# component through meta.spectral_fitter, and every field of meta echoed
# into the model's corner so that both packages' values are compared.
HOGBOM = textwrap.dedent(
    """
    import numpy as np

    def deconvolve(residual, model, psf, meta):
        nfreq, npol, h, w = residual.shape
        weights = np.array([c.weight for c in meta.channels])
        for _ in range(meta.max_iterations):
            integ = np.einsum("f,fhw->hw", weights, residual[:, 0])
            integ /= weights.sum()
            y, x = divmod(int(np.abs(integ).argmax()), w)
            if abs(integ[y, x]) <= meta.final_threshold:
                break
            values = meta.spectral_fitter.fit_and_evaluate(
                residual[:, 0, y, x], x, y)
            values = np.asarray(values, np.float64) * meta.gain
            model[:, 0, y, x] += values
            for f in range(nfreq):
                shifted = np.roll(psf[f], (y - h // 2, x - w // 2), (0, 1))
                residual[f, 0] -= values[f] * shifted
            meta.iteration_number += 1
        terms = meta.spectral_fitter.fit(model[:, 0, 0, 1] + 1.0, 0, 0)
        model[0, 0, 0, 0] = (meta.mgain + meta.major_iter_threshold
                             + meta.iteration_number + len(terms)
                             + float(meta.square_joined_channels))
        return {"residual": residual, "model": model,
                "level": float(np.abs(residual).max()), "continue": True}
    """
)


def make_settings(size, plugin, iterations=10):
    s = jrd.Settings()
    s.algorithm_type = jrd.AlgorithmType.PYTHON
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.pixel_scale.x = s.pixel_scale.y = 1.0 / 60.0 * (np.pi / 180.0)
    s.minor_iteration_count = iterations
    s.python.filename = str(plugin)
    return s


def port_settings(size, plugin, iterations=10):
    return settings_from_reference(make_settings(size, plugin, iterations))


def test_python_plugin(tmp_path):
    """``test_algorithms.py::test_python_plugin`` through the port, and
    the JAX package's run on the same plug-in."""
    plugin = tmp_path / "plugin.py"
    plugin.write_text(PEAK_MOVER)
    size = 32
    psf = np.zeros((size, size), np.float32)
    psf[size // 2, size // 2] = 1.0
    residual = np.zeros((size, size), np.float32)
    residual[10, 12] = 3.0
    out = {}
    for name, package, settings, device in (
        ("port", rd, port_settings(size, plugin), {"device": "cpu"}),
        ("jax", jrd, make_settings(size, plugin), {}),
    ):
        res, mod = residual.copy(), np.zeros_like(residual)
        r = package.Radler(settings, psf, res, mod, 0.0, **device)
        out[name] = (r.perform(0), r.iteration_number, res, mod)
    again, iterations, res, mod = out["port"]
    assert again is False
    assert mod[10, 12] == pytest.approx(3.0)
    assert res[10, 12] == 0.0
    assert iterations == 1
    assert out["jax"][:2] == out["port"][:2]
    np.testing.assert_array_equal(res, out["jax"][2])
    np.testing.assert_array_equal(mod, out["jax"][3])


def test_plugin_error_paths(tmp_path):
    """``test_algorithms.py::test_plugin_error_paths`` (``cpp/test/
    test_python_deconvolution.cc``) through the port: the same errors with
    the same messages."""
    size = 16
    psf = np.zeros((size, size), np.float32)
    psf[8, 8] = 1.0
    img = np.zeros((size, size), np.float32)

    def radler(filename, iterations=10):
        return rd.Radler(port_settings(size, filename, iterations), psf,
                         img.copy(), img.copy(), 0.0, device="cpu")

    with pytest.raises((RuntimeError, OSError)):
        radler(tmp_path / "missing.py")

    bad = tmp_path / "bad.py"
    bad.write_text("def not_deconvolve():\n    pass\n")
    with pytest.raises(RuntimeError, match="does not define a deconvolve"):
        radler(bad)

    raises = tmp_path / "raises.py"
    raises.write_text(
        "def deconvolve(residual, model, psf, meta):\n"
        "    raise ValueError('boom')\n"
    )
    with pytest.raises(RuntimeError, match="python deconvolution.*boom"):
        radler(raises, 5).perform(0)

    wrong_return = tmp_path / "wrong.py"
    wrong_return.write_text(
        "def deconvolve(residual, model, psf, meta):\n    return 42\n"
    )
    with pytest.raises(RuntimeError, match="dictionary"):
        radler(wrong_return).perform(0)

    missing = tmp_path / "missing_items.py"
    missing.write_text(
        "def deconvolve(residual, model, psf, meta):\n"
        "    return {'residual': residual, 'model': model}\n"
    )
    with pytest.raises(RuntimeError, match="missing items"):
        radler(missing).perform(0)


def test_python_plugin_channels_and_fitter_match_jax(tmp_path):
    """A NumPy Högbom plug-in on four channels with a 2-term polynomial
    fit: ``meta.channels``, the fitter's ``fit`` and ``fit_and_evaluate``,
    the gains and thresholds reach the plug-in as in the JAX package, and
    the cubes come back as float32 on the run's device."""
    plugin = tmp_path / "hogbom.py"
    plugin.write_text(HOGBOM)
    size, n_chan = 32, 4
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:size, 0:size]
    psf = np.exp(-((yy - size // 2) ** 2 + (xx - size // 2) ** 2) / 4.0)
    psfs = np.stack([psf] * n_chan).astype(np.float32)
    residual = np.zeros((n_chan, size, size), np.float32)
    for _ in range(3):
        y, x = rng.integers(4, size - 4, 2)
        spectrum = rng.uniform(0.5, 2.0) * (1.0 + 0.1 * np.arange(n_chan))
        residual += (spectrum[:, None, None]
                     * np.roll(psf, (y - size // 2, x - size // 2), (0, 1))
                     ).astype(np.float32)
    freqs = np.array([[1e8 + 1e7 * c, 1.1e8 + 1e7 * c]
                      for c in range(n_chan)])
    weights = np.array([1.0, 0.8, 1.2, 0.5])
    jax_settings = make_settings(size, plugin, iterations=40)
    jax_settings.minor_loop_gain = 0.2
    jax_settings.absolute_threshold = 0.05
    jax_settings.spectral_fitting.mode = jrd.SpectralFittingMode.POLYNOMIAL
    jax_settings.spectral_fitting.terms = 2
    out = {}
    for name, package, settings, device in (
        ("port", rd, settings_from_reference(jax_settings), {"device": "cpu"}),
        ("jax", jrd, jax_settings, {}),
    ):
        res, mod = residual.copy(), np.zeros_like(residual)
        r = package.Radler(settings, psfs, res, mod, 0.0, frequencies=freqs,
                           weights=weights, **device)
        out[name] = (r.perform(0), r.iteration_number, res, mod)
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][1] == 40
    np.testing.assert_allclose(out["port"][2], out["jax"][2], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(out["port"][3], out["jax"][3], atol=1e-6,
                               rtol=0)
    assert out["port"][3][0, 0, 0] == out["jax"][3][0, 0, 0] != 0.0


def test_python_plugin_keeps_tensors_on_their_device(tmp_path):
    """Tensor images stay tensors on their device: the plug-in's float64
    arrays come back as float32 tensors through the accessors."""
    plugin = tmp_path / "plugin.py"
    plugin.write_text(PEAK_MOVER)
    size = 16
    psf = torch.zeros(size, size)
    psf[8, 8] = 1.0
    residual = torch.zeros(size, size)
    residual[3, 5] = -2.0
    model = torch.zeros(size, size)
    r = rd.Radler(port_settings(size, plugin), psf, residual, model, 0.0)
    assert r.perform(0) is False
    front = r._table.front
    out_res = front.residual_accessor.array
    out_mod = front.model_accessor.array
    assert out_res.dtype == out_mod.dtype == torch.float32
    assert out_mod.device == psf.device
    assert float(out_mod[3, 5]) == -2.0 and float(out_res.abs().max()) == 0.0
