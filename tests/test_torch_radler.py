"""End-to-end Radler parity: the port against the JAX package on the CPU.

Mirrors ``tests/test_radler.py`` (the reference's ``python/test/test_radler.py``
and ``cpp/test/test_radler.cc``) for ``radler_tpu_torch``, and runs both
packages on one problem from one ``radler_tpu.Settings``.

Tolerances: the point-source contract is the reference's, 2e-6 absolute on
the residual and the model; between the packages, ``perform()``'s result and
the iteration count are exact, the residual agrees within 2e-6 absolute and
the model peak within 1e-4 relative (the ROADMAP's parity contract).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu_torch.interop import settings_from_reference
from radler_tpu_torch.utils.fits import write_fits_image

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from bench import make_problem  # noqa: E402

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

WIDTH = 64
HEIGHT = 64
BEAM_SIZE = 0.0
PIXEL_SCALE = 1.0 / 60.0 * (np.pi / 180.0)
MINOR_ITERATION_COUNT = 1000


@pytest.fixture
def settings():
    s = rd.Settings()
    s.algorithm_type = rd.AlgorithmType.GENERIC_CLEAN
    s.trimmed_image_width = WIDTH
    s.trimmed_image_height = HEIGHT
    s.pixel_scale.x = PIXEL_SCALE
    s.pixel_scale.y = PIXEL_SCALE
    s.minor_iteration_count = MINOR_ITERATION_COUNT
    s.absolute_threshold = 1e-8
    s.generic.use_sub_minor_optimization = False
    return s


def get_point_source():
    return np.array(
        [[0.0, 0.4, 0.0], [0.25, 1.0, 0.5], [0.0, 0.6, 0.0]], dtype=np.float32
    )


def get_psf():
    point_source = get_point_source()
    psf = np.zeros((HEIGHT, WIDTH), dtype=np.float32)
    oy = HEIGHT // 2 - point_source.shape[0] // 2
    ox = WIDTH // 2 - point_source.shape[1] // 2
    psf[oy : oy + 3, ox : ox + 3] = point_source
    return psf


def get_residual(scale, shift_x, shift_y):
    point_source = scale * get_point_source()
    cy = HEIGHT // 2 + shift_y
    cx = WIDTH // 2 + shift_x
    residual = np.zeros((HEIGHT, WIDTH), dtype=np.float32)
    residual[cy - 1 : cy + 2, cx - 1 : cx + 2] = point_source
    return residual


def check_model_point_source(model, scale, shift_x, shift_y):
    model_ref = np.zeros((HEIGHT, WIDTH), dtype=np.float32)
    model_ref[HEIGHT // 2 + shift_y, WIDTH // 2 + shift_x] = scale
    np.testing.assert_allclose(model, model_ref, atol=2e-6)


def test_input_dtype(settings):
    psf = get_psf()
    residual = get_residual(1.0, 0, 0)
    model = np.zeros_like(residual)
    with pytest.raises(TypeError):
        rd.Radler(settings, psf.astype(np.float64), residual, model, BEAM_SIZE,
                  device="cpu")
    with pytest.raises(TypeError):
        rd.Radler(settings, psf, residual.astype(np.float16), model, BEAM_SIZE,
                  device="cpu")
    with pytest.raises(TypeError):
        rd.Radler(settings, psf, residual, model.astype(int), BEAM_SIZE,
                  device="cpu")
    with pytest.raises(TypeError):
        rd.Radler(
            settings,
            torch.as_tensor(psf, dtype=torch.float64),
            torch.as_tensor(residual),
            torch.as_tensor(model),
            BEAM_SIZE,
        )
    rd.Radler(settings, psf, residual, model, BEAM_SIZE, device="cpu")


def test_matching_arrays(settings):
    valid = np.zeros((3, HEIGHT, WIDTH), dtype=np.float32)
    rd.Radler(
        settings,
        valid,
        valid,
        valid,
        BEAM_SIZE,
        frequencies=np.zeros((3, 2), dtype=np.float64),
        weights=np.zeros((3,), dtype=np.float64),
        device="cpu",
    )
    bad = np.zeros((42,), dtype=np.float32)
    with pytest.raises(RuntimeError):
        rd.Radler(settings, bad, bad, bad, BEAM_SIZE, device="cpu")
    nonmatching = np.zeros((3, WIDTH + 42, HEIGHT + 42), dtype=np.float32)
    with pytest.raises(RuntimeError):
        rd.Radler(settings, valid, valid, nonmatching, BEAM_SIZE,
                  device="cpu")
    with pytest.raises(RuntimeError):
        rd.Radler(
            settings, valid, valid, valid, BEAM_SIZE,
            frequencies=np.zeros((42, 2)), device="cpu",
        )
    with pytest.raises(RuntimeError):
        rd.Radler(
            settings, valid, valid, valid, BEAM_SIZE, weights=np.zeros((42,)),
            device="cpu",
        )


def test_require_frequencies(settings):
    image = np.zeros((HEIGHT, WIDTH), dtype=np.float32)
    settings.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
    with pytest.raises(RuntimeError):
        rd.Radler(settings, image, image, image, BEAM_SIZE, device="cpu")


@pytest.mark.parametrize("source_shift", [(0, 0), (-9, 15)])
def test_point_source_generic(settings, source_shift):
    scale = 2.5
    psf = get_psf()
    residual = get_residual(scale, *source_shift)
    model = np.zeros_like(residual)
    r = rd.Radler(
        settings, psf, residual, model, BEAM_SIZE, rd.Polarization.STOKES_I,
        device="cpu",
    )
    assert r.perform(0) is False
    assert r.iteration_number <= settings.minor_iteration_count
    np.testing.assert_allclose(residual, np.zeros_like(residual), atol=2e-6)
    check_model_point_source(model, scale, *source_shift)


def test_point_source_tensor_accessors(settings):
    """CPU tensors take the tensor-resident path: results come back through
    the accessors, on the tensors' device, and match the NumPy path."""
    psf = torch.as_tensor(get_psf())
    residual = torch.as_tensor(get_residual(2.5, -9, 15))
    r = rd.Radler(settings, psf, residual, torch.zeros_like(residual), 0.0)
    assert r.perform(0) is False
    front = r._table.front
    assert isinstance(front.residual_accessor, rd.TensorImageAccessor)
    out_res = front.residual_accessor.array
    assert out_res.device == psf.device
    np.testing.assert_allclose(out_res.numpy(), 0.0, atol=2e-6)
    check_model_point_source(front.model_accessor.array.numpy(), 2.5, -9, 15)
    comps = r.get_component_list()
    assert comps.component_count(0) == int(
        (front.model_accessor.array != 0).sum()
    )


@pytest.mark.parametrize(
    "setting, value",
    [
        ("algorithm_type", rd.AlgorithmType.MORE_SANE),
        ("grid", 2),
        ("mesh", True),
    ],
)
def test_unported_settings_raise(settings, setting, value, tmp_path,
                                 monkeypatch):
    """The settings that the port once refused (MORE_SANE; facets on a
    device mesh; the mesh with the Clark loop) run, and match the JAX
    package's run within the parity contract (``assert_parity``)."""
    s = jrd.Settings()
    s.trimmed_image_width = WIDTH
    s.trimmed_image_height = HEIGHT
    s.pixel_scale.x = s.pixel_scale.y = PIXEL_SCALE
    s.minor_iteration_count = MINOR_ITERATION_COUNT
    s.absolute_threshold = 1e-8
    s.generic.use_sub_minor_optimization = False
    if setting == "algorithm_type":
        from tests.test_torch_more_sane import write_stand_in

        monkeypatch.chdir(tmp_path)
        s.algorithm_type = getattr(jrd.AlgorithmType, value.name)
        s.more_sane.location = str(write_stand_in(tmp_path))
    elif setting == "grid":
        s.parallel.grid_width = value
        s.parallel.use_device_mesh = True
        s.parallel.n_devices = 8
    else:
        s.parallel.use_device_mesh = value
        s.parallel.n_devices = 8
        s.generic.use_sub_minor_optimization = True
    jax_out, port_out = run_both(s, get_psf(), get_residual(2.5, -9, 15))
    assert np.abs(port_out[3]).max() > 0
    assert_parity(jax_out, port_out)


def run_both(jax_settings, psf, residual, model=None, beam_size=0.0,
             **kwargs):
    """One perform of each package from the same Settings and arrays;
    returns ((again, iterations, residual, model), ...) for JAX, port."""
    out = []
    for package, settings, device in (
        (jrd, jax_settings, {}),
        (rd, settings_from_reference(jax_settings), {"device": "cpu"}),
    ):
        res = residual.copy()
        mod = np.zeros_like(res) if model is None else model.copy()
        r = package.Radler(settings, psf, res, mod, beam_size, **kwargs,
                           **device)
        again = r.perform(0)
        out.append((again, r.iteration_number, res, mod))
    return out


def assert_parity(jax_out, port_out):
    assert port_out[0] == jax_out[0]
    assert port_out[1] == jax_out[1]
    np.testing.assert_allclose(port_out[2], jax_out[2], atol=2e-6)
    np.testing.assert_allclose(
        np.abs(port_out[3]).max(), np.abs(jax_out[3]).max(), rtol=1e-4
    )
    np.testing.assert_allclose(port_out[3], jax_out[3], atol=1e-4)


@pytest.mark.parametrize("major_loop_gain", [1.0, 0.5])
def test_multi_source_parity_with_jax(major_loop_gain):
    """The bench problem at 256^2 (30 sources, 500 iterations) through both
    Radlers."""
    size = 256
    psf, residual = make_problem(size, 30, seed=7)
    s = jrd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.minor_iteration_count = 500
    s.absolute_threshold = 0.05
    s.minor_loop_gain = 0.1
    s.major_loop_gain = major_loop_gain
    s.generic.use_sub_minor_optimization = False
    jax_out, port_out = run_both(s, psf, residual)
    assert port_out[1] > 0
    assert_parity(jax_out, port_out)


def test_border_and_negatives_parity_with_jax():
    """A clean border (the kernel's weight plane) and stop-on-negative."""
    size = 128
    psf, residual = make_problem(size, 12, seed=3)
    residual -= np.float32(0.3) * np.roll(residual, (17, -23), (0, 1))
    s = jrd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.minor_iteration_count = 400
    s.absolute_threshold = 0.02
    s.border_ratio = 0.1
    s.generic.use_sub_minor_optimization = False
    for stop_on_negative in (False, True):
        s.stop_on_negative_components = stop_on_negative
        jax_out, port_out = run_both(s, psf, residual)
        assert_parity(jax_out, port_out)


def test_auto_mask_two_phases_parity_with_jax():
    """Auto-masking: the first perform cleans to the mask threshold, the
    second cleans deeper inside the mask (``cpp/radler.cc:172-311``)."""
    size = 128
    psf, residual = make_problem(size, 12, seed=5)
    rng = np.random.default_rng(1)
    residual += rng.normal(scale=0.01, size=residual.shape).astype(np.float32)
    s = jrd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.minor_iteration_count = 600
    s.auto_mask_sigma = 8.0
    s.auto_threshold_sigma = 2.0
    s.generic.use_sub_minor_optimization = False
    results = []
    for package, settings, device in (
        (jrd, s, {}), (rd, settings_from_reference(s), {"device": "cpu"})
    ):
        res = residual.copy()
        mod = np.zeros_like(res)
        r = package.Radler(settings, psf, res, mod, 0.0, **device)
        steps = [(r.perform(i), r.iteration_number) for i in range(2)]
        results.append((steps, res, mod))
    (steps_j, res_j, mod_j), (steps_t, res_t, mod_t) = results
    assert steps_t == steps_j
    np.testing.assert_allclose(res_t, res_j, atol=2e-6)
    np.testing.assert_allclose(mod_t, mod_j, atol=1e-4)


# ---------------------------------------------------------------------------
# The Clark subminor loop (the default, use_sub_minor_optimization=True) and
# local RMS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source_shift", [(0, 0), (-9, 15)])
def test_point_source_clark(settings, source_shift):
    """The reference contract with the library's default Clark loop, and
    parity with the JAX package."""
    settings.generic.use_sub_minor_optimization = True
    scale = 2.5
    psf = get_psf()
    residual = get_residual(scale, *source_shift)
    model = np.zeros_like(residual)
    r = rd.Radler(settings, psf, residual, model, BEAM_SIZE, device="cpu")
    assert r.perform(0) is False
    np.testing.assert_allclose(residual, np.zeros_like(residual), atol=2e-6)
    check_model_point_source(model, scale, *source_shift)

    s = jrd.Settings()
    s.trimmed_image_width = WIDTH
    s.trimmed_image_height = HEIGHT
    s.minor_iteration_count = MINOR_ITERATION_COUNT
    s.absolute_threshold = 1e-8
    jax_out, port_out = run_both(s, psf, get_residual(scale, *source_shift))
    assert port_out[1] == r.iteration_number
    assert_parity(jax_out, port_out)


def bench_settings(size, iterations, threshold, **fields):
    s = jrd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.minor_iteration_count = iterations
    s.absolute_threshold = threshold
    s.minor_loop_gain = 0.1
    for name, value in fields.items():
        setattr(s, name, value)
    return s


@pytest.mark.parametrize("major_loop_gain", [1.0, 0.5])
def test_multi_source_clark_parity_with_jax(major_loop_gain):
    """The bench problem at 256^2 (30 sources, 500 iterations) through both
    Radlers with the Clark loop."""
    psf, residual = make_problem(256, 30, seed=7)
    s = bench_settings(256, 500, 0.05, major_loop_gain=major_loop_gain)
    assert s.generic.use_sub_minor_optimization
    jax_out, port_out = run_both(s, psf, residual)
    assert port_out[1] > 0
    assert_parity(jax_out, port_out)


@pytest.mark.parametrize("stop_on_negative", [False, True])
def test_border_and_negatives_clark_parity_with_jax(stop_on_negative):
    """A clean border, negative components and stop-on-negative, Clark."""
    psf, residual = make_problem(128, 12, seed=3)
    residual -= np.float32(0.3) * np.roll(residual, (17, -23), (0, 1))
    s = bench_settings(128, 400, 0.02, border_ratio=0.1,
                       stop_on_negative_components=stop_on_negative)
    jax_out, port_out = run_both(s, psf, residual)
    assert_parity(jax_out, port_out)


def test_polynomial_channels_clark_parity_with_jax():
    """4 channels with a 2-term polynomial spectral fit, Clark (the kernel's
    baked projection)."""
    size, C = 128, 4
    psf, residual = make_problem(size, 12, seed=9)
    freqs = np.array([[1.0e8 + c * 2e7, 1.2e8 + c * 2e7] for c in range(C)])
    scale = ((freqs.mean(1) / freqs.mean()) ** -0.7).astype(np.float32)
    cube = residual[None] * scale[:, None, None]
    psfs = np.repeat(psf[None], C, axis=0)
    s = bench_settings(size, 300, 0.02)
    s.spectral_fitting.mode = jrd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    jax_out, port_out = run_both(
        s, psfs, cube, frequencies=freqs, weights=np.array([1.0, 0.8, 1.2, 0.5])
    )
    assert port_out[1] > 0
    assert_parity(jax_out, port_out)


@pytest.mark.parametrize("use_subminor", [True, False])
@pytest.mark.parametrize(
    "method", ["RMS_WINDOW", "RMS_AND_MINIMUM_WINDOW", "FITS_IMAGE"]
)
def test_local_rms_parity_with_jax(method, use_subminor, tmp_path):
    """Local-RMS weighting made from the residual or read from a FITS
    image, with the Clark loop and with Högbom."""
    size = 128
    psf, residual = make_problem(size, 12, seed=5)
    rng = np.random.default_rng(2)
    noise = rng.normal(scale=0.01, size=residual.shape).astype(np.float32)
    noise[: size // 2] *= 4.0  # a noisier half for the weighting to see
    residual += noise
    # The weighting divides by the local RMS, which is high around bright
    # sources, so the weighted peaks are small.
    s = bench_settings(size, 300, 0.002)
    s.generic.use_sub_minor_optimization = use_subminor
    s.pixel_scale.x = s.pixel_scale.y = PIXEL_SCALE
    if method == "FITS_IMAGE":
        yy, xx = np.mgrid[0:size, 0:size]
        rms_map = (0.01 + 0.03 * np.exp(-((xx - 40.0) ** 2 + (yy - 70.0) ** 2)
                                       / 800.0)).astype(np.float32)
        s.local_rms.image = str(tmp_path / "rms.fits")
        write_fits_image(s.local_rms.image, rms_map)
    else:
        s.local_rms.method = getattr(jrd.LocalRmsMethod, method)
        s.local_rms.window = 3.0
    jax_out, port_out = run_both(s, psf, residual, beam_size=5 * PIXEL_SCALE)
    assert port_out[1] > 0
    assert_parity(jax_out, port_out)
