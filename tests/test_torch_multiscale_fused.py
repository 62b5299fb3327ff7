"""The port's fused multiscale loop against the JAX package's, on the CPU.

Both packages run multiscale on the fused route by default
(``RADLER_TPU_NO_FUSED_MS`` unset): the JAX package as one jitted program,
the port as :func:`radler_tpu_torch.models.multiscale_fused.
fused_multiscale_minor_loop` with B1's plain version in its dense subminor
loop.  Inputs are made with NumPy from a seed and handed to both.

Tolerances, with their reasons:

* the FFT helpers within 2e-6 of the inputs' scale (unit-variance images;
  torch's and XLA's FFTs round apart by a few ulps, as in
  ``test_torch_multiscale.py``); the correction split and the coefficient
  basis exactly (the same host arithmetic);
* the banks: PSF peaks, bias factors and gains within 1e-6 relative, the
  spectra and twice-convolved PSFs within 2e-6 of their largest value;
* ``Radler.perform`` against the JAX fused run: equal iteration counts,
  return values, components per scale and scale masks; residual and model
  within 1e-5 of ``max(1, |res|max)`` in the image region (measured at
  most 1.3e-6 and 3.7e-8); the port's fused route against its host path
  within the JAX test's own 1e-4.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import radler_tpu as jrd
from radler_tpu.image_set import CubeMeta as JaxMeta
from radler_tpu.models import multiscale as JM
from radler_tpu.models.multiscale_fused import (
    _coefficient_basis as jax_coefficient_basis,
)
from radler_tpu.ops import convolution as JC
from radler_tpu.ops.spectral_fitting import SpectralFitter as JaxFitter
from radler_tpu.settings import SpectralFittingMode as JaxMode

import radler_tpu_torch as rd
from radler_tpu_torch.interop import (
    cube_meta_from_reference,
    settings_from_reference,
)
from radler_tpu_torch.models import multiscale as TM
from radler_tpu_torch.models import multiscale_fused as TF
from radler_tpu_torch.ops import convolution as TC
from radler_tpu_torch.ops.spectral_fitting import SpectralFitter

from test_torch_multiscale import (
    assert_runs_match,
    diffuse_problem,
    mixed_problem,
    ms_settings,
    run_package,
)

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)


def rng_image(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def spectra_close(port, jax_value, rtol=2e-6):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    want = np.asarray(jax_value)
    assert port.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(port - want).max() <= rtol * scale


# ---------------------------------------------------------------------------
# ops/convolution.py: the five FFT helpers
# ---------------------------------------------------------------------------

FFT_SHAPES = [(64, 64), (63, 80), (2, 50, 37), (3, 41, 64)]
PADDED = {(64, 64): (70, 72), (63, 80): (70, 90), (50, 37): (56, 45),
          (41, 64): (49, 70)}


@pytest.mark.parametrize("shape", FFT_SHAPES, ids=str)
def test_fft_helpers_match_jax(shape):
    """forward_fft2, inverse_fft2_real, forward_fft2_padded and
    inverse_fft2_real_trimmed at even, odd and padded sizes."""
    img = rng_image(1, shape)
    h, w = shape[-2:]
    ph, pw = PADDED[(h, w)]
    t, j = torch.as_tensor(img), jnp.asarray(img)
    spectra_close(TC.forward_fft2(t), JC.forward_fft2(j))
    spec = TC.forward_fft2(t)
    spectra_close(TC.inverse_fft2_real(spec, (h, w)),
                  JC.inverse_fft2_real(jnp.asarray(spec.numpy()), (h, w)))
    for padded in ((h, w), (ph, pw)):
        pad_t = TC.forward_fft2_padded(t, padded)
        spectra_close(pad_t, JC.forward_fft2_padded(j, padded))
        back_t = TC.inverse_fft2_real_trimmed(pad_t, padded, (h, w))
        back_j = JC.inverse_fft2_real_trimmed(
            jnp.asarray(pad_t.numpy()), padded, (h, w))
        spectra_close(back_t, back_j)
        np.testing.assert_allclose(back_t.numpy(), img, atol=2e-6)


@pytest.mark.parametrize("kernel_shape, shape", [
    ((1, 1), (64, 64)), ((5, 5), (63, 80)), ((3, 9, 9), (70, 72)),
    ((2, 64, 64), (64, 64)), ((17, 17), (49, 70)),
], ids=str)
def test_centered_embed_kernel_fft_matches_jax(kernel_shape, shape):
    kernel = rng_image(2, kernel_shape)
    spectra_close(TC.centered_embed_kernel_fft(torch.as_tensor(kernel), shape),
                  JC.centered_embed_kernel_fft(jnp.asarray(kernel), shape))


# ---------------------------------------------------------------------------
# models/multiscale_fused.py and the callers' helpers
# ---------------------------------------------------------------------------

FIT_CASES = [
    # (mode, terms, channels, polarizations)
    ("POLYNOMIAL", 2, 4, 1),
    ("POLYNOMIAL", 3, 5, 2),
    ("POLYNOMIAL", 2, 1, 1),
    ("NO_FITTING", 2, 4, 1),
    ("LOG_POLYNOMIAL", 2, 4, 1),
    ("FORCED_TERMS", 2, 4, 1),
]


@pytest.mark.parametrize("case", FIT_CASES, ids=str)
def test_coefficient_basis_matches_jax(case):
    mode, terms, C, P = case
    freqs = tuple(1e8 + 1.3e7 * c for c in range(C))
    weights = tuple(np.random.default_rng(3).uniform(0.5, 1.5, C).tolist())
    jmeta = JaxMeta(C, P, weights, (True,) * P, 1.0, False, freqs)
    jf = JaxFitter(getattr(JaxMode, mode), terms, freqs, weights)
    tf = SpectralFitter(getattr(rd.SpectralFittingMode, mode), terms, freqs,
                        weights)
    want = jax_coefficient_basis(jf, jmeta)
    got = TF._coefficient_basis(tf, cube_meta_from_reference(jmeta))
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
    assert TF._coefficient_basis(None, cube_meta_from_reference(jmeta)) is None


def algorithm_pair(scale_list=(), size=128, shape="TAPERED_QUADRATIC",
                   max_scales=0, beam=0.0):
    """The JAX and the port's MultiScaleAlgorithm with the same scales."""
    pair = []
    for pkg, module in ((jrd, JM), (rd, TM)):
        settings = pkg.Settings().multiscale
        settings.shape = getattr(pkg.MultiscaleShape, shape)
        settings.scale_list = list(scale_list)
        settings.max_scales = max_scales
        alg = module.MultiScaleAlgorithm(settings, beam, 1.0, 1.0)
        module.initialize_scales(alg.scale_infos, alg.beam_size_in_pixels,
                                 size, settings.shape, max_scales,
                                 list(scale_list))
        pair.append(alg)
    return pair


@pytest.mark.parametrize("size", [64, 100, 128, 257, 500, 1000, 2048])
@pytest.mark.parametrize("scales", [
    (), (0.0, 4.0, 12.0), (0.0, 30.0), (0.0,), (2.0, 5.0, 9.0, 17.0, 33.0),
], ids=["auto", "list3", "far", "one", "dense_list"])
def test_correction_split_matches_jax(size, scales):
    """The same split and padded sizes, square and not."""
    for height, width in ((size, size), (size, size // 2 + 3)):
        jax_alg, port_alg = algorithm_pair(scales, min(height, width))
        assert [e.scale for e in port_alg.scale_infos] == [
            e.scale for e in jax_alg.scale_infos]
        assert port_alg._correction_split(width, height) == (
            jax_alg._correction_split(width, height))


@pytest.mark.parametrize("case", [
    # (channels, height, width, shape, scale list, beam)
    (2, 96, 128, "TAPERED_QUADRATIC", (), 0.0),
    (1, 128, 128, "TAPERED_QUADRATIC", (), 3.0),
    (3, 100, 90, "GAUSSIAN", (0.0, 4.0, 12.0, 30.0), 0.0),
], ids=["2ch_auto", "1ch_beam", "3ch_gaussian_list"])
def test_prepare_fused_banks_matches_jax(case):
    """Peaks, bias factors and gains, the twice-convolved PSFs and the
    kernel and PSF spectra at both padded sizes, and the split."""
    C, h, w, shape, scale_list, beam = case
    psfs, _ = diffuse_problem(max(h, w), C)
    psfs = np.ascontiguousarray(psfs[:, :h, :w])
    freqs = tuple(1e8 + 1e7 * c for c in range(C))
    jmeta = JaxMeta(C, 1, (1.0,) * C, (True,), 1.0, False, freqs)
    jax_alg, port_alg = algorithm_pair(scale_list, min(h, w), shape,
                                       beam=beam)
    want = jax_alg._prepare_fused_banks(jmeta, w, h, jnp.asarray(psfs))
    got = port_alg._prepare_fused_banks(cube_meta_from_reference(jmeta), w,
                                        h, torch.as_tensor(psfs))
    (kf, twice, pf, kfl, pfl, bias, gain, split, pa, pb) = got
    assert (split, pa, pb) == tuple(want[7:])
    assert split < len(port_alg.scale_infos)  # both sizes are exercised
    for ej, et in zip(jax_alg.scale_infos, port_alg.scale_infos):
        for name in ("psf_peak", "bias_factor", "gain"):
            np.testing.assert_allclose(getattr(et, name), getattr(ej, name),
                                       rtol=1e-6)
    np.testing.assert_allclose(bias, np.asarray(want[5]), rtol=1e-6)
    np.testing.assert_allclose(gain, np.asarray(want[6]), rtol=1e-6)
    for port, jax_value in zip((kf, twice, pf, kfl, pfl), want[:5]):
        spectra_close(port, jax_value)


def test_fused_banks_kept_per_algorithm():
    """A ``Radler`` builds its banks once: the same PSF stack, or an equal
    one, hits; a stack changed in place, or another PSF, builds anew."""
    psfs, _ = diffuse_problem(64, 2)
    meta = cube_meta_from_reference(
        JaxMeta(2, 1, (1.0, 1.0), (True,), 1.0, False, (1e8, 1.1e8)))
    _, alg = algorithm_pair((), 64)
    psf_t = torch.as_tensor(psfs.copy())
    first = alg._prepare_fused_banks(meta, 64, 64, psf_t)
    assert alg._prepare_fused_banks(meta, 64, 64, psf_t) is first
    assert alg._prepare_fused_banks(meta, 64, 64,
                                    torch.as_tensor(psfs.copy())) is first
    psf_t.mul_(1.0)  # an in-place write, even of the same values
    second = alg._prepare_fused_banks(meta, 64, 64, psf_t)
    assert second is not first
    third = alg._prepare_fused_banks(meta, 64, 64, psf_t * 0.5)
    assert third is not second
    np.testing.assert_allclose(third[1].numpy(), second[1].numpy() * 0.5,
                               rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# The slice as a whole: Radler.perform on the fused route
# ---------------------------------------------------------------------------


def fused_case(nch=2, iters=120, with_fit=True, automask=False,
               problem=diffuse_problem):
    psfs, residual = problem(128, nch)
    s = ms_settings(128, iters, with_fit, automask)
    freqs = (np.array([[1.0e8 + c * 1e7, 1.1e8 + c * 1e7]
                       for c in range(nch)]) if with_fit or nch > 1 else None)
    if nch == 1:
        psfs, residual = psfs[0], residual[0]
    return s, psfs, residual, freqs


def both_fused(s, psfs, residual, freqs, majors=1):
    return [run_package(p, s, psfs, residual, majors, freqs)
            for p in (jrd, rd)]


def host_run(monkeypatch, s, psfs, residual, freqs, majors=1):
    monkeypatch.setenv("RADLER_TPU_NO_FUSED_MS", "1")
    try:
        return run_package(rd, s, psfs, residual, majors, freqs)
    finally:
        monkeypatch.delenv("RADLER_TPU_NO_FUSED_MS")


def assert_close_to_host(fused, host, tolerance=1e-4):
    """``tests/test_multiscale_fused.py``'s comparison of the two routes."""
    res_f, mod_f, it_f, more_f, nc_f = fused[:5]
    res_h, mod_h, it_h, more_h, nc_h = host[:5]
    assert (it_f, more_f, nc_f) == (it_h, more_h, nc_h)
    scale = max(1.0, float(np.abs(res_h).max()))
    assert np.abs(res_f - res_h).max() / scale < tolerance
    assert np.abs(mod_f - mod_h).max() / scale < tolerance


def test_fused_matches_host_path(monkeypatch):
    """``test_multiscale_fused.py::test_fused_matches_host_path``: 2
    channels with the 2-term fit (coefficient space), against the JAX fused
    run and against the port's host path."""
    s, psfs, residual, freqs = fused_case()
    jax_run, port_run = both_fused(s, psfs, residual, freqs)
    assert_runs_match(jax_run, port_run)
    assert_close_to_host(port_run, host_run(monkeypatch, s, psfs, residual,
                                            freqs))


def test_fused_single_channel_converges():
    """``test_fused_single_channel_converges``: one channel, no fit, 400
    iterations; the rms halves, and the JAX fused run's counts and cubes."""
    s, psfs, residual, freqs = fused_case(nch=1, with_fit=False, iters=400)
    jax_run, port_run = both_fused(s, psfs, residual, freqs)
    assert_runs_match(jax_run, port_run)
    res = port_run[0]
    assert float(np.sqrt(np.mean(res**2))) < 0.5 * float(
        np.sqrt(np.mean(residual**2)))
    assert port_run[2] > 10


def test_fused_matches_host_path_with_automask(monkeypatch):
    """``test_fused_matches_host_path_with_automask``: both auto-mask
    phases over 3 majors; the tracked masks equal the JAX fused run's and
    the host path's exactly."""
    s, psfs, residual, freqs = fused_case(nch=1, with_fit=False, iters=150,
                                          automask=True)
    jax_run, port_run = both_fused(s, psfs, residual, freqs, majors=3)
    assert_runs_match(jax_run, port_run)
    host = host_run(monkeypatch, s, psfs, residual, freqs, majors=3)
    assert_close_to_host(port_run, host)
    for mf, mh in zip(port_run[5], host[5]):
        np.testing.assert_array_equal(mf, mh)
    assert any(m is not None and m.any() for m in port_run[5])


def test_fused_eligible_with_tracking():
    """``test_fused_eligible_with_tracking``: auto-masking keeps the fused
    route, and its first phase builds non-empty masks on the device, as
    the JAX fused run's."""
    s, psfs, residual, freqs = fused_case(nch=1, with_fit=False, iters=150,
                                          automask=True)
    jax_run, port_run = both_fused(s, psfs, residual, freqs)
    assert_runs_match(jax_run, port_run)
    alg = port_run[-1]._parallel.algorithms[0]
    assert alg.track_per_scale_masks
    assert alg._fused_banks is not None  # the fused route ran
    assert any(m is not None and m.any() for m in alg.scale_masks)


def test_fused_several_scales_and_component_list():
    """A field where three scales take components (both correction sizes)
    over 2 majors with the fit, and ``save_source_list``: the per-scale
    component list of both packages' fused runs."""
    s, psfs, residual, freqs = fused_case(iters=150, problem=mixed_problem)
    s.save_source_list = True
    jax_run, port_run = both_fused(s, psfs, residual, freqs, majors=2)
    assert_runs_match(jax_run, port_run)
    assert sum(n > 0 for n in port_run[4]) >= 3
    split = port_run[-1]._parallel.algorithms[0]._fused_banks[4][7]
    assert any(n > 0 for n in port_run[4][split:])
    jl, tl = jax_run[-1].component_list, port_run[-1].component_list
    assert tl.n_scales == jl.n_scales
    for scale in range(jl.n_scales):
        assert tl.get_positions(scale) == jl.get_positions(scale)
        for i in range(jl.component_count(scale)):
            np.testing.assert_allclose(tl.get_component(scale, i)[2],
                                       jl.get_component(scale, i)[2],
                                       rtol=1e-5, atol=1e-6)


def test_fused_forced_terms(tmp_path):
    """FORCED_TERMS takes the N-plane branch (the fit between launches,
    the forced terms gathered at each peak): 2 channels, a spectral index
    that varies over the image."""
    from radler_tpu.utils.fits import write_fits_image

    s, psfs, residual, freqs = fused_case(with_fit=False)
    yy, xx = np.mgrid[0:128, 0:128]
    alpha = (-0.7 + 0.004 * (xx - yy)).astype(np.float32)[None]
    path = str(tmp_path / "forced.fits")
    write_fits_image(path, alpha)
    s.spectral_fitting.mode = jrd.SpectralFittingMode.FORCED_TERMS
    s.spectral_fitting.terms = 2
    s.spectral_fitting.forced_filename = path
    assert_runs_match(*both_fused(s, psfs, residual, freqs))


def test_fused_no_fitting_two_channels():
    """NO_FITTING with 2 channels: the N-plane branch without a fit."""
    s, psfs, residual, freqs = fused_case(with_fit=False)
    assert_runs_match(*both_fused(s, psfs, residual, freqs))


def test_fused_route_is_the_default(monkeypatch):
    """A multiscale perform takes the fused route by default and the host
    path under ``RADLER_TPU_NO_FUSED_MS=1``, as the JAX package does."""
    calls = []
    original = TM.fused_multiscale_minor_loop

    def spy(*args, **kwargs):
        calls.append(kwargs["split"])
        return original(*args, **kwargs)

    monkeypatch.setattr(TM, "fused_multiscale_minor_loop", spy)
    s, psfs, residual, freqs = fused_case(iters=30)
    run_package(rd, s, psfs, residual, 1, freqs)
    assert calls == [2]
    host_run(monkeypatch, s, psfs, residual, freqs)
    assert calls == [2]
    s.multiscale.fast_sub_minor_loop = False  # the slow sub-loop: host path
    run_package(rd, s, psfs, residual, 1, freqs)
    assert calls == [2]


def test_fused_forced_terms_without_images_raise():
    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = 32
    s.algorithm_type = rd.AlgorithmType.MULTISCALE
    s.minor_iteration_count = 10
    psf = np.zeros((2, 32, 32), np.float32)
    psf[:, 16, 16] = 1.0
    res = psf.copy()
    r = rd.Radler(s, psf, res, np.zeros_like(res), 0.0, device="cpu",
                  frequencies=np.array([[1e8, 1.1e8], [1.1e8, 1.2e8]]))
    fitter = SpectralFitter(
        rd.SpectralFittingMode.FORCED_TERMS, 2, [1.05e8, 1.15e8], [1.0, 1.0])
    r._parallel.algorithms[0].spectral_fitter = fitter
    with pytest.raises(RuntimeError, match="Forced terms have not been set"):
        r.perform(0)


def test_fused_two_polarizations():
    """2 channels x (XX, YY) through a work table with the 2-term fit:
    the coefficient basis of 2 polarizations and the per-plane PSF spectra
    of the correction, against the JAX fused run."""
    from test_torch_joined_polarization import SIZE, run_table

    psfs, residual = diffuse_problem(SIZE, 2)
    images = {}
    for ch in range(2):
        images[(ch, "XX")] = residual[ch]
        images[(ch, "YY")] = (0.8 * residual[ch]).astype(np.float32)
    s = ms_settings(SIZE, 80, True, False)
    runs = [run_table(package, s if package is jrd else
                      settings_from_reference(s), ["XX", "YY"], images,
                      psfs[0])
            for package in (jrd, rd)]
    (again_j, it_j, res_j, mod_j), (again_t, it_t, res_t, mod_t) = runs
    assert (again_t, it_t) == (again_j, it_j) and it_t > 10
    scale = max(1.0, max(float(np.abs(r).max()) for r in res_j.values()))
    for key in res_j:
        assert np.abs(res_t[key] - res_j[key]).max() / scale < 1e-5
        assert np.abs(mod_t[key] - mod_j[key]).max() / scale < 1e-5
