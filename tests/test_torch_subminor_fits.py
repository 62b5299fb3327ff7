"""The Clark subminor loop (B2) with the log-polynomial and forced-term
spectral fits in its body: the port against the JAX package on the CPU.

Inputs are made with NumPy from a seed and handed to both packages.  The
JAX package applies these fits in its XLA loop (``_subminor_while``,
``radler_tpu/models/subminor.py:113``) and its mesh program
(``radler_tpu/parallel/mesh.py:488``); the port in B2's plain version
(:func:`radler_tpu_torch.kernels.subminor_loop.subminor_loop_reference`),
which the CUDA kernel matches bit for bit on the card.

Tolerances (the ROADMAP's parity contract): equal iteration counts and
stop reasons, the residual within 2e-6 absolute, the model within 1e-4 of
its peak.  The two packages sum the fits' channel sums in other orders (the
port in channel order with fused multiply-adds, XLA's einsum its own way),
and the JAX mesh fits before the gain where the port fits after it, so the
values differ by rounding and the decisions do not.  The fit's constants
are held to the fitter's own bit for bit.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu.image_set import CubeMeta as JaxMeta
from radler_tpu.image_set import linear_integration_coefficients
from radler_tpu.models import subminor as jsm
from radler_tpu.ops.spectral_fitting import SpectralFitter as JaxFitter
from radler_tpu_torch.interop import settings_from_reference
from radler_tpu_torch.kernels import subminor_loop as sl
from radler_tpu_torch.models import subminor as sm
from radler_tpu_torch.ops.spectral_fitting import SpectralFitter
from radler_tpu_torch.utils.fits import write_fits_image

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

SIZE = 64
RESIDUAL_ATOL = 2e-6
MODEL_PEAK_RTOL = 1e-4
MODES = ("LOG_POLYNOMIAL", "FORCED_TERMS")
ALPHA = -0.7

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


def frequencies(n_chan):
    """Channel edges, 20 MHz apart from 120 MHz."""
    return np.array([[1.1e8 + 2e7 * c, 1.3e8 + 2e7 * c]
                     for c in range(n_chan)])


def spectral_problem(size, n_chan, n_pols, seed, n_sources=12,
                     negative=False):
    """Point sources with their own spectral index under a Gaussian PSF
    whose width scales with 1/nu; returns (psfs [C, H, W], cube [C P, H,
    W], the index map [1, H, W] (each source's index at its pixel, ALPHA
    elsewhere), channel frequencies [C, 2])."""
    rng = np.random.default_rng(seed)
    freqs = frequencies(n_chan)
    nu = freqs.mean(axis=1)
    ratio = nu / nu.mean()
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2.0 + (xx - size // 2) ** 2.0
    psfs = np.stack([np.exp(-r2 * ratio[c] ** 2 / (2 * 2.0 ** 2))
                     for c in range(n_chan)]).astype(np.float32)
    index_map = np.full((1, size, size), ALPHA, np.float32)
    sky = np.zeros((n_chan, size, size))
    ys = rng.integers(6, size - 6, n_sources)
    xs = rng.integers(6, size - 6, n_sources)
    amps = rng.uniform(0.3, 1.0, n_sources)
    if negative:
        amps[0] = -1.5
    alphas = rng.normal(ALPHA, 0.2, n_sources)
    for y, x, a, alpha in zip(ys, xs, amps, alphas):
        sky[:, y, x] += a * ratio ** alpha
        index_map[0, y, x] = alpha
    planes = []
    for c in range(n_chan):
        plane = np.real(np.fft.ifft2(
            np.fft.fft2(sky[c]) * np.fft.fft2(np.fft.ifftshift(psfs[c]))))
        for p in range(n_pols):
            planes.append(plane * (1.0 - 0.3 * p))
    cube = np.stack(planes).astype(np.float32)
    cube += rng.normal(scale=0.002, size=cube.shape).astype(np.float32)
    return psfs, cube, index_map, freqs


def meta_args(n_chan, n_pols, freqs):
    return (n_chan, n_pols, (1.0,) * n_chan, (True,) * n_pols, 1.0, False,
            tuple(freqs.mean(axis=1)))


def fitters(mode, freqs, index_map):
    """The JAX and the port's fitter of ``mode`` (2 terms), the forced
    terms set from ``index_map``."""
    nu = tuple(freqs.mean(axis=1))
    weights = (1.0,) * len(nu)
    jfit = JaxFitter(getattr(jrd.SpectralFittingMode, mode), 2, nu, weights)
    tfit = SpectralFitter(getattr(rd.SpectralFittingMode, mode), 2, nu,
                          weights)
    if mode == "FORCED_TERMS":
        jfit.set_forced_terms(jnp.asarray(index_map))
        tfit.set_forced_terms(torch.as_tensor(index_map))
    return jfit, tfit


def stop_reason(iteration, value, diverging, max_iterations, threshold,
                stop_on_negative):
    if diverging:
        return "diverging"
    if iteration >= max_iterations:
        return "iterations"
    if stop_on_negative and value < 0:
        return "negative"
    assert abs(value) <= threshold * (1 + 1e-6)
    return "threshold"


def assert_contract(port_res, port_mod, jax_res, jax_mod):
    np.testing.assert_allclose(port_res, jax_res, atol=RESIDUAL_ATOL, rtol=0)
    peak = np.abs(jax_mod).max()
    assert peak > 0
    assert np.abs(port_mod - jax_mod).max() <= MODEL_PEAK_RTOL * peak


# ---------------------------------------------------------------------------
# The plain B2 against _subminor_while
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("negative", [False, True],
                         ids=["positive-only", "negative-source"])
@pytest.mark.parametrize("use_rms", [False, True], ids=["no-rms", "rms"])
@pytest.mark.parametrize("n_pols", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_plain_loop_matches_xla_loop(mode, n_pols, use_rms, negative):
    """One candidate set through the JAX package's XLA loop with the fit
    and through the port's plain B2 with the same fit as a SubminorFit:
    equal iterations and stop reason, the state within the contract.  With
    ``negative`` a strong negative source is cleaned (negatives allowed),
    which the log-polynomial fit's sign must carry; without it only
    positive components are taken."""
    C = 3
    psfs, cube, index_map, freqs = spectral_problem(
        SIZE, C, n_pols, seed=11 + n_pols, negative=negative)
    meta = JaxMeta(*meta_args(C, n_pols, freqs))
    threshold = 0.04 * float(np.abs(cube).max())
    max_iters, gain, divergence = 400, 0.1, 4.0
    loop = jsm.SubMinorLoop(SIZE, SIZE, 2 * SIZE, 2 * SIZE)
    loop.set_threshold(threshold, threshold)
    loop.allow_negative_components = negative
    if use_rms:
        yy, xx = np.mgrid[0:SIZE, 0:SIZE]
        loop.rms_factor_image = jnp.asarray(
            (0.6 + 0.8 * (xx + yy) / (2.0 * SIZE)).astype(np.float32))
    count = loop.find_peak_positions(jnp.asarray(cube), meta)
    assert count > 50
    jfit, tfit = fitters(mode, freqs, index_map)
    coef = linear_integration_coefficients(meta)
    res_j, mod_j, it_j, val_j, div_j = jsm._subminor_while(
        loop._residual_k, jnp.zeros_like(loop._residual_k), loop._rms_k,
        loop._valid, loop._xs, loop._ys, jnp.asarray(psfs),
        jnp.asarray(coef), jnp.float32(threshold), jnp.float32(gain),
        jnp.int32(0), jnp.int32(max_iters), jnp.float32(divergence),
        allow_negative=negative, stop_on_negative=False, fitter=jfit,
        n_channels=C, n_polarizations=n_pols, height=SIZE, width=SIZE)

    k = lambda a: torch.as_tensor(np.array(a)[..., :count])  # noqa: E731
    xs, ys = k(loop._xs), k(loop._ys)
    res = k(loop._residual_k).clone()
    mod = torch.zeros_like(res)
    fit = sm.fit_arguments(tfit, "cpu", xs, ys)
    assert fit.mode == getattr(sl, "FIT_" + mode)
    out = sl.subminor_loop(
        res, mod, k(loop._rms_k) if use_rms else None, xs, ys,
        torch.as_tensor(psfs), torch.as_tensor(coef), fit,
        sl.SubminorParams.make(threshold, gain, 0, max_iters, divergence,
                               negative, False),
        n_polarizations=n_pols)
    iteration, value, diverging = sl.read_result(out)
    assert iteration == int(it_j) > 20
    assert diverging == bool(div_j)
    reasons = [stop_reason(it, v, d, max_iters, threshold, False)
               for it, v, d in ((iteration, value, diverging),
                                (int(it_j), float(val_j), bool(div_j)))]
    assert reasons[0] == reasons[1]
    assert_contract(res.numpy(), mod.numpy(),
                    np.asarray(res_j)[:, :count], np.asarray(mod_j)[:, :count])
    if negative:
        assert mod.numpy().min() < 0


def test_fit_constants_are_the_fitters_own():
    """SubminorFit's constants equal, bit for bit, those the fitters apply:
    the port's (``_log_poly_fit``, ``_forced_fit``) and the JAX
    package's."""
    freqs = frequencies(4)
    nu = tuple(freqs.mean(axis=1))
    weights = (1.0, 0.5, 2.0, 1.5)
    terms = torch.zeros(2, 8, 8)
    xs = torch.tensor([1, 5], dtype=torch.int32)
    for mode in MODES:
        jfit = JaxFitter(getattr(jrd.SpectralFittingMode, mode), 3, nu,
                         weights)
        tfit = SpectralFitter(getattr(rd.SpectralFittingMode, mode), 3, nu,
                              weights)
        tfit.set_forced_terms(terms)
        fit = sm.fit_arguments(tfit, "cpu", xs, xs)
        if mode == "LOG_POLYNOMIAL":
            expect = {
                "fit_matrix": jnp.asarray(jfit._fit_matrix, jnp.float32),
                "design": jnp.asarray(jfit._design, jnp.float32),
                "mean_weights": jnp.asarray(
                    jfit.weights / max(jfit.weights.sum(), 1e-300),
                    jnp.float32),
            }
            own = dict(zip(("fit_matrix", "design", "mean_weights"),
                           tfit.log_polynomial_constants("cpu")))
        else:
            lx = jnp.asarray(jfit._abscissa(jfit.frequencies), jnp.float32)
            expect = {
                "weights": jnp.asarray(jfit.weights, jnp.float32),
                "powers": jnp.stack([lx ** (k + 1) for k in range(2)]),
            }
            own = dict(zip(("weights", "powers"),
                           tfit.forced_constants(2, "cpu")))
            assert fit.terms.shape == (2, 2)
        for name, value in expect.items():
            got = getattr(fit, name)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(value))
            np.testing.assert_array_equal(got.numpy(), own[name].numpy())


def test_forced_terms_are_gathered_at_the_candidates():
    """The forced fit's ``terms`` are the term images at each candidate's
    (y, x), in the candidates' order, as ``_forced_fit`` indexes them."""
    rng = np.random.default_rng(4)
    images = rng.normal(size=(2, 16, 20)).astype(np.float32)
    tfit = SpectralFitter(rd.SpectralFittingMode.FORCED_TERMS, 3,
                          (1e8, 1.2e8, 1.4e8), (1.0, 1.0, 1.0))
    tfit.set_forced_terms(torch.as_tensor(images))
    xs = torch.tensor([19, 0, 7, 7], dtype=torch.int32)
    ys = torch.tensor([0, 15, 3, 4], dtype=torch.int32)
    fit = sm.fit_arguments(tfit, "cpu", xs, ys)
    np.testing.assert_array_equal(fit.terms.numpy(),
                                  images[:, ys.numpy(), xs.numpy()])
    assert fit.terms.is_contiguous() and fit.forced_rows == 2


def test_plain_fits_match_the_fitters():
    """``apply_fit`` (the kernel's order) against the fitters'
    ``fit_and_evaluate`` on random spectra, P = 2, a negative one among
    them: within float32 rounding."""
    rng = np.random.default_rng(9)
    freqs = frequencies(5)
    nu = tuple(freqs.mean(axis=1))
    weights = tuple(rng.uniform(0.5, 2.0, 5))
    for mode in MODES:
        tfit = SpectralFitter(getattr(rd.SpectralFittingMode, mode), 3, nu,
                              weights)
        images = rng.normal(-0.7, 0.3, (2, 4, 4)).astype(np.float32)
        tfit.set_forced_terms(torch.as_tensor(images))
        xs = torch.arange(4, dtype=torch.int32)
        fit = sm.fit_arguments(tfit, "cpu", xs, xs)
        for m in range(4):
            vals = torch.as_tensor(rng.uniform(0.1, 2.0, (5, 2)).astype(
                np.float32))
            vals[:, 1] *= -1.0
            got = sl.apply_fit(vals.reshape(-1), fit, torch.tensor(m), 2)
            want = tfit.fit_and_evaluate(vals, m, m).reshape(-1)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6)


# ---------------------------------------------------------------------------
# The tile axis
# ---------------------------------------------------------------------------


def test_plain_tile_axis_follows_the_segments_with_forced_terms():
    """Each segment of the plain tile axis uses its own candidates' forced
    terms: equal to the plain loop run on the segment alone with the
    segment's terms."""
    psfs, cube, index_map, freqs = spectral_problem(32, 2, 1, seed=5)
    _, tfit = fitters("FORCED_TERMS", freqs, index_map)
    n = cube.shape[0]
    flat = np.flatnonzero(np.abs(cube).sum(0) > 0.2)
    xs = torch.as_tensor((flat % 32).astype(np.int32))
    ys = torch.as_tensor((flat // 32).astype(np.int32))
    res0 = torch.as_tensor(cube.reshape(n, -1)[:, flat])
    k = res0.shape[1]
    counts = [k // 3, 0, k - k // 3]
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                              dtype=torch.int32)
    fit = sm.fit_arguments(tfit, "cpu", xs, ys)
    coef = torch.full((n,), 1.0 / n)
    params = sl.SubminorParams.make(0.1, 0.2, 0, 100, 0.0, True, False)
    res, mod = res0.clone(), torch.zeros_like(res0)
    out = sl.subminor_loop_tiles(res, mod, None, xs, ys, torch.as_tensor(psfs),
                                 coef, fit, params, offsets, counts,
                                 n_polarizations=1)
    begin = 0
    for t, count in enumerate(counts):
        cut = slice(begin, begin + count)
        begin += count
        if count == 0:
            continue
        res_s, mod_s = res0[:, cut].clone(), torch.zeros_like(res0[:, cut])
        alone = sl.subminor_loop_reference(
            res_s, mod_s, None, xs[cut], ys[cut], torch.as_tensor(psfs), coef,
            sm.fit_arguments(tfit, "cpu", xs[cut], ys[cut]), params,
            n_polarizations=1)
        assert torch.equal(out[t], alone)
        assert torch.equal(res[:, cut], res_s)
        assert torch.equal(mod[:, cut], mod_s)
        assert sl.read_result(alone)[0] > 0


def mesh_settings(size, n_iter, mode, forced_filename=None):
    s = jrd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.minor_iteration_count = n_iter
    s.minor_loop_gain = 0.2
    s.major_loop_gain = 0.85
    s.spectral_fitting.mode = getattr(jrd.SpectralFittingMode, mode)
    s.spectral_fitting.terms = 2
    if forced_filename:
        s.spectral_fitting.forced_filename = forced_filename
    s.parallel.use_device_mesh = True
    s.parallel.n_devices = 8
    return s


def perform_both(jax_settings, psfs, cube, freqs):
    """One perform of each package; returns ((again, iterations, residual,
    model), ...) for JAX, port."""
    out = []
    for package, settings, extra in (
        (jrd, jax_settings, {}),
        (rd, settings_from_reference(jax_settings), {"device": "cpu"}),
    ):
        res = cube.copy()
        mod = np.zeros_like(res)
        r = package.Radler(settings, psfs, res, mod, 0.0, frequencies=freqs,
                           weights=np.ones(len(freqs)), **extra)
        again = r.perform(0)
        out.append((again, r.iteration_number, res, mod))
    return out


def assert_perform_contract(jax_out, port_out):
    assert port_out[0] == jax_out[0]
    assert port_out[1] == jax_out[1] > 0
    assert_contract(port_out[2], port_out[3], jax_out[2], jax_out[3])


@needs_8
def test_mesh_subminor_with_forced_terms(tmp_path):
    """The forced-term fit inside every tile's loop (B2's tile axis, its
    plain version on the CPU) on chan 2 x tile 4, against the JAX mesh
    run."""
    psfs, cube, index_map, freqs = spectral_problem(64, 2, 1, seed=7)
    path = str(tmp_path / "forced.fits")
    write_fits_image(path, index_map)
    jax_out, port_out = perform_both(
        mesh_settings(64, 150, "FORCED_TERMS", path), psfs, cube, freqs)
    assert_perform_contract(jax_out, port_out)


# ---------------------------------------------------------------------------
# Radler.perform
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_perform_clark_with_fit_matches_jax(mode, tmp_path):
    """``Radler.perform`` with the Clark default and each fit at 128^2 x 3
    channels, against the JAX package's perform."""
    size, C = 128, 3
    psfs, cube, index_map, freqs = spectral_problem(size, C, 1, seed=21,
                                                    n_sources=20)
    s = jrd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.minor_iteration_count = 400
    s.absolute_threshold = 0.02
    s.minor_loop_gain = 0.1
    s.spectral_fitting.mode = getattr(jrd.SpectralFittingMode, mode)
    s.spectral_fitting.terms = 2
    if mode == "FORCED_TERMS":
        s.spectral_fitting.forced_filename = str(tmp_path / "forced.fits")
        write_fits_image(s.spectral_fitting.forced_filename, index_map)
    assert s.generic.use_sub_minor_optimization
    before = sl.subminor_loop.launches
    jax_out, port_out = perform_both(s, psfs, cube, freqs)
    assert sl.subminor_loop.launches == before  # the CPU runs plain
    assert_perform_contract(jax_out, port_out)
