"""The port's multiscale CLEAN against the JAX package's host path, on the CPU.

The JAX package runs multiscale as one fused program by default; its own
switches ``RADLER_TPU_NO_FUSED_MS`` (the host-orchestrated path, which the
port carries) and ``RADLER_TPU_NO_DENSE_SUBMINOR`` (the Clark subminor loop
in place of the dense one) select what each test compares.  The port
reaches its Clark route with ``DENSE_SUBMINOR_MAX_PIXELS = 0``.

Tolerances, with their reasons:

* the scale kernels: the same NumPy code, so exact; the shape stamp within
  1e-6; the scale convolution of a unit-variance image within 2e-6, as
  ``test_torch_iuwt.py`` holds its FFT paths (torch's and XLA's FFTs round
  apart by up to 10 ulps there);
* the scale maxima: equal positions, values within 1e-6 relative;
* the dense subminor loop (plain B1 in linear mode against the JAX loop
  with ``use_pallas=False``): equal iteration counts and final positions,
  the component cube and the residual within 1e-6 absolute;
* ``Radler.perform``: equal iteration counts, return values, components per
  scale and scale masks; residual and model within 1e-5 of
  ``max(1, |res|max)``; the point-source contract at 2e-6.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import radler_tpu as jrd
from radler_tpu.image_set import CubeMeta as JaxMeta
from radler_tpu.models import multiscale as JM
from radler_tpu.models.multiscale_fused import (
    dense_subminor_loop as jax_dense_loop,
)
from radler_tpu.ops import multiscale_kernels as JK
from radler_tpu.ops.spectral_fitting import SpectralFitter as JaxFitter
from radler_tpu.settings import SpectralFittingMode as JaxMode

import radler_tpu_torch as rd
from radler_tpu_torch.image_set import CubeMeta
from radler_tpu_torch.interop import settings_from_reference
from radler_tpu_torch.models import multiscale as TM
from radler_tpu_torch.models.multiscale_fused import dense_subminor_loop
from radler_tpu_torch.ops import multiscale_kernels as TK
from radler_tpu_torch.ops.peak_finder import window_mask
from radler_tpu_torch.ops.spectral_fitting import SpectralFitter

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

SCALES = [0.0, 2.0, 5.5, 16.0, 40.0]
SHAPES = ["TAPERED_QUADRATIC", "GAUSSIAN"]


def rng_image(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ops/multiscale_kernels.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", SHAPES)
def test_scale_kernels_match_jax(shape, scale):
    """Peak value, embedded kernel, scale convolution and the shape stamp
    (at an interior pixel and one whose stamp the border clips)."""
    jshape, tshape = getattr(jrd.MultiscaleShape, shape), getattr(
        rd.MultiscaleShape, shape)
    h, w = 96, 128
    assert TK.kernel_peak_value(scale, h, tshape) == JK.kernel_peak_value(
        scale, h, jshape)
    assert TK.tapered_quadratic_kernel_size(scale) == (
        JK.tapered_quadratic_kernel_size(scale))
    assert TK.gaussian_sigma(scale) == JK.gaussian_sigma(scale)
    emb_t = TK.embedded_kernel(scale, h, w, tshape)
    np.testing.assert_array_equal(emb_t, JK.embedded_kernel(scale, h, w,
                                                             jshape))
    img = rng_image(1, (2, h, w))
    conv_t = TK.scale_convolve(torch.as_tensor(img), torch.as_tensor(emb_t))
    conv_j = JK.scale_convolve(jnp.asarray(img), jnp.asarray(emb_t))
    np.testing.assert_allclose(conv_t.numpy(), np.asarray(conv_j), atol=2e-6)
    for x, y in ((70, 40), (3, 92)):
        out_t = TK.add_shape_component(torch.as_tensor(img[0]), scale, x, y,
                                       0.7, tshape)
        out_j = JK.add_shape_component(jnp.asarray(img[0]), scale, x, y,
                                       0.7, jshape)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# Scales: initialize_scales, select_maximum_scale, the scale maxima
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beam, max_scales, scale_list", [
    (1.0, 0, []),
    (3.0, 0, []),
    (3.0, 3, []),
    (1.0, 0, [12.0, 0.0, 4.0]),
], ids=["beam0", "beam3", "max3", "list"])
@pytest.mark.parametrize("shape", SHAPES)
def test_initialize_scales_matches_jax(beam, max_scales, scale_list, shape):
    """The scale series of a beam of 0 px (the algorithm's 1 px) and 3 px,
    capped by ``max_scales``, or an explicit list; then a second call at a
    smaller image drops the scales past half of it."""
    jax_scales, port_scales = [], []
    for size in (200, 40):
        JM.initialize_scales(jax_scales, beam, size,
                             getattr(jrd.MultiscaleShape, shape), max_scales,
                             scale_list)
        TM.initialize_scales(port_scales, beam, size,
                             getattr(rd.MultiscaleShape, shape), max_scales,
                             scale_list)
        assert [dataclasses.asdict(s) for s in port_scales] == [
            dataclasses.asdict(s) for s in jax_scales]


def test_select_maximum_scale_matches_jax():
    """Bias-weighted, active scales only, the lowest index wins ties."""
    rng = np.random.default_rng(3)
    cases = [
        [(0.5, 1.0, True), (-0.6, 1.0, True), (0.9, 0.5, True)],
        [(0.5, 1.0, True), (0.25, 2.0, True), (-0.5, 1.0, True)],
        [(0.5, 1.0, False), (0.1, 1.0, True)],
        [(0.5, 1.0, False)],
    ] + [
        [(float(v), float(b), bool(a)) for v, b, a in zip(
            rng.normal(size=5), rng.uniform(0.3, 1.0, 5), rng.random(5) > 0.3)]
        for _ in range(20)
    ]
    for case in cases:
        lists = []
        for module in (JM, TM):
            lists.append([module.ScaleInfo(
                max_unnormalized_image_value=v, bias_factor=b, is_active=a)
                for v, b, a in case])
        assert TM.select_maximum_scale(lists[1]) == JM.select_maximum_scale(
            lists[0])


def scale_problem(h=96, w=128, seed=4):
    """Extended and point emission of both signs on noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = rng.normal(scale=0.02, size=(h, w))
    for _ in range(6):
        cy, cx = rng.integers(10, h - 10), rng.integers(10, w - 10)
        s, a = rng.uniform(1.0, 9.0), rng.uniform(-1.0, 1.0)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    rms = (0.5 + 0.5 * (xx + yy) / (h + w)).astype(np.float32)
    return img.astype(np.float32), rms


@pytest.mark.parametrize("use_rms", [False, True])
@pytest.mark.parametrize("masks", ["none", "clean", "per_scale"])
@pytest.mark.parametrize("allow_negative", [True, False])
def test_scale_maxima_match_jax(use_rms, masks, allow_negative):
    """Every scale's peak, position, normalized value and RMS, from one
    reduction in each package."""
    img, rms = scale_problem()
    h, w = img.shape
    rng = np.random.default_rng(9)
    algorithms = []
    for module, as_array, shape in (
        (JM, jnp.asarray, jrd.MultiscaleShape.TAPERED_QUADRATIC),
        (TM, torch.as_tensor, rd.MultiscaleShape.TAPERED_QUADRATIC),
    ):
        settings = (jrd if module is JM else rd).Settings().multiscale
        alg = module.MultiScaleAlgorithm(settings, 0.0, 1.0, 1.0)
        alg.allow_negative_components = allow_negative
        alg.clean_border_ratio = 0.05
        module.initialize_scales(alg.scale_infos, 2.0, min(h, w), shape, 0,
                                 [])
        for i, e in enumerate(alg.scale_infos):
            e.is_active = i % 2 == 0  # inactive scales are refreshed too
        if use_rms:
            alg.rms_factor_image = as_array(rms)
        if masks == "clean":
            alg.clean_mask = rng_image(5, (h, w)) > -0.5
        elif masks == "per_scale":
            alg.use_per_scale_masks = True
            alg.scale_masks = [
                np.random.default_rng(i).random((h, w)) > 0.3
                for i in range(len(alg.scale_infos))
            ]
        alg._find_active_scale_convolved_maxima(as_array(img),
                                                report_rms=True)
        algorithms.append(alg)
    jax_alg, port_alg = algorithms
    assert len(port_alg.scale_infos) == len(jax_alg.scale_infos) == 4
    for ej, et in zip(jax_alg.scale_infos, port_alg.scale_infos):
        assert (et.max_image_value_x, et.max_image_value_y) == (
            ej.max_image_value_x, ej.max_image_value_y)
        for name in ("max_unnormalized_image_value",
                     "max_normalized_image_value", "rms"):
            np.testing.assert_allclose(getattr(et, name), getattr(ej, name),
                                       rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The dense subminor loop (the module that reaches B1)
# ---------------------------------------------------------------------------


def dense_problem(C, P, seed, bad_psf=False):
    """A [C*P, 64, 80] scale-convolved cube of sources of both signs on
    noise, per-channel Gaussian PSFs (negated and doubled with
    ``bad_psf``, which makes every subtraction grow the peak)."""
    h, w = 64, 80
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    r2 = (yy - h // 2) ** 2.0 + (xx - w // 2) ** 2.0
    psfs = np.stack([np.exp(-r2 / (2 * (2.0 + 0.3 * c) ** 2))
                     for c in range(C)]).astype(np.float32)
    if bad_psf:
        psfs = (-2.5 * psfs).astype(np.float32)
    sky = np.zeros((h, w))
    for _ in range(10):
        sky[rng.integers(6, h - 6), rng.integers(6, w - 6)] += rng.uniform(
            -0.6, 1.0)
    planes = []
    for c in range(C):
        plane = np.real(np.fft.ifft2(
            np.fft.fft2(sky) * np.fft.fft2(np.fft.ifftshift(psfs[c]))))
        for p in range(P):
            planes.append(plane * (1.0 + 0.1 * c) * (1.0 - 0.2 * p))
    cube = (np.stack(planes) + rng.normal(scale=0.01, size=(C * P, h, w)))
    meta_args = (C, P, tuple(rng.uniform(0.5, 1.5, C).tolist()),
                 (True,) * P, 1.0, False,
                 tuple(1e8 + 1e7 * c for c in range(C)))
    return cube.astype(np.float32), psfs, meta_args


DENSE_CASES = [
    # (name, C, P, seed, options)
    ("plain", 4, 1, 1, {}),
    ("fit", 4, 1, 2, {"fit": True}),
    ("rms", 4, 1, 3, {"rms": True}),
    ("fit_rms_2pol", 2, 2, 4, {"fit": True, "rms": True}),
    ("stop_on_negative", 4, 1, 5, {"stop_on_negative": True}),
    ("positive_only", 4, 1, 6, {"allow_negative": False}),
    ("divergence", 4, 1, 7, {"bad_psf": True, "divergence_limit": 4.0}),
]


@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_dense_subminor_loop_matches_jax(case):
    """The port's plain loop (B1's plain versions in linear mode) against
    the JAX loop without Pallas, from the same start: the peak of the linear
    integration times the weight."""
    _, C, P, seed, opt = case
    cube, psfs, meta_args = dense_problem(C, P, seed, opt.get("bad_psf"))
    n, h, w = cube.shape
    rng = np.random.default_rng(seed + 100)
    window = window_mask(h, w, 5, 3) & (rng.random((h, w)) > 0.05)
    rms = (0.6 + 0.4 * rng.random((h, w))).astype(np.float32)
    use_rms = bool(opt.get("rms"))
    weight = window.astype(np.float32) * (rms if use_rms else 1.0)
    allow_negative = opt.get("allow_negative", True)
    stop_on_negative = bool(opt.get("stop_on_negative"))
    from radler_tpu.image_set import linear_integration_coefficients as lin

    integ = np.einsum("n,nhw->hw", lin(JaxMeta(*meta_args)), cube)
    cmp = integ * weight
    cmp = np.abs(cmp) if allow_negative else cmp
    y0, x0 = np.unravel_index(np.argmax(cmp), cmp.shape)
    value0 = float(integ[y0, x0] * (rms[y0, x0] if use_rms else 1.0))
    threshold = 0.05 * abs(value0)
    gain, max_iterations = 0.1, 300
    divergence_limit = opt.get("divergence_limit", 0.0)
    fit = opt.get("fit")
    freqs = meta_args[-1]
    jfit = JaxFitter(JaxMode.POLYNOMIAL, 2, freqs, meta_args[2]) if fit else None
    tfit = (SpectralFitter(rd.SpectralFittingMode.POLYNOMIAL, 2, freqs,
                           meta_args[2]) if fit else None)

    per_plane = psfs[np.arange(n) // P]
    psf_pad = np.pad(per_plane, ((0, 0), (h - h // 2, h // 2 + 8),
                                 (w - w // 2, w // 2 + 128)))
    j_res, j_comp, j_it, j_value, j_found, j_div = jax_dense_loop(
        jnp.asarray(cube), jnp.asarray(psf_pad), jnp.asarray(weight),
        jnp.asarray(rms if use_rms else np.ones_like(rms)),
        jnp.float32(threshold), jnp.float32(gain), jnp.int32(7),
        jnp.int32(max_iterations), jnp.float32(divergence_limit),
        jnp.float32(value0), jnp.int32(x0), jnp.int32(y0), jnp.asarray(True),
        meta=JaxMeta(*meta_args), allow_negative=allow_negative,
        stop_on_negative=stop_on_negative, fitter=jfit, use_rms=use_rms,
        use_pallas=False, block_rows=8,
    )
    # The port cleans its cube in place: give it a copy, as JAX may still be
    # reading ``cube`` (its CPU arrays can alias NumPy's memory).
    t_res, t_comp, t_it, t_value, t_found, t_div = dense_subminor_loop(
        torch.tensor(cube), torch.as_tensor(psfs), torch.as_tensor(weight),
        torch.as_tensor(rms) if use_rms else None, threshold, gain, 7,
        max_iterations, divergence_limit,
        (value0, int(x0), int(y0), True), meta=CubeMeta(*meta_args),
        allow_negative=allow_negative, stop_on_negative=stop_on_negative,
        fitter=tfit,
    )
    assert t_it == int(j_it) > 8
    assert (t_found, t_div) == (bool(j_found), bool(j_div))
    if opt.get("divergence_limit"):
        assert t_div
    np.testing.assert_allclose(t_value, float(j_value), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_comp.numpy(), np.asarray(j_comp), atol=1e-6)
    np.testing.assert_allclose(t_res.numpy(), np.asarray(j_res), atol=1e-6)
    # The final position: the last component of both loops.
    last = np.argwhere(np.any(np.asarray(j_comp) != 0, axis=0))
    assert np.array_equal(np.argwhere(np.any(t_comp.numpy() != 0, axis=0)),
                          last)


# ---------------------------------------------------------------------------
# The slice as a whole: Radler.perform
# ---------------------------------------------------------------------------


def diffuse_problem(size, n_channels, seed=5):
    """``tests/test_multiscale_fused.py``'s ``_diffuse_problem``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psfs = []
    for c in range(n_channels):
        w = 2.5 * (1.0 + 0.04 * c)
        p = np.exp(-r2 / (2 * w * w))
        p += 0.06 * np.exp(-((np.sqrt(r2) - 14 * (1 + 0.03 * c)) ** 2) / 6)
        psfs.append(p.astype(np.float32))
    psfs = np.stack(psfs)
    sky = np.zeros((size, size), np.float32)
    for _ in range(12):
        cy, cx = rng.integers(size // 8, 7 * size // 8, 2)
        s = rng.uniform(1.5, 12)
        a = rng.uniform(0.2, 1.0)
        m = max(1, int(4 * s))
        y0, y1 = max(0, cy - m), min(size, cy + m)
        x0, x1 = max(0, cx - m), min(size, cx + m)
        sky[y0:y1, x0:x1] += a * np.exp(
            -((yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2)
            / (2 * s * s)
        )
    residual = np.empty((n_channels, size, size), np.float32)
    for c in range(n_channels):
        fp = np.fft.rfft2(np.fft.ifftshift(psfs[c]))
        residual[c] = np.fft.irfft2(
            np.fft.rfft2(sky * (1 + 0.1 * c)) * fp, s=(size, size)
        ).astype(np.float32)
    return psfs, residual


def mixed_problem(size, n_channels, seed=11):
    """Point sources, compact and extended Gaussians under
    :func:`diffuse_problem`'s PSFs: a field whose peaks several scales
    take in turn (the diffuse field's go to the largest scale only)."""
    psfs, _ = diffuse_problem(size, n_channels)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    sky = np.zeros((size, size))
    # (sigma range in pixels, 0 for a point; amplitude range; count)
    for (s_lo, s_hi), (a_lo, a_hi), count in (((0, 0), (1.0, 3.0), 6),
                                              ((1.0, 3.0), (0.5, 1.5), 4),
                                              ((6.0, 14.0), (0.1, 0.4), 3)):
        for _ in range(count):
            cy, cx = rng.integers(size // 8, 7 * size // 8, 2)
            a = rng.uniform(a_lo, a_hi)
            if s_hi == 0:
                sky[cy, cx] += a
            else:
                s = rng.uniform(s_lo, s_hi)
                sky += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                  / (2 * s * s))
    residual = np.stack([
        np.fft.irfft2(np.fft.rfft2(sky * (1 + 0.1 * c))
                      * np.fft.rfft2(np.fft.ifftshift(psfs[c])), s=sky.shape)
        for c in range(n_channels)
    ]).astype(np.float32)
    return psfs, residual


def ms_settings(size, iters, with_fit, automask):
    s = jrd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.algorithm_type = jrd.AlgorithmType.MULTISCALE
    s.minor_iteration_count = iters
    s.minor_loop_gain = 0.1
    s.major_loop_gain = 0.85
    if automask:
        s.auto_mask_sigma = 4.0
    if with_fit:
        s.spectral_fitting.mode = jrd.SpectralFittingMode.POLYNOMIAL
        s.spectral_fitting.terms = 2
    return s


def run_package(package, settings, psfs, residual, n_majors=1, freqs=None,
                beam=0.0):
    """``n_majors`` performs of one package; returns (residual, model,
    iterations, [perform results], components per scale, scale masks,
    the Radler)."""
    kw = {} if package is jrd else {"device": "cpu"}
    if package is rd:
        settings = settings_from_reference(settings)
    res, model = residual.copy(), np.zeros_like(residual)
    r = package.Radler(settings, psfs, res, model, beam, frequencies=freqs,
                       **kw)
    results = []
    for major in range(n_majors):
        results.append(r.perform(major))
        if not results[-1]:
            break
    alg = r._parallel.algorithms[0]
    ncomp = [e.n_components_cleaned for e in alg.scale_infos]
    masks = [None if m is None else np.asarray(m) for m in alg.scale_masks]
    return res, model, r.iteration_number, results, ncomp, masks, r


def assert_runs_match(jax_run, port_run, tolerance=1e-5):
    res_j, mod_j, it_j, more_j, nc_j, masks_j, _ = jax_run
    res_t, mod_t, it_t, more_t, nc_t, masks_t, _ = port_run
    assert it_t == it_j > 0
    assert more_t == more_j
    assert nc_t == nc_j
    scale = max(1.0, float(np.abs(res_j).max()))
    assert np.abs(res_t - res_j).max() / scale < tolerance
    assert np.abs(mod_t - mod_j).max() / scale < tolerance
    assert len(masks_t) == len(masks_j)
    for mt, mj in zip(masks_t, masks_j):
        assert (mt is None) == (mj is None)
        if mt is not None:
            np.testing.assert_array_equal(mt, mj)


@pytest.fixture
def jax_host_path(monkeypatch):
    monkeypatch.setenv("RADLER_TPU_NO_FUSED_MS", "1")


PERFORM_CASES = {
    # name: (channels, iterations, fit, auto-mask, majors, route)
    "fit_2ch": (2, 120, True, False, 1, "dense"),
    "automask": (1, 150, False, True, 3, "dense"),
    "slow_sub_loop": (2, 60, True, False, 1, "slow"),
    "clark": (2, 120, True, False, 1, "clark"),
    "clark_automask": (1, 150, False, True, 3, "clark"),
    "mixed_scales": (2, 150, True, False, 2, "dense"),
    "mixed_scales_clark": (2, 150, True, False, 2, "clark"),
    "gaussian_list_border": (2, 100, True, False, 2, "dense"),
}
# What a case changes beyond ``ms_settings``: the mixed field, where three
# scales take components (the others clean at the largest scale only); the
# Gaussian shape on an explicit scale list, a clean border and positive
# components only.
PERFORM_OVERRIDES = {
    "mixed_scales": {"problem": mixed_problem},
    "mixed_scales_clark": {"problem": mixed_problem},
    "gaussian_list_border": {
        "problem": mixed_problem,
        "multiscale.shape": "GAUSSIAN",
        "multiscale.scale_list": [0.0, 4.0, 12.0, 30.0],
        "border_ratio": 0.05,
        "allow_negative_components": False,
    },
}


@pytest.mark.parametrize("name", list(PERFORM_CASES))
def test_perform_matches_jax_host_path(name, jax_host_path, monkeypatch):
    """``tests/test_multiscale_fused.py``'s ``_run`` at 128^2 through both
    packages' host paths: the dense route, the slow sub-loop and the Clark
    route, with the 2-term fit, the auto-mask case over 3 majors, and a
    field whose peaks several scales take (the Gaussian shape on a scale
    list with a border among them) over 2 majors."""
    nch, iters, fit, automask, majors, route = PERFORM_CASES[name]
    overrides = dict(PERFORM_OVERRIDES.get(name, {}))
    psfs, residual = overrides.pop("problem", diffuse_problem)(128, nch)
    s = ms_settings(128, iters, fit, automask)
    for path, value in overrides.items():
        owner, _, field = path.rpartition(".")
        if field == "shape":
            value = getattr(jrd.MultiscaleShape, value)
        setattr(getattr(s, owner) if owner else s, field, value)
    if route == "slow":
        s.multiscale.fast_sub_minor_loop = False
    if route == "clark":
        monkeypatch.setenv("RADLER_TPU_NO_DENSE_SUBMINOR", "1")
        monkeypatch.setattr(TM, "DENSE_SUBMINOR_MAX_PIXELS", 0)
    freqs = (np.array([[1.0e8 + c * 1e7, 1.1e8 + c * 1e7]
                       for c in range(nch)]) if fit else None)
    if nch == 1:
        psfs, residual = psfs[0], residual[0]
    runs = [run_package(p, s, psfs, residual, majors, freqs)
            for p in (jrd, rd)]
    assert_runs_match(*runs)
    if "problem" in PERFORM_OVERRIDES.get(name, {}):
        assert sum(n > 0 for n in runs[1][4]) >= 2
    if automask:
        assert any(m is not None and m.any() for m in runs[1][5])


def test_point_source_multiscale():
    """``tests/test_radler.py::test_point_source_multiscale``: the residual
    within 2e-6 and the model peak 2.5 within 1e-4 relative."""
    from test_torch_radler import (
        HEIGHT, WIDTH, check_model_point_source, get_psf, get_residual,
    )

    s = rd.Settings()
    s.trimmed_image_width = WIDTH
    s.trimmed_image_height = HEIGHT
    s.pixel_scale.x = s.pixel_scale.y = 1.0 / 60.0 * (np.pi / 180.0)
    s.algorithm_type = rd.AlgorithmType.MULTISCALE
    s.absolute_threshold = 1e-7
    s.minor_iteration_count = 600
    residual = get_residual(2.5, -9, 15)
    model = np.zeros_like(residual)
    r = rd.Radler(s, get_psf(), residual, model, 0.0, device="cpu")
    assert r.perform(0) is False
    np.testing.assert_allclose(residual, 0.0, atol=2e-6)
    check_model_point_source(model, 2.5, -9, 15)
    assert model[HEIGHT // 2 + 15, WIDTH // 2 - 9] == pytest.approx(
        2.5, rel=1e-4)


def test_diffuse_source_functional_bounds(jax_host_path):
    """``tests/test_diffuse_gate.py::test_diffuse_source_functional_bounds``
    (the Vela-like field, multiscale with 4-sigma auto-masking, one perform)
    at the reference's bounds, and the JAX host path's iteration count."""
    from test_diffuse_gate import make_case

    psf, dirty = make_case()
    s = jrd.Settings()
    s.algorithm_type = jrd.AlgorithmType.MULTISCALE
    s.absolute_threshold = 1.0e-8
    s.major_iteration_count = 30
    s.trimmed_image_width = s.trimmed_image_height = 256
    s.minor_iteration_count = 300
    s.minor_loop_gain = 0.8
    s.auto_mask_sigma = 4.0
    s.pixel_scale.x = s.pixel_scale.y = 1.0
    beam = 2.5 * 2.355
    jax_run, port_run = [run_package(p, s, psf, dirty, beam=beam)
                         for p in (jrd, rd)]
    residual, model, iterations = port_run[:3]
    assert 100 <= iterations <= s.minor_iteration_count
    assert iterations == jax_run[2]
    assert float(np.sqrt((residual**2).mean())) < 0.75 * float(
        np.sqrt((dirty**2).mean()))
    assert float(residual.max()) < 0.1 * float(dirty.max())
    assert np.isfinite(model).all() and model.max() > 0.5


def test_component_list_matches_jax(jax_host_path):
    """``save_source_list``: the per-scale component list of both packages
    (the dense route's device accumulation, flushed once per major)."""
    psfs, residual = diffuse_problem(128, 2)
    s = ms_settings(128, 120, True, False)
    s.save_source_list = True
    freqs = np.array([[1.0e8 + c * 1e7, 1.1e8 + c * 1e7] for c in range(2)])
    lists = [run_package(p, s, psfs, residual, 2, freqs)[-1].component_list
             for p in (jrd, rd)]
    jl, tl = lists
    assert tl.n_scales == jl.n_scales > 1
    for scale in range(jl.n_scales):
        assert tl.component_count(scale) == jl.component_count(scale)
        assert tl.get_positions(scale) == jl.get_positions(scale)
        for i in range(jl.component_count(scale)):
            np.testing.assert_allclose(tl.get_component(scale, i)[2],
                                       jl.get_component(scale, i)[2],
                                       rtol=1e-5, atol=1e-6)
    assert sum(tl.component_count(s) for s in range(tl.n_scales)) > 0


def test_component_optimization_matches_jax():
    """Multiscale with component optimization (GRADIENT_DESCENT), which
    ``radler.py`` sets once auto-masking has finished: without a tracked
    component list both packages raise the same RuntimeError; with the
    source list, a perform after a cleaning one refines its components
    (``RunFullComponentFitter``) as the JAX package's does: the residual
    within 1e-5 of max(1, |res|max), the model and the component values
    within 1e-4 (the contract's model bound).  The fit's float32 line searches
    amplify rounding: the JAX run on its input times float32(1 + 1e-7)
    moves by 9.1e-8 after the cleaning perform and by 2.5e-6 after the
    fit (the port by 1.2e-7 and 3.8e-6)."""
    size = 64
    yy, xx = np.mgrid[0:size, 0:size]
    psf = np.exp(-((yy - 32) ** 2 + (xx - 32) ** 2) / 8.0).astype(np.float32)
    res = np.zeros((size, size), np.float32)
    for (y, x), a in {(20, 22): 1.0, (40, 44): 0.6, (30, 12): 0.8}.items():
        res += a * np.roll(psf, (y - 32, x - 32), axis=(0, 1))
    s = jrd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.algorithm_type = jrd.AlgorithmType.MULTISCALE
    s.minor_iteration_count = 60
    s.multiscale.max_scales = 3
    runs = []
    for package, kw in ((jrd, {}), (rd, {"device": "cpu"})):
        settings = s if package is jrd else settings_from_reference(s)
        cube, model = res.copy(), np.zeros_like(res)
        r = package.Radler(settings, psf, cube, model, 0.0, **kw)
        r._parallel.set_component_optimization(
            package.OptimizationAlgorithm.GRADIENT_DESCENT)
        with pytest.raises(RuntimeError, match="component list"):
            r.perform(0)
        settings.save_source_list = True
        r = package.Radler(settings, psf, cube, model, 0.0, **kw)
        r.perform(0)
        cleaned = model.copy()
        r._parallel.set_component_optimization(
            package.OptimizationAlgorithm.GRADIENT_DESCENT)
        r.perform(1)
        cl = r._parallel.first_algorithm.get_component_list()
        values = [np.asarray(cl.get_component(i, k)[2])
                  for i in range(cl.n_scales)
                  for k in range(cl.component_count(i))]
        runs.append((cube, model, cleaned, np.concatenate(values)))
        s.save_source_list = False
    (jres, jmod, jclean, jvals), (tres, tmod, tclean, tvals) = runs
    scale = max(1.0, float(np.abs(jres).max()))
    np.testing.assert_allclose(tres, jres, atol=1e-5 * scale)
    np.testing.assert_allclose(tmod, jmod, atol=1e-4)
    np.testing.assert_allclose(tvals, jvals, atol=1e-4)
    assert np.abs(tmod - tclean).max() > 1e-4  # the fitter moved the model
