"""The Clark subminor loop, FFT convolution and local RMS: the port against
the JAX package on the CPU.

Inputs are made with NumPy from a seed and handed to both packages.  The
subminor problems are those of ``tests/test_subminor_fused.py`` (64^2,
K <= 512 candidates).

Tolerances:
* the port's plain subminor loop against the TPU kernel's program
  (``subminor_loop_fused`` in interpret mode, with the interaction matrix of
  ``build_interaction_matrix``): iterations and divergence exact, the
  candidate residual and model within 1e-6 absolute (both perform the same
  float32 operations in the same order, so bit equality is expected);
* against the JAX package's XLA loop (``_subminor_while``): iterations and
  divergence exact, values within the JAX package's own 3e-5 (its
  integration and polynomial fit are matrix products that may sum in
  another order);
* candidate selection: positions and order exact;
* FFT convolutions and local-RMS maps within 1e-6 absolute (``jnp.fft``
  and ``torch.fft`` round differently); the sliding extrema and the beam
  kernel exact.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from radler_tpu.image_set import CubeMeta as JaxMeta
from radler_tpu.image_set import linear_integration_coefficients
from radler_tpu.models import subminor as jsm
from radler_tpu.ops import convolution as jconv
from radler_tpu.ops import rms_image as jrms
from radler_tpu.ops.pallas.subminor_fused import (
    build_interaction_matrix,
    subminor_loop_fused,
)
from radler_tpu.ops.spectral_fitting import SpectralFitter as JaxFitter
from radler_tpu.settings import SpectralFittingMode as JaxMode
from radler_tpu.utils.fft_size import calculate_good_fft_size as jfft_size
from radler_tpu_torch.component_list import ComponentList
from radler_tpu_torch.image_set import CubeMeta
from radler_tpu_torch.kernels import subminor_loop as sl
from radler_tpu_torch.models import subminor as sm
from radler_tpu_torch.models.generic_clean import GenericClean
from radler_tpu_torch.ops import convolution as conv
from radler_tpu_torch.ops import rms_image as rms
from radler_tpu_torch.ops.spectral_fitting import SpectralFitter
from radler_tpu_torch.settings import SpectralFittingMode
from radler_tpu_torch.utils.fft_size import calculate_good_fft_size

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

SIZE = 64


def make_problem(n_channels=2, n_pols=1, seed=3, n_sources=12):
    """``tests/test_subminor_fused.py``'s problem: sources convolved with a
    Gaussian PSF per channel, polarizations scaled."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    r2 = (yy - SIZE // 2) ** 2.0 + (xx - SIZE // 2) ** 2.0
    psf = np.exp(-r2 / (2 * 2.0**2)).astype(np.float32)
    psfs = np.stack([psf * (1.0 - 0.1 * c) for c in range(n_channels)])
    sky = np.zeros((SIZE, SIZE), np.float32)
    ys = rng.integers(8, SIZE - 8, n_sources)
    xs = rng.integers(8, SIZE - 8, n_sources)
    amps = rng.uniform(0.3, 1.0, n_sources).astype(np.float32)
    np.add.at(sky, (ys, xs), amps)
    planes = []
    for c in range(n_channels):
        plane = np.real(
            np.fft.ifft2(
                np.fft.fft2(sky) * np.fft.fft2(np.fft.ifftshift(psfs[c]))
            )
        ).astype(np.float32)
        for p in range(n_pols):
            planes.append(plane * (1.0 - 0.15 * p))
    meta_args = (
        n_channels,
        n_pols,
        tuple([1.0] * n_channels),
        tuple([True] * n_pols),
        1.0,
        False,
        tuple(1e8 + 1e7 * c for c in range(n_channels)),
    )
    return psfs.astype(np.float32), np.stack(planes), meta_args


def rms_plane():
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    return (0.5 + 0.5 * (xx + yy) / (2.0 * SIZE)).astype(np.float32)


# (name, n_channels, n_pols, seed, threshold fraction, options)
LOOP_CASES = [
    ("multichannel", 2, 2, 3, 0.05, {}),
    ("rms_factor", 1, 1, 3, 0.04, {"rms": True}),
    ("polynomial", 3, 1, 3, 0.05, {"fit": True}),
    ("stop_on_negative", 1, 1, 11, 0.02,
     {"negative": True, "stop_on_negative": True}),
    ("divergence", 1, 1, 5, 0.05,
     {"bad_psf": True, "max_iters": 200, "divergence_limit": 4.0}),
    ("positive_only", 2, 1, 7, 0.05, {"allow_negative": False}),
]


def run_three(case):
    """One candidate set through the TPU kernel's program (interpreted), the
    JAX XLA loop and the port's plain loop; returns the three results as
    (residual_k, model_k, iteration, value, diverging).  The JAX package pads
    the candidates to a capacity bucket and masks the padding; the port takes
    the ``count`` valid ones, which come first, and so do the compared
    values."""
    _, C, P, seed, frac, opt = case
    psfs, residual, meta_args = make_problem(C, P, seed)
    if opt.get("negative"):
        residual[0, 20, 20] = -0.8 * np.abs(residual).max()
    if opt.get("bad_psf"):
        # A broken (negated, doubled) PSF makes every subtraction grow the
        # peak.
        psfs = (-2.5 * psfs).astype(np.float32)
    meta = JaxMeta(*meta_args)
    threshold = frac * float(np.abs(residual).max())
    max_iters = opt.get("max_iters", 500)
    gain = 0.1
    allow_negative = opt.get("allow_negative", True)
    stop_on_negative = opt.get("stop_on_negative", False)
    divergence_limit = opt.get("divergence_limit", 0.0)
    use_rms = opt.get("rms", False)

    loop = jsm.SubMinorLoop(SIZE, SIZE, 2 * SIZE, 2 * SIZE)
    loop.set_threshold(threshold, threshold)
    loop.set_iteration_info(0, max_iters)
    loop.set_gain(gain)
    loop.allow_negative_components = allow_negative
    loop.stop_on_negative_component = stop_on_negative
    loop.divergence_limit = divergence_limit
    if use_rms:
        loop.rms_factor_image = jnp.asarray(rms_plane())
    count = loop.find_peak_positions(jnp.asarray(residual), meta)
    assert count > 0
    jfit, proj = None, None
    if opt.get("fit"):
        jfit = JaxFitter(JaxMode.POLYNOMIAL, 2, meta.frequencies, (1.0,) * C)
        proj = np.asarray(jfit._projection, np.float32)
    coef = linear_integration_coefficients(meta)
    res_k0 = loop._residual_k
    mod_k0 = jnp.zeros_like(res_k0)
    scalars = (
        jnp.float32(threshold),
        jnp.float32(gain),
        jnp.int32(0),
        jnp.int32(max_iters),
        jnp.float32(divergence_limit),
    )
    matrix = build_interaction_matrix(
        jnp.asarray(psfs), loop._xs, loop._ys, loop._valid,
        height=SIZE, width=SIZE,
    )
    fused = subminor_loop_fused(
        res_k0, mod_k0, loop._rms_k, loop._valid, matrix, *scalars,
        coef=tuple(float(v) for v in coef),
        proj=None if proj is None else tuple(tuple(map(float, r)) for r in proj),
        n_channels=C, n_polarizations=P, allow_negative=allow_negative,
        stop_on_negative=stop_on_negative, use_rms=use_rms, interpret=True,
    )
    xla = jsm._subminor_while(
        res_k0, mod_k0, loop._rms_k, loop._valid, loop._xs, loop._ys,
        jnp.asarray(psfs), jnp.asarray(coef), *scalars,
        allow_negative=allow_negative, stop_on_negative=stop_on_negative,
        fitter=jfit, n_channels=C, n_polarizations=P, height=SIZE, width=SIZE,
    )

    k = lambda a: torch.as_tensor(np.array(a)[..., :count])  # noqa: E731
    res_k = k(res_k0).clone()
    mod_k = torch.zeros_like(res_k)
    out = sl.subminor_loop(
        res_k, mod_k, k(loop._rms_k) if use_rms else None,
        k(loop._xs), k(loop._ys), torch.as_tensor(psfs),
        torch.as_tensor(coef),
        None if proj is None else sl.projection_fit(torch.as_tensor(proj)),
        sl.SubminorParams.make(threshold, gain, 0, max_iters, divergence_limit,
                               allow_negative, stop_on_negative),
        n_polarizations=P,
    )
    iteration, value, diverging = sl.read_result(out)
    port = (res_k.numpy(), mod_k.numpy(), iteration, value, diverging)
    fused, xla = [
        (np.asarray(r)[:, :count], np.asarray(m)[:, :count], *rest)
        for r, m, *rest in (fused, xla)
    ]
    return fused, xla, port


def assert_loops_match(jax_out, port, atol):
    res_j, mod_j, it_j, val_j, div_j = jax_out
    res_t, mod_t, it_t, val_t, div_t = port
    assert it_t == int(it_j)
    assert div_t == bool(div_j)
    np.testing.assert_allclose(val_t, float(val_j), atol=atol)
    np.testing.assert_allclose(res_t, np.asarray(res_j), atol=atol)
    np.testing.assert_allclose(mod_t, np.asarray(mod_j), atol=atol)


@pytest.mark.parametrize("case", LOOP_CASES, ids=lambda c: c[0])
def test_plain_loop_matches_tpu_kernel_and_xla_loop(case):
    fused, xla, port = run_three(case)
    assert port[2] > 0
    assert_loops_match(fused, port, atol=1e-6)
    assert_loops_match(xla, port, atol=3e-5)
    if case[0] == "divergence":
        assert port[4]  # the run must actually have diverged


def jax_and_port_loops(C, P, seed, threshold, borders=(0, 0), mask=None,
                       use_rms=False, allow_negative=True):
    psfs, residual, meta_args = make_problem(C, P, seed)
    loops = []
    for module, as_array in ((jsm, jnp.asarray), (sm, torch.as_tensor)):
        loop = module.SubMinorLoop(SIZE, SIZE, 2 * SIZE, 2 * SIZE)
        loop.set_threshold(threshold, threshold)
        loop.set_iteration_info(0, 300)
        loop.set_gain(0.1)
        loop.set_clean_borders(*borders)
        loop.allow_negative_components = allow_negative
        loop.mask = mask
        if use_rms:
            loop.rms_factor_image = as_array(rms_plane())
        loops.append(loop)
    return loops, psfs, residual, meta_args


@pytest.mark.parametrize("allow_negative", [True, False])
@pytest.mark.parametrize(
    "options",
    [
        dict(C=1, P=1),
        dict(C=2, P=2, borders=(6, 9)),
        dict(C=3, P=1, use_rms=True),
        dict(C=1, P=1, mask=True, borders=(3, 3)),
        dict(C=2, P=1, borders=(5, 11)),
        dict(C=1, P=1, borders=(40, 2)),
        dict(C=2, P=1, mask=True),
        dict(C=3, P=1, mask=True, use_rms=True),
    ],
    ids=["plain", "borders-2x2", "rms-3ch", "mask", "borders-asymmetric",
         "border-past-half", "mask-no-borders", "mask-rms"],
)
def test_find_peak_positions_matches_jax(options, allow_negative):
    opts = dict(options)
    if opts.pop("mask", False):
        opts["mask"] = np.random.default_rng(2).uniform(size=(SIZE, SIZE)) > 0.3
    (jloop, tloop), _, residual, meta_args = jax_and_port_loops(
        seed=4, threshold=0.08, allow_negative=allow_negative, **opts
    )
    count_j = jloop.find_peak_positions(jnp.asarray(residual), JaxMeta(*meta_args))
    count_t = tloop.find_peak_positions(
        torch.as_tensor(residual), CubeMeta(*meta_args)
    )
    # A border past half the image leaves an empty window (window_mask's
    # clamps); every other case selects.
    empty = max(opts.get("borders", (0, 0))) > SIZE // 2
    assert count_t == count_j and (count_j == 0) == empty
    if empty:
        return
    valid_j = np.asarray(jloop._valid)
    assert valid_j[:count_j].all() and not valid_j[count_j:].any()
    np.testing.assert_array_equal(tloop._xs.numpy(), np.asarray(jloop._xs)[:count_j])
    np.testing.assert_array_equal(tloop._ys.numpy(), np.asarray(jloop._ys)[:count_j])
    np.testing.assert_array_equal(
        tloop._residual_k.numpy(), np.asarray(jloop._residual_k)[:, :count_j]
    )
    if opts.get("use_rms"):
        np.testing.assert_array_equal(
            tloop._rms_k.numpy(), np.asarray(jloop._rms_k)[:count_j]
        )


def test_find_peak_positions_nothing_selected():
    (jloop, tloop), _, residual, meta_args = jax_and_port_loops(
        1, 1, 4, threshold=1e9
    )
    assert tloop.find_peak_positions(
        torch.as_tensor(residual), CubeMeta(*meta_args)
    ) == 0
    assert tloop.run(torch.as_tensor(residual), CubeMeta(*meta_args),
                     torch.zeros(1, SIZE, SIZE)) == (False, None)


@pytest.mark.parametrize("fit_mode", ["NO_FITTING", "POLYNOMIAL", "LOG_POLYNOMIAL"])
def test_run_and_correction_match_jax(fit_mode):
    """SubMinorLoop.run then correct_residual_dirty, both packages: the
    corrected residual, the full model and the auto-mask/component-list
    updates.  The log-polynomial fit runs in the plain loop's body, as the
    JAX package's XLA loop applies it."""
    C = 1 if fit_mode == "NO_FITTING" else 3
    (jloop, tloop), psfs, residual, meta_args = jax_and_port_loops(
        C, 1, 6, threshold=0.1
    )
    freqs = meta_args[-1]
    outs = []
    for loop, meta, as_array, fitter in (
        (jloop, JaxMeta(*meta_args), jnp.asarray,
         JaxFitter(getattr(JaxMode, fit_mode), 2, freqs, (1.0,) * C)),
        (tloop, CubeMeta(*meta_args), torch.as_tensor,
         SpectralFitter(getattr(SpectralFittingMode, fit_mode), 2, freqs,
                        (1.0,) * C)),
    ):
        res = as_array(residual)
        diverging, value = loop.run(res, meta, as_array(psfs), fitter)
        new_res, full_model = loop.correct_residual_dirty(res, as_array(psfs))
        mask = np.zeros((SIZE, SIZE), bool)
        loop.update_auto_mask(mask)
        outs.append((loop.current_iteration, diverging, value,
                     np.asarray(new_res), np.asarray(full_model), mask))
    (it_j, div_j, val_j, res_j, mod_j, mask_j) = outs[0]
    (it_t, div_t, val_t, res_t, mod_t, mask_t) = outs[1]
    assert it_t == it_j > 0 and div_t == div_j
    np.testing.assert_allclose(val_t, val_j, atol=3e-5)
    np.testing.assert_allclose(res_t, res_j, atol=3e-5)
    np.testing.assert_allclose(mod_t, mod_j, atol=3e-5)
    np.testing.assert_array_equal(mask_t, mask_j)
    comps = ComponentList(SIZE, SIZE, 1, C)
    tloop.update_component_list(comps, 0)
    assert comps.component_count(0) == int(mask_t.sum())


def test_generic_clean_routing_on_the_card():
    """Which loop a Clark run takes, decided without a card, by the JAX
    package's TPU rule: B2 for no fit and the polynomial projection at any
    size; for the log-polynomial and forced-term fits the Högbom kernel up
    to 4096^2 and B2 (the fit in its body) above."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    fitters = {
        mode: SpectralFitter(getattr(SpectralFittingMode, mode), 2,
                             [1e8, 1.2e8], [1.0, 1.0])
        for mode in ("POLYNOMIAL", "LOG_POLYNOMIAL", "FORCED_TERMS")
    }
    runs = GenericClean._clark_runs
    assert runs(cuda, None, 4096, 8192)
    assert runs(cuda, fitters["POLYNOMIAL"], 8192, 8192)
    assert runs(cpu, fitters["LOG_POLYNOMIAL"], 8192, 8192)
    for mode in ("LOG_POLYNOMIAL", "FORCED_TERMS"):
        assert not runs(cuda, fitters[mode], 4096, 4096)
        assert runs(cuda, fitters[mode], 4096, 4097)
        assert runs(cuda, fitters[mode], 8192, 8192)


def test_kernel_wrapper_rejects_other_devices():
    state = torch.zeros(1, 8, device="meta")
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        sl.subminor_loop(
            state, state, None, k, k,
            torch.zeros(1, 4, 4), torch.ones(1), None,
            sl.SubminorParams.make(0.0, 0.1, 0, 10, 0.0, True, False),
            n_polarizations=1,
        )


def test_choose_padded_size_matches_jax():
    for args in ((64, 64, 1.1), (2048, 2048, 1.1), (1000, 1300, 1.5)):
        assert sm.choose_padded_size(*args) == jsm.choose_padded_size(*args)
    for n in (1, 2, 3, 17, 97, 1000, 2253, 4097, 10007):
        assert calculate_good_fft_size(n) == jfft_size(n)


# ---------------------------------------------------------------------------
# FFT convolution and local RMS
# ---------------------------------------------------------------------------


def rng_image(seed, shape=(48, 56)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def sparse_model(seed, shape):
    """Point components of amplitude below one, as a subminor run leaves."""
    rng = np.random.default_rng(seed)
    image = np.zeros(shape, np.float32)
    image[rng.uniform(size=shape) > 0.97] = 1.0
    return image * rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def unit_psf(seed, shape):
    """A unit-peak Gaussian PSF (width set by the seed) per leading plane."""
    h, w = shape[-2:]
    yy, xx = np.mgrid[0:h, 0:w]
    r2 = (yy - h // 2) ** 2.0 + (xx - w // 2) ** 2.0
    sigma = 1.5 + seed % 3
    return np.broadcast_to(np.exp(-r2 / (2 * sigma**2)), shape).astype(
        np.float32
    )


@pytest.mark.parametrize(
    "image_shape, kernel_shape",
    [((48, 56), (48, 56)), ((3, 48, 56), (3, 48, 56)),
     ((2, 3, 48, 56), (2, 1, 48, 56)), ((48, 56), (9, 13))],
)
def test_padded_convolve_matches_jax(image_shape, kernel_shape):
    image = sparse_model(1, image_shape)
    kernel = unit_psf(2, kernel_shape)
    for padded_shape in (None, (63, 70)):
        j = jconv.padded_convolve(
            jnp.asarray(image), jnp.asarray(kernel), padded_shape=padded_shape
        )
        t = conv.padded_convolve(
            torch.as_tensor(image), torch.as_tensor(kernel),
            padded_shape=padded_shape,
        )
        assert t.shape == tuple(j.shape) and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def test_convolve_same_matches_jax():
    image, kernel = sparse_model(3, (2, 40, 50)), unit_psf(4, (40, 50))
    j = jconv.convolve_same(jnp.asarray(image), jnp.asarray(kernel))
    t = conv.convolve_same(torch.as_tensor(image), torch.as_tensor(kernel))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    with pytest.raises(ValueError):
        conv.convolve_same(torch.as_tensor(image), torch.zeros(3, 3))


@pytest.mark.parametrize("shape", [(256, 256), (2, 250, 262)])
def test_batched_irfft2_matches_numpy(shape):
    """The batched inverse FFT against NumPy's, plane by plane (the JAX
    package maps inverses per plane for a TPU fault; the port does not)."""
    rng = np.random.default_rng(5)
    spec = rng.normal(size=shape[:-1] + (shape[-1] // 2 + 1,)) + 1j * rng.normal(
        size=shape[:-1] + (shape[-1] // 2 + 1,)
    )
    got = torch.fft.irfft2(
        torch.as_tensor(spec.astype(np.complex64)), s=shape[-2:]
    ).numpy()
    want = np.fft.irfft2(spec.astype(np.complex64), s=shape[-2:])
    np.testing.assert_allclose(got, want, atol=1e-6)


BEAM = (4.0, 3.0, 0.3, 1.0, 1.3)  # major, minor, pa, pixel l, pixel m


def test_gaussian_beam_kernel_matches_jax():
    np.testing.assert_array_equal(
        rms.gaussian_beam_kernel(31, 40, *BEAM),
        jrms.gaussian_beam_kernel(31, 40, *BEAM),
    )


@pytest.mark.parametrize("window", [1, 2, 5, 8])
def test_sliding_extrema_match_jax(window):
    image = rng_image(6, (23, 37))
    for port_fn, jax_fn in (
        (rms.sliding_minimum, jrms.sliding_minimum),
        (rms.sliding_maximum, jrms.sliding_maximum),
    ):
        np.testing.assert_array_equal(
            port_fn(torch.as_tensor(image), window).numpy(),
            np.asarray(jax_fn(jnp.asarray(image), window)),
        )


@pytest.mark.parametrize("window_size", [2.0, 5.0])
def test_rms_images_match_jax(window_size):
    # Residual-like noise of 0.05 (Jy) with a brighter patch.
    image = 0.05 * rng_image(7, (60, 52))
    image[20:30, 10:20] *= 5.0
    args = (window_size, 3.0, 3.0, 0.0, 1.0, 1.0)
    for port_fn, jax_fn in (
        (rms.make_rms_image, jrms.make_rms_image),
        (rms.make_with_negativity_limit, jrms.make_with_negativity_limit),
    ):
        t = port_fn(torch.as_tensor(image), *args)
        j = jax_fn(jnp.asarray(image), *args)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


@pytest.mark.parametrize("strength", [1.0, 0.5, 0.0])
def test_rms_factor_image_matches_jax(strength):
    image = np.abs(rng_image(8, (20, 30))) + 0.1
    image[3, 4] = 0.0
    t, t_low = rms.make_rms_factor_image(torch.as_tensor(image), strength)
    j, j_low = jrms.make_rms_factor_image(jnp.asarray(image), strength)
    assert t_low == j_low
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    with pytest.raises(RuntimeError):
        rms.make_rms_factor_image(torch.as_tensor(-image), strength)


# ---------------------------------------------------------------------------
# The kernel's launch plan
# ---------------------------------------------------------------------------


PLAN_CASES = [(1, 1), (1, 37), (1, 1000), (1, 1024), (1, 1025), (1, 5003),
              (1, 7169), (1, 60218), (1, 230_000), (1, 300_000), (4, 3000),
              (4, 150_000), (8, 20_000), (9, 20_000), (80, 2000), (4000, 10),
              (4000, 100_000)]


@pytest.mark.parametrize("n_images,k", PLAN_CASES)
def test_cluster_plan_is_launchable(n_images, k):
    """A power of two up to 16 blocks, contiguous slices that cover
    0..K-1 exactly once, and no more shared memory than a block may hold
    beside the kernel's static part."""
    plan = sl.cluster_plan(n_images, k)
    r = plan.cluster_size
    assert 1 <= r <= sl.MAX_CLUSTER and r & (r - 1) == 0
    assert sl.MIN_THREADS <= plan.threads <= sl.MAX_THREADS
    assert plan.threads % 32 == 0
    assert (plan.threads == sl.MAX_THREADS
            or plan.threads * sl.CANDIDATES_PER_THREAD >= plan.slice_len)
    covered = np.zeros(k, int)
    for rank in range(r):
        first = rank * plan.slice_len
        covered[first:min(k, first + plan.slice_len)] += 1
    assert (covered == 1).all()
    assert plan.shared_bytes + sl.STATIC_SHARED_RESERVE <= (
        sl.SHARED_BYTES_PER_BLOCK) <= 232_448
    state = plan.slice_len * (4 * n_images + 12) if plan.on_chip else 0
    assert plan.shared_bytes == 12 * n_images + state
    assert plan.ship_raw == (n_images <= sl.SHIP_RAW_MAX_IMAGES)


def test_cluster_plan_crossovers():
    """One block for few candidates; the state in shared memory as long as
    16 blocks hold it, in global memory beyond."""
    assert sl.cluster_plan(1, 1000).cluster_size == 1
    assert sl.cluster_plan(4, 250).cluster_size == 1
    assert sl.cluster_plan(4, 300).cluster_size == 16
    assert sl.cluster_plan(1, 60218) == sl.ClusterPlan(
        16, 1024, 3764, True, True, 12 + 3764 * 16)
    assert sl.cluster_plan(1, 1000).threads == 416
    assert sl.cluster_plan(1, 37).threads == sl.MIN_THREADS
    # Threads follow a block's candidates, whatever the number of planes.
    assert [sl.cluster_plan(n, 10_000).threads for n in (1, 4, 8, 80)] == (
        [256] * 4)
    assert sl.cluster_plan(4000, 10).threads == sl.MIN_THREADS
    assert sl.cluster_plan(1, 5000).cluster_size == 16
    room = sl.SHARED_BYTES_PER_BLOCK - sl.STATIC_SHARED_RESERVE - 12
    most = 16 * (room // 16)
    assert sl.cluster_plan(1, most).on_chip
    beyond = sl.cluster_plan(1, most + 16)
    assert not beyond.on_chip and beyond.cluster_size == 16
    assert beyond.shared_bytes == 12


@pytest.mark.parametrize("cluster_size", [1, 2, 4, 8, 16])
def test_cluster_plan_forced(cluster_size):
    """A forced cluster size keeps the state on the chip where it fits; a
    forced place that does not fit, a size that is no power of two and raw
    values for too many planes raise."""
    plan = sl.cluster_plan(1, 60218, cluster_size=cluster_size)
    assert plan.cluster_size == cluster_size
    assert plan.on_chip == (cluster_size >= 8)
    assert plan.slice_len * cluster_size >= 60218
    assert not sl.cluster_plan(1, 60218, cluster_size=cluster_size,
                               on_chip=False).on_chip
    assert not sl.cluster_plan(2, 100, cluster_size=cluster_size,
                               ship_raw=False).ship_raw
    if cluster_size < 8:
        with pytest.raises(ValueError):
            sl.cluster_plan(1, 60218, cluster_size=cluster_size, on_chip=True)
    with pytest.raises(ValueError):
        sl.cluster_plan(1, 100, cluster_size=3 * cluster_size)
    with pytest.raises(ValueError):
        sl.cluster_plan(9, 100, cluster_size=cluster_size, ship_raw=True)
