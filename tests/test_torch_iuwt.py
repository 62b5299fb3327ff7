"""The port's IUWT against the JAX package's, on the CPU.

Inputs are made with NumPy from a seed and handed to both packages.
Tolerances, with their reasons:

* one ``iuwt_convolve`` and the MAD sigma: bit-equal (the same float32
  operations in the same order; products by 1/16 and 4/16 are exact);
* the plain B3 and ``decompose``: 2e-6 absolute on unit-variance inputs,
  the JAX package's own tolerance for its kernel (``test_iuwt_atrous.py``),
  because XLA fuses and reorders the jitted transform;
* stats, selection, boxes and fits: as ``tests/test_iuwt_ops.py`` states
  them for the JAX package, or exact where no arithmetic is reordered;
* the CG solve: 1e-4 relative, float32 dot products over the image summed
  in another order;
* ``Radler.perform``: see the perform tests below.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import radler_tpu as jrd
from radler_tpu.image_set import CubeMeta as JaxCubeMeta
from radler_tpu.image_set import get_integrated_psf as jax_integrated_psf
from radler_tpu.models.iuwt import _IuwtEngine as JaxEngine
from radler_tpu.ops import convolution as jconv
from radler_tpu.ops import iuwt as J
from radler_tpu.ops import noise as jnoise
from radler_tpu.ops.pallas.iuwt_atrous import atrous_decompose_lo as jax_lo
from radler_tpu.ops.pallas.iuwt_atrous import cascade_reach as jax_reach

import radler_tpu_torch as rd
from radler_tpu_torch.image_set import get_integrated_psf
from radler_tpu_torch.interop import cube_meta_from_reference
from radler_tpu_torch.interop import settings_from_reference
from radler_tpu_torch.kernels import iuwt_atrous as K
from radler_tpu_torch.models.iuwt import _IuwtEngine
from radler_tpu_torch.ops import convolution as tconv
from radler_tpu_torch.ops import iuwt as T
from radler_tpu_torch.ops import noise as tnoise

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)


def t(a):
    return torch.as_tensor(np.array(a))


def n(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.array(a)


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(42)
    img = rng.normal(scale=0.1, size=(64, 64)).astype(np.float32)
    img[20, 30] += 3.0
    img[40, 44] -= 2.0
    return img


def delta_psf(height, width):
    psf = np.zeros((height, width), np.float32)
    psf[height // 2, width // 2] = 1.0
    return psf


# ---------------------------------------------------------------------------
# The transform and kernel B3's plain version
# ---------------------------------------------------------------------------


def test_cascade_reach_values():
    """The halo of the JAX package's one-pass kernel (``cascade_reach``) is
    the reach of the port's per-scale launches: the last wavelet plane of an
    impulse is non-zero exactly out to that many pixels from it (every B3
    tap is positive, so nothing cancels at the edge)."""
    size, centre = 361, 180
    impulse = torch.zeros((size, size))
    impulse[centre, centre] = 1.0
    for n_lo, reach in ((1, 4), (2, 14), (3, 36), (4, 82), (5, 176)):
        assert jax_reach(n_lo) == reach
        w, _ = K.atrous_decompose_lo(impulse, n_lo)
        ys, xs = torch.nonzero(w[n_lo - 1], as_tuple=True)
        assert int((ys - centre).abs().max()) == reach
        assert int((xs - centre).abs().max()) == reach


@pytest.mark.parametrize("scale", [1, 2, 3, 5])
def test_iuwt_convolve_bit_equal_to_jax(scale):
    img = np.random.default_rng(scale).standard_normal((70, 90))
    img = img.astype(np.float32)
    np.testing.assert_array_equal(
        n(K.iuwt_convolve(t(img), scale)),
        n(J.iuwt_convolve(jnp.asarray(img), scale)),
    )


@pytest.mark.parametrize("n_lo", [1, 3, 5])
@pytest.mark.parametrize(
    "shape,block", [((200, 300), (64, 128)), ((256, 256), (128, 128))]
)
def test_plain_atrous_matches_jax(n_lo, shape, block):
    """The plain B3 against the Pallas kernel (interpreted) and against the
    JAX package's decompose and smoothing chain, 2e-6 absolute."""
    img = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    w, smooth = K.atrous_decompose_lo(t(img), n_lo)
    assert w.shape == (n_lo, *shape) and smooth.shape == shape
    jw, jsmooth = jax_lo(jnp.asarray(img), n_lo, block_h=block[0],
                         block_w=block[1], interpret=True)
    np.testing.assert_allclose(n(w), n(jw), atol=2e-6)
    np.testing.assert_allclose(n(smooth), n(jsmooth), atol=2e-6)
    ref = n(J.decompose(jnp.asarray(img), 8))
    np.testing.assert_allclose(n(w), ref[:n_lo], atol=2e-6)
    cur = jnp.asarray(img)
    for s in range(n_lo):
        cur = J.iuwt_convolve(cur, s + 1)
    np.testing.assert_allclose(n(smooth), n(cur), atol=2e-6)


@pytest.mark.parametrize("n_lo", [1, 3, 5])
def test_plain_atrous_batch(n_lo):
    """A batch of 3: each plane as JAX decomposes it alone, and the batch
    layout [n_lo, B, H, W] equal to the planes run one at a time."""
    imgs = np.random.default_rng(4).standard_normal((3, 200, 300))
    imgs = imgs.astype(np.float32)
    w, smooth = K.atrous_decompose_lo(t(imgs), n_lo)
    assert w.shape == (n_lo, 3, 200, 300) and smooth.shape == (3, 200, 300)
    for b in range(3):
        ref = n(J.decompose(jnp.asarray(imgs[b]), 8))
        np.testing.assert_allclose(n(w[:, b]), ref[:n_lo], atol=2e-6)
        one_w, one_smooth = K.atrous_decompose_lo(t(imgs[b]), n_lo)
        assert torch.equal(w[:, b], one_w)
        assert torch.equal(smooth[b], one_smooth)


def test_atrous_writes_into_given_buffers():
    img = t(np.random.default_rng(5).standard_normal((40, 50)).astype(
        np.float32))
    stack = torch.full((4, 40, 50), np.nan)
    w, smooth = K.atrous_decompose_lo(img, 3, w=stack[:3], smooth=stack[3])
    assert w.data_ptr() == stack.data_ptr()
    ref_w, ref_smooth = K.atrous_decompose_lo(img, 3)
    assert torch.equal(stack[:3], ref_w) and torch.equal(stack[3], ref_smooth)


@pytest.mark.parametrize("n_scales", [2, 5, 9, 11])
@pytest.mark.parametrize("shape", [(64, 64), (37, 91)])
def test_decompose_matches_jax(n_scales, shape):
    """Every scale through the plain B3, up to 11 of them; 2e-6."""
    img = np.random.default_rng(n_scales).standard_normal(shape)
    img = img.astype(np.float32)
    got = n(T.decompose(t(img), n_scales))
    ref = n(J.decompose(jnp.asarray(img), n_scales))
    assert got.shape == ref.shape == (n_scales + 1, *shape)
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_decompose_batched_layout():
    imgs = np.random.default_rng(6).standard_normal((3, 48, 40))
    imgs = imgs.astype(np.float32)
    got = T.decompose(t(imgs), 4)
    assert got.shape == (5, 3, 48, 40)
    for b in range(3):
        assert torch.equal(got[:, b], T.decompose(t(imgs[b]), 4))


@pytest.mark.parametrize("include_largest", [False, True])
def test_recompose_and_mask_match_jax(field, include_largest):
    n_scales = 4
    coeffs = J.decompose(jnp.asarray(field), n_scales)
    mask = np.random.default_rng(7).uniform(size=(n_scales, 64, 64)) > 0.4
    jm = J.apply_mask(coeffs, jnp.asarray(mask))
    tm = T.apply_mask(t(n(coeffs)), t(mask))
    np.testing.assert_array_equal(n(tm), n(jm))
    for source_j, source_t in ((coeffs, t(n(coeffs))), (jm, tm)):
        np.testing.assert_allclose(
            n(T.recompose(source_t, n_scales, include_largest)),
            n(J.recompose(source_j, n_scales, include_largest)),
            atol=2e-6,
        )


# ---------------------------------------------------------------------------
# Statistics and selection
# ---------------------------------------------------------------------------


def test_mad_sigma_batched_bit_equal_to_jax():
    rng = np.random.default_rng(8)
    for shape in ((4, 64, 80), (3, 17, 31), (2, 1, 9)):
        planes = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(
            n(tnoise.mad_sigma_batched(t(planes))),
            n(jnoise.mad_sigma_batched(jnp.asarray(planes))),
        )


@pytest.mark.parametrize("allow_negative", [True, False])
def test_scale_peak_stats_matches_jax(field, allow_negative):
    coeffs = n(J.decompose(jnp.asarray(field), 3))[:3]
    coeffs[1, 5, 7] = coeffs[1, 50, 9] = 40.0  # a tie: the first index wins
    window = np.zeros((64, 64), bool)
    window[4:-4, 4:-4] = True
    jv, jx, jy = J.scale_peak_stats(jnp.asarray(coeffs), jnp.asarray(window),
                                    allow_negative)
    tv, tx, ty = T.scale_peak_stats(t(coeffs), t(window), allow_negative)
    np.testing.assert_array_equal(n(tv), n(jv))
    np.testing.assert_array_equal(n(tx), n(jx))
    np.testing.assert_array_equal(n(ty), n(jy))


def test_structure_stats_matches_jax(field):
    """The JAX package's test_structure_stats_matches_parts, against the
    JAX function: coefficients to 2e-6, sigma, value and signed value to
    1e-6 relative, positions exact."""
    window = np.zeros((64, 64), bool)
    window[4:-4, 4:-4] = True
    jc, js = J.structure_stats(jnp.asarray(field), jnp.asarray(window), 3,
                               True)
    tc, ts = T.structure_stats(t(field), t(window), 3, True)
    np.testing.assert_allclose(n(tc), n(jc), atol=2e-6)
    np.testing.assert_array_equal(n(ts)[2:4], n(js)[2:4])
    np.testing.assert_allclose(n(ts), n(js), rtol=1e-6)


def test_structure_stats_row_sampled_mad():
    """At 2048 rows and more the sigma comes from every 4th row, as in the
    JAX package (``ops/iuwt.py:327-331``)."""
    img = np.random.default_rng(9).standard_normal((2048, 24))
    img = img.astype(np.float32)
    window = np.ones((2048, 24), bool)
    coeffs, stats = T.structure_stats(t(img), t(window), 2, True)
    sampled = tnoise.mad_sigma_batched(coeffs[:2, ::4, :])
    assert torch.equal(stats[0], sampled)
    _, jstats = J.structure_stats(jnp.asarray(img), jnp.asarray(window), 2,
                                  True)
    np.testing.assert_allclose(n(stats)[0], n(jstats)[0], rtol=1e-6)


def test_psf_response_stats_matches_jax():
    psf = delta_psf(64, 64)
    psf[31:34, 32] += 0.3
    np.testing.assert_allclose(
        n(T.psf_response_stats(t(psf), 3)),
        n(J.psf_response_stats(jnp.asarray(psf), 3)),
        rtol=1e-5, atol=1e-7,
    )


@pytest.mark.parametrize("min_scale", [0, 1])
def test_select_structures_matches_jax(field, min_scale):
    coeffs = J.decompose(jnp.asarray(field), 3)
    window = np.ones((64, 64), bool)
    window[:, :10] = False
    for thr in ((0.05, 0.1, 0.08), (-0.05, -0.1, -0.08)):
        jm, jcount = J.select_structures(
            coeffs, jnp.asarray(thr, jnp.float32), jnp.asarray(window),
            jnp.int32(min_scale))
        tm, tcount = T.select_structures(
            t(n(coeffs)), t(np.asarray(thr, np.float32)), t(window),
            min_scale)
        np.testing.assert_array_equal(n(tm), n(jm))
        assert int(tcount) == int(jcount)


def test_bounding_box_matches_jax(field):
    for img in (field, np.zeros((30, 40), np.float32)):
        np.testing.assert_array_equal(
            n(T.bounding_box(t(img))), n(J.bounding_box(jnp.asarray(img))))


def test_masked_recompose_bbox_and_dirty(field):
    n_scales = 2
    coeffs = J.decompose(jnp.asarray(field), n_scales)
    mask = np.zeros((n_scales, 64, 64), bool)
    mask[:, 18:23, 28:33] = True
    np.testing.assert_array_equal(
        n(T.masked_recompose_bbox(t(n(coeffs)), t(mask), n_scales)),
        n(J.masked_recompose_bbox(coeffs, jnp.asarray(mask), n_scales)),
    )
    jmds, jmd = J.masked_dirty_of(jnp.asarray(field), jnp.asarray(mask),
                                  n_scales)
    tmds, tmd = T.masked_dirty_of(t(field), t(mask), n_scales)
    np.testing.assert_allclose(n(tmds), n(jmds), atol=2e-6)
    np.testing.assert_allclose(n(tmd), n(jmd), atol=2e-6)


@pytest.mark.parametrize("min_scale", [0, 1])
@pytest.mark.parametrize("allow_negative", [True, False])
def test_structure_stats_select_matches_jax(field, min_scale, allow_negative):
    """The one-read front half: blob equal within 1e-6 relative (counts,
    boxes and the selected scale exact), mask exact."""
    n_scales = 3
    window = np.zeros((64, 64), bool)
    window[3:-3, 3:-3] = True
    select = window.copy()
    select[:, 50:] = False
    psf_rms = np.asarray([0.3, 0.2, 0.1], np.float32)
    args = (psf_rms, np.float32(1.3), 4.0, 0.01, 0.75)
    jc, jm, jb = J.structure_stats_select(
        jnp.asarray(field), jnp.asarray(window), jnp.asarray(select),
        jnp.asarray(psf_rms), *(jnp.float32(a) for a in args[1:]),
        jnp.int32(min_scale), n_scales, allow_negative)
    tc, tm, tb, tthr = T.structure_stats_select(
        t(field), t(window), t(select), t(psf_rms), *args[1:], min_scale,
        n_scales, allow_negative)
    np.testing.assert_array_equal(n(tm), n(jm))
    np.testing.assert_array_equal(n(tb)[5 * n_scales:-1],
                                  n(jb)[5 * n_scales:-1])
    np.testing.assert_allclose(n(tb), n(jb), rtol=1e-6)
    assert n(tb)[-2] >= min_scale
    # The thresholds returned for the trimmed re-selection are the ones the
    # JAX package's engine computes on the host.
    stats = n(jb)[: 5 * n_scales].reshape(5, n_scales)
    host = stats[0] * (4.0 * 4.0 / 5.0)
    host = np.maximum(host, 0.75 * abs(float(n(jb)[-1])))
    if float(n(jb)[-1]) < 0.0:
        host = -host
    np.testing.assert_allclose(n(tthr), host, rtol=1e-6)


# ---------------------------------------------------------------------------
# FFT convolution, the CG solve, the guard and the component fit
# ---------------------------------------------------------------------------


def test_prefft_convolution_matches_jax(field):
    kernel = np.random.default_rng(10).standard_normal((64, 64))
    kernel = kernel.astype(np.float32)
    got = tconv.convolve_same_prefft(t(field),
                                     tconv.prepare_kernel_fft(t(kernel)))
    ref = jconv.convolve_same_prefft(jnp.asarray(field),
                                     jconv.prepare_kernel_fft(
                                         jnp.asarray(kernel)))
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-5, atol=2e-5)


def _cg_problem(field, n_scales):
    psf = delta_psf(64, 64)
    psf[31:34, 31:34] += np.float32(0.2)
    mask = np.zeros((n_scales, 64, 64), bool)
    mask[:, 12:30, 22:40] = True
    jmds, jmd = J.masked_dirty_of(jnp.asarray(field), jnp.asarray(mask),
                                  n_scales)
    return psf, mask, jmds, jmd


@pytest.mark.parametrize("max_iterations", [3, 20])
def test_conjugate_gradient_matches_jax(field, max_iterations):
    n_scales = 2
    psf, mask, jmds, jmd = _cg_problem(field, n_scales)
    jmodel, jstatus = J.conjugate_gradient(jmds, jnp.asarray(mask), jmd,
                                           jnp.asarray(psf), n_scales,
                                           max_iterations)
    tmodel, tstatus = T.conjugate_gradient(t(n(jmds)), t(mask), t(n(jmd)),
                                           t(psf), n_scales, max_iterations)
    assert n(tstatus)[0] == n(jstatus)[0]
    np.testing.assert_allclose(n(tstatus)[1], n(jstatus)[1], rtol=1e-4)
    scale = np.abs(n(jmodel)).max()
    np.testing.assert_allclose(n(tmodel), n(jmodel), atol=1e-4 * scale)


def test_conjugate_gradient_solves_delta_psf(field):
    """The JAX package's own CG test, on the port: with a delta PSF and a
    full mask, CG reproduces the masked dirty image."""
    n_scales = 2
    mask = torch.ones((n_scales, 64, 64), dtype=torch.bool)
    scales = T.apply_mask(T.decompose(t(field), n_scales), mask)
    masked_dirty = T.recompose(scales, n_scales, False)
    model, status = T.conjugate_gradient(scales, mask, masked_dirty,
                                         t(delta_psf(64, 64)), n_scales)
    assert bool(status[0])
    err = float((model - masked_dirty).abs().max())
    assert err < 5e-2 * float(masked_dirty.abs().max())


def test_rms_guard_and_guarded_cg_match_jax(field):
    n_scales = 2
    psf, mask, jmds, jmd = _cg_problem(field, n_scales)
    np.testing.assert_allclose(
        n(T.rms_guard(t(field), t(field), t(psf), 0.5)),
        n(J.rms_guard(jnp.asarray(field), jnp.asarray(field),
                      jnp.asarray(psf), jnp.float32(0.5))),
        rtol=1e-5,
    )
    _, jstatus = J.conjugate_gradient_guarded(
        jmds, jnp.asarray(mask), jmd, jnp.asarray(field), jnp.asarray(psf),
        jnp.float32(0.1), n_scales)
    _, tstatus = T.conjugate_gradient_guarded(
        t(n(jmds)), t(mask), t(n(jmd)), t(field), t(psf), 0.1, n_scales)
    assert tstatus.shape == (4,) and n(tstatus)[0] == n(jstatus)[0]
    np.testing.assert_allclose(n(tstatus), n(jstatus), rtol=1e-4)


def test_component_fit_ratio_recovers_scale_factor(field):
    """A model that is exactly half the dirty structure fits factor 2, as
    in the JAX package's test: the batched fit over one component whose box
    is the whole image, against the JAX package's one-component fit; sums
    within 1e-5."""
    n_scales = 2
    psf = delta_psf(64, 64)
    model = np.zeros((64, 64), np.float32)
    model[20, 30] = 1.0
    mask = np.ones((n_scales, 64, 64), bool)
    area = np.zeros((64, 64), bool)
    area[15:26, 25:36] = True
    _, masked_dirty = T.masked_dirty_of(t(2.0 * model), t(mask), n_scales)
    sums = n(T.component_fit_ratio_batched(
        t(mask), t(model), masked_dirty, t(psf), t(area[None]), [0], [0],
        n_scales, 64, 64))[0]
    assert sums[1] / sums[0] == pytest.approx(2.0, rel=1e-4)
    ref = J.component_fit_ratio(jnp.asarray(mask), jnp.asarray(model),
                                jnp.asarray(n(masked_dirty)),
                                jnp.asarray(psf), jnp.asarray(area), n_scales)
    np.testing.assert_allclose(sums, n(ref), rtol=1e-5)


def test_component_fit_ratio_batched_matches_jax(field):
    """Three components in one 32x32 bucket, against the JAX package's
    lax.map; 1e-5 relative."""
    n_scales = 2
    rng = np.random.default_rng(11)
    model = np.where(np.abs(field) > 0.2, field, 0.0).astype(np.float32)
    masked_dirty = rng.standard_normal((64, 64)).astype(np.float32)
    mask = rng.uniform(size=(n_scales, 64, 64)) > 0.3
    psf = delta_psf(32, 32)
    psf[15:18, 15:18] += np.float32(0.3)
    areas = rng.uniform(size=(3, 32, 32)) > 0.5
    y1s, x1s = [0, 10, 32], [5, 32, 0]
    ref = J.component_fit_ratio_batched(
        jnp.asarray(mask), jnp.asarray(model), jnp.asarray(masked_dirty),
        jnp.asarray(psf), jnp.asarray(areas), jnp.asarray(y1s, jnp.int32),
        jnp.asarray(x1s, jnp.int32), n_scales, 32, 32)
    got = T.component_fit_ratio_batched(
        t(mask), t(model), t(masked_dirty), t(psf), t(areas), y1s, x1s,
        n_scales, 32, 32)
    assert got.shape == (3, 2)
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Boxes, scale counts, the integrated PSF
# ---------------------------------------------------------------------------


def test_box_helpers_match_jax(field):
    coeffs = J.decompose(jnp.asarray(field), 2)
    np.testing.assert_array_equal(
        n(T.trim_coeffs_box(t(n(coeffs)), 8, 12, 2, 16, 20)),
        n(J.trim_coeffs_box(coeffs, jnp.int32(8), jnp.int32(12), 2, 16, 20)),
    )
    small = np.arange(40, dtype=np.float32).reshape(2, 4, 5)
    np.testing.assert_array_equal(
        n(T.embed_box3_zeros(t(small), 3, 6, 10, 12)),
        n(J.embed_box3_zeros(jnp.asarray(small), jnp.int32(3), jnp.int32(6),
                             10, 12)),
    )
    np.testing.assert_array_equal(
        n(T.slice_box2(t(field), 5, 7, 9, 11)),
        n(J.slice_box2(jnp.asarray(field), 5, 7, 9, 11)),
    )
    np.testing.assert_array_equal(
        n(T.slice_box3(t(small), 1, 2, 3, 3)),
        n(J.slice_box3(jnp.asarray(small), 1, 2, 3, 3)),
    )
    np.testing.assert_array_equal(
        n(T.expand_single_plane(t(field), 3)),
        n(J.expand_single_plane(jnp.asarray(field), 3)),
    )
    for dim in (64, 100, 128, 4096, 5000):
        assert T.end_scale(dim) == J.end_scale(dim)
    for s in range(2, 10):
        assert T.min_image_dimension(s) == J.min_image_dimension(s)


def test_adjust_box_matches_jax():
    """The power-of-two box growth is carried from the JAX package as is."""
    rng = np.random.default_rng(12)
    for _ in range(200):
        width, height = (int(v) for v in rng.integers(130, 1200, 2))
        x1, y1 = int(rng.integers(0, width - 2)), int(rng.integers(0, height - 2))
        x2 = int(rng.integers(x1 + 1, width))
        y2 = int(rng.integers(y1 + 1, height))
        scale = int(rng.integers(1, 6))
        assert _IuwtEngine._adjust_box(x1, y1, x2, y2, width, height, scale) \
            == JaxEngine._adjust_box(x1, y1, x2, y2, width, height, scale)


def test_integrated_psf_matches_jax():
    psfs = np.random.default_rng(13).standard_normal((3, 16, 20))
    psfs = psfs.astype(np.float32)
    jmeta = JaxCubeMeta(3, 1, (1.0, 0.0, 2.5), (True,), 1.0, False,
                        (1e8, 1.1e8, 1.2e8))
    ref = jax_integrated_psf(jnp.asarray(psfs), jmeta)
    got = get_integrated_psf(t(psfs), cube_meta_from_reference(jmeta))
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Radler.perform with IUWT through both packages
# ---------------------------------------------------------------------------

PIXEL_SCALE = 1.0 / 60.0 * (np.pi / 180.0)


def gaussian_psf(size, sigma=2.0):
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    return np.exp(-r2 / (2 * sigma**2)).astype(np.float32)


def diffuse_sky(size):
    yy, xx = np.mgrid[0:size, 0:size]
    return np.exp(
        -((yy - 60.0) ** 2 + (xx - 70.0) ** 2) / (2 * 4.0**2)
    ).astype(np.float32)


def iuwt_settings(size, iterations):
    s = jrd.Settings()
    s.algorithm_type = jrd.AlgorithmType.IUWT
    s.trimmed_image_width = s.trimmed_image_height = size
    s.pixel_scale.x = s.pixel_scale.y = PIXEL_SCALE
    s.minor_iteration_count = iterations
    return s


def perform_both(settings, psf, residual, **kwargs):
    """One perform of each package on copies of the same arrays; returns
    ((again, iterations, residual, model), ...) for JAX, then the port."""
    out = []
    for package, s, device in (
        (jrd, settings, {}),
        (rd, settings_from_reference(settings), {"device": "cpu"}),
    ):
        res = residual.copy()
        mod = np.zeros_like(res)
        r = package.Radler(s, psf, res, mod, 0.0, **kwargs, **device)
        again = r.perform(0)
        out.append((again, r.iteration_number, res, mod))
    return out


def rms(a, axis=None):
    return np.sqrt((a.astype(np.float64) ** 2).mean(axis=axis))


# (iterations, max |residual difference|, residual rms relative difference).
# The JAX package's own IUWT perform on this problem is not reproducible in
# its last iterations, where the peak nears the noise: from run to run of
# the same program, and with the cores XLA may use, its final residual rms
# at 50 iterations was 0.016935, 0.016941, 0.016948 or 0.017034 (5.8e-3
# apart, relative), and two of its runs differed by up to 8.8e-3 in a
# residual pixel (scripts/iuwt_jax_spread.py).  The port's CPU run lay
# within 7.8e-3 in a pixel and 5.9e-3 in rms of every one of those runs.
# So at 50 iterations, the JAX test's own setting, the port is held to just
# above the JAX package's own spread, 9e-3 absolute and 7e-3 relative; at
# 40, before it sets in (JAX runs within 3e-8 of each other, the port
# within 2.2e-6), to 5e-3 absolute and 1e-3 relative.
DIFFUSE_CASES = [(40, 5e-3, 1e-3), (50, 9e-3, 7e-3)]


@pytest.mark.parametrize("case", DIFFUSE_CASES, ids=lambda c: f"{c[0]}it")
def test_iuwt_diffuse_source_parity_with_jax(case):
    """``test_iuwt_diffuse_source`` (``tests/test_algorithms.py``) through
    both packages: equal iteration counts and ``perform()`` results, the
    JAX test's accuracy gates on the port, the model flux within 1e-3
    relative and the residual within the case's tolerances."""
    iterations, max_diff, rms_rel = case
    size = 128
    psf = gaussian_psf(size)
    sky = diffuse_sky(size)
    residual = np.asarray(
        jconv.padded_convolve(jnp.asarray(sky), jnp.asarray(psf))
    ).astype(np.float32)
    rng = np.random.default_rng(0)
    residual += rng.normal(scale=1e-3, size=residual.shape).astype(np.float32)
    jax_out, port_out = perform_both(iuwt_settings(size, iterations), psf,
                                     residual)
    assert port_out[:2] == jax_out[:2]
    assert port_out[1] == iterations
    final_res, model = port_out[2], port_out[3]
    if iterations == 50:
        assert rms(final_res) <= 0.25 * rms(residual)
        assert np.abs(final_res).max() <= 0.1 * np.abs(residual).max()
        assert abs(model.sum() - sky.sum()) < 0.2 * sky.sum()
    assert np.abs(final_res - jax_out[2]).max() <= max_diff
    assert rms(final_res) == pytest.approx(rms(jax_out[2]), rel=rms_rel)
    assert model.sum() == pytest.approx(jax_out[3].sum(), rel=1e-3)


def test_iuwt_multichannel_flux_refit_parity_with_jax():
    """``test_iuwt_multichannel_flux_refit`` through both packages: the
    per-image flux refit (host labelling, batched component fits)."""
    size = 128
    rng = np.random.default_rng(1)
    psf = gaussian_psf(size)
    conv = np.asarray(
        jconv.padded_convolve(jnp.asarray(diffuse_sky(size)),
                              jnp.asarray(psf))
    ).astype(np.float32)
    scales = (1.0, 1.6)
    residual = np.stack([conv * s for s in scales])
    residual += rng.normal(scale=1e-3, size=residual.shape).astype(np.float32)
    freqs = np.array([[1.0e8, 1.1e8], [1.2e8, 1.3e8]])
    jax_out, port_out = perform_both(iuwt_settings(size, 50),
                                     np.stack([psf, psf]), residual,
                                     frequencies=freqs)
    assert port_out[:2] == jax_out[:2]
    final_res, model = port_out[2], port_out[3]
    assert (rms(final_res, (1, 2)) <= 0.3 * rms(residual, (1, 2))).all()
    flux = model.sum(axis=(1, 2))
    assert flux[1] / flux[0] == pytest.approx(scales[1] / scales[0], rel=0.1)
    jflux = jax_out[3].sum(axis=(1, 2))
    assert flux[1] / flux[0] == pytest.approx(jflux[1] / jflux[0], rel=1e-3)
    np.testing.assert_allclose(flux, jflux, rtol=1e-3)
    assert np.abs(final_res - jax_out[2]).max() <= 5e-3
    np.testing.assert_allclose(rms(final_res, (1, 2)),
                               rms(jax_out[2], (1, 2)), rtol=1e-3)


@pytest.mark.parametrize("variant", ["mask", "border", "no_negatives"])
def test_iuwt_mask_border_negatives_parity_with_jax(variant, tmp_path):
    """A FITS clean mask (the search and selection windows, cut to the
    trimmed box), a clean border, and positive components only, with a
    negative blob in the residual; 30 structure iterations, within 5e-3
    absolute and 1e-3 relative as the 40-iteration diffuse case."""
    from radler_tpu_torch.utils.fits import write_fits_image

    size = 128
    psf = gaussian_psf(size)
    yy, xx = np.mgrid[0:size, 0:size]
    negative = np.exp(-((yy - 90.0) ** 2 + (xx - 35.0) ** 2) / 18.0)
    sky = diffuse_sky(size) - 0.6 * negative.astype(np.float32)
    residual = np.asarray(
        jconv.padded_convolve(jnp.asarray(sky), jnp.asarray(psf))
    ).astype(np.float32)
    rng = np.random.default_rng(2)
    residual += rng.normal(scale=1e-3, size=residual.shape).astype(np.float32)
    s = iuwt_settings(size, 30)
    if variant == "mask":
        mask = np.zeros((size, size), np.float32)
        mask[20:110, 30:100] = 1.0
        s.fits_mask = str(tmp_path / "mask.fits")
        write_fits_image(s.fits_mask, mask)
    elif variant == "border":
        s.border_ratio = 0.2
    else:
        s.allow_negative_components = False
    jax_out, port_out = perform_both(s, psf, residual)
    assert port_out[:2] == jax_out[:2]
    assert rms(port_out[2]) < 0.5 * rms(residual)
    assert np.abs(port_out[2] - jax_out[2]).max() <= 5e-3
    assert rms(port_out[2]) == pytest.approx(rms(jax_out[2]), rel=1e-3)
    assert port_out[3].sum() == pytest.approx(jax_out[3].sum(), rel=1e-3)


def test_iuwt_tensor_inputs_and_component_list():
    """CPU tensors keep their device; the component list counts the
    model's non-zero pixels."""
    size = 64
    psf = gaussian_psf(size)
    sky = np.zeros((size, size), np.float32)
    sky[30:34, 28:33] = 1.0
    residual = n(tconv.convolve_same(t(sky), t(psf)))
    s = settings_from_reference(iuwt_settings(size, 10))
    res = t(residual).clone()
    r = rd.Radler(s, t(psf), res, torch.zeros_like(res), 0.0)
    r.perform(0)
    front = r._table.front
    out = front.residual_accessor.array
    assert out.device == res.device and rms(n(out)) < 0.5 * rms(residual)
    model = front.model_accessor.array
    assert r.get_component_list().component_count(0) == int((model != 0).sum())


def test_numpy_radler_without_device_runs_on_the_card():
    """NumPy images with no ``device`` resolve to the card; with no card
    the constructor raises and never falls back to the CPU."""
    s = settings_from_reference(iuwt_settings(32, 5))
    image = gaussian_psf(32)
    if torch.cuda.is_available():
        r = rd.Radler(s, image, image.copy(), np.zeros_like(image), 0.0)
        assert r._device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rd.Radler(s, image, image.copy(), np.zeros_like(image), 0.0)
    r = rd.Radler(s, image, image.copy(), np.zeros_like(image), 0.0,
                  device="cpu")
    assert r._device.type == "cpu"
