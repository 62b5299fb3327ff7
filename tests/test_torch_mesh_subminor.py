"""The port's mesh Clark subminor loop against the JAX package's.

Twins ``tests/test_mesh_subminor.py`` (its chan-only, banded-emulation,
polynomial-fitter and mask cases) for ``radler_tpu_torch``: the same
problem, made with NumPy from a seed, goes through ``Radler.perform`` of
both packages with ``use_device_mesh`` and the default Clark setting.  The
JAX side runs on the 8 virtual CPU devices of ``conftest.py``; the port's
mesh has every shard on the CPU, where B2's tile axis runs its plain
version (:func:`subminor_loop_tiles_reference`).

Tolerances, each with its reason:

* against the JAX mesh run: equal iteration counts and ``perform()``
  results, the residual within 2e-6 absolute and the model within 1e-4 of
  its peak (the ROADMAP's parity contract).  The candidate order differs
  (the JAX program orders a tile's candidates by value, the port by
  raster), which changes a winner only on exact ties of the integrated
  value; these fields have none;
* against the port's own single device (a chan-only mesh has one tile,
  whose candidate set is the image's) and its banded host emulation: the
  JAX test's 3e-5 and 5e-5, since the single-device loop selects at the
  threshold where the mesh selects at 0.99 of it.

The JAX package clamps a tile's candidates at 2^20 (``_capacity_bucket``)
and the port does not: every case here is far under the clamp, and the
JAX test of the overflow has no twin.
"""

import numpy as np
import pytest
import torch
import jax

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu_torch.interop import settings_from_reference
from radler_tpu_torch.kernels import subminor_loop as sl
from radler_tpu_torch.models.subminor import SubMinorLoop, correct_residual
from radler_tpu_torch.parallel import mesh as pm
from radler_tpu_torch.image_set import CubeMeta

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

RESIDUAL_ATOL = 2e-6
MODEL_PEAK_RTOL = 1e-4

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


def make_problem(n_chan, size, seed=7):
    """``test_mesh_subminor.py``'s field: ten point sources under a
    Gaussian PSF, the channels scaled by 1 - 0.08 c."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psf = np.exp(-r2 / 10.0).astype(np.float32)
    psf /= psf.max()
    sky = np.zeros((size, size), np.float32)
    for _ in range(10):
        cy, cx = rng.integers(8, size - 8, 2)
        sky[cy, cx] += rng.uniform(0.5, 2.0)
    conv = np.real(
        np.fft.ifft2(np.fft.fft2(sky) * np.fft.fft2(np.fft.ifftshift(psf)))
    ).astype(np.float32)
    res = np.stack([conv * (1.0 - 0.08 * c) for c in range(n_chan)])
    return np.stack([psf] * n_chan), res


def make_settings(size, n_iter, use_mesh, fit_terms=0):
    s = jrd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.minor_iteration_count = n_iter
    s.minor_loop_gain = 0.2
    s.major_loop_gain = 0.85
    s.generic.use_sub_minor_optimization = True
    if fit_terms:
        s.spectral_fitting.mode = jrd.SpectralFittingMode.POLYNOMIAL
        s.spectral_fitting.terms = fit_terms
    if use_mesh:
        s.parallel.use_device_mesh = True
        s.parallel.n_devices = 8
    return s


def frequencies(n_chan):
    return np.array([[1.0e8 + c * 1e7, 1.1e8 + c * 1e7]
                     for c in range(n_chan)])


def perform(package, jax_settings, psfs, res0, mask=None):
    """One perform; returns (again, iterations, residual, model)."""
    res = res0.copy()
    mdl = np.zeros_like(res)
    if package is jrd:
        r = jrd.Radler(jax_settings, psfs, res, mdl, 0.0,
                       frequencies=frequencies(len(psfs)))
    else:
        r = rd.Radler(settings_from_reference(jax_settings), psfs, res, mdl,
                      0.0, frequencies=frequencies(len(psfs)), device="cpu")
    if mask is not None:
        r._clean_mask = mask
        r._parallel.set_clean_mask(mask)
    again = r.perform(0)
    return again, r.iteration_number, res, mdl


def assert_contract(port, ref):
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    np.testing.assert_allclose(port[2], ref[2], atol=RESIDUAL_ATOL, rtol=0)
    peak = np.abs(ref[3]).max()
    assert peak > 0
    assert np.abs(port[3] - ref[3]).max() <= MODEL_PEAK_RTOL * peak


@needs_8
def test_mesh_subminor_chan_only_matches_jax_and_single_device():
    """chan 8 x tile 1: one tile, whose candidates are the image's."""
    psfs, res0 = make_problem(8, 64)
    mesh_run = perform(rd, make_settings(64, 200, True), psfs, res0)
    assert_contract(mesh_run, perform(jrd, make_settings(64, 200, True),
                                      psfs, res0))
    single = perform(rd, make_settings(64, 200, False), psfs, res0)
    assert mesh_run[1] == single[1]
    np.testing.assert_allclose(mesh_run[2], single[2], atol=3e-5)
    np.testing.assert_allclose(mesh_run[3], single[3], atol=3e-5)


@needs_8
def test_mesh_subminor_tiles_match_jax_and_banded_emulation():
    """chan 2 x tile 4: each tile cleans its own rows to the shared
    threshold; the port's run against the JAX mesh run, and against the
    port's serial subminor loop run per row band with one shared
    correction (the reference's per-sub-image semantics)."""
    n_chan, size, tiles = 2, 64, 4
    psfs, res0 = make_problem(n_chan, size)
    mesh_run = perform(rd, make_settings(size, 200, True), psfs, res0)
    assert_contract(mesh_run, perform(jrd, make_settings(size, 200, True),
                                      psfs, res0))

    meta = CubeMeta(n_channels=n_chan, n_polarizations=1,
                    weights=(1.0,) * n_chan, linked=(True,),
                    polarization_norm_factor=1.0, squared_joins=False,
                    frequencies=tuple(1e8 + 1e7 * c for c in range(n_chan)))
    integ = np.einsum("c,chw->hw", [0.5, 0.5], res0)
    first_threshold = max(np.abs(integ).max() * (1.0 - 0.85), 0.0)
    h_loc = size // tiles
    delta = torch.zeros(res0.shape)
    iters = 0
    for t in range(tiles):
        band = np.zeros((size, size), bool)
        band[t * h_loc:(t + 1) * h_loc] = True
        sub = SubMinorLoop(size, size, size * 2, size * 2)
        sub.set_iteration_info(0, 200)
        sub.set_threshold(first_threshold, first_threshold * 0.99)
        sub.set_gain(0.2)
        sub.mask = band
        diverging, max_value = sub.run(torch.as_tensor(res0), meta,
                                       torch.as_tensor(psfs), None)
        assert not diverging
        if max_value is not None:
            delta += sub.full_model_cube()
            iters += sub.current_iteration
    res_ref = correct_residual(torch.as_tensor(res0), delta,
                               torch.as_tensor(psfs), size * 2, size * 2,
                               n_chan)
    assert mesh_run[1] == iters
    np.testing.assert_allclose(mesh_run[3], delta.numpy(), atol=3e-5)
    np.testing.assert_allclose(mesh_run[2], res_ref.numpy(), atol=3e-5)


@needs_8
def test_mesh_subminor_with_polynomial_fitter():
    """The polynomial fit inside every tile's loop (B2's projection):
    against the JAX mesh run on chan 8 x tile 1 and chan 2 x tile 4, and
    the chan-only mesh against the port's single device."""
    for n_chan in (8, 2):
        psfs, res0 = make_problem(n_chan, 64)
        mesh_run = perform(rd, make_settings(64, 150, True, 2), psfs, res0)
        assert_contract(mesh_run, perform(
            jrd, make_settings(64, 150, True, 2), psfs, res0))
    psfs, res0 = make_problem(8, 64)
    mesh_run = perform(rd, make_settings(64, 150, True, 2), psfs, res0)
    single = perform(rd, make_settings(64, 150, False, 2), psfs, res0)
    assert mesh_run[1] == single[1]
    np.testing.assert_allclose(mesh_run[2], single[2], atol=5e-5)
    np.testing.assert_allclose(mesh_run[3], single[3], atol=5e-5)


@needs_8
def test_mesh_subminor_respects_mask():
    """Only the top half may be cleaned: two of the four tiles select
    nothing, and the run matches the JAX mesh run."""
    n_chan, size = 2, 64
    mask = np.zeros((size, size), bool)
    mask[: size // 2] = True
    psfs, res0 = make_problem(n_chan, size)
    port = perform(rd, make_settings(size, 200, True), psfs, res0, mask)
    assert np.abs(port[3][:, size // 2:, :]).max() == 0.0
    assert np.abs(port[3]).max() > 0.0
    assert_contract(port, perform(jrd, make_settings(size, 200, True), psfs,
                                  res0, mask))


def tile_state(counts, n_images=2, seed=3, size=32):
    """A concatenated candidate state with the given segment lengths, on
    ten sources, as the mesh's selection would hand it to B2."""
    rng = np.random.default_rng(seed)
    total = sum(counts)
    res = rng.normal(scale=0.05, size=(n_images, total)).astype(np.float32)
    res[:, rng.integers(0, total, 10)] += rng.uniform(0.5, 2.0, (n_images, 10))
    xs = rng.integers(0, size, total).astype(np.int32)
    ys = rng.integers(0, size, total).astype(np.int32)
    yy, xx = np.mgrid[0:size, 0:size]
    psf = np.exp(-((yy - size // 2) ** 2 + (xx - size // 2) ** 2) / 6.0)
    psfs = np.stack([psf * (1.0 - 0.1 * c) for c in range(n_images)])
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return (torch.as_tensor(res), torch.as_tensor(xs), torch.as_tensor(ys),
            torch.as_tensor(psfs.astype(np.float32)),
            torch.as_tensor(offsets))


def test_plain_tile_axis_at_one_tile_is_the_plain_loop():
    """T = 1: the plain tile axis is ``subminor_loop_reference``, bit for
    bit, in the state, the model and the result."""
    res, xs, ys, psfs, offsets = tile_state([400])
    params = sl.SubminorParams.make(0.3, 0.2, 5, 300, 4.0, True, False)
    coef = torch.tensor([0.5, 0.5])
    args = dict(n_polarizations=1)
    res_a, mod_a = res.clone(), torch.zeros_like(res)
    out_a = sl.subminor_loop_reference(res_a, mod_a, None, xs, ys, psfs,
                                       coef, None, params, **args)
    res_b, mod_b = res.clone(), torch.zeros_like(res)
    out_b = sl.subminor_loop_tiles(res_b, mod_b, None, xs, ys, psfs, coef,
                                   None, params, offsets, [400], **args)
    assert out_b.shape == (1, 3)
    assert torch.equal(out_b[0], out_a)
    assert torch.equal(res_b, res_a) and torch.equal(mod_b, mod_a)
    assert sl.read_tile_results(out_b)[0] == sl.read_result(out_a)
    assert sl.read_result(out_a)[0] > 5


def test_plain_tile_axis_runs_each_segment_on_its_own():
    """Ragged segments and an empty one: each segment's result and state
    are those of the plain loop run on that segment alone; the empty one
    stops at the start with the value 0."""
    counts = [150, 0, 40, 300]
    res, xs, ys, psfs, offsets = tile_state(counts, seed=5)
    rms = torch.as_tensor(np.random.default_rng(2).uniform(
        0.5, 1.0, sum(counts)).astype(np.float32))
    params = sl.SubminorParams.make(0.25, 0.2, 3, 200, 4.0, True, False)
    coef = torch.tensor([0.5, 0.5])
    res_t, mod_t = res.clone(), torch.zeros_like(res)
    out = sl.subminor_loop_tiles(res_t, mod_t, rms, xs, ys, psfs, coef, None,
                                 params, offsets, counts, n_polarizations=1)
    begin = 0
    for t, count in enumerate(counts):
        cut = slice(begin, begin + count)
        begin += count
        if count == 0:
            assert out[t].tolist() == [3, 0, 0]
            continue
        res_s = res[:, cut].clone()
        mod_s = torch.zeros_like(res_s)
        alone = sl.subminor_loop_reference(
            res_s, mod_s, rms[cut].clone(), xs[cut].clone(), ys[cut].clone(),
            psfs, coef, None, params, n_polarizations=1)
        assert torch.equal(out[t], alone)
        assert torch.equal(res_t[:, cut], res_s)
        assert torch.equal(mod_t[:, cut], mod_s)


@pytest.mark.parametrize("results, expected", [
    ([(7, 0.5, False), (9, -0.75, False)], (11, -0.75, False)),
    ([(7, -0.5, False), (5, 0.5, True), (5, 0.0, False)], (7, 0.5, True)),
    ([(5, 0.0, False)], (5, 0.0, False)),
], ids=["largest-magnitude", "tie-takes-positive", "one-empty-tile"])
def test_reduce_tile_results(results, expected):
    """``mesh.py:650-664``: iterations added over tiles from the shared
    start 5, the signed value of the largest magnitude (+v over -v), any
    divergence."""
    assert pm.reduce_tile_results(results, 5) == expected


def test_mesh_subminor_raises_for_rows_that_do_not_divide():
    meta = CubeMeta(n_channels=1, n_polarizations=1, weights=(1.0,),
                    linked=(True,), polarization_norm_factor=1.0,
                    squared_joins=False, frequencies=(1e8,))
    mesh = pm.Mesh(1, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="do not divide"):
        pm.mesh_subminor_clean(
            mesh, torch.zeros(1, 60, 64), torch.zeros(1, 60, 64), None,
            torch.ones(60, 64, dtype=torch.bool), 0.1,
            sl.SubminorParams.make(0.1, 0.1, 0, 10, 0.0, True, False),
            meta=meta)


@needs_8
def test_no_mesh_subminor_switch_takes_the_hogbom_mesh(monkeypatch):
    """``RADLER_TPU_NO_MESH_SUBMINOR`` sends the Clark setting on a mesh to
    the mesh's Högbom loop in both packages (the JAX package's switch, set
    on both sides): the runs match each other, and the port's matches its
    own Högbom-setting mesh run bit for bit."""
    monkeypatch.setenv("RADLER_TPU_NO_MESH_SUBMINOR", "1")
    psfs, res0 = make_problem(2, 64)
    port = perform(rd, make_settings(64, 200, True), psfs, res0)
    assert_contract(port, perform(jrd, make_settings(64, 200, True), psfs,
                                  res0))
    hogbom = make_settings(64, 200, True)
    hogbom.generic.use_sub_minor_optimization = False
    same = perform(rd, hogbom, psfs, res0)
    assert port[:2] == same[:2]
    np.testing.assert_array_equal(port[2], same[2])
    np.testing.assert_array_equal(port[3], same[3])


@needs_8
def test_mesh_subminor_with_log_polynomial_fitter():
    """A fit that is not a projection (LOG_POLYNOMIAL) runs in the plain
    tile axis on the CPU, against the JAX mesh run on chan 2 x tile 4."""
    psfs, res0 = make_problem(2, 64)
    settings = make_settings(64, 150, True, 2)
    settings.spectral_fitting.mode = jrd.SpectralFittingMode.LOG_POLYNOMIAL
    port = perform(rd, settings, psfs, res0)
    assert_contract(port, perform(jrd, settings, psfs, res0))
