"""Faceted deconvolution in the port against the JAX package, on the CPU.

A facet grid splits the image along Dijkstra paths and runs each facet's
minor loop, batched (generic CLEAN: every facet's Högbom loop in lockstep,
B1's facet mode) or serially (IUWT, multiscale, and generic CLEAN with
``RADLER_TPU_NO_BATCHED_FACETS``).  The same NumPy-seeded inputs go through
``radler_tpu`` (JAX on the CPU, its own route by its own rule, or the
serial route where the switch is set on both sides) and
``radler_tpu_torch``; the JAX package runs its Högbom loop in XLA there,
the port the plain versions of its kernels.

Tolerances, with their reasons:

* sub-images: equal boxes, boundary masks and search masks (host code);
* ``perform``: equal results and per-facet iteration counts, the residual
  within 2e-6 absolute, the model peak within 1e-4 relative and the model
  within 1e-4 absolute (the ROADMAP's parity contract); multiscale within
  2e-6 of ``max(1, |res|max)`` as PRs 6 and 7 held it, and within the JAX
  package's own 3e-5 of its batched route, which the port does not take
  for multiscale (ROADMAP queue A, item 6b);
* ``ImageSet``'s facet helpers: exact (slices, products by 0 and 1,
  selections);
* the facet-mode plain B1 against the per-facet single-cube plain B1: bit
  for bit, by construction.

Fields: point sources (the Högbom loop's picks on a smooth blob turn on the
last bit of a subtraction, and XLA contracts multiply-adds where the port
does not), the JAX facet tests' fields elsewhere.  The serial route's
multiscale and IUWT cases, checkpoints and clones are in
``test_torch_facets_serial.py``.
"""

import numpy as np
import pytest
import torch

import radler_tpu as jrd
import radler_tpu.parallel.faceting as jax_faceting
from radler_tpu.image_set import ImageSet as JaxImageSet
from radler_tpu.work_table import (
    LoadAndStoreImageAccessor as JaxLoadStore,
    LoadOnlyImageAccessor as JaxLoadOnly,
    WorkTable as JaxWorkTable,
    WorkTableEntry as JaxEntry,
)

import radler_tpu_torch as rd
from radler_tpu_torch.image_set import ImageSet
from radler_tpu_torch.interop import settings_from_reference
from radler_tpu_torch.kernels import hogbom_step as hs
from radler_tpu_torch.work_table import (
    LoadAndStoreImageAccessor,
    LoadOnlyImageAccessor,
    WorkTable,
    WorkTableEntry,
)

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

NO_BATCH = "RADLER_TPU_NO_BATCHED_FACETS"


def gaussian_psf(size, sigma=2.0):
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2.0 + (xx - size // 2) ** 2.0
    return np.exp(-r2 / (2 * sigma**2)).astype(np.float32)


def convolve(sky, psf):
    return np.real(
        np.fft.ifft2(np.fft.fft2(sky) * np.fft.fft2(np.fft.ifftshift(psf)))
    ).astype(np.float32)


def point_field(size, psf, seed=9, n=14, blob=0.0):
    """``n`` point sources (``test_batched_facets.py``'s sky, optionally
    with its diffuse blob) under ``psf``."""
    rng = np.random.default_rng(seed)
    sky = np.zeros((size, size), np.float32)
    ys = rng.integers(12, size - 12, n)
    xs = rng.integers(12, size - 12, n)
    np.add.at(sky, (ys, xs), rng.uniform(0.5, 2.0, n).astype(np.float32))
    if blob:
        yy, xx = np.mgrid[0:size, 0:size]
        sky += blob * np.exp(
            -((yy - 3 * size // 4) ** 2 + (xx - size // 4) ** 2)
            / (2 * 5.0**2)).astype(np.float32)
    return convolve(sky, psf)


def settings(algorithm, size, grid=2, iterations=2000, **fields):
    s = jrd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.algorithm_type = getattr(jrd.AlgorithmType, algorithm)
    s.minor_iteration_count = iterations
    s.absolute_threshold = 5e-3
    s.major_loop_gain = 0.8
    s.multiscale.max_scales = 3
    s.generic.use_sub_minor_optimization = False
    s.parallel.grid_width = s.parallel.grid_height = grid
    for name, value in fields.items():
        obj = s
        *path, last = name.split("__")
        for part in path:
            obj = getattr(obj, part)
        setattr(obj, last, value)
    return s


def run(package, s, psf, residual, monkeypatch, serial, majors=1,
        table=None, **kwargs):
    """Up to ``majors`` performs of ``package`` (``radler_tpu`` or the port
    on the CPU), while they ask for another; returns (results, per-facet iterations, residual, model, radler,
    the JAX package's sub-images of its last split or the port's)."""
    if serial:
        monkeypatch.setenv(NO_BATCH, "1")
    else:
        monkeypatch.delenv(NO_BATCH, raising=False)
    res = residual.copy()
    model = np.zeros_like(res)
    split = []
    if package is jrd:
        make = jax_faceting.make_sub_images

        def spy(*a, **k):
            split[:] = make(*a, **k)
            return split

        monkeypatch.setattr(jax_faceting, "make_sub_images", spy)
        args = (s,) + ((table(jrd, res, model),) if table else
                       (psf, res, model))
        r = jrd.Radler(*args, **kwargs)
    else:
        s = settings_from_reference(s)
        args = (s,) + ((table(rd, res, model),) if table else
                       (psf, res, model))
        r = rd.Radler(*args, device="cpu", **kwargs)
    again = []
    while len(again) < majors and (not again or again[-1]):
        again.append(r.perform(len(again)))
    monkeypatch.undo()
    if package is rd:
        split = r._parallel.last_sub_images
    iterations = [a.iteration_number for a in r._parallel.algorithms]
    return again, iterations, res, model, r, split


def assert_same_split(jax_split, port_split):
    assert len(port_split) == len(jax_split) > 1
    for a, b in zip(jax_split, port_split):
        assert (b.x, b.y, b.width, b.height) == (a.x, a.y, a.width, a.height)
        np.testing.assert_array_equal(b.boundary_mask, a.boundary_mask)
        np.testing.assert_array_equal(b.mask, a.mask)


def assert_parity(j, t, atol=2e-6):
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert_same_split(j[5], t[5])
    assert np.abs(j[3]).max() > 0
    np.testing.assert_allclose(t[2], j[2], atol=atol)
    np.testing.assert_allclose(np.abs(t[3]).max(), np.abs(j[3]).max(),
                               rtol=1e-4)
    np.testing.assert_allclose(t[3], j[3], atol=1e-4)


# ---------------------------------------------------------------------------
# ImageSet's facet helpers
# ---------------------------------------------------------------------------


def image_sets(n_channels=3, size=(40, 52), seed=0):
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(n_channels, *size)).astype(np.float32)
    sets = []
    for package, table_cls, entry_cls, store, load, kw in (
        (jrd, JaxWorkTable, JaxEntry, JaxLoadStore, JaxLoadOnly, {}),
        (rd, WorkTable, WorkTableEntry, LoadAndStoreImageAccessor,
         LoadOnlyImageAccessor, {"device": "cpu"}),
    ):
        table = table_cls([], n_channels, 0)
        for c in range(n_channels):
            e = entry_cls()
            e.polarization = package.Polarization.STOKES_I
            e.original_channel_index = c
            e.image_weight = 1.0
            e.psf_accessors = [load(planes[c])]
            e.residual_accessor = store(planes[c].copy())
            e.model_accessor = store(planes[c].copy())
            table.add_entry(e)
        cls = JaxImageSet if package is jrd else ImageSet
        image_set = cls.from_table(table, False, set(), size[1], size[0], **kw)
        image_set.load_and_average(True)
        sets.append(image_set)
    return sets


def test_image_set_facet_helpers_match_jax():
    (j, t), (j2, t2) = image_sets(), image_sets(seed=1)
    rng = np.random.default_rng(2)
    box = (5, 7, 37, 30)  # x1, y1, x2, y2
    mask = rng.random((box[3] - box[1], box[2] - box[0])) < 0.5
    np.testing.assert_array_equal(t.trim(*box).data.numpy(),
                                  np.asarray(j.trim(*box).data))
    tm, jm = t.trim_masked(*box, mask), j.trim_masked(*box, mask)
    np.testing.assert_array_equal(tm.data.numpy(), np.asarray(jm.data))
    # The trimmed copy is the set's own: changing it leaves t alone.
    trimmed = t.trim(*box)
    trimmed.data += 1.0
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    src_t, src_j = t2.trim(*box), j2.trim(*box)
    t.copy_masked(src_t, 3, 4, mask)
    j.copy_masked(src_j, 3, 4, mask)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    t.add_sub_image(src_t, 6, 2)
    j.add_sub_image(src_j, 6, 2)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))


# ---------------------------------------------------------------------------
# Faceted perform: each route against the JAX package
# ---------------------------------------------------------------------------

ROUTES = {
    # name: (algorithm, grid, serial, extra settings, port's route)
    "hogbom-batched": ("GENERIC_CLEAN", 2, False, {}, "batched"),
    "clark-batched-3x3": ("GENERIC_CLEAN", 3, False,
                          {"generic__use_sub_minor_optimization": True},
                          "batched"),
    "hogbom-serial": ("GENERIC_CLEAN", 2, True, {}, "serial"),
    "clark-serial-3x3": ("GENERIC_CLEAN", 3, True,
                         {"generic__use_sub_minor_optimization": True},
                         "serial"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_generic_facets_match_jax(route, monkeypatch):
    algorithm, grid, serial, fields, port_route = ROUTES[route]
    psf = gaussian_psf(128)
    residual = point_field(128, psf)
    s = settings(algorithm, 128, grid, **fields)
    j = run(jrd, s, psf, residual, monkeypatch, serial)
    t = run(rd, s, psf, residual, monkeypatch, serial)
    assert t[4]._parallel.last_route == port_route
    assert_parity(j, t)


# ---------------------------------------------------------------------------
# The batched route's options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["GENERIC_CLEAN", "MULTISCALE"])
def test_squared_joins_polynomial_match_jax(algorithm, monkeypatch):
    """Config 5's shape at 96^2: I, Q, U, V x 2 channels, squared joins, a
    2-term polynomial fit, 2x2 facets; generic CLEAN batched and serial,
    multiscale serial (three scales)."""
    size, C = 96, 2
    rng = np.random.default_rng(3)
    psfs = np.stack([gaussian_psf(size, 2.0 + 0.2 * c) for c in range(C)])
    sky = np.zeros((size, size), np.float32)
    ys, xs = rng.integers(10, size - 10, (2, 10))
    np.add.at(sky, (ys, xs), rng.uniform(0.5, 2.0, 10).astype(np.float32))
    pol_flux = {"STOKES_I": 1.0, "STOKES_Q": 0.3, "STOKES_U": -0.2,
                "STOKES_V": 0.05}
    planes, psf_planes = [], []
    for c in range(C):
        for flux in pol_flux.values():
            planes.append(convolve(sky * flux * (1 - 0.1 * c), psfs[c]))
            psf_planes.append(psfs[c])

    def make_table(package, res, model):
        mod = __import__(package.__name__ + ".work_table",
                         fromlist=["WorkTable"])
        tab = mod.WorkTable([], C, 0)
        i = 0
        for c in range(C):
            for pol in pol_flux:
                e = mod.WorkTableEntry()
                e.polarization = getattr(package.Polarization, pol)
                e.original_channel_index = c
                e.image_weight = 1.0
                e.band_start_frequency = 1.0e8 + 1.0e7 * c
                e.band_end_frequency = 1.0e8 + 1.0e7 * (c + 1)
                if pol == "STOKES_I":
                    e.psf_accessors = [
                        mod.LoadOnlyImageAccessor(psf_planes[i])]
                e.residual_accessor = mod.LoadAndStoreImageAccessor(res[i])
                e.model_accessor = mod.LoadAndStoreImageAccessor(model[i])
                tab.add_entry(e)
                i += 1
        return tab

    residual = np.stack(planes)
    s = settings(algorithm, size, iterations=400, squared_joins=True,
                 spectral_fitting__mode=jrd.SpectralFittingMode.POLYNOMIAL,
                 spectral_fitting__terms=2, major_loop_gain=0.85)
    generic = algorithm == "GENERIC_CLEAN"
    for serial in (False, True) if generic else (True,):
        j = run(jrd, s, None, residual, monkeypatch, serial, table=make_table)
        t = run(rd, s, None, residual, monkeypatch, serial, table=make_table)
        assert t[4]._parallel.last_route == ("batched" if generic
                                             and not serial else "serial")
        assert_parity(j, t)


def test_batched_local_rms_matches_jax(monkeypatch):
    psf = gaussian_psf(128)
    residual = point_field(128, psf) + np.random.default_rng(5).normal(
        scale=0.01, size=(128, 128)).astype(np.float32)
    s = settings("GENERIC_CLEAN", 128, pixel_scale__x=1.0,
                 pixel_scale__y=1.0, local_rms__window=25.0,
                 local_rms__method=jrd.LocalRmsMethod.RMS_WINDOW)
    j = run(jrd, s, psf, residual, monkeypatch, False, beam_size=2.0)
    t = run(rd, s, psf, residual, monkeypatch, False, beam_size=2.0)
    assert t[4]._parallel.last_route == "batched"
    assert_parity(j, t)


def test_batched_automask_and_source_list_match_jax(monkeypatch):
    """Auto-masking over its two phases and the source list on the batched
    route (generic CLEAN: the phase-2 clean mask, every model pixel a
    component)."""
    psf = gaussian_psf(128)
    residual = point_field(128, psf) + np.random.default_rng(6).normal(
        scale=0.01, size=(128, 128)).astype(np.float32)
    s = settings("GENERIC_CLEAN", 128, iterations=600, auto_mask_sigma=4.0,
                 absolute_threshold=0.0, save_source_list=True)
    j = run(jrd, s, psf, residual, monkeypatch, False, majors=5)
    t = run(rd, s, psf, residual, monkeypatch, False, majors=5)
    assert t[4]._auto_mask_is_finished and t[4]._auto_mask is not None
    assert_parity(j, t)
    cj, ct = j[4].get_component_list(), t[4].get_component_list()
    assert ct.component_count(0) == cj.component_count(0) > 0


def dd_table(package, psfs_by_facet, residual, model, size):
    mod = __import__(package.__name__ + ".work_table",
                     fromlist=["WorkTable"])
    grid = int(round(len(psfs_by_facet) ** 0.5))
    step = size // grid
    offsets = [mod.PsfOffset(gx * step + step // 2, gy * step + step // 2)
               for gy in range(grid) for gx in range(grid)]
    table = mod.WorkTable(offsets, 1, 1)
    entry = mod.WorkTableEntry()
    entry.polarization = package.Polarization.STOKES_I
    entry.image_weight = 1.0
    entry.psf_accessors = [mod.LoadOnlyImageAccessor(p)
                           for p in psfs_by_facet]
    entry.residual_accessor = mod.LoadAndStoreImageAccessor(residual)
    entry.model_accessor = mod.LoadAndStoreImageAccessor(model)
    table.add_entry(entry)
    return table


@pytest.mark.parametrize("serial", [False, True], ids=["batched", "serial"])
def test_direction_dependent_psfs_match_jax(serial, monkeypatch):
    """2x2 facets, each with the nearest of two PSF widths."""
    size = 128
    narrow, wide = gaussian_psf(size, 1.8), gaussian_psf(size, 2.6)
    residual = point_field(size, narrow)
    psfs = [wide if (i % 2 + i // 2) % 2 else narrow for i in range(4)]
    s = settings("GENERIC_CLEAN", size)
    table = lambda p, r, m: dd_table(p, psfs, r, m, size)  # noqa: E731
    j = run(jrd, s, None, residual, monkeypatch, serial, table=table)
    t = run(rd, s, None, residual, monkeypatch, serial, table=table)
    assert_parity(j, t)


def test_batched_forced_terms_match_jax(monkeypatch, tmp_path):
    """FORCED_TERMS fitting with a spatially varying spectral index: each
    facet's slice of the term images rides the batched loop."""
    from radler_tpu_torch.utils.fits import write_fits_image

    size, C = 128, 3
    psf1 = gaussian_psf(size)
    psf = np.stack([psf1] * C)
    freqs = np.array([[1.0e8, 1.1e8], [1.2e8, 1.3e8], [1.4e8, 1.5e8]])
    centers = freqs.mean(axis=1)
    yy, xx = np.mgrid[0:size, 0:size]
    alpha = (-1.0 + 1.2 * (xx / size) + 0.5 * (yy / size)).astype(np.float32)
    rng = np.random.default_rng(4)
    ys, xs = rng.integers(12, size - 12, (2, 8))
    amps = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    residual = np.zeros((C, size, size), np.float32)
    for c in range(C):
        cube = np.zeros((size, size), np.float32)
        np.add.at(cube, (ys, xs),
                  amps * (centers[c] / centers.mean()) ** alpha[ys, xs])
        residual[c] = convolve(cube, psf1)
    path = str(tmp_path / "alpha.fits")
    write_fits_image(path, alpha[None])
    s = settings("GENERIC_CLEAN", size, iterations=200,
                 spectral_fitting__mode=jrd.SpectralFittingMode.FORCED_TERMS,
                 spectral_fitting__terms=2,
                 spectral_fitting__forced_filename=path)
    kw = dict(frequencies=freqs, weights=np.ones(C))
    j = run(jrd, s, psf, residual, monkeypatch, False, **kw)
    t = run(rd, s, psf, residual, monkeypatch, False, **kw)
    assert t[4]._parallel.last_route == "batched"
    assert_parity(j, t)


def test_batched_route_engages_once_a_phase(monkeypatch):
    """Two batched calls a perform (the peak-only pass and the clean pass),
    and none with the switch set."""
    from radler_tpu_torch.models.generic_clean import GenericClean

    calls = []
    orig = GenericClean.execute_batched_facets

    def spy(self, *a, **k):
        calls.append(a[8])  # find_peak_only
        return orig(self, *a, **k)

    monkeypatch.setattr(GenericClean, "execute_batched_facets", spy)
    psf = gaussian_psf(64)
    residual = point_field(64, psf, n=4)
    s = settings_from_reference(settings("GENERIC_CLEAN", 64))
    rd.Radler(s, psf, residual.copy(), np.zeros_like(residual), 0.0,
              device="cpu").perform(0)
    assert calls == [True, False]
    monkeypatch.setenv(NO_BATCH, "1")
    rd.Radler(s, psf, residual.copy(), np.zeros_like(residual), 0.0,
              device="cpu").perform(0)
    assert calls == [True, False]


# ---------------------------------------------------------------------------
# Divergence and rollback (cpp/test/test_divergence.cc)
# ---------------------------------------------------------------------------

GRID, SUB = 3, 32
BROKEN = 5  # facet [1, 2]


def divergence_run(package, monkeypatch, serial):
    """``test_divergence.py`` on a 3x3 grid of 32^2 facets: a point pair in
    each facet, each facet's own PSF, one of them broken (off-centre peaks
    and no central one)."""
    size = GRID * SUB
    pixel_scale = 1.0 / 60.0 / 60.0 * (np.pi / 180.0)
    good = np.zeros((size, size), np.float32)
    good[size // 2, size // 2] = 1.0
    bad = np.zeros((size, size), np.float32)
    bad[size // 2, size // 2 - 2] = 2.0
    bad[size // 2, size // 2 + 2] = 2.0
    residual = np.zeros((size, size), np.float32)
    for gy in range(GRID):
        for gx in range(GRID):
            x, y = gx * SUB + SUB // 2, gy * SUB + SUB // 2
            residual[y, x] = 5.0
            residual[y, x + 2] = 3.0
    psfs = [bad if i == BROKEN else good for i in range(GRID * GRID)]
    s = settings("GENERIC_CLEAN", size, GRID, iterations=1_000_000,
                 absolute_threshold=1e-6, divergence_limit=4.0,
                 major_loop_gain=1.0, save_source_list=True,
                 pixel_scale__x=pixel_scale, pixel_scale__y=pixel_scale)
    table = lambda p, r, m: dd_table(p, psfs, r, m, size)  # noqa: E731
    return run(package, s, None, residual, monkeypatch, serial, table=table,
               beam_size=pixel_scale)


@pytest.mark.parametrize("serial", [False, True], ids=["batched", "serial"])
def test_divergence_rolls_back_the_broken_facet(serial, monkeypatch):
    t = divergence_run(rd, monkeypatch, serial)
    j = divergence_run(jrd, monkeypatch, serial)
    assert_parity(j, t)
    model, residual = t[3], t[2]
    for gy in range(GRID):
        for gx in range(GRID):
            facet = gy * GRID + gx
            x, y = gx * SUB + SUB // 2, gy * SUB + SUB // 2
            block = np.s_[gy * SUB:(gy + 1) * SUB, gx * SUB:(gx + 1) * SUB]
            sources = np.zeros((SUB, SUB), bool)
            sources[SUB // 2, SUB // 2] = sources[SUB // 2, SUB // 2 + 2] = True
            assert np.isfinite(model[block]).all()
            assert np.isfinite(residual[block]).all()
            if facet == BROKEN:
                assert (np.abs(model[block]) < 1e-5).all()
                assert (residual[block][~sources] < 1e-5).all()
            else:
                np.testing.assert_allclose(model[y, x], 5.0, rtol=1e-3)
                np.testing.assert_allclose(model[y, x + 2], 3.0, rtol=1e-3)
                assert (np.abs(model[block][~sources]) < 1e-5).all()
                assert (residual[block] < 1e-5).all()
    # Exactly two components in each healthy facet.
    components = t[4].get_component_list()
    assert components.component_count(0) == GRID * GRID * 2 - 2


# ---------------------------------------------------------------------------
# The facet-mode plain B1 and the batching budget
# ---------------------------------------------------------------------------


def facet_loop_against_per_facet_loops(shared, boxed):
    """The plain facet-mode loop against each facet's single-cube plain loop
    (``hogbom_loop``): the same bits, iteration counts and peaks; facets
    with different thresholds and starts, one with no peak.  ``boxed``
    gives the lockstep loop each facet's true box (the weight 0 outside
    it): inside the boxes the bits are the single loops', and the padding,
    which the single loops update, is left as it was."""
    from radler_tpu_torch.image_set import CubeMeta
    from radler_tpu_torch.ops.spectral_fitting import SpectralFitter

    n_facets, h, w = 3, 40, 52
    meta = CubeMeta(2, 2, (1.0, 0.7), (True, True), 1.0, True, (1e8, 1.2e8))
    rng = np.random.default_rng(0)
    res = rng.normal(scale=0.01, size=(n_facets, 4, h, w)).astype(np.float32)
    for f in range(n_facets - 1):
        for _ in range(6):
            y, x = rng.integers(4, h - 4), rng.integers(4, w - 4)
            res[f, :, y, x] += rng.uniform(0.5, 2.0, 4).astype(np.float32)
    res[n_facets - 1] = 0.0
    yy, xx = np.mgrid[0:h, 0:w]
    psf = lambda s_: np.exp(-((yy - h // 2) ** 2 + (xx - w // 2) ** 2)  # noqa
                            / (2 * s_**2)).astype(np.float32)
    psfs = np.stack([np.stack([psf(1.5 + 0.3 * f), psf(1.8 + 0.3 * f)])
                     for f in range(n_facets)])
    weight = rng.uniform(0.5, 1.0, (n_facets, h, w)).astype(np.float32)
    weight[:, :, w - 9:] = 0.0
    boxes = [(h, w - 9), (h - 6, w - 20), (h - 3, 1)]
    if boxed:
        for f, (rows, cols) in enumerate(boxes):
            weight[f, rows:, :] = 0.0
            weight[f, :, cols:] = 0.0
    fitter = SpectralFitter(rd.SpectralFittingMode.POLYNOMIAL, 2,
                            [1e8, 1.2e8], [1.0, 0.7])
    thresholds, starts, limits = [0.05, 0.3, 0.05], [0, 5, 0], [200, 60, 200]
    t = torch.as_tensor
    psfs_in = t(psfs[0]) if shared else t(psfs)
    peaks = []
    for f in range(n_facets):
        flat = int(np.argmax(np.abs(res[f, 0]) * weight[f]))
        y, x = divmod(flat, w)
        peaks.append((float(res[f, 0, y, x]), x, y, f != n_facets - 1))
    batched_res, batched_model = t(res.copy()), torch.zeros(res.shape)
    out = hs.facet_hogbom_loop(
        batched_res, batched_model, psfs_in, t(weight), None, peaks,
        hs.FacetLoopParams.make(0.1, thresholds, [3.0] * n_facets, 4.0,
                                limits, False, "cpu"),
        starts, meta=meta, allow_negative=True, fitter=fitter,
        boxes=torch.tensor(boxes, dtype=torch.int32) if boxed else None)
    for f in range(n_facets):
        r, m = t(res[f].copy()), torch.zeros(res[f].shape)
        one = hs.hogbom_loop(
            r, m, psfs_in if shared else psfs_in[f], t(weight[f]), None,
            peaks[f], hs.LoopParams.make(0.1, thresholds[f], 3.0, 4.0,
                                         limits[f], False),
            starts[f], meta=meta, allow_negative=True, fitter=fitter)
        assert out.results[f] == one
        if boxed:
            rows, cols = boxes[f]
            assert torch.equal(batched_res[f, :, :rows, :cols],
                               r[:, :rows, :cols])
            pad = torch.ones((h, w), dtype=torch.bool)
            pad[:rows, :cols] = False
            assert torch.equal(batched_res[f][:, pad], t(res[f])[:, pad])
        else:
            assert torch.equal(batched_res[f], r)
        assert torch.equal(batched_model[f], m)
    done = [r.iteration - s for r, s in zip(out.results, starts)]
    assert done[-1] == 0 and done[0] > 10
    assert out.lockstep >= max(done)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-facet"])
def test_facet_loop_bit_equal_to_per_facet_loops(shared):
    """The lockstep loop over the common box (``facet_loop_against_per_facet
    _loops``)."""
    facet_loop_against_per_facet_loops(shared, boxed=False)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-facet"])
def test_facet_loop_bit_equal_to_per_facet_loops_in_true_boxes(shared):
    """The lockstep loop over each facet's true box, the batched route's
    (``facet_loop_against_per_facet_loops``)."""
    facet_loop_against_per_facet_loops(shared, boxed=True)


def test_batching_budget_follows_the_device():
    """The batched route's budget is the JAX package's 4e9 bytes whatever
    the device, so that both packages take the same route on the CPU and
    on a card (config 5 at 4096^2, whose common box of 2372 x 2390 gives
    an estimate of 4.5e9, runs serially in both)."""
    from radler_tpu.image_set import CubeMeta as JaxMeta
    from radler_tpu.models.generic_clean import GenericClean as JaxClean

    from radler_tpu_torch.interop import cube_meta_from_reference
    from radler_tpu_torch.models import generic_clean as gc

    meta = JaxMeta(2, 4, (1.0, 1.0), (True,) * 4, 1.0, True, (1e8, 1.1e8))
    port = gc.GenericClean()
    for box, facets in ((2560, 4), (2048, 4), (1024, 16), (3000, 9),
                        (2390, 4)):
        assert port.batched_facets_eligible(
            cube_meta_from_reference(meta), box, box,
            facets) == JaxClean().batched_facets_eligible(meta, box, box,
                                                          facets)
    assert not port.batched_facets_eligible(
        cube_meta_from_reference(meta), 2390, 2372, 4)
    assert gc.BATCHED_FACETS_BUDGET == 4e9
