"""Multiscale on the batched facet route, in the port against the JAX
package, on the CPU.

With default settings both packages run multiscale on a facet grid as one
program for all facets (the JAX package vmaps its fused loop; the port
runs :func:`~radler_tpu_torch.models.multiscale_fused.
facet_fused_multiscale_minor_loop`, every facet's dense subminor loop in
B1's facet mode).  The same NumPy-seeded inputs go through both packages'
default (batched) routes.  Helpers and fields are ``test_torch_facets.py``'s
and ``test_torch_facets_serial.py``'s.

Tolerances, with their reasons:

* ``perform``: equal results, per-facet iteration counts and components per
  scale, the residual within 2e-6 of ``max(1, |res|max)`` and the model
  within 1e-4 (the parity contract multiscale is held to since PR 6): the
  two packages take the same float32 decisions, and their FFTs round
  differently;
* the batched route against the port's serial route: the JAX package's own
  3e-5 of ``test_batched_facets.py`` on its field;
* the lockstep loop with ``integration=`` and ``coefficients=`` against
  each facet's ``hogbom_loop``: bit for bit, by construction.

Near-ties: every field here was checked for rounding that decides a pick
(the JAX package's run on its input times float32(1 + 1e-7) agrees with its
own run within the contract; ``print_readings`` below prints the readings).
"""

import numpy as np
import pytest
import torch

import radler_tpu as jrd
from radler_tpu.image_set import CubeMeta as JaxMeta
from radler_tpu.models.multiscale import MultiScaleAlgorithm as JaxMS
from radler_tpu.settings import MultiscaleSettings as JaxMSSettings

import radler_tpu_torch as rd
from radler_tpu_torch.image_set import CubeMeta
from radler_tpu_torch.interop import (
    cube_meta_from_reference,
    settings_from_reference,
)
from radler_tpu_torch.kernels import hogbom_step as hs
from radler_tpu_torch.models import multiscale as ms
from radler_tpu_torch.models.multiscale_fused import _coefficient_basis
from radler_tpu_torch.ops.spectral_fitting import SpectralFitter
from radler_tpu_torch.settings import MultiscaleSettings as MSSettings

from test_torch_facets import (
    NO_BATCH,
    assert_parity,
    convolve,
    dd_table,
    gaussian_psf,
    point_field,
    run,
    settings,
)
from test_torch_facets_serial import (
    NUDGE,
    check_field,
    components,
    iquv_table,
)

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)


def both(s, psf, residual, monkeypatch, **kw):
    """The JAX package's and the port's default-route runs."""
    j = run(jrd, s, psf, residual, monkeypatch, False, **kw)
    t = run(rd, s, psf, residual, monkeypatch, False, **kw)
    assert t[4]._parallel.last_route == "batched"
    return j, t


def contract(j, t):
    """The parity contract, with the residual held to 2e-6 of max(1,
    |res|max)."""
    assert_parity(j, t, atol=2e-6 * max(1.0, float(np.abs(j[2]).max())))


def check_case(seed=7, size=128):
    """``test_torch_facets_serial.py``'s all-scales field at ``size``^2 x 2
    channels x IQUV: config 5's settings (squared joins, a 2-term fit,
    gain 0.1, major gain 0.85, 2x2 facets, 300 iterations) with every
    scale and the source list."""
    psfs, planes = check_field(size, 2, seed)
    s = jrd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.algorithm_type = jrd.AlgorithmType.MULTISCALE
    s.minor_iteration_count = 300
    s.minor_loop_gain, s.major_loop_gain = 0.1, 0.85
    s.squared_joins = True
    s.save_source_list = True
    s.parallel.grid_width = s.parallel.grid_height = 2
    s.spectral_fitting.mode = jrd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    return s, None, planes, {"table": iquv_table(psfs)}


def blob_case():
    """``test_batched_facets.py``'s field: 14 point sources and a blob at
    128^2, three scales, 300 iterations."""
    psf = gaussian_psf(128)
    return (settings("MULTISCALE", 128, iterations=300), psf,
            point_field(128, psf, blob=1.5), {})


def local_rms_case():
    psf = gaussian_psf(128)
    residual = point_field(128, psf, blob=1.5) + np.random.default_rng(
        5).normal(scale=0.01, size=(128, 128)).astype(np.float32)
    s = settings("MULTISCALE", 128, iterations=300, pixel_scale__x=1.0,
                 pixel_scale__y=1.0, local_rms__window=25.0,
                 local_rms__method=jrd.LocalRmsMethod.RMS_WINDOW)
    return s, psf, residual, {"beam_size": 2.0}


def automask_case():
    """Ten sources in noise of 0.01, auto-masking over its two phases, the
    source list, 4 majors."""
    size = 128
    pixel_scale = 1.0 / 60.0 * (np.pi / 180.0)
    psf = gaussian_psf(size)
    residual = point_field(size, psf, n=10) + np.random.default_rng(
        6).normal(scale=0.01, size=(size, size)).astype(np.float32)
    s = settings("MULTISCALE", size, iterations=600, absolute_threshold=0.0,
                 major_loop_gain=1.0, auto_mask_sigma=4.0,
                 save_source_list=True, pixel_scale__x=pixel_scale,
                 pixel_scale__y=pixel_scale)
    return s, psf, residual, {"majors": 4}


FOUR_SOURCES = [(22, 22), (22, 72), (72, 22), (72, 72)]


def four_sources_case():
    """``test_faceted_multiscale.py``'s run at 96^2: four sources in noise,
    auto-masking and the auto threshold over up to 10 majors, the source
    list."""
    size = 96
    rng = np.random.default_rng(2)
    psf = gaussian_psf(size, 1.5)
    sky = np.zeros((size, size), np.float32)
    for y, x in FOUR_SOURCES:
        sky[y, x] = 1.0
    residual = convolve(sky, psf) + rng.normal(
        scale=5e-3, size=(size, size)).astype(np.float32)
    pixel_scale = 1.0 / 60.0 * (np.pi / 180.0)
    s = settings("MULTISCALE", size, iterations=2000, absolute_threshold=0.0,
                 major_loop_gain=1.0, auto_mask_sigma=5.0,
                 auto_threshold_sigma=1.0, save_source_list=True,
                 pixel_scale__x=pixel_scale, pixel_scale__y=pixel_scale)
    return s, psf, residual, {"beam_size": 1.5 * pixel_scale, "majors": 10}


def dd_case():
    """2x2 facets, each with the nearest of two PSF widths."""
    size = 128
    narrow, wide = gaussian_psf(size, 1.8), gaussian_psf(size, 2.6)
    residual = point_field(size, narrow, blob=1.5)
    psfs = [wide if (i % 2 + i // 2) % 2 else narrow for i in range(4)]
    table = lambda p, r, m: dd_table(p, psfs, r, m, size)  # noqa: E731
    return (settings("MULTISCALE", size, iterations=300), None, residual,
            {"table": table})


def forced_case(directory):
    """FORCED_TERMS with a spatially varying spectral index (its term image
    written into ``directory``)."""
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
    path = str(directory / "alpha.fits")
    write_fits_image(path, alpha[None])
    s = settings("MULTISCALE", size, iterations=200,
                 spectral_fitting__mode=jrd.SpectralFittingMode.FORCED_TERMS,
                 spectral_fitting__terms=2,
                 spectral_fitting__forced_filename=path)
    return s, psf, residual, dict(frequencies=freqs, weights=np.ones(C))


def test_default_route_matches_the_jax_default(monkeypatch):
    """On the check field at 128^2 (seed 7) the JAX package's batched and
    serial routes part by 1.16 of max(1, |res|max) and stop the fourth
    facet at 90 and 50 iterations.  The port's default route is the JAX
    package's default (batched) and holds the contract against it, with
    equal components per scale; on the serial route it held the JAX serial
    run instead."""
    s, _, planes, kw = check_case()
    j, t = both(s, None, planes, monkeypatch, **kw)
    contract(j, t)
    cj, ct = components(j[4]), components(t[4])
    assert {k: sorted(v) for k, v in ct.items()} == {
        k: sorted(v) for k, v in cj.items()}
    for k in cj:
        for p in cj[k]:
            np.testing.assert_allclose(ct[k][p], cj[k][p], atol=1e-4)
    js = run(jrd, s, None, planes, monkeypatch, True, **kw)
    assert js[1] != j[1]
    scale = max(1.0, float(np.abs(j[2]).max()))
    assert np.abs(js[2] - j[2]).max() > 1e3 * 2e-6 * scale


def test_batched_facets_match_jax_and_serial(monkeypatch):
    """``test_batched_facets_match_serial``'s field (128^2, 14 point sources
    and a blob, three scales, 300 iterations): the port's batched run
    against the JAX batched run, and against the port's serial run within
    the JAX package's 3e-5."""
    s, psf, residual, _ = blob_case()
    j, t = both(s, psf, residual, monkeypatch)
    contract(j, t)
    ts = run(rd, s, psf, residual, monkeypatch, True)
    assert ts[4]._parallel.last_route == "serial"
    assert ts[0] == t[0]
    np.testing.assert_allclose(t[2], ts[2], atol=3e-5)
    np.testing.assert_allclose(t[3], ts[3], atol=3e-5)


def test_batched_path_engages_twice(monkeypatch):
    """Two batched calls a perform (the peak-only pass and the clean pass),
    each once for every facet, and none with the switch set."""
    calls = []
    orig = ms.MultiScaleAlgorithm.execute_batched_facets

    def spy(self, *a, **k):
        calls.append(a[8])  # find_peak_only
        return orig(self, *a, **k)

    monkeypatch.setattr(ms.MultiScaleAlgorithm, "execute_batched_facets",
                        spy)
    psf = gaussian_psf(64)
    residual = point_field(64, psf, n=4)
    s = settings_from_reference(settings("MULTISCALE", 64, iterations=100))
    r = rd.Radler(s, psf, residual.copy(), np.zeros_like(residual), 0.0,
                  device="cpu")
    r.perform(0)
    assert calls == [True, False]
    assert r._parallel.last_route == "batched"
    monkeypatch.setenv(NO_BATCH, "1")
    r = rd.Radler(s, psf, residual.copy(), np.zeros_like(residual), 0.0,
                  device="cpu")
    r.perform(0)
    assert calls == [True, False]
    assert r._parallel.last_route == "serial"


def test_batched_facets_with_local_rms(monkeypatch):
    """``test_batched_facets_with_local_rms``: the RMS window's factor image
    sliced a facet."""
    s, psf, residual, kw = local_rms_case()
    j, t = both(s, psf, residual, monkeypatch, **kw)
    contract(j, t)
    assert max(t[1]) > 0


def test_batched_automask_and_source_list(monkeypatch):
    """``test_batched_facets_with_automask_and_source_list``'s run (auto-
    masking over its two phases, the source list, 4 majors): the per-scale
    masks merged over the facets and the component list, equal to the JAX
    package's batched run.  That test's field, ten sources and a blob
    without noise, is decided by rounding (the JAX package's own run on
    its input times float32(1 + 1e-7) parts from it by 0.13), and so is it
    with noise of 0.01 (4.4e-6); its ten sources in that noise are not."""
    s, psf, residual, kw = automask_case()
    j, t = both(s, psf, residual, monkeypatch, **kw)
    contract(j, t)
    assert t[4]._auto_mask_is_finished
    masks_j, masks_t = j[4]._parallel._scale_masks, t[4]._parallel._scale_masks
    assert len(masks_t) == len(masks_j) > 1
    assert any(m.any() for m in masks_t)
    for a, b in zip(masks_j, masks_t):
        np.testing.assert_array_equal(b, a)
    cj, ct = components(j[4]), components(t[4])
    assert {k: sorted(v) for k, v in ct.items()} == {
        k: sorted(v) for k, v in cj.items()}
    assert sum(len(v) for v in ct.values()) > 0


def test_faceted_multiscale_automask(monkeypatch):
    """``test_faceted_multiscale.py``'s run (four sources in noise, 2x2,
    auto-masking and the auto threshold over up to 10 majors, the source
    list) at 96^2 on the batched route: the JAX package's batched run, and
    that test's own gates."""
    s, psf, residual, kw = four_sources_case()
    j, t = both(s, psf, residual, monkeypatch, **kw)
    contract(j, t)
    model = t[3]
    for y, x in FOUR_SOURCES:
        assert model[y - 1:y + 2, x - 1:x + 2].sum() == pytest.approx(
            1.0, rel=0.15)
    assert np.abs(t[2]).max() < 0.05
    assert sum(len(v) for v in components(t[4]).values()) >= 4


def test_batched_facets_with_dd_psfs(monkeypatch):
    """``test_batched_facets_with_dd_psfs``: 2x2 facets with the nearest of
    two PSF widths; the banks are made a unique PSF and picked by slot."""
    s, psf, residual, kw = dd_case()
    j, t = both(s, psf, residual, monkeypatch, **kw)
    contract(j, t)
    alg = t[4]._parallel.first_algorithm
    assert alg._fused_banks is not None and set(alg._slot_banks) == {1, 2, 3}


def test_bank_cache_across_slots(monkeypatch):
    """Direction-dependent PSFs keep one bank a slot: the first batched call
    builds one a unique PSF, and a second on the same boxes, with new PSF
    stacks of the same values (the facet layer makes them anew every
    perform), builds none; new values in one slot rebuild that slot's."""
    size, n_facets = 64, 4
    narrow, wide = gaussian_psf(size, 1.8), gaussian_psf(size, 2.6)
    residual = point_field(size, narrow, n=6)
    builds = []
    make = ms.MultiScaleAlgorithm._keep_banks

    def keep(self, slot, kept):
        if kept is not None:
            builds.append(slot)
        return make(self, slot, kept)

    monkeypatch.setattr(ms.MultiScaleAlgorithm, "_keep_banks", keep)
    alg = ms.MultiScaleAlgorithm(MSSettings(), 0.0, 1.0, 1.0)
    alg.max_iterations = 40
    meta = CubeMeta(1, 1, (1.0,), (True,), 1.0, False, (1e8,))
    boxes = [(60, 64), (64, 58), (64, 64), (50, 61)]
    masks = np.ones((n_facets, size, size), dtype=bool)

    def call(psfs, starts):
        res = torch.as_tensor(np.stack([residual[None]] * n_facets))
        return alg.execute_batched_facets(
            res, torch.zeros_like(res), torch.as_tensor(psfs), boxes, masks,
            None, 0.0, starts, False, meta, facet_psf_slot=[0, 1, 1, 0])

    first = call(np.stack([narrow[None], wide[None]]), [0] * n_facets)
    assert sorted(builds) == [0, 1] and min(first[1]) > 0
    call(np.stack([narrow[None], wide[None]]), first[1])
    assert sorted(builds) == [0, 1]
    call(np.stack([narrow[None], 0.5 * wide[None]]), first[1])
    assert sorted(builds) == [0, 1, 1]


def test_batched_forced_terms(monkeypatch, tmp_path):
    """``test_batched_facets_forced_terms[multiscale]``: FORCED_TERMS with a
    spatially varying spectral index, each facet's slice of the term
    images in the batched loop's fit."""
    s, psf, residual, kw = forced_case(tmp_path)
    j, t = both(s, psf, residual, monkeypatch, **kw)
    contract(j, t)


def test_batching_budget_follows_the_jax_rule():
    """Multiscale's batched budget is the JAX package's 9e9 bytes whatever
    the device, with its per-facet estimate: the same route on the CPU, the
    card and in the JAX package (config 5 at 4096^2, a common box of 2390
    x 2372 and ten scales, is over it)."""
    meta = JaxMeta(2, 4, (1.0, 1.0), (True,) * 4, 1.0, True, (1e8, 1.1e8))
    for box_w, box_h, facets, unique, track in (
            (2390, 2372, 4, 1, False), (1024, 1024, 4, 1, True),
            (512, 512, 16, 4, True), (2048, 2048, 4, 1, False),
            (1600, 1600, 4, 2, False), (256, 256, 4, 1, False)):
        jax_alg = JaxMS(JaxMSSettings(), 0.0, 1.0, 1.0, track)
        port = ms.MultiScaleAlgorithm(MSSettings(), 0.0, 1.0, 1.0, track)
        assert port.batched_facets_eligible(
            cube_meta_from_reference(meta), box_w, box_h, facets,
            unique) == jax_alg.batched_facets_eligible(
                meta, box_w, box_h, facets, unique), (box_w, facets)
    assert not port.batched_facets_eligible(
        cube_meta_from_reference(meta), 2390, 2372, 4)
    assert ms.BATCHED_FACETS_BUDGET == 9e9


# ---------------------------------------------------------------------------
# The lockstep loop in linear mode, against each facet's single loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fit", ["coefficients", "fitter", "none"])
def test_facet_loop_linear_bit_equal_to_per_facet_loops(fit):
    """``facet_hogbom_loop`` with ``integration=`` (linear) and, for the
    fused loop's coefficient space, ``coefficients=``, a gain a facet,
    per-facet PSFs, an rms factor and true boxes, against each facet's
    ``hogbom_loop`` with the same arguments: the same bits inside the boxes
    and in the component cubes, the same counts and peaks."""
    n_facets, h, w = 3, 40, 52
    C, P = 2, 2
    meta = CubeMeta(C, P, (1.0, 0.7), (True, True), 1.0, True, (1e8, 1.2e8))
    rng = np.random.default_rng(1)
    res = rng.normal(scale=0.01, size=(n_facets, C * P, h, w)).astype(
        np.float32)
    for f in range(n_facets):
        for _ in range(6):
            y, x = rng.integers(4, h - 10), rng.integers(4, w - 22)
            res[f, :, y, x] += rng.uniform(0.5, 2.0, C * P).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    psf = lambda s_: np.exp(-((yy - h // 2) ** 2 + (xx - w // 2) ** 2)  # noqa
                            / (2 * s_**2)).astype(np.float32)
    psfs = np.stack([np.stack([psf(1.5 + 0.3 * f), psf(1.8 + 0.3 * f)])
                     for f in range(n_facets)])
    boxes = [(h, w - 9), (h - 6, w - 20), (h - 3, w - 30)]
    weight = rng.uniform(0.5, 1.0, (n_facets, h, w)).astype(np.float32)
    rms = rng.uniform(0.8, 1.2, (n_facets, h, w)).astype(np.float32)
    for f, (rows, cols) in enumerate(boxes):
        weight[f, rows:, :] = 0.0
        weight[f, :, cols:] = 0.0
    fitter = SpectralFitter(rd.SpectralFittingMode.POLYNOMIAL, 2,
                            [1e8, 1.2e8], [1.0, 0.7])
    pair = (torch.as_tensor(fitter._fit_matrix, dtype=torch.float32),
            torch.as_tensor(_coefficient_basis(fitter, meta)))
    lin = np.asarray([0.5, 0.25, 0.125, 0.125], np.float32)
    kw = dict(meta=meta, allow_negative=True, integration=("linear", lin),
              fitter=fitter if fit == "fitter" else None,
              coefficients=pair if fit == "coefficients" else None)
    gains = [0.1, 0.05, 0.2]
    thresholds, starts, limits = [0.05, 0.3, 0.05], [0, 5, 0], [200, 60, 200]
    n_comp = 2 * P if fit == "coefficients" else C * P
    t = torch.as_tensor
    peaks = []
    for f in range(n_facets):
        integ = np.tensordot(lin, res[f], axes=1)
        flat = int(np.argmax(np.abs(integ) * weight[f]))
        y, x = divmod(flat, w)
        peaks.append((float(integ[y, x] * rms[f, y, x]), x, y, True))
    batched_res = t(res.copy())
    batched_model = torch.zeros((n_facets, n_comp, h, w))
    out = hs.facet_hogbom_loop(
        batched_res, batched_model, t(psfs), t(weight), t(rms), peaks,
        hs.FacetLoopParams.make(gains, thresholds, [3.0] * n_facets, 4.0,
                                limits, False, "cpu"),
        starts, boxes=torch.tensor(boxes, dtype=torch.int32), **kw)
    for f in range(n_facets):
        r, m = t(res[f].copy()), torch.zeros((n_comp, h, w))
        one = hs.hogbom_loop(
            r, m, t(psfs[f]), t(weight[f]), t(rms[f]), peaks[f],
            hs.LoopParams.make(gains[f], thresholds[f], 3.0, 4.0, limits[f],
                               False),
            starts[f], **kw)
        assert out.results[f] == one
        rows, cols = boxes[f]
        assert torch.equal(batched_res[f, :, :rows, :cols],
                           r[:, :rows, :cols])
        assert torch.equal(batched_model[f], m)
    done = [r.iteration - s for r, s in zip(out.results, starts)]
    assert min(done[0], done[2]) > 10 and done[1] > 0


def print_readings():
    """The readings behind the fields above: for each, both packages'
    per-facet counts, the port against the JAX batched run, the JAX batched
    run against its own serial run and against its run on its input times
    float32(1 + 1e-7), in units of max(1, |res|max)."""
    import pathlib
    import tempfile

    mp = pytest.MonkeyPatch()
    with tempfile.TemporaryDirectory() as directory:
        cases = {"check field, seed 7": check_case(),
                 "blob": blob_case(), "local RMS": local_rms_case(),
                 "auto-masking": automask_case(),
                 "four sources": four_sources_case(),
                 "direction-dependent PSFs": dd_case(),
                 "forced terms": forced_case(pathlib.Path(directory))}
        for name, (s, psf, planes, kw) in cases.items():
            j = run(jrd, s, psf, planes, mp, False, **kw)
            n = run(jrd, s, psf, planes * NUDGE, mp, False, **kw)
            js = run(jrd, s, psf, planes, mp, True, **kw)
            t = run(rd, s, psf, planes, mp, False, **kw)
            scale = max(1.0, float(np.abs(j[2]).max()))
            d = lambda a, b: float(np.abs(a[2] - b[2]).max()) / scale  # noqa
            print(f"{name}: counts port {t[1]}, JAX {j[1]}, JAX serial "
                  f"{js[1]}, JAX nudged {n[1]}; port vs JAX {d(t, j):.3g}, "
                  f"JAX vs JAX serial {d(j, js):.3g}, JAX vs JAX nudged "
                  f"{d(j, n):.3g}", flush=True)


if __name__ == "__main__":
    # From the repo's root, on the CPU:
    #   PYTHONPATH=.:tests python tests/test_torch_batched_ms_facets.py
    import jax

    jax.config.update("jax_platforms", "cpu")
    print_readings()
