"""The batched facets, IUWT and ASP spread over a mesh's groups, on the CPU.

A group is a position in ``Mesh.devices``, so ``("cpu",) * g`` runs the
code of a mesh over g cards here, every copy between groups included
(``tests/test_torch_mesh_cards.py``).  The JAX package lays these three
workloads over its mesh's devices (``mesh.py:842-886``, ``models/iuwt.py:
107-132``, ``models/asp.py:72-90``); the port runs them there too:

* the batched facets, each group its facets' lockstep loop, are bit-equal
  to one device, and within the JAX mesh tests' 2e-5 of the JAX mesh run;
* B3's plain row-block mode and the spread decompose are bit-equal to the
  whole-image decompose (the taps and their order are the same);
* the slab FFT convolution is not ``rfft2``'s bits: held within 2e-6 of
  the largest |output| (float32 rounding of two passes of 1-D FFTs at
  these sizes; the measured gap is about 3e-7 of it);
* IUWT and ASP over groups against the port's one-device run and the JAX
  package's mesh run: equal iteration counts, the cubes within 2e-5 of
  max(1, |res|max) (the JAX mesh tests' tolerance between a mesh and a
  single device).

Inputs are made with NumPy from a seed.
"""

import types

import numpy as np
import pytest
import torch
import jax

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu.parallel.mesh import facet_axis_spec as jax_facet_axis_spec
from radler_tpu_torch.interop import settings_from_reference
from radler_tpu_torch.kernels import iuwt_atrous as ia
from radler_tpu_torch.models import asp as asp_module
from radler_tpu_torch.models.generic_clean import GenericClean
from radler_tpu_torch.models.multiscale import MultiScaleAlgorithm
from radler_tpu_torch.ops import iuwt as iuwt_ops
from radler_tpu_torch.ops.convolution import convolve_same, prepare_kernel_fft
from radler_tpu_torch.ops.peak_finder import masked_peaks
from radler_tpu_torch.parallel import mesh as pm
from radler_tpu_torch.parallel import rows as pr

from test_mesh_iuwt import _problem as iuwt_problem
from test_torch_asp import FREQS, channel_psfs, convolve, fitted_settings
from test_torch_asp import point_source_case
from test_torch_facets import point_field
from test_torch_iuwt import diffuse_sky, gaussian_psf
from tests.test_batched_facets import _gaussian_psf

torch.set_num_threads(1)

CPU = torch.device("cpu")
MESH_VS_SINGLE = 2e-5
SLAB_RTOL = 2e-6

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


def scaled_max(a, b, ref):
    return np.abs(a - b).max() / max(1.0, float(np.abs(ref).max()))


def on_cards(monkeypatch, cards):
    """``Radler``'s cards listed as ``cards`` CPU groups."""
    monkeypatch.setattr(pm, "visible_cards", lambda device: [CPU] * cards)


# ---------------------------------------------------------------------------
# Which group runs which facet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chan, tile, groups, n_facets, owners", [
    (1, 4, 4, 4, [0, 1, 2, 3]),  # the whole mesh, a facet a group
    (1, 4, 2, 8, [0, 0, 0, 0, 1, 1, 1, 1]),  # whole mesh, 2 a shard
    (2, 2, 4, 4, [0, 1, 2, 3]),  # the whole mesh over both axes
    (2, 4, 4, 4, [0, 0, 1, 1]),  # "tile": replicated over chan
    (2, 4, 2, 4, [0, 0, 0, 0]),  # "tile" on chan 0's group alone
    (4, 2, 4, 6, [0] * 6),  # "tile": both tiles on chan 0's group
    (4, 2, 8, 6, [0, 0, 0, 1, 1, 1]),  # "tile", 3 facets a tile
    (3, 2, 3, 9, [0] * 3 + [1] * 3 + [2] * 3),  # "chan": over chan
    (4, 3, 4, 5, [0] * 5),  # none: every facet on the lead
    (2, 2, 2, 9, [0] * 9),  # none
])
def test_facet_groups_follow_the_jax_rule(chan, tile, groups, n_facets,
                                          owners):
    mesh = pm.Mesh(chan, tile, CPU, (CPU,) * groups)
    jax_mesh = types.SimpleNamespace(size=chan * tile,
                                     shape={"chan": chan, "tile": tile})
    assert pm.facet_axis_spec(mesh, n_facets) == jax_facet_axis_spec(
        jax_mesh, n_facets)
    assert pm.facet_groups(mesh, n_facets) == owners
    runs = pm.facet_runs(mesh, n_facets)
    assert [f for _, facets in runs for f in facets] == list(range(n_facets))
    assert [g for g, _ in runs] == sorted(set(owners))


# ---------------------------------------------------------------------------
# The batched facets over groups
# ---------------------------------------------------------------------------


def facet_run(package, monkeypatch, algorithm, cards=1):
    """``test_mesh_facets.py``'s settings on ``point_field``'s 128^2 sky
    (no exact ties), 2 x 2 facets, the batched route; the port on a mesh of
    4 shards over ``cards`` groups, the JAX package on its 8 devices."""
    monkeypatch.delenv("RADLER_TPU_NO_BATCHED_FACETS", raising=False)
    size = 128
    psf = _gaussian_psf(size)
    residual = point_field(size, psf)
    model = np.zeros_like(residual)
    s = jrd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.algorithm_type = getattr(jrd.AlgorithmType, algorithm)
    s.minor_iteration_count = 300
    s.absolute_threshold = 5e-3
    s.major_loop_gain = 0.8
    s.multiscale.max_scales = 3
    s.parallel.grid_width = s.parallel.grid_height = 2
    s.parallel.use_device_mesh = True
    if package is jrd:
        r = jrd.Radler(s, psf, residual, model, 0.0)
        return residual, model, r.perform(0), r.iteration_number, None
    on_cards(monkeypatch, cards)
    s.parallel.n_devices = 4
    r = rd.Radler(settings_from_reference(s), psf, residual, model, 0.0,
                  device="cpu")
    more = r.perform(0)
    p = r._parallel
    assert p.last_route == "batched"
    assert p.first_algorithm.device_mesh.groups == cards
    return residual, model, more, r.iteration_number, p.last_lockstep


@pytest.mark.parametrize("cards", [2, 4])
@pytest.mark.parametrize("algorithm", ["GENERIC_CLEAN", "MULTISCALE"])
def test_batched_facets_over_groups_bit_equal_to_one(monkeypatch, algorithm,
                                                     cards):
    one = facet_run(rd, monkeypatch, algorithm)
    spread = facet_run(rd, monkeypatch, algorithm, cards)
    assert one[1].max() > 0
    assert spread[2:4] == one[2:4]
    np.testing.assert_array_equal(spread[0], one[0])
    np.testing.assert_array_equal(spread[1], one[1])
    # Each group stops with its own facets: never more lockstep
    # iterations than the one group's loop.
    assert 0 < spread[4] <= one[4]


def test_card_copies_are_kept_while_the_source_is_unchanged():
    """A copy on another device (``meta`` stands in for a card) is made
    once for a source tensor and kept while that tensor is unchanged; a
    write to it, or another tensor under the same name, makes a new copy;
    a tensor already on the device is itself."""
    copies = pm.CardCopies()
    card = torch.device("meta")
    psfs = torch.ones(2, 8, 8)
    first = copies.on("psfs", psfs, card)
    assert first.device == card
    assert copies.on("psfs", psfs, card) is first
    psfs.mul_(2.0)
    second = copies.on("psfs", psfs, card)
    assert second is not first
    assert copies.on("psfs", psfs.clone(), card) is not second
    assert copies.on("psfs", first, card) is first
    assert copies.on("psfs", None, card) is None


@needs_8
@pytest.mark.parametrize("algorithm", ["GENERIC_CLEAN", "MULTISCALE"])
def test_batched_facets_over_groups_match_jax_mesh(monkeypatch, algorithm):
    res, mdl, more, it, _ = facet_run(rd, monkeypatch, algorithm, cards=4)
    jres, jmdl, jmore, jit, _ = facet_run(jrd, monkeypatch, algorithm)
    assert jmdl.max() > 0 and (more, it) == (jmore, jit)
    np.testing.assert_allclose(res, jres, atol=MESH_VS_SINGLE)
    np.testing.assert_allclose(mdl, jmdl, atol=MESH_VS_SINGLE)


# ---------------------------------------------------------------------------
# B3's row-block mode and the slab FFT
# ---------------------------------------------------------------------------


def even_layout(height, parts):
    return pr.RowLayout(tuple(height * p // parts for p in range(parts + 1)),
                        (CPU,) * parts)


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("n_scales", range(1, 10))
def test_row_block_decompose_bit_equal_to_whole_image(n_scales, parts):
    """Every launch of the plan on every part's block (at 9 scales the
    halo, 4 x 511 rows, is taller than the image), then the planes read
    back: the whole-image decompose's bits."""
    height, width = 320, 72
    img = np.random.default_rng(n_scales).standard_normal((height, width))
    img = torch.as_tensor(img.astype(np.float32))
    layout = even_layout(height, parts)
    got = pr.decompose_rows(pr.Rows.scatter(img, layout), n_scales)
    assert torch.equal(got.gather(), iuwt_ops.decompose(img, n_scales))
    reaches = [ia.launch_reach(s) for s in ia.launch_plan(n_scales, height,
                                                          width)]
    assert reaches[0] == ia.cascade_reach(min(n_scales, 2))
    if n_scales >= 6:
        assert max(reaches) > height // parts  # halos from several parts


@pytest.mark.parametrize("lead", [(), (3,)])
def test_row_block_reference_on_one_block(lead):
    """One launch's plain row-block mode on a block cut out of a batch:
    its rows are the whole image's."""
    img = np.random.default_rng(2).standard_normal((*lead, 200, 90))
    img = torch.as_tensor(img.astype(np.float32))
    whole = iuwt_ops.decompose(img, 4)
    step = ia.launch_plan(4, 200, 90)[2]  # scale 3 on its lattice
    reach = ia.launch_reach(step)
    assert reach == 4 * 15
    # The carried plane that scale 3 reads is the smooth plane of 3 scales.
    carried = iuwt_ops.decompose(img, 3)[3]
    r0, r1 = 70, 130
    block = carried[..., r0 - reach:r1 + reach, :].contiguous()
    w = torch.empty((1, *lead, r1 - r0, 90))
    smooth = torch.empty((*lead, r1 - r0, 90))
    ia.atrous_rows(block, step, reach, r1 - r0, w, smooth)
    assert torch.equal(w[0], whole[3][..., r0:r1, :])
    assert torch.equal(smooth, whole[4][..., r0:r1, :])


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("shape", [(128, 96), (2, 120, 64), (96, 75)])
def test_slab_convolution_matches_convolve_same(shape, parts):
    rng = np.random.default_rng(parts)
    img = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    ker = torch.as_tensor(rng.standard_normal(shape[-2:]).astype(np.float32))
    layout = even_layout(shape[-2], parts)
    want = convolve_same(img, ker)
    pr.exchange_bytes[0] = 0
    got = pr.convolve_rows(pr.Rows.scatter(img, layout),
                           pr.SlabSpectrum(prepare_kernel_fft(ker), layout))
    got = got.gather()
    assert got.shape == want.shape
    assert (got - want).abs().max() <= SLAB_RTOL * want.abs().max()
    assert pr.exchange_bytes[0] == 0  # every part on the one CPU


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("allow_negative", [True, False])
def test_spread_peaks_are_the_whole_images(parts, allow_negative):
    """Each part's masked argmax combined by ``Rows.peaks``: the whole
    image's value and flat index, ties between parts included (the values
    are whole numbers, so every plane's maximum repeats in several
    parts)."""
    rng = np.random.default_rng(parts)
    planes = torch.as_tensor(rng.integers(-4, 5, (3, 96, 40)).astype(
        np.float32))
    valid = torch.as_tensor(rng.random((96, 40)) < 0.9)
    want = masked_peaks(planes, valid[None], allow_negative)
    layout = even_layout(96, parts)

    def search(part, ok):
        best, signed, idx = masked_peaks(part, ok[None], allow_negative)
        return best, idx, signed

    best, flat, signed = pr.Rows.scatter(planes, layout).peaks(
        search, pr.Rows.scatter(valid, layout))
    assert torch.equal(best, want[0])
    assert torch.equal(flat, want[2])
    assert torch.equal(signed, want[1])


@pytest.mark.parametrize("parts", [2, 4])
def test_spread_cg_matches_one_device(parts):
    """The CG and its RMS guard on ``RowSteps`` (slab FFTs, the decompose
    on row blocks, dot products as partials) against ``ImageSteps``: the
    same success flag, the model within 2e-5 of its peak and the SNR and
    RMS values within 1e-4 relative (the slab FFTs round apart)."""
    height, n_scales = 128, 4
    psf = torch.as_tensor(gaussian_psf(height, 2.5))
    noise = np.random.default_rng(parts).standard_normal((height, height))
    dirty = convolve_same(torch.as_tensor(diffuse_sky(height)), psf) + (
        torch.as_tensor(1e-3 * noise.astype(np.float32)))
    coeffs = iuwt_ops.decompose(dirty, n_scales)
    thr = 0.5 * coeffs[:n_scales].abs().amax(dim=(1, 2))
    mask = coeffs[:n_scales].abs() > thr[:, None, None]
    mds, md = iuwt_ops.masked_dirty_of(dirty, mask, n_scales)
    want_model, want = iuwt_ops.conjugate_gradient_guarded(
        mds, mask, md, dirty, psf, 0.1, n_scales)
    layout = even_layout(height, parts)
    steps = iuwt_ops.RowSteps(
        pr.SlabSpectrum(prepare_kernel_fft(psf), layout),
        pr.Rows.scatter(mask, layout), n_scales, CPU)
    spread = [pr.Rows.scatter(t, layout) for t in (mds, md, dirty)]
    model, status = iuwt_ops.solve(steps, spread[0], spread[1], 20)
    status = torch.cat([status, iuwt_ops.guard(steps, spread[2], model,
                                               0.1)])
    assert status[0] == want[0]
    assert ((model.gather() - want_model).abs().max()
            <= 2e-5 * want_model.abs().max())
    assert torch.allclose(status[1:], want[1:], rtol=1e-4)


@pytest.mark.parametrize("chan, tile, groups, height, bounds", [
    (1, 8, 4, 64, (0, 16, 32, 48, 64)),  # whole mesh, 2 shards a group
    (2, 4, 4, 64, (0, 16, 32, 48, 64)),  # whole mesh over both axes
    (2, 4, 4, 60, (0, 30, 60)),  # "tile": chan 0's groups
    (2, 4, 2, 60, None),  # "tile", every row on chan 0's group
    (1, 4, 4, 63, None),  # neither divides: the lead
])
def test_iuwt_rows_follow_the_jax_rule(chan, tile, groups, height, bounds):
    mesh = pm.Mesh(chan, tile, CPU, (CPU,) * groups)
    layout = pr.mesh_rows(mesh, height)
    assert (layout.bounds if layout else None) == bounds


@pytest.mark.parametrize("tile, groups, height, bounds", [
    (4, 4, 64, (0, 16, 32, 48, 64)),
    (4, 4, 62, (0, 16, 32, 48, 62)),  # padded: the last run is short
    (4, 2, 62, (0, 32, 62)),
    (8, 4, 30, (0, 8, 16, 24, 30)),
])
def test_asp_rows_follow_the_jax_rule(tile, groups, height, bounds):
    mesh = pm.Mesh(1, tile, CPU, (CPU,) * groups)
    assert pr.tile_rows(mesh, height).bounds == bounds


# ---------------------------------------------------------------------------
# IUWT and ASP over groups
# ---------------------------------------------------------------------------


def iuwt_run(package, monkeypatch, cards=1):
    """``test_mesh_iuwt.py``'s run: 256^2, six structure iterations, on a
    mesh of 8 shards (the port's over ``cards`` groups)."""
    psf, residual = iuwt_problem()
    size = residual.shape[0]
    s = jrd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.algorithm_type = jrd.AlgorithmType.IUWT
    s.minor_iteration_count = 6
    s.major_loop_gain = 0.8
    s.parallel.use_device_mesh = True
    model, resid = np.zeros_like(residual), residual.copy()
    if package is jrd:
        r = jrd.Radler(s, psf, resid, model, 0.0)
    else:
        on_cards(monkeypatch, cards)
        s.parallel.n_devices = 8
        r = rd.Radler(settings_from_reference(s), psf, resid, model, 0.0,
                      device="cpu")
        assert r._parallel.first_algorithm.device_mesh.groups == cards
    more = r.perform(0)
    return resid, model, r.iteration_number, more


@pytest.mark.parametrize("cards", [2, 4])
def test_iuwt_over_groups_matches_one_device(monkeypatch, cards):
    res1, mdl1, it1, more1 = iuwt_run(rd, monkeypatch)
    res, mdl, it, more = iuwt_run(rd, monkeypatch, cards)
    assert (it, more) == (it1, more1) and np.abs(mdl1).max() > 0
    assert scaled_max(res, res1, res1) < MESH_VS_SINGLE
    assert scaled_max(mdl, mdl1, res1) < MESH_VS_SINGLE


@needs_8
@pytest.mark.parametrize("cards", [2, 4])
def test_iuwt_over_groups_matches_jax_mesh(monkeypatch, cards):
    res, mdl, it, more = iuwt_run(rd, monkeypatch, cards)
    jres, jmdl, jit, jmore = iuwt_run(jrd, monkeypatch)
    assert (it, more) == (jit, jmore)
    assert scaled_max(res, jres, jres) < MESH_VS_SINGLE
    assert scaled_max(mdl, jmdl, jres) < MESH_VS_SINGLE


@pytest.mark.parametrize("cards, parts", [(2, 2), (4, 4)])
def test_two_channel_iuwt_over_groups_matches_one_device(monkeypatch, cards,
                                                         parts):
    """``test_iuwt_multichannel_flux_refit``'s two channels at 128^2 on a
    chan 2 x tile 2 mesh: the cube's update convolves both channels by slab
    FFTs and the per-image refit runs on the lead; 12 structure
    iterations."""
    size = 128
    rng = np.random.default_rng(1)
    psf = gaussian_psf(size)
    conv = convolve_same(torch.as_tensor(diffuse_sky(size)),
                         torch.as_tensor(psf)).numpy()
    residual = np.stack([conv * s for s in (1.0, 1.6)]).astype(np.float32)
    residual += rng.normal(scale=1e-3, size=residual.shape).astype(np.float32)
    seen = []
    real = iuwt_ops.decompose_rows
    monkeypatch.setattr(iuwt_ops, "decompose_rows",
                        lambda image, n: seen.append(image.layout.parts)
                        or real(image, n))

    def run(cards):
        on_cards(monkeypatch, cards)
        s = rd.Settings()
        s.trimmed_image_width = s.trimmed_image_height = size
        s.algorithm_type = rd.AlgorithmType.IUWT
        s.minor_iteration_count = 12
        s.parallel.use_device_mesh = True
        s.parallel.n_devices = 4
        res, mod = residual.copy(), np.zeros_like(residual)
        r = rd.Radler(s, np.stack([psf, psf]), res, mod, 0.0,
                      frequencies=np.array([[1.0e8, 1.1e8], [1.2e8, 1.3e8]]),
                      device="cpu")
        r.perform(0)
        return res, mod, r.iteration_number

    res1, mdl1, it1 = run(1)
    assert not seen
    res, mdl, it = run(cards)
    assert set(seen) == {parts}
    assert it == it1 == 12 and np.abs(mdl1).max() > 0
    assert scaled_max(res, res1, res1) < MESH_VS_SINGLE
    assert scaled_max(mdl, mdl1, res1) < MESH_VS_SINGLE


def point_field_case():
    """``test_asp_point_field_matches_jax``'s three point sources at 128^2
    x 2 channels with the 2-term fit (ASP's Gaussian and point-source
    paths), 37 iterations."""
    size = 128
    rng = np.random.default_rng(7)
    sky = np.zeros((size, size))
    ys = rng.integers(size // 8, 7 * size // 8, 3)
    xs = rng.integers(size // 8, 7 * size // 8, 3)
    np.add.at(sky, (ys, xs), rng.uniform(0.2, 1.0, 3))
    psfs = channel_psfs(size)
    return fitted_settings(size, 80), psfs, convolve(sky, psfs, -0.05)


ASP_CASES = {
    # name: (case, n_devices, kwargs, {cards: parts of the rows})
    "point source": (point_source_case, 4, {}, {2: 2, 4: 4}),
    "point field": (point_field_case, 8, {"frequencies": FREQS},
                    {4: 2, 8: 4}),
}


def asp_run(package, monkeypatch, name, cards=1):
    make, n_devices, kwargs, _ = ASP_CASES[name]
    s, psf, residual = make()
    if name == "point source":
        s.minor_iteration_count = 40
    s.parallel.use_device_mesh = True
    res, model = residual.copy(), np.zeros_like(residual)
    if package is jrd:
        r = jrd.Radler(s, psf, res, model, 0.0, **kwargs)
    else:
        on_cards(monkeypatch, cards)
        s.parallel.n_devices = n_devices
        r = rd.Radler(settings_from_reference(s), psf, res, model, 0.0,
                      device="cpu", **kwargs)
    r.perform(0)
    return res, model, r.iteration_number


@pytest.mark.parametrize("name, cards", [
    (name, cards) for name, case in ASP_CASES.items() for cards in case[3]])
def test_asp_over_groups_matches_one_device(monkeypatch, name, cards):
    parts = []
    real = asp_module.scale_maxima_rows
    monkeypatch.setattr(asp_module, "scale_maxima_rows",
                        lambda image, *a: parts.append(
                            image.layout.parts) or real(image, *a))
    res1, mdl1, it1 = asp_run(rd, monkeypatch, name)
    assert not parts
    res, mdl, it = asp_run(rd, monkeypatch, name, cards)
    assert set(parts) == {ASP_CASES[name][3][cards]}
    assert it == it1 and np.abs(mdl1).max() > 0
    assert scaled_max(res, res1, res1) < MESH_VS_SINGLE
    assert scaled_max(mdl, mdl1, res1) < MESH_VS_SINGLE


@needs_8
@pytest.mark.parametrize("name", list(ASP_CASES))
def test_asp_over_groups_matches_jax_mesh(monkeypatch, name):
    cards = max(ASP_CASES[name][3])
    res, mdl, it = asp_run(rd, monkeypatch, name, cards)
    jres, jmdl, jit = asp_run(jrd, monkeypatch, name)
    assert it == jit
    assert scaled_max(res, jres, jres) < MESH_VS_SINGLE
    assert scaled_max(mdl, jmdl, jres) < MESH_VS_SINGLE


# ---------------------------------------------------------------------------
# Radler.perform takes the spread routes by itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workload", ["generic facets", "multiscale facets",
                                      "iuwt", "asp"])
def test_radler_spreads_each_workload(monkeypatch, workload):
    """With the cards listed as 4 CPU groups, ``Radler.perform`` sends each
    workload to its spread route: the facets' loops on several groups, the
    IUWT decompose and ASP's scale maxima on spread rows."""
    seen = []

    def spy(owner, name):
        real = getattr(owner, name)

        def called(*args, **kwargs):
            seen.append(name)
            return real(*args, **kwargs)
        monkeypatch.setattr(owner, name, called)

    if workload == "generic facets":
        spy(GenericClean, "_spread_facet_loops")
        facet_run(rd, monkeypatch, "GENERIC_CLEAN", cards=4)
    elif workload == "multiscale facets":
        spy(MultiScaleAlgorithm, "_spread_fused_facets")
        facet_run(rd, monkeypatch, "MULTISCALE", cards=4)
    elif workload == "iuwt":
        spy(iuwt_ops, "decompose_rows")
        iuwt_run(rd, monkeypatch, cards=4)
    else:
        spy(asp_module, "scale_maxima_rows")
        asp_run(rd, monkeypatch, "point source", cards=4)
    assert seen
