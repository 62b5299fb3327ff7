"""The device mesh over several groups of shards, on the CPU.

A mesh's shards spread over the groups of ``Mesh.devices``; a group is a
position in the tuple, so ``("cpu",) * g`` runs the code of a mesh over g
cards here, every copy between groups included.  Every collective keeps
one order of operations whatever the groups, so each loop over 2, 4 and 8
groups must end in the bits of the same loop over one group
(``torch.equal`` on residual and model, ``==`` on the loop's result).

``Radler.perform`` with 8 shards on 4 groups (the function that lists the
cards replaced by four CPU groups) is bit-equal to its run on one group,
and held against the JAX package's 8-device CPU mesh within the ROADMAP's
contract: equal iteration counts, the residual within 2e-6 absolute (2e-5
for multiscale, the tolerance of the port's one-group multiscale mesh
against the JAX mesh, ``tests/test_torch_mesh_multiscale.py``), the model
within 1e-4 of its peak.
Inputs are made with NumPy from a seed.
"""

import numpy as np
import pytest
import torch
import jax

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu_torch.image_set import CubeMeta
from radler_tpu_torch.interop import mesh_from_jax, settings_from_reference
from radler_tpu_torch.kernels import hogbom_step as hs
from radler_tpu_torch.kernels.subminor_loop import SubminorParams
from radler_tpu_torch.models.multiscale_fused import _coefficient_basis
from radler_tpu_torch.ops.spectral_fitting import SpectralFitter
from radler_tpu_torch.parallel import mesh as pm

from test_torch_mesh import cross_psf, multichannel_problem
from test_torch_mesh_multiscale import port_field
from test_torch_mesh_subminor import make_problem as clark_problem

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
HEIGHT, WIDTH = 64, 48
RESIDUAL_ATOL = 2e-6
MODEL_PEAK_RTOL = 1e-4
MULTISCALE_ATOL = 2e-5

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


def on_groups(shape, groups):
    """A ``chan x tile`` mesh over ``groups`` CPU groups."""
    return pm.Mesh(*shape, CPU, (CPU,) * groups)


def make_meta(C, P, squared):
    return CubeMeta(C, P, tuple(1.0 - 0.1 * c for c in range(C)),
                    (True,) * P, float(P), squared,
                    tuple(1e8 + 1e7 * c for c in range(C)))


def make_cube(C, P, seed, empty_rows=None):
    """Point sources under Gaussian PSFs that differ per channel, on faint
    noise, each plane scaled by its own factor; no source within 4 rows of
    ``empty_rows`` (a band that then holds no Clark candidate)."""
    rng = np.random.default_rng(seed)
    n = C * P
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
    r2 = (yy - HEIGHT // 2) ** 2.0 + (xx - WIDTH // 2) ** 2.0
    psfs = np.stack([np.exp(-r2 / (2.0 * (1.2 + 0.2 * c) ** 2))
                     for c in range(C)]).astype(np.float32)
    res = rng.normal(scale=1e-3, size=(n, HEIGHT, WIDTH))
    placed = 0
    while placed < 14:
        y, x = rng.integers(3, HEIGHT - 3), rng.integers(3, WIDTH - 3)
        if empty_rows and empty_rows[0] - 4 <= y < empty_rows[1] + 4:
            continue
        flux = rng.uniform(0.3, 1.5)
        for i in range(n):
            res[i] += flux * (1 - 0.07 * i) * np.roll(
                psfs[i // P], (y - HEIGHT // 2, x - WIDTH // 2), (0, 1))
        placed += 1
    return psfs, res.astype(np.float32)


def initial_peak(res, weight):
    integ = np.abs(res.sum(0)) * weight
    y, x = divmod(int(np.argmax(integ)), WIDTH)
    return float(res.sum(0)[y, x]), x, y


# ---------------------------------------------------------------------------
# The Högbom mesh loop
# ---------------------------------------------------------------------------

# (C, P, squared joins, mesh shape): B1 on row shards, B4 in normal mode
# with one plane a shard, B4 in squared mode on linked polarizations.
HOGBOM_CASES = {
    "chan1-tile8-B1": (2, 1, False, (1, 8)),
    "chan4-tile2-B4": (4, 1, False, (4, 2)),
    "chan2-tile4-squared": (2, 2, True, (2, 4)),
}
# (P, mesh shape) of the linear loop with coefficients (multiscale's dense
# subminor loop): B1 linear on rows, B4 linear, B4 splitting polarization
# groups (one PSF a plane).
LINEAR_CASES = {
    "chan1-tile8-B1": (1, (1, 8)),
    "chan4-tile2-B4": (1, (4, 2)),
    "chan4-tile2-split-pols": (2, (4, 2)),
}
_ONE_GROUP = {}


def run_hogbom(mesh, C, P, squared, linear=False):
    """A mesh Högbom loop with a weight plane and an rms factor; returns
    (result, residual, model)."""
    psfs, res = make_cube(C, P, seed=10 * C + P)
    rng = np.random.default_rng(3)
    rms = rng.uniform(0.8, 1.2, (HEIGHT, WIDTH)).astype(np.float32)
    weight = rng.uniform(0.5, 1.0, (HEIGHT, WIDTH)).astype(np.float32)
    weight[:2] = weight[-2:] = 0.0
    meta = make_meta(C, P, squared)
    v0, x0, y0 = initial_peak(res, weight * rms)
    residual = torch.as_tensor(res)
    kwargs = dict(meta=meta, allow_negative=True)
    if linear:
        fitter = SpectralFitter(rd.SpectralFittingMode.POLYNOMIAL, 2,
                                meta.frequencies, meta.weights)
        expand = torch.as_tensor(_coefficient_basis(fitter, meta))
        kwargs.update(
            integration=("linear", np.full(C * P, 1.0 / (C * P), np.float32)),
            coefficients=(torch.as_tensor(fitter._fit_matrix,
                                          dtype=torch.float32), expand))
        model = torch.zeros((expand.shape[1], HEIGHT, WIDTH))
    else:
        model = torch.zeros_like(residual)
    params = hs.LoopParams.make(0.15, 0.02, abs(v0), 4.0, 90, False)
    out = pm.mesh_hogbom_loop(
        mesh, residual, model, torch.as_tensor(psfs),
        torch.as_tensor(weight * rms), torch.as_tensor(rms),
        (v0, x0, y0, True), params, 0, **kwargs)
    return out, residual, model


def assert_loop_bit_equal(key, run):
    """``run(mesh)`` over ``key``'s groups against its one-group run."""
    shape, groups = key[-2:]
    if key[:-1] not in _ONE_GROUP:
        _ONE_GROUP[key[:-1]] = run(pm.Mesh(*shape, CPU))
    want = _ONE_GROUP[key[:-1]]
    got = run(on_groups(shape, groups))
    assert got[0] == want[0] and want[0].iteration > 20
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("groups", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(HOGBOM_CASES))
def test_hogbom_loop_over_groups_is_bit_equal(case, groups):
    C, P, squared, shape = HOGBOM_CASES[case]
    assert_loop_bit_equal(("hogbom", case, shape, groups),
                          lambda mesh: run_hogbom(mesh, C, P, squared))


@pytest.mark.parametrize("groups", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(LINEAR_CASES))
def test_linear_loop_with_coefficients_over_groups_is_bit_equal(case,
                                                                groups):
    P, shape = LINEAR_CASES[case]
    C = 4 // P
    assert_loop_bit_equal(
        ("linear", case, shape, groups),
        lambda mesh: run_hogbom(mesh, C, P, False, linear=True))


# ---------------------------------------------------------------------------
# The mesh's Clark subminor loop
# ---------------------------------------------------------------------------


def run_clark(mesh, fit):
    """The mesh's Clark loop on 4 channels, rows 40-47 (tile 5 of 8)
    without a candidate, with an rms factor; returns (result without its
    delta, delta)."""
    C = 4
    psfs, res = make_cube(C, 1, seed=21, empty_rows=(40, 48))
    meta = make_meta(C, 1, False)
    fitter = None
    if fit:
        fitter = SpectralFitter(rd.SpectralFittingMode.LOG_POLYNOMIAL, 2,
                                meta.frequencies, meta.weights)
    rms = np.random.default_rng(5).uniform(0.9, 1.1, (HEIGHT, WIDTH))
    window = torch.zeros((HEIGHT, WIDTH), dtype=torch.bool)
    window[2:-2, 2:-2] = True
    out = pm.mesh_subminor_clean(
        mesh, torch.as_tensor(res), torch.as_tensor(psfs),
        torch.as_tensor(rms.astype(np.float32)), window, 0.05,
        SubminorParams.make(0.05, 0.1, 3, 150, 4.0, True, False),
        meta=meta, fitter=fitter)
    return out._replace(delta=None), out.delta


@pytest.mark.parametrize("groups", [2, 4, 8])
@pytest.mark.parametrize("fit", [False, True], ids=["no-fit", "log-poly"])
@pytest.mark.parametrize("shape", [(1, 8), (4, 2)],
                         ids=["chan1-tile8", "chan4-tile2"])
def test_clark_mesh_over_groups_is_bit_equal(shape, fit, groups):
    key = ("clark", fit, shape, groups)
    if key[:-1] not in _ONE_GROUP:
        _ONE_GROUP[key[:-1]] = run_clark(pm.Mesh(*shape, CPU), fit)
    (want, want_delta) = _ONE_GROUP[key[:-1]]
    got, delta = run_clark(on_groups(shape, groups), fit)
    assert got == want and want.iteration > 10 and want.any_selected
    assert torch.equal(delta, want_delta)


# ---------------------------------------------------------------------------
# Layout: blocks, placement, the card count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, groups, blocks", [
    ((1, 8), 4, [(0, 1, 0, 2), (0, 1, 2, 2), (0, 1, 4, 2), (0, 1, 6, 2)]),
    ((4, 2), 2, [(0, 2, 0, 2), (2, 2, 0, 2)]),
    ((4, 2), 8, [(c, 1, t, 1) for c in range(4) for t in range(2)]),
    ((2, 4), 4, [(0, 1, 0, 2), (0, 1, 2, 2), (1, 1, 0, 2), (1, 1, 2, 2)]),
    ((4, 3), 4, [(c, 1, 0, 3) for c in range(4)]),
])
def test_rectangular_blocks(shape, groups, blocks):
    mesh = on_groups(shape, groups)
    assert [mesh.block(g) for g in range(groups)] == blocks
    for g, (c0, chan_g, t0, tile_g) in enumerate(blocks):
        assert {mesh.group_of(c0 + c, t0 + t) for c in range(chan_g)
                for t in range(tile_g)} == {g}


@pytest.mark.parametrize("shape, groups", [
    ((4, 3), 6),   # runs of 2 shards cut the 3 tiles
    ((4, 3), 8),   # 12 shards do not divide over 8
    ((2, 4), 3),
    ((1, 8), 16),  # fewer shards than groups
])
def test_other_layouts_raise(shape, groups):
    with pytest.raises(ValueError, match="rectangular"):
        on_groups(shape, groups)


def test_mesh_devices_rules():
    assert pm.Mesh(1, 8, CPU).devices == (CPU,)
    assert pm.Mesh(1, 8, CPU) == pm.Mesh(1, 8, "cpu", ("cpu",))
    with pytest.raises(ValueError, match="lead"):
        pm.Mesh(1, 8, CPU, (torch.device("meta"), CPU))
    with pytest.raises(ValueError, match="index"):
        pm.Mesh(1, 8, torch.device("cuda"), (torch.device("cuda"),) * 2)
    assert pm.visible_cards("cpu") == [CPU]
    jax_mesh = type("JaxMesh", (), {"shape": {"chan": 2, "tile": 4}})
    assert mesh_from_jax(jax_mesh, "cpu") == pm.Mesh(2, 4, CPU)
    assert mesh_from_jax(jax_mesh, devices=["cpu"] * 4) == on_groups((2, 4),
                                                                     4)
    assert pm.peer_access([CPU, CPU]) == [[True, True], [True, True]]


@pytest.mark.parametrize("shape, groups", [((1, 8), 2), ((1, 8), 8),
                                           ((4, 2), 2), ((4, 2), 4),
                                           ((2, 4), 8)])
def test_place_round_trip_over_groups(shape, groups):
    cube = torch.arange(4 * 8 * 3, dtype=torch.float32).view(4, 8, 3)
    mesh = on_groups(shape, groups)
    chan, tile = shape
    whole = pm.place(cube, pm.Mesh(*shape, CPU))
    target = torch.zeros_like(cube)
    blocks = []
    for g in range(groups):
        c0, chan_g, t0, tile_g = mesh.block(g)
        block = pm.place(cube, mesh, g)
        assert block.shape == (chan_g, tile_g, 4 // chan, 8 // tile, 3)
        assert block.is_contiguous()
        assert torch.equal(block, whole[c0:c0 + chan_g, t0:t0 + tile_g])
        if g > 0:  # a copy, never a view of the cube
            assert block.data_ptr() != cube.data_ptr()
        pm.unplace(block, target, mesh, g)
        blocks.append(block)
    assert torch.equal(target, cube)
    assert torch.equal(pm.gather(blocks, mesh, CPU), whole)


@pytest.mark.parametrize("shape, groups, runs", [
    ((1, 8), 4, [(0, 2, 0), (2, 4, 1), (4, 6, 2), (6, 8, 3)]),
    ((4, 2), 4, [(0, 1, 0), (1, 2, 2)]),
    ((2, 4), 8, [(0, 1, 0), (1, 2, 2), (2, 3, 4), (3, 4, 6)]),
    ((1, 8), 1, [(0, 8, 0)]),
])
def test_clark_tile_runs(shape, groups, runs):
    """Tile t's Clark loop runs on group t * G // T."""
    assert pm.tile_runs(on_groups(shape, groups)) == runs


@pytest.mark.parametrize("n, n_channels, cards, shape, groups", [
    (8, 1, 4, (1, 8), 4),
    (8, 4, 4, (4, 2), 4),
    (8, 4, 3, (4, 2), 2),  # 3 does not divide 8
    (8, 2, 8, (2, 4), 8),
    (12, 4, 6, (4, 3), 4),  # 6 groups would cut the tiles
    (6, 1, 4, (1, 6), 3),
    (2, 1, 4, (1, 2), 2),  # no more groups than shards
    (8, 4, 1, (4, 2), 1),
])
def test_make_mesh_picks_the_card_count(n, n_channels, cards, shape, groups):
    mesh = pm.make_mesh(n, n_channels, "cpu", cards=["cpu"] * cards)
    assert (mesh.chan, mesh.tile) == shape and mesh.groups == groups


def radler(settings, psf, residual, **kwargs):
    res, model = residual.copy(), np.zeros_like(residual)
    return (rd.Radler(settings, psf, res, model, 0.0, device="cpu",
                      **kwargs), res, model)


@pytest.mark.parametrize("n_devices, cards, groups", [
    (0, 4, 4), (8, 4, 4), (8, 8, 8), (6, 4, 3), (8, 1, 1), (0, 1, 1),
])
def test_radler_spreads_the_shards_over_the_cards(monkeypatch, n_devices,
                                                  cards, groups):
    """``_make_mesh``: one shard a card with ``n_devices`` 0, else the most
    cards that take rectangular blocks; the run's device leads."""
    monkeypatch.setattr(pm, "visible_cards", lambda device: [CPU] * cards)
    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = 64
    s.parallel.use_device_mesh = True
    s.parallel.n_devices = n_devices
    psf = cross_psf(64)
    r = radler(s, psf, 0.5 * psf)[0]
    mesh = r._parallel.first_algorithm.device_mesh
    assert mesh.size == (n_devices or cards) and mesh.groups == groups
    assert mesh.device == CPU


# ---------------------------------------------------------------------------
# Radler.perform on 4 groups against the JAX package's 8-device mesh
# ---------------------------------------------------------------------------


def perform_all(monkeypatch, jax_settings, psf, residual, **kwargs):
    """The JAX package's mesh run and the port's on one group and on 4
    groups (the cards listed as one or four CPU groups); returns
    ((iterations, residual, model) of each, the port's 4-group mesh)."""
    outs = []
    for cards in (None, 1, 4):
        res, model = residual.copy(), np.zeros_like(residual)
        if cards is None:
            r = jrd.Radler(jax_settings, psf, res, model, 0.0, **kwargs)
        else:
            monkeypatch.setattr(pm, "visible_cards",
                                lambda device, k=cards: [CPU] * k)
            r = rd.Radler(settings_from_reference(jax_settings), psf, res,
                          model, 0.0, device="cpu", **kwargs)
        r.perform(0)
        outs.append((r.iteration_number, res, model))
    mesh = r._parallel.first_algorithm.device_mesh
    assert np.array_equal(outs[1][1], outs[2][1])
    assert np.array_equal(outs[1][2], outs[2][2])
    assert outs[1][0] == outs[2][0]
    return outs, mesh


def assert_contract(port, ref, atol=RESIDUAL_ATOL):
    assert port[0] == ref[0] > 0
    np.testing.assert_allclose(port[1], ref[1], atol=atol, rtol=0)
    peak = np.abs(ref[2]).max()
    assert peak > 0 and np.abs(port[2] - ref[2]).max() <= (
        MODEL_PEAK_RTOL * peak)


def jax_settings(size, iterations, algorithm="hogbom"):
    s = jrd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.minor_iteration_count = iterations
    s.parallel.use_device_mesh = True
    s.parallel.n_devices = 8
    if algorithm == "multiscale":
        s.algorithm_type = jrd.AlgorithmType.MULTISCALE
        s.multiscale.max_scales = 3
        s.absolute_threshold = 1e-3
        s.major_loop_gain = 0.8
        s.spectral_fitting.mode = jrd.SpectralFittingMode.POLYNOMIAL
        s.spectral_fitting.terms = 2
    else:
        s.absolute_threshold = 1e-3
        s.generic.use_sub_minor_optimization = algorithm == "clark"
        s.minor_loop_gain = 0.2 if algorithm == "clark" else 0.1
        s.major_loop_gain = 0.85 if algorithm == "clark" else 1.0
    return s


def frequencies(n_chan):
    return np.array([[1.0e8 + c * 1e7, 1.1e8 + c * 1e7]
                     for c in range(n_chan)])


@needs_8
@pytest.mark.parametrize("n_channels, shape", [(1, (1, 8)), (2, (2, 4))],
                         ids=["chan1-tile8", "chan2-tile4"])
def test_perform_hogbom_on_four_groups_matches_jax(monkeypatch, n_channels,
                                                   shape):
    psf, residual, freqs = multichannel_problem(2, 11)
    kwargs = {"frequencies": freqs}
    if n_channels == 1:
        psf, residual, kwargs = psf[0], residual[0], {}
    (ref, _, port), mesh = perform_all(monkeypatch, jax_settings(64, 100),
                                       psf, residual, **kwargs)
    assert (mesh.chan, mesh.tile, mesh.groups) == (*shape, 4)
    assert_contract(port, ref)


@needs_8
def test_perform_clark_on_four_groups_matches_jax(monkeypatch):
    psfs, residual = clark_problem(2, 64)
    (ref, _, port), mesh = perform_all(
        monkeypatch, jax_settings(64, 200, "clark"), psfs, residual,
        frequencies=frequencies(2))
    assert (mesh.chan, mesh.tile, mesh.groups) == (2, 4, 4)
    assert_contract(port, ref)


@needs_8
def test_perform_multiscale_on_four_groups_matches_jax(monkeypatch):
    """The fused loop with a 2-term fit, its dense subminor loop on B4's
    plain version over chan 2 x tile 4 in 4 groups: bit-equal to one
    group, and against the JAX mesh run within
    ``tests/test_torch_mesh_multiscale.py``'s 2e-5 on the residual (the
    JAX multiscale tests' own; the two packages' FFT corrections round
    apart by up to 1.3e-5 on this field at one group already)."""
    psfs, residual = port_field(2)
    size = residual.shape[-1]
    (ref, _, port), mesh = perform_all(
        monkeypatch, jax_settings(size, 200, "multiscale"), psfs, residual,
        frequencies=frequencies(2))
    assert (mesh.chan, mesh.tile, mesh.groups) == (2, 4, 4)
    assert_contract(port, ref, atol=MULTISCALE_ATOL)
