"""The port's fused multiscale loop on a device mesh against the JAX mesh run.

``tests/test_mesh_multiscale.py`` runs the JAX package's fused loop on the 8
virtual CPU devices of ``conftest.py`` (its dense subminor loop as the
shard-mapped Pallas pass, interpreted).  The port runs the same settings on
a mesh of 8 shards on the CPU: B4's plain version on every shard with a
channel split (chan 2 x tile 4), B1's plain version on row shards without
one (chan 1 x tile 8).  Inputs are made with NumPy from a seed.

Tolerances: the JAX tests' own (equal iteration counts, residual and model
within 2e-5 absolute, the tracked masks exactly), against the JAX mesh run
and against the port's single-device run.

The JAX tests' own field (a Gaussian PSF and a circular blob) has exact
ties between mirror-image pixels, which each package's FFT rounding
breaks its own way: there the JAX package's host path and fused loop part
by 1.87 within 5 iterations, and the port and the JAX package end 0.59
apart at equal counts.  The port is held against the JAX mesh run on
``test_torch_multiscale.py``'s diffuse field (a PSF with a sidelobe ring,
emission of several widths), and against its own single-device run on the
JAX tests' field.
"""

import numpy as np
import pytest
import jax
import torch

import radler_tpu as jrd
from radler_tpu.parallel import mesh as jax_mesh

import radler_tpu_torch as rd
from radler_tpu_torch.interop import settings_from_reference
from radler_tpu_torch.models import multiscale as TM
from radler_tpu_torch.parallel import mesh as pm

from test_mesh_multiscale import _diffuse_residual, _gaussian_psf
from test_torch_multiscale import diffuse_problem

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")
SIZE = 128
ATOL = 2e-5


def jax_field(n_chan):
    """``test_mesh_multiscale.py``'s field: ``n_chan`` = 0 is its
    single-image auto-mask case."""
    psf1 = _gaussian_psf(SIZE)
    base = _diffuse_residual(SIZE, psf1)
    if n_chan == 0:
        return psf1, base.copy()
    return (np.stack([psf1] * n_chan),
            np.stack([base * (1.0 - 0.1 * c) for c in range(n_chan)]))


def port_field(n_chan):
    psfs, residual = diffuse_problem(SIZE, max(n_chan, 1))
    if n_chan == 0:
        return psfs[0], residual[0]
    return psfs, residual


def settings(package, use_mesh, automask, fit=False):
    """The two JAX tests' settings (``_run`` and ``_run_automask``), with 8
    shards asked for explicitly: the port counts one device on the CPU."""
    s = jrd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = SIZE
    s.algorithm_type = jrd.AlgorithmType.MULTISCALE
    s.minor_iteration_count = 200
    s.multiscale.max_scales = 3
    s.parallel.use_device_mesh = use_mesh
    s.parallel.n_devices = 8 if use_mesh else 0
    if automask:
        s.minor_loop_gain = 0.2
        s.auto_mask_sigma = 4.0
    else:
        s.absolute_threshold = 1e-3
        s.major_loop_gain = 0.8
    if fit:
        s.spectral_fitting.mode = jrd.SpectralFittingMode.POLYNOMIAL
        s.spectral_fitting.terms = 2
    return s if package is jrd else settings_from_reference(s)


def perform(package, s, psf, residual, n_majors):
    """Up to ``n_majors`` performs; returns (residual, model, iterations,
    scale masks, the algorithm)."""
    residual, model = residual.copy(), np.zeros_like(residual)
    freqs = (np.array([[1.0e8 + c * 1e7, 1.1e8 + c * 1e7]
                       for c in range(residual.shape[0])])
             if residual.ndim == 3 else None)
    kw = {} if package is jrd else {"device": "cpu"}
    r = package.Radler(s, psf, residual, model, 0.0, frequencies=freqs, **kw)
    for major in range(n_majors):
        if not r.perform(major):
            break
    alg = r._parallel.algorithms[0]
    masks = [None if m is None else np.asarray(m) for m in alg.scale_masks]
    return residual, model, r.iteration_number, masks, alg


def assert_same(run, want):
    res, mdl, it, masks = run[:4]
    res_w, mdl_w, it_w, masks_w = want[:4]
    assert it == it_w > 0
    np.testing.assert_allclose(res, res_w, atol=ATOL)
    np.testing.assert_allclose(mdl, mdl_w, atol=ATOL)
    assert len(masks) == len(masks_w)
    for m, mw in zip(masks, masks_w):
        assert (m is None) == (mw is None)
        if m is not None:
            np.testing.assert_array_equal(m, mw)


@pytest.fixture
def spies(monkeypatch):
    """Count the mesh placements and each shard kernel's calls."""
    calls = {"shard": [], "b4": 0, "b1_rows": 0}
    place = TM.shard_multiscale_inputs
    b4, b1 = pm.subtract_integrate, pm.hogbom_step

    def shard(mesh, *tensors):
        calls["shard"].append(mesh)
        return place(mesh, *tensors)

    def count_b4(*args, **kwargs):
        calls["b4"] += 1
        return b4(*args, **kwargs)

    def count_b1(*args, **kwargs):
        calls["b1_rows"] += kwargs.get("row_offset", 0) > 0
        return b1(*args, **kwargs)

    monkeypatch.setattr(TM, "shard_multiscale_inputs", shard)
    monkeypatch.setattr(pm, "subtract_integrate", count_b4)
    monkeypatch.setattr(pm, "hogbom_step", count_b1)
    return calls


@needs_8
@pytest.mark.parametrize("fit", [False, True], ids=["no_fit", "fit"])
def test_mesh_multiscale_matches_single_device(spies, monkeypatch, fit):
    """``test_mesh_multiscale_matches_single_device``: 2 channels on chan 2
    x tile 4 (B4 on every shard; with the 2-term fit in coefficient space)
    against the JAX mesh run, and on the JAX test's own field against the
    port's single-device run; the single-device run places nothing."""
    jax_calls = []
    jax_place = jax_mesh.shard_multiscale_inputs

    def jax_spy(*args, **kwargs):
        jax_calls.append(args[0])
        return jax_place(*args, **kwargs)

    monkeypatch.setattr(jax_mesh, "shard_multiscale_inputs", jax_spy)
    psf, residual = port_field(2)
    want = perform(jrd, settings(jrd, True, False, fit), psf, residual, 1)
    assert jax_calls and jax_calls[0].size == 8
    run = perform(rd, settings(rd, True, False, fit), psf, residual, 1)
    assert [(m.chan, m.tile) for m in spies["shard"]] == [(2, 4)]
    assert spies["b4"] >= 8 * run[2]
    assert_same(run, want)

    psf, residual = jax_field(2)
    single = perform(rd, settings(rd, False, False, fit), psf, residual, 1)
    assert len(spies["shard"]) == 1  # one device: no placement
    run = perform(rd, settings(rd, True, False, fit), psf, residual, 1)
    assert_same(run, single)
    assert np.abs(single[0]).max() < 0.5 * np.abs(residual).max()


@needs_8
def test_mesh_multiscale_with_automask(spies):
    """``test_mesh_multiscale_with_automask``: one image on chan 1 x tile 8
    (B1 on row shards) over both auto-mask phases; the tracked masks
    exactly, against the JAX mesh run and, on the JAX test's own field,
    against the port's single-device run."""
    psf, residual = port_field(0)
    want = perform(jrd, settings(jrd, True, True), psf, residual, 3)
    run = perform(rd, settings(rd, True, True), psf, residual, 3)
    assert {(m.chan, m.tile) for m in spies["shard"]} == {(1, 8)}
    assert spies["b1_rows"] >= 7 * run[2]
    assert_same(run, want)
    assert any(m is not None and m.any() for m in run[3])

    psf, residual = jax_field(0)
    single = perform(rd, settings(rd, False, True), psf, residual, 3)
    run = perform(rd, settings(rd, True, True), psf, residual, 3)
    assert_same(run, single)


def test_mesh_subminor_eligible():
    """The JAX package's mesh gate without its 128-lane rule: planes over
    "chan", rows over "tile" in shards of a multiple of 8 rows, no fit or
    a polynomial one."""
    from radler_tpu_torch.image_set import CubeMeta
    from radler_tpu_torch.models.multiscale_fused import mesh_subminor_eligible
    from radler_tpu_torch.ops.spectral_fitting import SpectralFitter

    meta = CubeMeta(4, 1, (1.0,) * 4, (True,), 1.0, False,
                    (1e8, 1.1e8, 1.2e8, 1.3e8))
    poly, log_poly = (
        SpectralFitter(mode, 2, meta.frequencies, meta.weights)
        for mode in (rd.SpectralFittingMode.POLYNOMIAL,
                     rd.SpectralFittingMode.LOG_POLYNOMIAL))
    mesh = pm.make_mesh(8, 4, device="cpu")  # chan 4 x tile 2
    assert mesh_subminor_eligible(mesh, meta, 96, None)
    assert mesh_subminor_eligible(mesh, meta, 96, poly)
    assert not mesh_subminor_eligible(mesh, meta, 96, log_poly)
    assert not mesh_subminor_eligible(mesh, meta, 100, None)  # 50-row shards
    assert not mesh_subminor_eligible(mesh, meta, 97, None)
    assert not mesh_subminor_eligible(pm.make_mesh(8, 8, device="cpu"),
                                      meta, 96, None)  # 8 > 4 planes
    assert not mesh_subminor_eligible(None, meta, 96, None)
    assert not mesh_subminor_eligible(pm.make_mesh(1, 4, device="cpu"),
                                      meta, 96, None)


@pytest.mark.parametrize("mesh_shape, C, P", [
    ((1, 4), 4, 1), ((2, 2), 4, 1), ((4, 2), 2, 2), ((2, 4), 2, 2),
], ids=["chan1-B1", "chan2-B4", "chan4-B4-per-plane", "chan2-B4-2pol"])
def test_mesh_dense_subminor_matches_single_device(mesh_shape, C, P):
    """The fused loop's dense subminor on a mesh (linear integration, the
    2-term fit in coefficient space; with 2 polarizations over 4 shards
    each shard holds part of a polarization group and subtracts its
    plane's own PSF) against the single-device loop from the same start,
    on a field without ties: the same count, residual and coefficient
    cube within 1e-6."""
    from radler_tpu_torch.image_set import (
        CubeMeta,
        linear_integration_coefficients,
    )
    from radler_tpu_torch.kernels.hogbom_step import LoopParams, hogbom_loop
    from radler_tpu_torch.models.multiscale_fused import _coefficient_basis
    from radler_tpu_torch.ops.spectral_fitting import SpectralFitter

    h, w = 64, 48
    rng = np.random.default_rng(12)
    meta = CubeMeta(C, P, tuple(rng.uniform(0.5, 1.5, C).tolist()),
                    (True,) * P, 1.0, False,
                    tuple(1e8 + 1e7 * c for c in range(C)))
    yy, xx = np.mgrid[0:h, 0:w]
    psfs = torch.as_tensor(np.stack([
        np.exp(-((yy - h // 2) ** 2 + (xx - w // 2) ** 2)
               / (2 * (1.5 + 0.3 * c) ** 2)) for c in range(C)
    ]).astype(np.float32))
    cube = rng.normal(scale=0.01, size=(C * P, h, w))
    for _ in range(10):
        cube[:, rng.integers(4, h - 4), rng.integers(4, w - 4)] += (
            rng.uniform(0.5, 2.0, C * P))
    cube = torch.as_tensor(cube.astype(np.float32))
    weight = torch.as_tensor(rng.uniform(0.5, 1.0, (h, w)).astype(np.float32))
    fitter = SpectralFitter(rd.SpectralFittingMode.POLYNOMIAL, 2,
                            meta.frequencies, meta.weights)
    pair = (torch.as_tensor(fitter._fit_matrix, dtype=torch.float32),
            torch.as_tensor(_coefficient_basis(fitter, meta)))
    lin = ("linear", linear_integration_coefficients(meta))
    lin_t = torch.as_tensor(lin[1])
    integ = torch.einsum("n,nhw->hw", lin_t, cube) * weight
    y, x = divmod(int(torch.argmax(integ.abs())), w)
    peak0 = (float(lin_t @ cube[:, y, x]), x, y, True)
    outs = []
    for mesh in (None, pm.Mesh(*mesh_shape, torch.device("cpu"))):
        res = cube.clone()
        comp = torch.zeros((pair[1].shape[1], h, w))
        params = LoopParams.make(0.1, 0.05, abs(peak0[0]), 0.0, 400, False)
        args = (res, comp, psfs, weight, None, peak0, params, 0)
        kw = dict(meta=meta, allow_negative=True, integration=lin,
                  coefficients=pair)
        out = (hogbom_loop(*args, **kw) if mesh is None
               else pm.mesh_hogbom_loop(mesh, *args, **kw))
        outs.append((out, res, comp))
    (o1, r1, c1), (om, rm, cm) = outs
    assert om.iteration == o1.iteration > 20
    np.testing.assert_allclose(rm.numpy(), r1.numpy(), atol=1e-6)
    np.testing.assert_allclose(cm.numpy(), c1.numpy(), atol=1e-6)


def test_shard_multiscale_inputs_checks_the_device():
    """On one device the fused loop's state is not moved: the placement
    passes tensors on the mesh's device (and None) and refuses a tensor
    elsewhere."""
    mesh = pm.make_mesh(8, 4, device="cpu")
    assert pm.shard_multiscale_inputs(mesh, torch.zeros(2, 4), None) is None
    with pytest.raises(ValueError, match="lies on meta"):
        pm.shard_multiscale_inputs(mesh, torch.zeros(2, 4),
                                   torch.zeros(2, 4, device="meta"))
