"""IUWT and facet grids on a device mesh: the port against itself on one
device and against the JAX package's mesh runs.

Twins ``tests/test_mesh_iuwt.py::test_mesh_iuwt_matches_single_device`` and
``tests/test_mesh_facets.py::test_facets_sharded_over_mesh_match_single_device``
(both algorithms) for ``radler_tpu_torch``.  In the JAX package both are
placements over the mesh's devices (IUWT's rows; the batched facets' facet
axis); every shard of the port's mesh lies on one device, so the port runs
them as on one device, bit for bit.  On the serial facet route each
facet's clone keeps the mesh and takes the mesh routes by the JAX
package's rule, applied to the facet's own height.

Tolerances, each with its reason:

* the port's mesh run against its single-device run: bit-equal;
* against the JAX mesh run: the JAX tests' own 2e-5 of max(1, |res|max)
  between a mesh and a single device, and equal iteration counts, on a
  field without exact ties for the facets (``test_mesh_facets.py``'s
  round blob has mirror ties, which each package's FFTs break their own
  way, as ``tests/test_mesh_multiscale.py``'s do); the
  serial facets on a chan 2 x tile 4 mesh the parity contract, 2e-6 of
  max(1, |res|max) (``test_torch_facets.py``'s scaling).
"""

import numpy as np
import pytest
import jax

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu_torch.interop import settings_from_reference

from test_mesh_iuwt import _problem as iuwt_problem
from test_torch_facets import (
    assert_parity,
    gaussian_psf,
    point_field,
    run,
    settings,
)
from tests.test_batched_facets import _gaussian_psf, _sky_residual

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")

MESH_VS_SINGLE = 2e-5


def scaled_max(a, b, ref):
    return np.abs(a - b).max() / max(1.0, float(np.abs(ref).max()))


def iuwt_run(package, use_mesh):
    """``test_mesh_iuwt.py``'s run: 256^2, six structure iterations."""
    psf, residual = iuwt_problem()
    size = residual.shape[0]
    s = jrd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.algorithm_type = jrd.AlgorithmType.IUWT
    s.minor_iteration_count = 6
    s.major_loop_gain = 0.8
    s.parallel.use_device_mesh = use_mesh
    model = np.zeros_like(residual)
    resid = residual.copy()
    if package is jrd:
        r = jrd.Radler(s, psf, resid, model, 0.0)
    else:
        s.parallel.n_devices = 8 if use_mesh else 0
        r = rd.Radler(settings_from_reference(s), psf, resid, model, 0.0,
                      device="cpu")
        assert (r._parallel.first_algorithm.device_mesh is not None
                and r._parallel.first_algorithm.device_mesh.size == 8
                ) == use_mesh
    more = r.perform(0)
    return residual, resid, model, r.iteration_number, more


@needs_8
def test_mesh_iuwt_matches_single_device():
    res0, res_1, mdl_1, it_1, more_1 = iuwt_run(rd, False)
    _, res_m, mdl_m, it_m, more_m = iuwt_run(rd, True)
    # The run actually deconvolved.
    assert float(np.sqrt(np.mean(res_1**2))) < 0.9 * float(
        np.sqrt(np.mean(res0**2)))
    assert (it_m, more_m) == (it_1, more_1)
    np.testing.assert_array_equal(res_m, res_1)
    np.testing.assert_array_equal(mdl_m, mdl_1)
    _, res_j, mdl_j, it_j, more_j = iuwt_run(jrd, True)
    assert (it_m, more_m) == (it_j, more_j)
    assert scaled_max(res_m, res_j, res_j) < MESH_VS_SINGLE
    assert scaled_max(mdl_m, mdl_j, res_j) < MESH_VS_SINGLE


def facet_mesh_run(package, use_mesh, monkeypatch, algorithm,
                   tie_free=False):
    """``test_mesh_facets.py``'s run: 128^2, 2x2 facets, 300 iterations,
    the default (batched) route, on its field, or with ``tie_free`` on
    ``point_field``'s (that field's round blob makes exact mirror ties,
    which each package's FFTs break their own way)."""
    monkeypatch.delenv("RADLER_TPU_NO_BATCHED_FACETS", raising=False)
    size = 128
    psf = _gaussian_psf(size)
    residual = (point_field(size, psf) if tie_free
                else _sky_residual(size, psf))
    model = np.zeros_like(residual)
    s = jrd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.algorithm_type = getattr(jrd.AlgorithmType, algorithm)
    s.minor_iteration_count = 300
    s.absolute_threshold = 5e-3
    s.major_loop_gain = 0.8
    s.multiscale.max_scales = 3
    s.parallel.grid_width = 2
    s.parallel.grid_height = 2
    s.parallel.use_device_mesh = use_mesh
    if package is jrd:
        r = jrd.Radler(s, psf, residual, model, 0.0)
    else:
        s.parallel.n_devices = 8 if use_mesh else 0
        r = rd.Radler(settings_from_reference(s), psf, residual, model, 0.0,
                      device="cpu")
    more = r.perform(0)
    if package is rd:
        assert r._parallel.last_route == "batched"
    return residual, model, more, r.iteration_number


@needs_8
@pytest.mark.parametrize("algorithm", ["MULTISCALE", "GENERIC_CLEAN"])
def test_facets_sharded_over_mesh_match_single_device(monkeypatch,
                                                      algorithm):
    res_1, mdl_1, more_1, it_1 = facet_mesh_run(rd, False, monkeypatch,
                                                algorithm)
    res_m, mdl_m, more_m, it_m = facet_mesh_run(rd, True, monkeypatch,
                                                algorithm)
    assert mdl_1.max() > 0
    assert (more_m, it_m) == (more_1, it_1)
    np.testing.assert_array_equal(res_m, res_1)
    np.testing.assert_array_equal(mdl_m, mdl_1)
    res_m, mdl_m, more_m, it_m = facet_mesh_run(rd, True, monkeypatch,
                                                algorithm, tie_free=True)
    res_j, mdl_j, more_j, it_j = facet_mesh_run(jrd, True, monkeypatch,
                                                algorithm, tie_free=True)
    assert mdl_j.max() > 0
    assert (more_m, it_m) == (more_j, it_j)
    np.testing.assert_allclose(res_m, res_j, atol=MESH_VS_SINGLE)
    np.testing.assert_allclose(mdl_m, mdl_j, atol=MESH_VS_SINGLE)


def two_channel_field(seed):
    """Two channels (1 and 0.8 times ``point_field``'s sky, no blob: its
    symmetric blob makes exact mirror ties) and their frequencies."""
    psf = gaussian_psf(128)
    res = point_field(128, psf, seed=seed)
    return (np.stack([psf, psf]), np.stack([res, 0.8 * res]),
            np.array([[1e8, 1.1e8], [1.1e8, 1.2e8]]))


@needs_8
def test_generic_serial_facets_on_a_mesh_match_jax(monkeypatch):
    """Serial facets, the Clark setting, on a chan 2 x tile 4 mesh: every
    facet's clone runs the mesh's Clark subminor loop (B2's tile axis).
    The field's facets are 68, 64, 80 and 80 rows high, so that every
    facet divides over the 4 tiles: the JAX package's fallback for a facet
    that does not raises (``jax.device_put`` of uneven shards)."""
    psfs, residual, freqs = two_channel_field(seed=11)
    s = settings("GENERIC_CLEAN", 128, iterations=300,
                 generic__use_sub_minor_optimization=True,
                 parallel__use_device_mesh=True, parallel__n_devices=8)
    t = run(rd, s, psfs, residual, monkeypatch, True, frequencies=freqs)
    assert t[4]._parallel.last_route == "serial"
    assert [b.height for b in t[5]] == [68, 64, 80, 80]
    mesh = t[4]._parallel.first_algorithm.device_mesh
    assert (mesh.chan, mesh.tile) == (2, 4)
    j = run(jrd, s, psfs, residual, monkeypatch, True, frequencies=freqs)
    assert t[1] == j[1] and sum(t[1]) > 0
    assert_parity(j, t, atol=2e-6 * max(1.0, float(np.abs(j[2]).max())))


@needs_8
def test_ragged_facets_on_a_mesh_take_the_single_device_loop(monkeypatch):
    """Facets 70, 58, 72 and 80 rows high on a chan 2 x tile 4 mesh with
    the Högbom setting: the two ragged facets run the single-device loop,
    the others the mesh's Högbom loop, and the whole matches the JAX
    package's serial run without a mesh (the mesh's loop differs from one
    device's only on exact ties, which this field has none of).  The JAX
    package's own mesh run raises there."""
    psfs, residual, freqs = two_channel_field(seed=0)
    s = settings("GENERIC_CLEAN", 128, iterations=300,
                 parallel__use_device_mesh=True, parallel__n_devices=8)
    t = run(rd, s, psfs, residual, monkeypatch, True, frequencies=freqs)
    assert [b.height for b in t[5]] == [70, 58, 72, 80]
    with pytest.raises(ValueError, match="divisible"):
        run(jrd, s, psfs, residual, monkeypatch, True, frequencies=freqs)
    s.parallel.use_device_mesh = False
    j = run(jrd, s, psfs, residual, monkeypatch, True, frequencies=freqs)
    assert t[1] == j[1] and sum(t[1]) > 0
    assert_parity(j, t, atol=2e-6 * max(1.0, float(np.abs(j[2]).max())))
