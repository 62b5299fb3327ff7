"""Checkpointing and the run-length masks: the port against the JAX package.

``radler_tpu_torch.checkpoint`` writes the JAX package's format, so the
tests check a round trip in each package's way and a checkpoint that
crosses from ``radler_tpu`` to the port.  Tolerances: the point-source
contract (2e-6 absolute, the model peak 1e-4); across the packages, equal
iteration counts and the residual within 1e-5 of ``max(1, |res|max)``.
"""

import numpy as np
import pytest
import torch

import radler_tpu as jrd
from radler_tpu.utils.compressed_mask import CompressedMask as JaxMask

import radler_tpu_torch as rd
from radler_tpu_torch.interop import settings_from_reference
from radler_tpu_torch.utils.compressed_mask import CompressedMask

from test_torch_multiscale import diffuse_problem

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

SIZE = 64
PIXEL_SCALE = 1.0 / 60.0 * (np.pi / 180.0)


def cross_psf():
    ps = np.array(
        [[0.0, 0.4, 0.0], [0.25, 1.0, 0.5], [0.0, 0.6, 0.0]], np.float32
    )
    psf = np.zeros((SIZE, SIZE), np.float32)
    psf[31:34, 31:34] = ps
    return psf, ps


def make_settings(algorithm=rd.AlgorithmType.GENERIC_CLEAN):
    s = rd.Settings()
    s.algorithm_type = algorithm
    s.trimmed_image_width = SIZE
    s.trimmed_image_height = SIZE
    s.pixel_scale.x = PIXEL_SCALE
    s.pixel_scale.y = PIXEL_SCALE
    s.minor_iteration_count = 500
    s.absolute_threshold = 1e-7
    return s


def test_checkpoint_roundtrip(tmp_path):
    """``tests/test_checkpoint_and_output.py::test_checkpoint_roundtrip``:
    a perform that stops partway, a checkpoint, a fresh Radler over the
    same buffers that resumes from it and cleans to the contract."""
    psf, ps = cross_psf()
    residual = np.zeros((SIZE, SIZE), np.float32)
    residual[21:24, 26:29] = 2.5 * ps
    model = np.zeros_like(residual)
    s = make_settings()
    s.major_loop_gain = 0.9  # stop partway
    r = rd.Radler(s, psf, residual, model, 0.0, device="cpu")
    assert r.perform(0) is True
    iters_before = r.iteration_number
    path = str(tmp_path / "state.ckpt")
    r.save_state(path)

    r2 = rd.Radler(s, psf, residual, model, 0.0, device="cpu")
    r2.load_state(path)
    assert r2.iteration_number == iters_before
    again = True
    major = 1
    while again and major < 20:
        again = r2.perform(major)
        major += 1
    np.testing.assert_allclose(residual, 0.0, atol=2e-6)
    assert model[22, 27] == pytest.approx(2.5, abs=1e-4)


def multiscale_settings(package):
    s = package.Settings()
    s.trimmed_image_width = s.trimmed_image_height = 128
    s.algorithm_type = package.AlgorithmType.MULTISCALE
    s.minor_iteration_count = 150
    s.minor_loop_gain = 0.1
    s.major_loop_gain = 0.85
    s.auto_mask_sigma = 4.0
    return s


def test_multiscale_roundtrip_with_automask(tmp_path):
    """Multiscale with auto-masking: after the first (mask-tracking)
    perform, the scale infos, the scale masks and the auto-mask phase
    survive a checkpoint, and the resumed run takes the same second perform
    as the run that never stopped."""
    psfs, residual = diffuse_problem(128, 1)
    psf, dirty = psfs[0], residual[0]
    s = multiscale_settings(rd)
    runs = []
    for resume in (False, True):
        res, model = dirty.copy(), np.zeros_like(dirty)
        r = rd.Radler(s, psf, res, model, 0.0, device="cpu")
        assert r.perform(0) is True
        if resume:
            path = str(tmp_path / "ms.ckpt")
            r.save_state(path)
            alg = r._parallel.algorithms[0]
            saved = ([vars(e).copy() for e in alg.scale_infos],
                     [m.copy() for m in alg.scale_masks],
                     r._auto_mask_is_finished)
            r = rd.Radler(s, psf, res, model, 0.0, device="cpu")
            r.load_state(path)
            alg = r._parallel.algorithms[0]
            assert r._auto_mask_is_finished == saved[2]
            keys = ("scale", "kernel_peak", "psf_peak", "bias_factor",
                    "gain", "is_active", "n_components_cleaned",
                    "total_flux_cleaned")
            assert [{k: vars(e)[k] for k in keys} for e in alg.scale_infos] \
                == [{k: e[k] for k in keys} for e in saved[0]]
            assert len(alg.scale_masks) == len(saved[1]) > 1
            assert any(m.any() for m in saved[1])
            for got, want in zip(alg.scale_masks, saved[1]):
                np.testing.assert_array_equal(got, want)
        r.perform(1)
        runs.append((r.iteration_number, res, model))
    (it_a, res_a, mod_a), (it_b, res_b, mod_b) = runs
    assert it_b == it_a
    np.testing.assert_array_equal(res_b, res_a)
    np.testing.assert_array_equal(mod_b, mod_a)


def test_jax_checkpoint_loads_into_the_port(tmp_path, monkeypatch):
    """A checkpoint written by ``radler_tpu.Radler.save_state`` after the
    first multiscale perform (host path) continues in the port to the JAX
    run's iteration count and residual."""
    monkeypatch.setenv("RADLER_TPU_NO_FUSED_MS", "1")
    psfs, residual = diffuse_problem(128, 1)
    psf, dirty = psfs[0], residual[0]
    s = multiscale_settings(jrd)
    res_j, model_j = dirty.copy(), np.zeros_like(dirty)
    rj = jrd.Radler(s, psf, res_j, model_j, 0.0)
    assert rj.perform(0) is True
    path = str(tmp_path / "jax.ckpt")
    rj.save_state(path)
    res_t, model_t = res_j.copy(), model_j.copy()
    rj.perform(1)

    rt = rd.Radler(settings_from_reference(s), psf, res_t, model_t, 0.0,
                   device="cpu")
    rt.load_state(path)
    rt.perform(1)
    assert rt.iteration_number == rj.iteration_number
    scale = max(1.0, float(np.abs(res_j).max()))
    assert np.abs(res_t - res_j).max() / scale < 1e-5
    assert np.abs(model_t - model_j).max() / scale < 1e-5


class TestCompressedMask:
    """``tests/test_work_table.py::TestCompressedMask``, plus the JAX
    package's bytes for the same masks."""

    def test_roundtrip(self):
        rng = np.random.default_rng(1)
        mask = rng.random((37, 53)) > 0.9
        cm = CompressedMask(53, 37)
        assert not cm.get().any()
        cm.set(mask)
        np.testing.assert_array_equal(cm.get(), mask)

    def test_boxes(self):
        cm = CompressedMask(64, 64)
        box = np.ones((8, 12), bool)
        cm.set_box(box, 5, 7, 12, 8)
        full = cm.get()
        assert full[7:15, 5:17].all()
        assert full.sum() == 8 * 12
        got = cm.get_box(5, 7, 12, 8)
        np.testing.assert_array_equal(got, box)

    def test_long_runs(self):
        n = 300
        mask = np.zeros((n, n), bool)
        mask[150, 200] = True  # forces a > 65536 run
        cm = CompressedMask(n, n)
        cm.set(mask)
        np.testing.assert_array_equal(cm.get(), mask)

    @pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
    def test_same_bytes_as_jax(self, density):
        mask = np.random.default_rng(2).random((300, 301)) < density
        cm, jm = CompressedMask(301, 300), JaxMask(301, 300)
        cm.set(mask)
        jm.set(mask)
        assert (cm._data, cm._first_value) == (jm._data, jm._first_value)
        assert cm.compressed_size() == jm.compressed_size()
