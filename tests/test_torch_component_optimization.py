"""Component optimization and least-squares deconvolution in the port
against the JAX package, on the CPU.

:mod:`radler_tpu_torch.ops.component_optimization` (on ``torch.fft``) and
:mod:`radler_tpu_torch.models.ls_deconvolution` against their JAX twins on
the same NumPy inputs, and ``Radler.perform`` with component optimization
(which ``radler.py`` switches on once auto-masking has finished) for
generic CLEAN and multiscale.  Tolerances, with their reasons:

* the solvers' outputs: 1e-5 of the largest value (float32 FFT
  convolutions and solves round differently in the two packages);
* the original tests' own gates (``test_ops.py::TestComponentOptimization``,
  ``test_algorithms.py::test_ls_deconvolution_*``) as they stand;
* ``perform``: equal results and iteration counts, the residual within
  2e-6 of ``max(1, |res|max)`` and the model within 1e-4, the parity
  contract (the JAX run on its input times float32(1 + 1e-7) moves by
  1.8e-7 to 2.0e-7 in the residual and up to 3.9e-6 in the model on this
  field).
"""

import numpy as np
import pytest
import torch

import radler_tpu as jrd
import radler_tpu.ops.component_optimization as jco
from radler_tpu.image_set import ImageSet as JaxImageSet
from radler_tpu.models.ls_deconvolution import LsDeconvolution as JaxLs
from radler_tpu.ops.convolution import padded_convolve as jax_convolve

import radler_tpu_torch as rd
import radler_tpu_torch.ops.component_optimization as tco
from radler_tpu_torch.image_set import ImageSet
from radler_tpu_torch.models import generic_clean as gc
from radler_tpu_torch.models import multiscale as ms
from radler_tpu_torch.models.ls_deconvolution import LsDeconvolution

from test_torch_facets import gaussian_psf, point_field, run, settings

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

t = torch.as_tensor


def close(port, jax_value, rtol=1e-5):
    want = np.asarray(jax_value)
    got = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    assert np.abs(got - want).max() <= rtol * max(1.0, np.abs(want).max())


def problem():
    """``TestComponentOptimization``'s field: two components under a 3-pixel
    PSF at 32^2."""
    size = 32
    psf = np.zeros((size, size), np.float32)
    psf[size // 2, size // 2] = 1.0
    psf[size // 2, size // 2 + 1] = 0.3
    psf[size // 2 + 1, size // 2] = 0.2
    model_true = np.zeros((size, size), np.float32)
    model_true[10, 10] = 2.0
    model_true[20, 25] = -1.0
    dirty = np.array(jax_convolve(model_true, psf))
    return size, psf, model_true, dirty


def test_linear_solve_exact():
    size, psf, model_true, dirty = problem()
    seed = (model_true != 0).astype(np.float32) * np.float32(1e-30)
    model, residual = tco.linear_component_solve(t(seed), t(dirty), t(psf))
    jm, jr = jco.linear_component_solve(seed, dirty, psf)
    close(model, jm)
    close(residual, jr)
    assert float(model[10, 10]) == pytest.approx(2.0, abs=1e-4)
    assert float(model[20, 25]) == pytest.approx(-1.0, abs=1e-4)
    assert abs(float(residual[10, 10])) < 1e-5


def test_gradient_descent_reduces_rms():
    size, psf, model_true, dirty = problem()
    support = (model_true != 0).astype(np.float32)
    model, residual = tco.gradient_descent(
        torch.zeros((size, size)), t(dirty), t(psf), support_mask=t(support))
    jm, jr = jco.gradient_descent(
        np.zeros((size, size), np.float32), dirty, psf, support_mask=support)
    close(model, jm)
    close(residual, jr)
    rms_before = float(np.sqrt((dirty**2).mean()))
    assert float(torch.sqrt(torch.mean(residual**2))) < 0.1 * rms_before
    assert float(model[10, 10]) == pytest.approx(2.0, rel=0.05)


def test_variable_psf_joint_fit():
    size = 32
    psf_a = np.zeros((size, size), np.float32)
    psf_a[size // 2, size // 2] = 1.0
    psf_b = psf_a.copy()
    psf_b[size // 2, size // 2 + 1] = 0.5
    model_a = np.zeros((size, size), np.float32)
    model_a[8, 8] = 1.5
    model_b = np.zeros((size, size), np.float32)
    model_b[22, 20] = 0.7
    dirty = np.array(jax_convolve(model_a, psf_a)
                       + jax_convolve(model_b, psf_b))
    supports = [(m != 0).astype(np.float32) for m in (model_a, model_b)]
    deltas = tco.gradient_descent_with_variable_psf(
        [t(s_) for s_ in supports], t(dirty), [t(psf_a), t(psf_b)])
    want = jco.gradient_descent_with_variable_psf(supports, dirty,
                                                  [psf_a, psf_b])
    for got, w in zip(deltas, want):
        close(got, w)
    assert float(deltas[0][8, 8]) == pytest.approx(1.5, rel=0.05)
    assert float(deltas[1][22, 20]) == pytest.approx(0.7, rel=0.05)


def lm_field():
    size = 32
    psf = np.zeros((size, size), np.float32)
    psf[size // 2, size // 2] = 1.0
    psf[size // 2, size // 2 + 1] = 0.4
    psf[size // 2 + 1, size // 2] = 0.25
    truth = {(10, 10): 2.0, (20, 14): 1.0}
    residual = np.zeros((size, size), np.float32)
    for (y, x), a in truth.items():
        residual[y, x] += a
        residual[y, x + 1] += 0.4 * a
        residual[y + 1, x] += 0.25 * a
    return psf, residual, truth


def image_sets(package, table_module, image_set_class, residual, psf):
    table = table_module.WorkTable([], 1, 1)
    e = table_module.WorkTableEntry()
    e.image_weight = 1.0
    e.psf_accessors = [table_module.LoadOnlyImageAccessor(psf)]
    e.residual_accessor = table_module.LoadAndStoreImageAccessor(residual)
    e.model_accessor = table_module.LoadAndStoreImageAccessor(
        np.zeros_like(residual))
    table.add_entry(e)
    size = residual.shape[-1]
    extra = ("cpu",) if package is rd else ()
    sets = [image_set_class.from_table(table, False, set(), size, size,
                                       *extra) for _ in range(2)]
    sets[0].load_and_average(True)
    sets[1].load_and_average(False)
    return sets


def ls_run(package, use_linear, residual, psf, mask):
    import importlib

    tables = importlib.import_module(package.__name__ + ".work_table")
    sets = image_sets(package, tables,
                      ImageSet if package is rd else JaxImageSet,
                      residual.copy(), psf)
    alg = (LsDeconvolution if package is rd else JaxLs)(
        use_linear_solver=use_linear)
    psfs = t(psf)[None] if package is rd else np.asarray(psf)[None]
    if not use_linear:
        with pytest.raises(RuntimeError, match="mask"):
            alg.execute_major_iteration(sets[0], sets[1], psfs)
    alg.clean_mask = mask
    alg.execute_major_iteration(sets[0], sets[1], psfs)
    return np.asarray(sets[1].data[0]), np.asarray(sets[0].data[0])


def test_ls_deconvolution_linear():
    """``test_ls_deconvolution_linear``: exact amplitudes at the mask."""
    size = 32
    psf = np.zeros((size, size), np.float32)
    psf[size // 2, size // 2] = 1.0
    psf[size // 2, size // 2 + 1] = 0.4
    residual = np.zeros((size, size), np.float32)
    residual[10, 10] = 2.0
    residual[10, 11] = 0.8
    mask = np.zeros((size, size), bool)
    mask[10, 10] = True
    model, res = ls_run(rd, True, residual, psf, mask)
    jmodel, jres = ls_run(jrd, True, residual, psf, mask)
    close(model, jmodel)
    close(res, jres)
    assert model[10, 10] == pytest.approx(2.0, abs=1e-4)
    assert abs(res[10, 10]) < 1e-5
    assert abs(res[10, 11]) < 1e-4


def test_ls_deconvolution_nonlinear():
    """``test_ls_deconvolution_nonlinear``: the regularized fit needs a
    mask, lands near the truth, and shrinks more with a stronger
    regularization."""
    psf, residual, truth = lm_field()
    mask = np.zeros(residual.shape, bool)
    for (y, x) in truth:
        mask[y, x] = True
    model, res = ls_run(rd, False, residual, psf, mask)
    jmodel, jres = ls_run(jrd, False, residual, psf, mask)
    close(model, jmodel)
    close(res, jres)
    for (y, x), a in truth.items():
        assert model[y, x] == pytest.approx(a, rel=0.05)
    assert float(np.abs(res).max()) < 0.1
    weak, _ = tco.lm_nonlinear_fit(mask, t(residual), t(psf),
                                   regularization=0.01)
    strong, _ = tco.lm_nonlinear_fit(mask, t(residual), t(psf),
                                     regularization=2.0)
    assert float(strong.abs().sum()) < float(weak.abs().sum())
    close(weak, jco.lm_nonlinear_fit(mask, residual, psf,
                                     regularization=0.01)[0])


def test_unsupported_optimization_raises_as_in_jax():
    """REGULARIZED_GRADIENT_DESCENT has no generic CLEAN solver: the same
    RuntimeError in both packages."""

    class Sets:
        n_images = 1

        def __init__(self, data):
            self.data = data
            self.meta = type("Meta", (), {"psf_index": lambda _, i: 0})()

    for module, package, zeros, psf in (
            (tco, rd, torch.zeros((1, 8, 8)), torch.eye(8)[None]),
            (jco, jrd, np.zeros((1, 8, 8), np.float32),
             np.eye(8, dtype=np.float32)[None])):
        with pytest.raises(RuntimeError, match="Unsupported optimization"):
            module.run_component_optimization(
                Sets(zeros), Sets(zeros), psf,
                package.OptimizationAlgorithm.REGULARIZED_GRADIENT_DESCENT)


# ---------------------------------------------------------------------------
# Through Radler.perform
# ---------------------------------------------------------------------------

CASES = {
    "generic-linear": ("GENERIC_CLEAN", "LINEAR_EQUATION_SOLVER", gc,
                       "run_component_optimization"),
    "generic-gradient": ("GENERIC_CLEAN", "GRADIENT_DESCENT", gc,
                         "run_component_optimization"),
    "multiscale-gradient": ("MULTISCALE", "GRADIENT_DESCENT",
                            ms.MultiScaleAlgorithm,
                            "_run_full_component_fitter"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_perform_with_component_optimization_matches_jax(case, monkeypatch):
    """Six point sources in noise at 64^2, auto-masking at 4 sigma and the
    source list, majors until done: once auto-masking has finished the
    next perform optimizes the components instead of cleaning, in both
    packages alike; the optimization runs in the port and moves the
    model."""
    algorithm, optimization, owner, name = CASES[case]
    size = 64
    psf = gaussian_psf(size)
    residual = point_field(size, psf, n=6) + np.random.default_rng(6).normal(
        scale=0.01, size=(size, size)).astype(np.float32)
    s = settings(algorithm, size, grid=1, iterations=3000,
                 absolute_threshold=0.0, auto_mask_sigma=4.0,
                 save_source_list=True)
    plain = run(rd, s, psf, residual, monkeypatch, True, majors=6)
    s.component_optimization_algorithm = getattr(jrd.OptimizationAlgorithm,
                                                 optimization)
    calls = []
    orig = getattr(owner, name)

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    j = run(jrd, s, psf, residual, monkeypatch, True, majors=6)
    monkeypatch.setattr(owner, name, spy)
    tr = run(rd, s, psf, residual, monkeypatch, True, majors=6)
    assert tr[4]._auto_mask_is_finished and calls == [1]
    assert tr[0] == j[0] and tr[1] == j[1]
    scale = max(1.0, float(np.abs(j[2]).max()))
    np.testing.assert_allclose(tr[2], j[2], atol=2e-6 * scale)
    np.testing.assert_allclose(tr[3], j[3], atol=1e-4)
    assert np.abs(tr[3] - plain[3]).max() > 1e-3
