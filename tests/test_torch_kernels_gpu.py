"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they need a CUDA device and skip elsewhere (the decision is
taken inside a fixture, so every worker collects the same tests).  On a
machine with a card and no JAX, run them with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

This file imports nothing of JAX.  Kernel and plain version perform the same
float32 operations in the same order, so results are compared bit for bit.
"""

import numpy as np
import pytest
import torch

import radler_tpu_torch as rd
from radler_tpu_torch.image_set import CubeMeta, linear_integration_coefficients
from radler_tpu_torch.kernels import hogbom_step as hs
from radler_tpu_torch.ops.spectral_fitting import SpectralFitter

pytestmark = pytest.mark.gpu

HEIGHT, WIDTH = 257, 383  # ragged: no dimension a multiple of a block

CASES = [
    ("signed", 1, 1, False),
    ("linear", 4, 1, False),
    ("normal", 4, 1, False),
    ("normal", 2, 4, False),
    ("squared", 2, 4, True),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_case(case, device, seed=0):
    mode, C, P, squared = case
    rng = np.random.default_rng(seed)
    weights = tuple(float(w) for w in rng.uniform(0.5, 2.0, C))
    meta = CubeMeta(C, P, weights, (True,) * P, 1.0, squared,
                    tuple(1e8 + 1e7 * c for c in range(C)))
    if mode == "linear":
        chan, pol = linear_integration_coefficients(meta), np.ones(1)
    else:
        _, chan, pol = hs.integration_coefficients(meta)
    res = rng.normal(scale=0.01, size=(C * P, HEIGHT, WIDTH)).astype(np.float32)
    for _ in range(12):
        y, x = rng.integers(0, HEIGHT), rng.integers(0, WIDTH)
        res[:, y, x] += rng.uniform(0.5, 2.0, C * P).astype(np.float32)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
    r2 = (yy - HEIGHT // 2) ** 2.0 + (xx - WIDTH // 2) ** 2.0
    psfs = np.stack(
        [np.exp(-r2 / (2.0 * (1.5 + 0.4 * c) ** 2)) for c in range(C)]
    ).astype(np.float32)
    weight = rng.uniform(0.0, 1.0, (HEIGHT, WIDTH)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return dict(
        meta=meta, mode=mode, P=P, res=t(res), psfs=t(psfs), weight=t(weight),
        coefs=t(hs.kernel_coefficients(mode, chan, pol)),
    )


def start_buffers(res, gain):
    n, _, width = res.shape
    flat = int(torch.argmax(res[0].abs()))
    y, x = divmod(flat, width)
    raw = res[:, y, x].clone()
    state = torch.tensor([y, x, 1, 0, 0, 1, flat, 0], dtype=torch.int32,
                         device=res.device)
    return hs.LoopBuffers(state, torch.zeros(1, device=res.device), raw,
                          raw * gain)


@pytest.mark.parametrize("allow_negative", [True, False])
@pytest.mark.parametrize("use_weight", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_step_and_select_bit_equal_to_plain(cuda, case, use_weight,
                                            allow_negative):
    c = make_case(case, cuda)
    params = hs.LoopParams.make(0.1, 0.0, 10.0, 0.0, 100, False)
    outs = []
    for plain in (False, True):
        res = c["res"].clone()
        model = torch.zeros_like(res)
        buffers = start_buffers(res, params.gain)
        step = hs.hogbom_step_reference if plain else hs.hogbom_step
        select = hs.hogbom_select_reference if plain else hs.hogbom_select
        partials = step(res, model, c["psfs"], buffers.values, buffers.state,
                        c["coefs"], c["weight"] if use_weight else None,
                        mode=c["mode"], n_polarizations=c["P"],
                        allow_negative=allow_negative)
        select(partials, res, buffers, params)
        torch.cuda.synchronize()
        outs.append((res, model, partials, buffers))
    (rk, mk, pk, bk), (rp, mp, pp, bp) = outs
    assert torch.equal(rk, rp) and torch.equal(mk, mp)
    for a, b in zip(pk, pp):
        assert torch.equal(a, b)
    for name in ("state", "value", "peak", "values"):
        assert torch.equal(getattr(bk, name), getattr(bp, name)), name


@pytest.mark.parametrize("fit_mode", ["NO_FITTING", "POLYNOMIAL"])
def test_loop_bit_equal_to_plain(cuda, fit_mode):
    """The chunked loop with the spectral fit between launches and an rms
    factor: kernel and plain loop end in the same state."""
    c = make_case(("normal", 2, 4, False), cuda, seed=3)
    fitter = SpectralFitter(
        getattr(rd.SpectralFittingMode, fit_mode), 2, [1e8, 1.1e8], [1.0, 2.0]
    )
    rms = torch.as_tensor(
        np.random.default_rng(4).uniform(0.5, 1.5, (HEIGHT, WIDTH)),
        dtype=torch.float32, device=cuda,
    )
    outs = []
    for plain in (False, True):
        res = c["res"].clone()
        model = torch.zeros_like(res)
        flat = int(torch.argmax(res[0].abs()))
        y, x = divmod(flat, WIDTH)
        params = hs.LoopParams.make(0.2, 0.05, 5.0, 4.0, 300, False)
        out = hs.hogbom_loop(
            res, model, c["psfs"], c["weight"] * rms, rms,
            (float(res[0, y, x]), x, y, True), params, 0, meta=c["meta"],
            allow_negative=True, fitter=fitter if fitter.is_active else None,
            plain=plain,
        )
        outs.append((out, res, model))
    (ok, rk, mk), (op, rp, mp) = outs
    assert ok == op and ok.iteration > 10
    assert torch.equal(rk, rp) and torch.equal(mk, mp)


def test_perform_point_source_and_counts(cuda):
    """The reference contract through Radler.perform on CUDA tensors, and
    one launch of each kernel per iteration."""
    size = 64
    point = np.array([[0.0, 0.4, 0.0], [0.25, 1.0, 0.5], [0.0, 0.6, 0.0]],
                     np.float32)
    psf = np.zeros((size, size), np.float32)
    psf[31:34, 31:34] = point
    res = np.zeros((size, size), np.float32)
    res[46:49, 22:25] = 2.5 * point
    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.minor_iteration_count = 1000
    s.absolute_threshold = 1e-8
    s.generic.use_sub_minor_optimization = False
    r = rd.Radler(s, torch.as_tensor(psf, device=cuda),
                  torch.as_tensor(res, device=cuda),
                  torch.zeros(size, size, device=cuda), 0.0)
    hs.hogbom_step.launches = hs.hogbom_select.launches = 0
    assert r.perform(0) is False
    assert hs.hogbom_step.launches == hs.hogbom_select.launches
    assert r.iteration_number <= hs.hogbom_step.launches
    assert hs.hogbom_step.launches < r.iteration_number + hs.CHUNK
    front = r._table.front
    assert front.residual_accessor.array.device.type == "cuda"
    out_res = front.residual_accessor.array.cpu().numpy()
    out_mod = front.model_accessor.array.cpu().numpy()
    assert np.abs(out_res).max() < 2e-6
    assert out_mod[47, 23] == pytest.approx(2.5, rel=1e-4)


def test_wrapper_rejects_bad_inputs(cuda):
    c = make_case(CASES[0], cuda)
    buffers = start_buffers(c["res"], 0.1)
    kw = dict(mode="signed", n_polarizations=1, allow_negative=True)
    with pytest.raises(ValueError):
        hs.hogbom_step(c["res"].transpose(1, 2), torch.zeros_like(c["res"]),
                       c["psfs"], buffers.values, buffers.state, c["coefs"],
                       **kw)
    with pytest.raises(TypeError):
        hs.hogbom_step(c["res"], torch.zeros_like(c["res"]), c["psfs"].double(),
                       buffers.values, buffers.state, c["coefs"], **kw)
    with pytest.raises(ValueError):
        hs.hogbom_step(c["res"], torch.zeros_like(c["res"]).cpu(), c["psfs"],
                       buffers.values, buffers.state, c["coefs"], **kw)


def test_numpy_inputs_run_on_the_device_argument(cuda):
    """NumPy images with ``device="cuda"`` run through the kernels and come
    back into the caller's arrays."""
    size = 96
    rng = np.random.default_rng(5)
    psf = np.zeros((size, size), np.float32)
    psf[size // 2, size // 2] = 1.0
    psf[size // 2, size // 2 + 1] = 0.4
    res = rng.normal(scale=0.01, size=(size, size)).astype(np.float32)
    res[30, 40] += 1.5
    model = np.zeros_like(res)
    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.minor_iteration_count = 200
    s.absolute_threshold = 0.05
    s.generic.use_sub_minor_optimization = False
    before = hs.hogbom_step.launches
    plain_res, plain_model = res.copy(), model.copy()
    rd.Radler(s, psf, res, model, 0.0, device=cuda).perform(0)
    rd.Radler(s, psf, plain_res, plain_model, 0.0).perform(0)  # CPU, plain
    assert hs.hogbom_step.launches > before
    np.testing.assert_array_equal(res, plain_res)
    np.testing.assert_array_equal(model, plain_model)
    assert model[30, 40] > 1.0
