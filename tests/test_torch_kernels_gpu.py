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
from radler_tpu_torch.kernels import iuwt_atrous as ia
from radler_tpu_torch.kernels import subminor_loop as sl
from radler_tpu_torch.models.subminor import SubMinorLoop
from radler_tpu_torch.ops import iuwt as iuwt_ops
from radler_tpu_torch.ops.convolution import padded_convolve
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
    rd.Radler(s, psf, plain_res, plain_model, 0.0, device="cpu").perform(0)
    assert hs.hogbom_step.launches > before
    np.testing.assert_array_equal(res, plain_res)
    np.testing.assert_array_equal(model, plain_model)
    assert model[30, 40] > 1.0


# ---------------------------------------------------------------------------
# The Clark subminor loop (kernel B2)
# ---------------------------------------------------------------------------


def subminor_case(C, P, use_rms, allow_negative, device, seed=0):
    """A candidate set of the ragged cube of :func:`make_case`, selected by
    SubMinorLoop."""
    c = make_case(("linear", C, P, False), device, seed)
    loop = SubMinorLoop(WIDTH, HEIGHT, 2 * WIDTH, 2 * HEIGHT)
    loop.set_threshold(0.01, 0.0)
    loop.allow_negative_components = allow_negative
    if use_rms:
        loop.rms_factor_image = c["weight"] + 0.5
    assert loop.find_peak_positions(c["res"], c["meta"]) > 100
    coef = torch.as_tensor(linear_integration_coefficients(c["meta"]),
                           device=device)
    proj = None
    if C > 1:
        fitter = SpectralFitter(rd.SpectralFittingMode.POLYNOMIAL, 2,
                                c["meta"].frequencies, c["meta"].weights)
        proj = torch.as_tensor(np.asarray(fitter._projection, np.float32),
                               device=device)
    return loop, c["psfs"], coef, proj


# (C, P, polynomial fit, rms factor, allow negative, stop on negative); a
# fit needs more than one channel, stopping on negatives allows them.
SUBMINOR_CASES = [
    (C, P, fit, use_rms, allow_negative, stop_on_negative)
    for C, P in ((1, 1), (4, 1), (2, 2))
    for fit in ((False, True) if C > 1 else (False,))
    for use_rms in (False, True)
    for allow_negative, stop_on_negative in ((True, False), (False, False),
                                             (True, True))
]


@pytest.mark.parametrize(
    "case", SUBMINOR_CASES,
    ids=lambda c: "{}x{}-fit{:d}-rms{:d}-neg{:d}-stop{:d}".format(*c),
)
def test_subminor_loop_bit_equal_to_plain(cuda, case):
    C, P, fit, use_rms, allow_negative, stop_on_negative = case
    loop, psfs, coef, proj = subminor_case(C, P, use_rms, allow_negative, cuda)
    params = sl.SubminorParams.make(0.005, 0.1, 3, 250, 4.0, allow_negative,
                                    stop_on_negative)
    outs = []
    for run in (sl.subminor_loop, sl.subminor_loop_reference):
        res = loop._residual_k.clone()
        model = torch.zeros_like(res)
        out = run(res, model, loop._rms_k, loop._xs, loop._ys,
                  psfs, coef, proj if fit else None, params,
                  n_polarizations=P)
        torch.cuda.synchronize()
        outs.append((out, res, model))
    (ok, rk, mk), (op, rp, mp) = outs
    assert torch.equal(ok, op)
    assert torch.equal(rk, rp) and torch.equal(mk, mp)
    assert sl.read_result(ok)[0] > 3


# Launch plans the kernel is held to beside its own: every cluster size,
# the state in global memory, the exchange with and without raw values.
SUBMINOR_PLANS = [
    dict(cluster_size=1), dict(cluster_size=2), dict(cluster_size=4),
    dict(cluster_size=8), dict(cluster_size=16),
    dict(cluster_size=16, on_chip=False), dict(cluster_size=1, on_chip=False),
    dict(cluster_size=4, ship_raw=False), dict(cluster_size=1, ship_raw=False),
]


@pytest.mark.parametrize(
    "plan", SUBMINOR_PLANS,
    ids=lambda p: "-".join(f"{k}{v}" for k, v in p.items()))
@pytest.mark.parametrize("case", [(1, 1, False, False), (2, 2, True, True)],
                         ids=["1x1", "2x2-fit-rms"])
def test_subminor_loop_every_plan_bit_equal_to_plain(cuda, case, plan):
    """Each cluster size, the global-state route and both exchanges give the
    plain version's bits, over a candidate count that no cluster size times
    the block's threads divides."""
    C, P, fit, use_rms = case
    loop, psfs, coef, proj = subminor_case(C, P, use_rms, True, cuda, seed=5)
    k = loop._residual_k.shape[1]
    params = sl.SubminorParams.make(0.005, 0.1, 0, 250, 4.0, True, False)
    outs = []
    for forced in (None, sl.cluster_plan(C * P, k, **plan)):
        res = loop._residual_k.clone()
        model = torch.zeros_like(res)
        args = (res, model, loop._rms_k, loop._xs, loop._ys, psfs, coef,
                proj if fit else None, params)
        if forced is None:
            out = sl.subminor_loop_reference(*args, n_polarizations=P)
        else:
            out = sl.subminor_loop(*args, n_polarizations=P, _plan=forced)
        torch.cuda.synchronize()
        outs.append((out, res, model))
    (op, rp, mp), (ok, rk, mk) = outs
    assert torch.equal(ok, op)
    assert torch.equal(rk, rp) and torch.equal(mk, mp)
    assert sl.read_result(ok)[0] > 3


def test_subminor_loop_few_candidates_on_a_full_cluster(cuda):
    """37 candidates on 16 blocks: most blocks own none."""
    loop, psfs, coef, _ = subminor_case(1, 1, False, True, cuda, seed=6)
    k = 37
    params = sl.SubminorParams.make(0.0, 0.1, 0, 100, 0.0, True, False)
    outs = []
    for forced in (None, sl.cluster_plan(1, k, cluster_size=16)):
        res = loop._residual_k[:, :k].clone()  # a slice of one row is a view
        model = torch.zeros_like(res)
        args = (res, model, None, loop._xs[:k].contiguous(),
                loop._ys[:k].contiguous(), psfs, coef, None, params)
        if forced is None:
            out = sl.subminor_loop_reference(*args, n_polarizations=1)
        else:
            out = sl.subminor_loop(*args, n_polarizations=1, _plan=forced)
        torch.cuda.synchronize()
        outs.append((out, res, model))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][2], outs[1][2])
    assert sl.read_result(outs[1][0])[0] == 100


def test_subminor_refused_launch_raises(cuda):
    """A launch the card cannot take (more shared memory than a block may
    hold) raises from the wrapper; nothing falls back to a smaller
    cluster."""
    loop, psfs, coef, _ = subminor_case(1, 1, False, True, cuda)
    k = loop._residual_k.shape[1]
    plan = sl.cluster_plan(1, k, cluster_size=2)._replace(
        shared_bytes=2 * sl.SHARED_BYTES_PER_BLOCK)
    params = sl.SubminorParams.make(0.01, 0.1, 0, 10, 0.0, True, False)
    res = loop._residual_k.clone()
    before = sl.subminor_loop.launches
    with pytest.raises(RuntimeError):
        sl.subminor_loop(res, torch.zeros_like(res), None, loop._xs, loop._ys,
                         psfs, coef, None, params, n_polarizations=1,
                         _plan=plan)
    assert sl.subminor_loop.launches == before
    torch.cuda.synchronize()


def test_subminor_loop_diverges_like_plain(cuda):
    loop, psfs, coef, _ = subminor_case(1, 1, False, True, cuda, seed=2)
    params = sl.SubminorParams.make(0.01, 0.1, 0, 200, 4.0, True, False)
    outs = []
    for run in (sl.subminor_loop, sl.subminor_loop_reference):
        res = loop._residual_k.clone()
        model = torch.zeros_like(res)
        outs.append(run(res, model, None, loop._xs, loop._ys,
                        -2.5 * psfs, coef, None, params, n_polarizations=1))
    assert torch.equal(outs[0], outs[1])
    assert sl.read_result(outs[0])[2]


def test_subminor_wrapper_rejects_bad_inputs(cuda):
    loop, psfs, coef, _ = subminor_case(1, 1, False, True, cuda)
    params = sl.SubminorParams.make(0.01, 0.1, 0, 10, 0.0, True, False)
    res = loop._residual_k.clone()
    args = [res, torch.zeros_like(res), None, loop._xs, loop._ys, psfs, coef,
            None, params]
    bad = {
        1: (torch.zeros_like(res).double(), TypeError),
        2: (torch.ones(7, device=cuda), ValueError),
        3: (loop._xs.long(), TypeError),
        4: (loop._ys.cpu(), ValueError),
        5: (psfs.transpose(1, 2), ValueError),
    }
    for index, (value, error) in bad.items():
        broken = list(args)
        broken[index] = value
        with pytest.raises(error):
            sl.subminor_loop(*broken, n_polarizations=1)
    with pytest.raises(ValueError):  # the kernel bakes no general fit
        sl.subminor_loop(*args, n_polarizations=1, fit=lambda v, x, y: v)
    with pytest.raises(ValueError):  # more planes than the kernel takes
        n, k = sl.MAX_IMAGES + 1, 10
        big = torch.zeros(n, k, device=cuda)
        sl.subminor_loop(big, big.clone(), None, loop._xs[:k], loop._ys[:k],
                         torch.zeros(n, 8, 8, device=cuda),
                         torch.ones(n, device=cuda), None, params,
                         n_polarizations=1)


def test_subminor_loop_many_planes(cuda):
    """80 planes (20 channels x 4 polarizations), beyond any fixed small
    per-plane buffer: kernel and plain version bit-equal."""
    loop, psfs, coef, _ = subminor_case(1, 1, False, True, cuda, seed=4)
    k = 2000
    n_chan, n_pols = 20, 4
    scale = torch.linspace(0.5, 1.5, n_chan * n_pols, device=cuda)[:, None]
    state = (loop._residual_k[:, :k] * scale).contiguous()
    psfs = psfs.repeat(n_chan, 1, 1).contiguous()
    coef = torch.full((n_chan * n_pols,), 1.0 / (n_chan * n_pols),
                      device=cuda)
    params = sl.SubminorParams.make(0.001, 0.1, 0, 200, 4.0, True, False)
    outs = []
    for run in (sl.subminor_loop, sl.subminor_loop_reference):
        res = state.clone()
        model = torch.zeros_like(res)
        out = run(res, model, None, loop._xs[:k].contiguous(),
                  loop._ys[:k].contiguous(), psfs,
                  coef, None, params, n_polarizations=n_pols)
        torch.cuda.synchronize()
        outs.append((out, res, model))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][2], outs[1][2])
    assert sl.read_result(outs[0][0])[0] == 200


def test_perform_clark_point_source_and_count(cuda):
    """The reference contract through Radler.perform with the default Clark
    loop on CUDA tensors: one B2 launch, no Högbom launch."""
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
    r = rd.Radler(s, torch.as_tensor(psf, device=cuda),
                  torch.as_tensor(res, device=cuda),
                  torch.zeros(size, size, device=cuda), 0.0)
    sl.subminor_loop.launches = 0
    hs.hogbom_step.launches = 0
    assert r.perform(0) is False
    assert sl.subminor_loop.launches == 1 and hs.hogbom_step.launches == 0
    front = r._table.front
    out_res = front.residual_accessor.array.cpu().numpy()
    out_mod = front.model_accessor.array.cpu().numpy()
    assert np.abs(out_res).max() < 2e-6
    assert out_mod[47, 23] == pytest.approx(2.5, rel=1e-4)


def test_perform_clark_log_fit_runs_hogbom(cuda):
    """With a fit the kernel does not bake, a Clark perform on the card
    runs the Högbom kernels, never the plain subminor loop."""
    C, size = 3, 96
    rng = np.random.default_rng(6)
    psf = np.zeros((C, size, size), np.float32)
    psf[:, size // 2, size // 2] = 1.0
    res = (rng.normal(scale=0.01, size=(C, size, size))).astype(np.float32)
    res[:, 30, 40] += np.array([1.5, 1.3, 1.1], np.float32)
    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.minor_iteration_count = 100
    s.absolute_threshold = 0.05
    s.spectral_fitting.mode = rd.SpectralFittingMode.LOG_POLYNOMIAL
    s.spectral_fitting.terms = 2
    freqs = np.array([[1e8 + 2e7 * c, 1.2e8 + 2e7 * c] for c in range(C)])
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    r = rd.Radler(s, t(psf), t(res), t(np.zeros_like(res)), 0.0,
                  frequencies=freqs)
    sl.subminor_loop.launches = 0
    hs.hogbom_step.launches = 0
    r.perform(0)
    assert sl.subminor_loop.launches == 0 and hs.hogbom_step.launches > 0


# ---------------------------------------------------------------------------
# The à-trous IUWT (kernel B3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_lo", [1, 2, 3, 5, 8, 9])
@pytest.mark.parametrize("shape", [(HEIGHT, WIDTH), (64, 64), (3, 200, 300),
                                   (5, 17)])
def test_atrous_bit_equal_to_plain(cuda, shape, n_lo):
    img = np.random.default_rng(n_lo).standard_normal(shape)
    img = torch.as_tensor(img.astype(np.float32), device=cuda)
    w, smooth = ia.atrous_decompose_lo(img, n_lo)
    pw, psmooth = ia.atrous_decompose_lo_reference(img, n_lo)
    torch.cuda.synchronize()
    assert torch.equal(w, pw) and torch.equal(smooth, psmooth)


@pytest.mark.parametrize("shape", [(HEIGHT, WIDTH), (20, 300), (130, 1001),
                                   (2, 300, 200), (256, 512)])
def test_atrous_routes_bit_equal_to_plain(cuda, shape):
    """The fused first launch (tiles inside the image load rows of 16-byte
    alignment 16 bytes at a time, the others pixel by pixel), followed by
    the lattice launches (rows contiguous in x at dilations 7 and 15, runs
    of 16 or 32 phases above): the plain version's bits."""
    img = np.random.default_rng(len(shape)).standard_normal(shape)
    img = torch.as_tensor(img.astype(np.float32), device=cuda)
    for n_lo in (1, 2, 4, 7):
        w, smooth = ia.atrous_decompose_lo(img, n_lo)
        pw, psmooth = ia.atrous_decompose_lo_reference(img, n_lo)
        torch.cuda.synchronize()
        assert torch.equal(w, pw) and torch.equal(smooth, psmooth)


def test_atrous_image_off_16_byte_alignment(cuda):
    """A contiguous image that starts 4 bytes past a 16-byte boundary: its
    rows cannot be loaded 16 bytes at a time, and the bits are the same."""
    base = np.random.default_rng(13).standard_normal(1 + 256 * 512)
    base = torch.as_tensor(base.astype(np.float32), device=cuda)
    img = base[1:].view(256, 512)
    assert img.is_contiguous() and img.data_ptr() % 16 == 4
    w, smooth = ia.atrous_decompose_lo(img, 2)
    pw, psmooth = ia.atrous_decompose_lo_reference(img.clone(), 2)
    torch.cuda.synchronize()
    assert torch.equal(w, pw) and torch.equal(smooth, psmooth)


def test_atrous_lattice_of_several_tiles_bit_equal_to_plain(cuda):
    """1100 x 900 at 8 scales: at dilation 63 the lattice (18 x 15 points)
    takes 2 x 1 tiles of 16 x 16 points of each group of 16 phases, and the
    last group of phases is not full; at dilations 127 and 255 the short
    lattices (9 x 8, 5 x 4) take the tile of 9 x 9 points and 32 phases,
    mostly padding."""
    img = np.random.default_rng(11).standard_normal((1100, 900))
    img = torch.as_tensor(img.astype(np.float32), device=cuda)
    plan = ia.launch_plan(8, 1100, 900)
    assert [(p.phases, p.rows) for p in plan[4:]] == [(16, 16), (32, 9),
                                                      (32, 9)]
    w, smooth = ia.atrous_decompose_lo(img, 8)
    pw, psmooth = ia.atrous_decompose_lo_reference(img, 8)
    torch.cuda.synchronize()
    assert torch.equal(w, pw) and torch.equal(smooth, psmooth)


def test_atrous_outputs_in_place(cuda):
    """``w`` and ``smooth`` given by the caller are written in place, the
    carried planes between launches being the wrapper's own."""
    img = np.random.default_rng(12).standard_normal((3, 96, 130))
    img = torch.as_tensor(img.astype(np.float32), device=cuda)
    stack = torch.full((6, 3, 96, 130), float("nan"), device=cuda)
    w, smooth = ia.atrous_decompose_lo(img, 5, w=stack[:5], smooth=stack[5])
    pw, psmooth = ia.atrous_decompose_lo_reference(img, 5)
    assert w.data_ptr() == stack.data_ptr()
    assert torch.equal(stack[:5], pw) and torch.equal(stack[5], psmooth)


def test_atrous_rejects_bad_inputs(cuda):
    img = torch.zeros(40, 50, device=cuda)
    bad = [
        (img.t(), 2, ValueError),  # not contiguous
        (img.double(), 2, TypeError),
        (img, 0, ValueError),
        (img, ia.MAX_SCALES + 1, ValueError),
        (img[None, None], 2, ValueError),
    ]
    for image, n_lo, error in bad:
        with pytest.raises(error):
            ia.atrous_decompose_lo(image, n_lo)
    with pytest.raises(ValueError):  # an output on another device
        ia.atrous_decompose_lo(img, 2, w=torch.zeros(2, 40, 50))


def test_decompose_launches_b3(cuda):
    """Every decompose on the card sends each of its scales through B3, in
    the launches of B3's plan (the low scales fused), and equals the CPU
    decompose bit for bit; past B3's most scales it raises."""
    img = np.random.default_rng(9).standard_normal((96, 130))
    img = img.astype(np.float32)
    for n_scales in (2, 6, 11, ia.MAX_SCALES):
        before = ia.atrous_decompose_lo.launches
        got = iuwt_ops.decompose(torch.as_tensor(img, device=cuda), n_scales)
        assert ia.atrous_decompose_lo.launches - before == len(
            ia.launch_plan(n_scales, 96, 130))
        assert torch.equal(got.cpu(), iuwt_ops.decompose(torch.as_tensor(img),
                                                         n_scales))
    with pytest.raises(ValueError):
        iuwt_ops.decompose(torch.as_tensor(img, device=cuda),
                           ia.MAX_SCALES + 1)


def test_perform_iuwt_on_card_matches_cpu(cuda):
    """The 128^2 diffuse source of the IUWT tests through Radler.perform on
    CUDA tensors: B3 launches, the JAX test's gates, and the residual
    within 1e-4 absolute and 1e-4 relative rms of the port's CPU run (the
    same code on the same inputs; chip_smoke.py read at most 3.5e-6 on an
    NVIDIA H100, PERF.md)."""
    size = 128
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psf = np.exp(-r2 / 8.0).astype(np.float32)
    sky = np.exp(-((yy - 60.0) ** 2 + (xx - 70.0) ** 2) / 32.0)
    res = padded_convolve(torch.as_tensor(sky.astype(np.float32)),
                          torch.as_tensor(psf)).numpy()
    res += np.random.default_rng(0).normal(scale=1e-3, size=res.shape).astype(
        np.float32)
    s = rd.Settings()
    s.algorithm_type = rd.AlgorithmType.IUWT
    s.trimmed_image_width = s.trimmed_image_height = size
    s.minor_iteration_count = 50
    cpu_res, cpu_model = res.copy(), np.zeros_like(res)
    rd.Radler(s, psf, cpu_res, cpu_model, 0.0, device="cpu").perform(0)
    ia.atrous_decompose_lo.launches = 0
    r = rd.Radler(s, torch.as_tensor(psf, device=cuda),
                  torch.as_tensor(res, device=cuda),
                  torch.zeros(size, size, device=cuda), 0.0)
    r.perform(0)
    assert ia.atrous_decompose_lo.launches > 0
    assert r.iteration_number == 50
    front = r._table.front
    out_res = front.residual_accessor.array.cpu().numpy()
    out_model = front.model_accessor.array.cpu().numpy()
    rms = lambda a: float(np.sqrt((a.astype(np.float64) ** 2).mean()))  # noqa
    assert rms(out_res) <= 0.25 * rms(res)
    assert np.abs(out_res).max() <= 0.1 * np.abs(res).max()
    assert abs(out_model.sum() - sky.sum()) < 0.2 * sky.sum()
    assert np.abs(out_res - cpu_res).max() <= 1e-4
    assert rms(out_res) == pytest.approx(rms(cpu_res), rel=1e-4)
    assert out_model.sum() == pytest.approx(cpu_model.sum(), rel=1e-3)


def test_perform_iuwt_two_channels_on_card_matches_cpu(cuda):
    """Two channels of NumPy images through IUWT with no ``device``, which
    runs them on the card, the per-image flux refit included (host
    labelling, the label map copied to the card once per accepted
    structure): the card's run within 5e-3 of the port's CPU run and each
    channel's flux within 1e-3."""
    size = 96
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psf = np.exp(-r2 / 8.0).astype(np.float32)
    sky = np.exp(-((yy - 40.0) ** 2 + (xx - 50.0) ** 2) / 32.0)
    conv = padded_convolve(torch.as_tensor(sky.astype(np.float32)),
                           torch.as_tensor(psf)).numpy()
    res = np.stack([conv, 1.6 * conv])
    res += np.random.default_rng(1).normal(scale=1e-3, size=res.shape).astype(
        np.float32)
    psfs = np.stack([psf, psf])
    s = rd.Settings()
    s.algorithm_type = rd.AlgorithmType.IUWT
    s.trimmed_image_width = s.trimmed_image_height = size
    s.minor_iteration_count = 30
    freqs = np.array([[1.0e8, 1.1e8], [1.2e8, 1.3e8]])
    cpu_res, cpu_model = res.copy(), np.zeros_like(res)
    rd.Radler(s, psfs, cpu_res, cpu_model, 0.0, frequencies=freqs,
              device="cpu").perform(0)
    card_res, card_model = res.copy(), np.zeros_like(res)
    ia.atrous_decompose_lo.launches = 0
    r = rd.Radler(s, psfs, card_res, card_model, 0.0, frequencies=freqs)
    assert r._device.type == "cuda"
    r.perform(0)
    assert ia.atrous_decompose_lo.launches > 0
    assert np.abs(card_res - cpu_res).max() <= 5e-3
    np.testing.assert_allclose(card_model.sum(axis=(1, 2)),
                               cpu_model.sum(axis=(1, 2)), rtol=1e-3)
    flux = card_model.sum(axis=(1, 2))
    assert flux[1] / flux[0] == pytest.approx(1.6, rel=0.1)


# ---------------------------------------------------------------------------
# B4 (the mesh loop's shard-local step) and B1 on row shards
# ---------------------------------------------------------------------------

from radler_tpu_torch.kernels import subtract_integrate as si  # noqa: E402
from radler_tpu_torch.parallel import mesh as pm  # noqa: E402

SHARD_ROWS = 64  # HEIGHT = 257 rows: shards start at rows 0, 64 and 193


def shard_case(case, device, seed=0):
    """``make_case`` plus the B4 coefficients of the case."""
    c = make_case(case, device, seed)
    mode, P = c["mode"], c["P"]
    if mode == "linear":
        chan, pol = linear_integration_coefficients(c["meta"]), np.ones(1)
    else:
        _, chan, pol = hs.integration_coefficients(c["meta"])
    c["plane_coefs"] = torch.as_tensor(si.plane_coefficients(mode, chan, P),
                                       device=device)
    c["pol"] = torch.as_tensor(np.asarray(pol, np.float32), device=device)
    return c


def shard_peaks(r0):
    """Peaks in, above and below the shard at row r0, and at the corners."""
    return [(r0 + 7, 100), (max(r0 - 20, 0), 5), (min(r0 + SHARD_ROWS + 9,
            HEIGHT - 1), WIDTH - 3), (0, 0), (0, WIDTH - 1),
            (HEIGHT - 1, 0), (HEIGHT - 1, WIDTH - 1)]


@pytest.mark.parametrize("r0", [0, 64, HEIGHT - SHARD_ROWS])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_subtract_integrate_bit_equal_to_plain(cuda, case, r0):
    c = shard_case(case, cuda)
    values = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.5, 0.8, c["res"].shape[0]).astype(np.float32), device=cuda)
    coefs = c["plane_coefs"]
    for y, x in shard_peaks(r0):
        state = torch.tensor([y, x, 1, 0, 0, 1, y * WIDTH + x, 0],
                             dtype=torch.int32, device=cuda)
        outs = []
        for plain in (False, True):
            res = c["res"][:, r0:r0 + SHARD_ROWS].clone()
            model = torch.zeros_like(res)
            part = torch.full((SHARD_ROWS, WIDTH), 3.0, device=cuda)
            run = si.subtract_integrate_reference if plain else (
                si.subtract_integrate)
            run(res, model, c["psfs"], values, state, coefs, c["pol"], part,
                mode=c["mode"], n_polarizations=c["P"], row_offset=r0)
            torch.cuda.synchronize()
            outs.append((res, model, part))
        for a, b in zip(*outs):
            assert torch.equal(a, b), (y, x)
        assert bool(outs[0][1].any()) == (r0 <= y < r0 + SHARD_ROWS)


@pytest.mark.parametrize("r0", [64, HEIGHT - SHARD_ROWS])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_step_with_row_offset_bit_equal_to_plain(cuda, case, r0):
    c = make_case(case, cuda)
    values = torch.as_tensor(np.random.default_rng(2).uniform(
        -0.5, 0.8, c["res"].shape[0]).astype(np.float32), device=cuda)
    weight = c["weight"][r0:r0 + SHARD_ROWS].contiguous()
    for y, x in shard_peaks(r0):
        state = torch.tensor([y, x, 1, 0, 0, 1, y * WIDTH + x, 0],
                             dtype=torch.int32, device=cuda)
        outs = []
        for plain in (False, True):
            res = c["res"][:, r0:r0 + SHARD_ROWS].clone()
            model = torch.zeros_like(res)
            step = hs.hogbom_step_reference if plain else hs.hogbom_step
            parts = step(res, model, c["psfs"], values, state, c["coefs"],
                         weight, mode=c["mode"], n_polarizations=c["P"],
                         allow_negative=True, row_offset=r0)
            torch.cuda.synchronize()
            outs.append((res, model, *parts))
        for a, b in zip(*outs):
            assert torch.equal(a, b), (y, x)


def test_subtract_integrate_rejects_bad_inputs(cuda):
    c = shard_case(("normal", 2, 4, False), cuda)
    res = c["res"][:, :SHARD_ROWS].clone()
    args = dict(model=torch.zeros_like(res), psfs=c["psfs"],
                values=torch.ones(8, device=cuda),
                state=torch.zeros(hs.STATE_SIZE, dtype=torch.int32,
                                  device=cuda),
                coefs=c["plane_coefs"], pol_coefs=c["pol"],
                out=torch.empty(SHARD_ROWS, WIDTH, device=cuda))
    kw = dict(mode="normal", n_polarizations=4)
    with pytest.raises(ValueError):  # the model on the wrong device
        si.subtract_integrate(res, **{**args, "model": args["model"].cpu()},
                              **kw)
    with pytest.raises(ValueError):  # a part of the wrong shape
        si.subtract_integrate(res, **{**args, "out": args["out"][:-1]}, **kw)
    with pytest.raises(ValueError):  # rows past the PSFs' height
        si.subtract_integrate(res, row_offset=HEIGHT - SHARD_ROWS + 1,
                              **args, **kw)
    with pytest.raises(ValueError):  # a split polarization group
        si.subtract_integrate(res[:6], **{**args, "model": args["model"][:6]},
                              **kw)
    with pytest.raises(TypeError):
        si.subtract_integrate(res, **{**args, "coefs": c["plane_coefs"]
                                      .double()}, **kw)
    with pytest.raises(ValueError):  # B1: rows past the PSFs' height
        hs.hogbom_step(res, args["model"], c["psfs"], args["values"],
                       args["state"], c["coefs"], mode="normal",
                       n_polarizations=4, allow_negative=True,
                       row_offset=HEIGHT)


@pytest.mark.parametrize("mesh_shape, case", [
    ((1, 4), ("normal", 2, 4, False)),
    ((2, 2), ("normal", 2, 4, False)),
    ((2, 4), ("squared", 2, 4, True)),
    ((4, 2), ("normal", 4, 1, False)),
], ids=["chan1-B1", "chan2-normal", "chan2-squared", "chan4-normal"])
def test_mesh_loop_bit_equal_to_plain(cuda, mesh_shape, case):
    """The mesh loop through the kernels against the same loop through the
    plain versions, on a 256-row cube with a weight and an rms factor."""
    c = make_case(case, cuda, seed=4)
    rows = 256
    res0 = c["res"][:, :rows].contiguous()
    psfs = c["psfs"][:, :rows].contiguous()
    weight = c["weight"][:rows].contiguous()
    rms = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, (rows, WIDTH)), dtype=torch.float32, device=cuda)
    flat = int(torch.argmax(res0[0].abs()))
    y, x = divmod(flat, WIDTH)
    mesh = pm.Mesh(*mesh_shape, cuda)
    outs = []
    for plain in (False, True):
        res = res0.clone()
        model = torch.zeros_like(res)
        params = hs.LoopParams.make(0.2, 0.05, 5.0, 4.0, 150, False)
        launches = (si.subtract_integrate.launches, hs.hogbom_step.launches)
        out = pm.mesh_hogbom_loop(
            mesh, res, model, psfs, weight * rms, rms,
            (float(res[0, y, x]), x, y, True), params, 0, meta=c["meta"],
            allow_negative=True, plain=plain)
        torch.cuda.synchronize()
        counted = (si.subtract_integrate.launches - launches[0],
                   hs.hogbom_step.launches - launches[1])
        outs.append((out, res, model, counted))
    (ok, rk, mk, ck), (op, rp, mp, cp) = outs
    assert ok == op and ok.iteration > 10
    assert torch.equal(rk, rp) and torch.equal(mk, mp)
    assert cp == (0, 0)
    kernel = 1 if mesh.chan == 1 else 0
    assert ck[kernel] >= ok.iteration * mesh.size and ck[1 - kernel] == 0


def test_perform_mesh_point_source_and_counts(cuda):
    """The reference contract through Radler.perform on a chan 1 x tile 8
    mesh of CUDA tensors, and a two-channel mesh perform through B4 that
    matches the single-device perform."""
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
    s.parallel.use_device_mesh = True
    s.parallel.n_devices = 8
    r = rd.Radler(s, torch.as_tensor(psf, device=cuda),
                  torch.as_tensor(res, device=cuda),
                  torch.zeros(size, size, device=cuda), 0.0)
    hs.hogbom_step.launches = hs.hogbom_select.launches = 0
    assert r.perform(0) is False
    assert hs.hogbom_select.launches == 0
    assert hs.hogbom_step.launches >= 8 * r.iteration_number > 0
    front = r._table.front
    out_res = front.residual_accessor.array.cpu().numpy()
    out_mod = front.model_accessor.array.cpu().numpy()
    assert np.abs(out_res).max() < 2e-6
    assert out_mod[47, 23] == pytest.approx(2.5, rel=1e-4)

    cube = np.stack([res, 0.8 * res])
    outs = []
    for use_mesh in (False, True):
        s.parallel.use_device_mesh = use_mesh
        residual = torch.as_tensor(cube, device=cuda)
        model = torch.zeros_like(residual)
        si.subtract_integrate.launches = 0
        r = rd.Radler(s, torch.as_tensor(np.stack([psf] * 2), device=cuda),
                      residual, model, 0.0,
                      frequencies=np.array([[1e8, 1.1e8], [1.2e8, 1.3e8]]))
        r.perform(0)
        outs.append((
            r.iteration_number,
            torch.stack([e.residual_accessor.array for e in r._table]),
            torch.stack([e.model_accessor.array for e in r._table]),
            si.subtract_integrate.launches,
        ))
    (n1, r1, m1, c1), (n8, r8, m8, c8) = outs
    assert n1 == n8 and c1 == 0 and c8 >= 8 * n8
    assert float((r1 - r8).abs().max()) <= 2e-6
    assert float((m1 - m8).abs().max()) <= 2e-6
