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
from radler_tpu_torch.models.subminor import (
    SubMinorLoop,
    fit_arguments,
    select_candidates,
)
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


def fused_and_plain(c, params, use_weight, allow_negative, rms=None,
                    buffers=None, iterations=1):
    """``iterations`` launches of the step with its select folded in, and
    as many of the plain pair (step, then select), from the same start;
    the kernel's counter is read back after each launch and must be 0.
    Returns (residual, model, partials, buffers) of each."""
    outs = []
    for plain in (False, True):
        res = c["res"].clone()
        model = torch.zeros_like(res)
        b = (start_buffers(res, params.gain) if buffers is None
             else hs.LoopBuffers(*(t.clone() for t in buffers)))
        step = hs.hogbom_step_reference if plain else hs.hogbom_step
        for _ in range(iterations):
            partials = step(res, model, c["psfs"], b.values, b.state,
                            c["coefs"], c["weight"] if use_weight else None,
                            mode=c["mode"], n_polarizations=c["P"],
                            allow_negative=allow_negative, buffers=b,
                            params=params, rms=rms)
            if not plain:
                assert b.workspace.counters.tolist() == [0]
        torch.cuda.synchronize()
        outs.append((res, model, [p.clone() for p in partials], b))
    return outs


def assert_bit_equal(outs):
    (rk, mk, pk, bk), (rp, mp, pp, bp) = outs
    assert torch.equal(rk, rp) and torch.equal(mk, mp)
    for a, b in zip(pk, pp):
        assert torch.equal(a, b)
    for name in ("state", "value", "peak", "values"):
        assert torch.equal(getattr(bk, name), getattr(bp, name)), name


@pytest.mark.parametrize("use_rms", [False, True], ids=["-", "rms"])
@pytest.mark.parametrize("allow_negative", [True, False])
@pytest.mark.parametrize("use_weight", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_step_and_select_bit_equal_to_plain(cuda, case, use_weight,
                                            allow_negative, use_rms):
    """One launch, the step with its select folded in, against the plain
    step followed by the plain select: residual, model, partials and loop
    state bit for bit, over 3 iterations."""
    c = make_case(case, cuda)
    params = hs.LoopParams.make(0.1, 0.0, 10.0, 0.0, 100, False)
    rms = (torch.as_tensor(np.random.default_rng(2).uniform(
        0.5, 1.5, (HEIGHT, WIDTH)), dtype=torch.float32, device=cuda)
        if use_rms else None)
    outs = fused_and_plain(c, params, use_weight, allow_negative, rms,
                           iterations=3)
    assert_bit_equal(outs)
    assert int(outs[0][3].state[hs.ITERATION]) == 3


@pytest.mark.parametrize("allow_negative", [True, False])
def test_fused_select_ties_take_the_smallest_index(cuda, allow_negative):
    """Equal maxima in several blocks (and twice in one): the launch picks
    the smallest flat index, as the plain pair does."""
    c = make_case(CASES[0], cuda)
    res = torch.full((1, HEIGHT, WIDTH), 0.001, device=cuda)
    ties = [90_000, 5000, 61_000, 4100, 4099 + 3 * hs.PIXELS_PER_BLOCK]
    res.view(-1)[ties] = 3.0
    c["res"] = res
    params = hs.LoopParams.make(0.1, 0.0, 10.0, 0.0, 100, False)
    state = torch.tensor([0, 0, 1, 0, 0, 1, 0, 0], dtype=torch.int32,
                         device=cuda)
    zeros = torch.zeros(1, device=cuda)  # component values 0: no change
    buffers = (state, zeros, zeros, zeros)
    outs = fused_and_plain(c, params, False, allow_negative, buffers=buffers)
    assert_bit_equal(outs)
    assert int(outs[0][3].state[hs.INDEX]) == min(ties)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_fused_select_on_an_all_zero_cube(cuda, case):
    """A cube of +0.0 and -0.0, which compare equal: every pixel ties, the
    launch takes flat index 0, finds no peak and stops, as the plain pair
    does."""
    c = make_case(case, cuda)
    signs = torch.rand(c["res"].shape, device=cuda) < 0.5
    c["res"] = torch.where(signs, torch.tensor(-0.0, device=cuda),
                           torch.tensor(0.0, device=cuda))
    params = hs.LoopParams.make(0.1, 0.0, 10.0, 0.0, 100, False)
    for allow_negative in (True, False):
        outs = fused_and_plain(c, params, True, allow_negative)
        assert_bit_equal(outs)
        state = outs[0][3].state.tolist()
        assert (state[hs.INDEX], state[hs.FOUND], state[hs.ACTIVE]) == (
            0, 0, 0)


def test_fused_select_on_an_inactive_state_changes_nothing(cuda):
    c = make_case(CASES[3], cuda)
    params = hs.LoopParams.make(0.1, 0.0, 10.0, 0.0, 100, False)
    b = start_buffers(c["res"], params.gain)
    b.state[hs.ACTIVE] = 0
    before = [t.clone() for t in (b.state, b.value, b.peak, b.values)]
    outs = fused_and_plain(c, params, True, True, buffers=before)
    # The launch returns at once in every block: its partials are not
    # written, and only what the plain pair leaves alone is compared.
    for out in outs:
        out[2].clear()
    assert_bit_equal(outs)
    assert torch.equal(outs[0][0], c["res"]) and not outs[0][1].any()
    for got, was in zip((outs[0][3].state, outs[0][3].value,
                         outs[0][3].peak, outs[0][3].values), before):
        assert torch.equal(got, was)


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
    one launch an iteration (the step with its select)."""
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
    hs.hogbom_step.launches = 0
    assert r.perform(0) is False
    assert not hasattr(hs, "hogbom_select")  # the select is in the launch
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
    # A row shard does not select; a selecting step reads the buffers'
    # own values and state.
    params = hs.LoopParams.make(0.1, 0.0, 10.0, 0.0, 100, False)
    tall = torch.cat([c["psfs"], c["psfs"]], dim=1)
    with pytest.raises(ValueError):
        hs.hogbom_step(c["res"], torch.zeros_like(c["res"]), tall,
                       buffers.values, buffers.state, c["coefs"], **kw,
                       row_offset=1, buffers=buffers, params=params)
    with pytest.raises(ValueError):
        hs.hogbom_step(c["res"], torch.zeros_like(c["res"]), c["psfs"],
                       buffers.values.clone(), buffers.state, c["coefs"],
                       **kw, buffers=buffers, params=params)


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


def subminor_case(C, P, use_rms, allow_negative, device, seed=0,
                  fit_mode="POLYNOMIAL", threshold=0.01):
    """A candidate set of the ragged cube of :func:`make_case`, selected by
    SubMinorLoop at ``threshold``, and B2's spectral fit of ``fit_mode`` (2
    terms; the forced terms a spectral-index image about -0.7) for more
    than one channel."""
    c = make_case(("linear", C, P, False), device, seed)
    loop = SubMinorLoop(WIDTH, HEIGHT, 2 * WIDTH, 2 * HEIGHT)
    loop.set_threshold(threshold, 0.0)
    loop.allow_negative_components = allow_negative
    if use_rms:
        loop.rms_factor_image = c["weight"] + 0.5
    assert loop.find_peak_positions(c["res"], c["meta"]) > 100
    coef = torch.as_tensor(linear_integration_coefficients(c["meta"]),
                           device=device)
    fit = None
    if C > 1:
        fitter = SpectralFitter(getattr(rd.SpectralFittingMode, fit_mode), 2,
                                c["meta"].frequencies, c["meta"].weights)
        if fit_mode == "FORCED_TERMS":
            rng = np.random.default_rng(seed + 100)
            fitter.set_forced_terms(torch.as_tensor(
                rng.normal(-0.7, 0.2, (1, HEIGHT, WIDTH)).astype(np.float32),
                device=device))
        fit = fit_arguments(fitter, device, loop._xs, loop._ys)
    return loop, c["psfs"], coef, fit


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


# (fit, C, P, rms factor, allow negative): the log-polynomial and
# forced-term fits on the ship-raw exchange (up to 8 planes) and without
# it (40 planes), squared-join-like P > 1 among them.
GENERAL_FIT_CASES = [
    (mode, C, P, use_rms, allow_negative)
    for mode in ("LOG_POLYNOMIAL", "FORCED_TERMS")
    for C, P in ((4, 1), (2, 2), (8, 1), (40, 1))
    for use_rms, allow_negative in ((False, True), (True, False))
]


@pytest.mark.parametrize(
    "case", GENERAL_FIT_CASES,
    ids=lambda c: "{}-{}x{}-rms{:d}-neg{:d}".format(*c))
def test_subminor_loop_general_fits_bit_equal_to_plain(cuda, case):
    """B2 with the log-polynomial or forced-term fit in its body, at its own
    plan and at every plan of SUBMINOR_PLANS, against its plain version, bit
    for bit."""
    mode, C, P, use_rms, allow_negative = case
    # The noise of the linear integration falls as 1/sqrt(C P): 40 planes
    # select a few thousand candidates at a lower threshold.
    loop, psfs, coef, fit = subminor_case(
        C, P, use_rms, allow_negative, cuda, seed=8, fit_mode=mode,
        threshold=0.01 if C * P <= 8 else 0.003)
    n, k = loop._residual_k.shape
    params = sl.SubminorParams.make(0.005, 0.1, 0, 250, 4.0, allow_negative,
                                    False)
    plans = [None] + [sl.cluster_plan(n, k, fit=fit, **plan)
                      for plan in SUBMINOR_PLANS]
    outs = []
    for plan in ["plain"] + plans:
        res = loop._residual_k.clone()
        model = torch.zeros_like(res)
        args = (res, model, loop._rms_k, loop._xs, loop._ys, psfs, coef, fit,
                params)
        if plan == "plain":
            out = sl.subminor_loop_reference(*args, n_polarizations=P)
        else:
            out = sl.subminor_loop(*args, n_polarizations=P, _plan=plan)
        torch.cuda.synchronize()
        outs.append((out, res, model))
    op, rp, mp = outs[0]
    for ok, rk, mk in outs[1:]:
        assert torch.equal(ok, op)
        assert torch.equal(rk, rp) and torch.equal(mk, mp)
    assert sl.read_result(op)[0] > 3


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
    with pytest.raises(ValueError):  # a fit whose constants do not match
        fit = sl.SubminorFit(sl.FIT_LOG_POLYNOMIAL,
                             fit_matrix=torch.ones(2, 3, device=cuda),
                             design=torch.ones(3, 2, device=cuda),
                             mean_weights=torch.ones(3, device=cuda))
        sl.subminor_loop(*args[:7], fit, params, n_polarizations=1)
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


# ---------------------------------------------------------------------------
# B2's grid route: one block a multiprocessor, a grid barrier an iteration
# ---------------------------------------------------------------------------

GRID_SIZE = 1024


def grid_case(C, P, k, device, seed, fit_mode="NO_FITTING"):
    """B2's arguments over the K brightest pixels (raster order) of a
    GRID_SIZE^2 field of 400 signed Gaussian sources (sigma 3) on noise,
    each plane the field scaled and with noise of its own at the
    candidates; Gaussian PSFs with a sidelobe ring at image size, widening
    with the channel; an rms factor; and the fit of ``fit_mode`` (2 terms;
    the forced terms a spectral-index image about -0.7)."""
    rng = np.random.default_rng(seed)
    n = C * P
    size = GRID_SIZE
    sky = np.zeros((size, size))
    ys, xs = rng.integers(8, size - 8, (2, 400))
    np.add.at(sky, (ys, xs), rng.uniform(-1.0, 1.0, 400))
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2.0 + (xx - size // 2) ** 2.0
    blob = np.fft.ifftshift(np.exp(-r2 / 18.0))
    field = np.fft.irfft2(np.fft.rfft2(sky) * np.fft.rfft2(blob),
                          s=(size, size))
    field += rng.normal(scale=0.002, size=field.shape)
    idx = np.sort(np.argsort(np.abs(field).ravel())[-k:])
    scale = np.linspace(1.2, 0.8, n)[:, None]
    state = (field.ravel()[idx][None, :] * scale
             + rng.normal(scale=0.001, size=(n, k))).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    r2_d = t(r2.astype(np.float32))
    psfs = torch.stack([
        torch.exp(-r2_d / (2.0 * (1.5 + 0.1 * c) ** 2))
        + 0.05 * torch.exp(-(r2_d.sqrt() - 9.0) ** 2 / 4.0)
        for c in range(C)]).contiguous()
    xs_d = t((idx % size).astype(np.int32))
    ys_d = t((idx // size).astype(np.int32))
    rms_k = t((0.6 + 0.8 * (idx % size) / size).astype(np.float32))
    coef = torch.full((n,), 1.0 / n, device=device)
    fit = None
    if fit_mode != "NO_FITTING":
        nu = tuple(1.2e8 + 2e7 * c for c in range(C))
        fitter = SpectralFitter(getattr(rd.SpectralFittingMode, fit_mode), 2,
                                nu, (1.0,) * C)
        if fit_mode == "POLYNOMIAL":
            fit = sl.projection_fit(torch.as_tensor(
                np.asarray(fitter._projection, np.float32), device=device))
        else:
            if fit_mode == "FORCED_TERMS":
                fitter.set_forced_terms(t(rng.normal(
                    -0.7, 0.2, (1, size, size)).astype(np.float32)))
            fit = fit_arguments(fitter, device, xs_d, ys_d)
    return (t(state), rms_k, xs_d, ys_d, psfs, coef, fit)


# (C, P, K, fit): K on both sides of the crossover at one plane; the
# spectral cells' K at 4 planes with every fit (a ragged last slice: K is
# no multiple of the multiprocessors); 9 planes (no raw values in the
# slot) with the fits; 80 planes at a K whose state outgrows every
# block's shared memory.
GRID_CASES = [
    (1, 1, sl.GRID_VALUES - 1, "NO_FITTING"),
    (1, 1, sl.GRID_VALUES, "NO_FITTING"),
    (1, 1, sl.GRID_VALUES + 1, "NO_FITTING"),
    (1, 1, 168_945, "NO_FITTING"),
    (1, 1, 300_000, "NO_FITTING"),
    (4, 1, 168_945, "NO_FITTING"),
    (4, 1, 168_945, "POLYNOMIAL"),
    (4, 1, 168_945, "LOG_POLYNOMIAL"),
    (4, 1, 168_945, "FORCED_TERMS"),
    (4, 1, 300_000, "LOG_POLYNOMIAL"),
    (9, 1, 168_945, "NO_FITTING"),
    (9, 1, 168_945, "LOG_POLYNOMIAL"),
    (3, 3, 168_945, "FORCED_TERMS"),
    (20, 4, 300_000, "NO_FITTING"),
]


@pytest.mark.parametrize("case", GRID_CASES,
                         ids=lambda c: "{}x{}-K{}-{}".format(*c))
def test_subminor_grid_route_bit_equal_to_plain_and_cluster(cuda, case):
    """The grid route (by the wrapper's own plan above the crossover, and
    forced by ``_plan`` below it), the cluster route forced by ``_plan``,
    and the plain version: equal output bits and state."""
    C, P, k, fit_mode = case
    n = C * P
    state, rms_k, xs, ys, psfs, coef, fit = grid_case(C, P, k, cuda,
                                                      seed=k % 97 + n)
    sms = sl.sm_count(cuda)
    own = sl.cluster_plan(n, k, fit=fit, sm_count=sms)
    assert (own.grid_blocks == sms) == (n * k > sl.GRID_VALUES)
    if n == 80:  # 96 MB of state: beyond every block's shared memory
        assert not sl.cluster_plan(n, k, fit=fit, grid_blocks=sms).on_chip
    params = sl.SubminorParams.make(0.0, 0.1, 0, 60 if n < 20 else 30, 0.0,
                                    True, False)
    plans = ["plain", None, sl.cluster_plan(n, k, fit=fit),
             sl.cluster_plan(n, k, fit=fit, grid_blocks=sms)]
    outs = []
    for plan in plans:
        res = state.clone()
        model = torch.zeros_like(res)
        args = (res, model, rms_k, xs, ys, psfs, coef, fit, params)
        if plan == "plain":
            out = sl.subminor_loop_reference(*args, n_polarizations=P)
        else:
            out = sl.subminor_loop(*args, n_polarizations=P, _plan=plan)
        torch.cuda.synchronize()
        outs.append((out, res, model))
    op, rp, mp = outs[0]
    for ok, rk, mk in outs[1:]:
        assert torch.equal(ok, op)
        assert torch.equal(rk, rp) and torch.equal(mk, mp)
    assert sl.read_result(op)[0] == params.max_iterations


@pytest.mark.parametrize("plan", [
    dict(on_chip=False), dict(ship_raw=False),
    dict(on_chip=False, ship_raw=False), dict(grid_blocks=2)],
    ids=["global", "no-raw", "global-no-raw", "2-a-sm"])
def test_subminor_grid_forms_bit_equal_to_plain(cuda, plan):
    """The grid with its state in global memory, without raw values in the
    slot, both, and at two blocks a multiprocessor, each at the spectral
    cells' K with the forced-term fit and the threshold, divergence and
    iteration stops."""
    state, rms_k, xs, ys, psfs, coef, fit = grid_case(4, 1, 168_945, cuda,
                                                      seed=3,
                                                      fit_mode="FORCED_TERMS")
    sms = sl.sm_count(cuda)
    kw = dict(plan)
    kw["grid_blocks"] = kw.get("grid_blocks", 1) * sms
    forced = sl.cluster_plan(4, 168_945, fit=fit, **kw)
    peak = float(state.abs().max())
    for params in (
            sl.SubminorParams.make(0.3 * peak, 0.1, 0, 500, 0.0, True, False),
            sl.SubminorParams.make(0.0, 0.1, 0, 500, 1.0001, True, False),
            sl.SubminorParams.make(0.0, 0.1, 5, 45, 0.0, False, True)):
        outs = []
        for run in ("plain", forced):
            res = state.clone()
            model = torch.zeros_like(res)
            args = (res, model, rms_k, xs, ys, psfs, coef, fit, params)
            if run == "plain":
                out = sl.subminor_loop_reference(*args, n_polarizations=1)
            else:
                out = sl.subminor_loop(*args, n_polarizations=1, _plan=run)
            torch.cuda.synchronize()
            outs.append((out, res, model))
        (op, rp, mp), (ok, rk, mk) = outs
        assert torch.equal(ok, op)
        assert torch.equal(rk, rp) and torch.equal(mk, mp)


def test_subminor_grid_the_card_cannot_hold_raises(cuda):
    """A grid of more blocks than the card can hold at once (four a
    multiprocessor at 1024 threads) raises from the wrapper; nothing falls
    back to a cluster.  A grid plan on the tile axis raises too."""
    state, rms_k, xs, ys, psfs, coef, _ = grid_case(1, 1, 120_000, cuda, 4)
    sms = sl.sm_count(cuda)
    plan = sl.cluster_plan(1, 120_000, grid_blocks=4 * sms)._replace(
        threads=1024)
    params = sl.SubminorParams.make(0.0, 0.1, 0, 10, 0.0, True, False)
    res = state.clone()
    before = sl.subminor_loop.launches
    with pytest.raises(RuntimeError):
        sl.subminor_loop(res, torch.zeros_like(res), rms_k, xs, ys, psfs,
                         coef, None, params, n_polarizations=1, _plan=plan)
    assert sl.subminor_loop.launches == before
    offsets = torch.tensor([0, 60_000, 120_000], dtype=torch.int32,
                           device=cuda)
    with pytest.raises(ValueError):
        sl.subminor_loop_tiles(
            res, torch.zeros_like(res), rms_k, xs, ys, psfs, coef, None,
            params, offsets, [60_000, 60_000], n_polarizations=1,
            _plan=sl.cluster_plan(1, 60_000, grid_blocks=sms))
    torch.cuda.synchronize()


# Segment lengths of B2's tile axis over a candidate set of K: ragged, one
# tile empty (the rest goes to the last tile).
TILE_SEGMENTS = {1: [], 2: [0], 8: [150, 0, 37, 1200, 5, 640, 300]}


def tile_offsets(counts, device):
    return torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32, device=device)


@pytest.mark.parametrize("tiles", sorted(TILE_SEGMENTS))
@pytest.mark.parametrize("case", [(1, 1, False, False), (2, 2, True, True)],
                         ids=["1x1", "2x2-fit-rms"])
def test_subminor_tiles_bit_equal_to_plain(cuda, case, tiles):
    """B2's tile axis at T = 1, 2 and 8 (ragged segments, an empty one)
    against its plain version, bit for bit; at T = 1 also against today's
    single launch without segments."""
    C, P, fit, use_rms = case
    loop, psfs, coef, proj = subminor_case(C, P, use_rms, True, cuda, seed=3)
    k = loop._residual_k.shape[1]
    counts = TILE_SEGMENTS[tiles] + [k - sum(TILE_SEGMENTS[tiles])]
    assert counts[-1] > 100 and (tiles == 1 or 0 in counts)
    offsets = tile_offsets(counts, cuda)
    params = sl.SubminorParams.make(0.005, 0.1, 3, 250, 4.0, True, False)
    outs = []
    for run in ("kernel", "plain", "single"):
        if run == "single" and tiles > 1:
            continue
        res = loop._residual_k.clone()
        model = torch.zeros_like(res)
        args = (res, model, loop._rms_k, loop._xs, loop._ys, psfs, coef,
                proj if fit else None, params)
        if run == "kernel":
            out = sl.subminor_loop_tiles(*args, offsets, counts,
                                         n_polarizations=P)
        elif run == "plain":
            out = sl.subminor_loop_tiles_reference(*args, counts,
                                                   n_polarizations=P)
        else:
            out = sl.subminor_loop(*args, n_polarizations=P)[None]
        torch.cuda.synchronize()
        outs.append((out, res, model))
    (ok, rk, mk) = outs[0]
    assert ok.shape == (tiles, 3)
    for op, rp, mp in outs[1:]:
        assert torch.equal(ok, op)
        assert torch.equal(rk, rp) and torch.equal(mk, mp)
    results = sl.read_tile_results(ok)
    for count, (iteration, value, _) in zip(counts, results):
        if count == 0:
            assert (iteration, value) == (3, 0.0)
        elif count > 100:
            assert iteration > 3


def test_subminor_tiles_every_plan_and_more_clusters_than_fit(cuda):
    """The tile axis at forced plans (one block, the state in global
    memory), and 300 tiles of 16 blocks, more clusters than the card holds
    at once: each bit-equal to the plain version."""
    loop, psfs, coef, _ = subminor_case(1, 1, False, True, cuda, seed=7)
    k = loop._residual_k.shape[1]
    params = sl.SubminorParams.make(0.005, 0.1, 0, 60, 4.0, True, False)
    many = [k // 300] * 299
    for counts, plan in (([k // 3, 0, k - k // 3], dict(cluster_size=1)),
                         ([k // 2, k - k // 2], dict(cluster_size=16,
                                                     on_chip=False)),
                         (many + [k - sum(many)], dict(cluster_size=16))):
        forced = sl.cluster_plan(1, max(counts), **plan)
        outs = []
        for kernel in (True, False):
            res = loop._residual_k.clone()
            model = torch.zeros_like(res)
            args = (res, model, None, loop._xs, loop._ys, psfs, coef, None,
                    params)
            if kernel:
                out = sl.subminor_loop_tiles(
                    *args, tile_offsets(counts, cuda), counts,
                    n_polarizations=1, _plan=forced)
            else:
                out = sl.subminor_loop_tiles_reference(*args, counts,
                                                       n_polarizations=1)
            torch.cuda.synchronize()
            outs.append((out, res, model))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])
        assert torch.equal(outs[0][2], outs[1][2])


@pytest.mark.parametrize("mode", ["LOG_POLYNOMIAL", "FORCED_TERMS"])
def test_subminor_tiles_with_each_fit_bit_equal_to_plain(cuda, mode):
    """B2's tile axis with the log-polynomial or forced-term fit (the forced
    terms following the segments) on 8 ragged tiles, an empty one among
    them, at its own plan and with the state in global memory without raw
    values, against its plain version, bit for bit."""
    loop, psfs, coef, fit = subminor_case(2, 2, True, True, cuda, seed=3,
                                          fit_mode=mode)
    n, k = loop._residual_k.shape
    counts = TILE_SEGMENTS[8] + [k - sum(TILE_SEGMENTS[8])]
    offsets = tile_offsets(counts, cuda)
    params = sl.SubminorParams.make(0.005, 0.1, 3, 250, 4.0, True, False)
    plans = [None, sl.cluster_plan(n, max(counts), fit=fit, cluster_size=16,
                                   on_chip=False, ship_raw=False)]
    outs = []
    for plan in ["plain"] + plans:
        res = loop._residual_k.clone()
        model = torch.zeros_like(res)
        args = (res, model, loop._rms_k, loop._xs, loop._ys, psfs, coef, fit,
                params)
        if plan == "plain":
            out = sl.subminor_loop_tiles_reference(*args, counts,
                                                   n_polarizations=2)
        else:
            out = sl.subminor_loop_tiles(*args, offsets, counts,
                                         n_polarizations=2, _plan=plan)
        torch.cuda.synchronize()
        outs.append((out, res, model))
    op, rp, mp = outs[0]
    for ok, rk, mk in outs[1:]:
        assert torch.equal(ok, op)
        assert torch.equal(rk, rp) and torch.equal(mk, mp)
    assert max(it for it, _, _ in sl.read_tile_results(op)) > 3


def test_perform_mesh_clark_on_card_matches_cpu(cuda):
    """The mesh's Clark subminor loop (chan 2 x tile 4, 2 channels with a
    2-term fit) through Radler.perform on the card, one tile-axis launch a
    card that holds tiles (one with one card), against the port's CPU run:
    equal counts, the cubes within 1e-5 of max(1, |res|max) (the FFT
    correction rounds differently)."""
    size = 128
    yy, xx = np.mgrid[0:size, 0:size]
    psf = np.exp(-((yy - size // 2) ** 2 + (xx - size // 2) ** 2) / 8.0)
    psfs = np.stack([psf, 0.9 * psf]).astype(np.float32)
    rng = np.random.default_rng(9)
    res = np.zeros((2, size, size))
    for _ in range(12):
        y, x, v = rng.integers(8, size - 8), rng.integers(8, size - 8), \
            rng.uniform(0.3, 1.5)
        for ch in range(2):
            res[ch] += v * (1 - 0.1 * ch) * np.roll(
                psfs[ch], (y - size // 2, x - size // 2), (0, 1))
    res = res.astype(np.float32)
    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.minor_iteration_count = 300
    s.minor_loop_gain, s.major_loop_gain = 0.1, 0.8
    s.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    s.parallel.use_device_mesh = True
    s.parallel.n_devices = 8
    freqs = np.array([[1.0e8, 1.1e8], [1.1e8, 1.2e8]])
    runs = []
    for device in ("cpu", cuda):
        cube, model = res.copy(), np.zeros_like(res)
        sl.subminor_loop_tiles.launches = 0
        r = rd.Radler(s, psfs, cube, model, 0.0, frequencies=freqs,
                      device=device)
        r.perform(0)
        mesh = r._parallel.first_algorithm.device_mesh
        runs.append((r.iteration_number, cube, model,
                     sl.subminor_loop_tiles.launches, (mesh.chan, mesh.tile)))
    (n_c, res_c, mod_c, _, shape), (n_g, res_g, mod_g, launches, _) = runs
    assert shape == (2, 4) and launches == len(pm.tile_runs(mesh))
    assert n_g == n_c > 0
    scale = max(1.0, float(np.abs(res_c).max()))
    assert np.abs(res_g - res_c).max() <= 1e-5 * scale
    assert np.abs(mod_g - mod_c).max() <= 1e-5 * scale


@pytest.mark.parametrize("use_mask", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("borders", [(0, 0), (7, 3)],
                         ids=["no-borders", "borders-7x3"])
def test_clark_selection_on_card_bit_equal_to_cpu(cuda, borders, use_mask):
    """The Clark selection at 1024^2 x 4 with an rms factor, on the card
    and on the CPU: the same flat indices in the same order, the same
    gathered residuals and rms values, every candidate inside the borders.
    The residual lies on a grid of 2^-10 and the channels weigh the same,
    so the integration and the rms product are exact on either device.  A
    selection copies a NumPy mask once, and none without one."""
    size, C = 1024, 4
    rng = np.random.default_rng(11)
    meta = CubeMeta(C, 1, (1.0,) * C, (True,), 1.0, False,
                    tuple(1e8 + 1e7 * c for c in range(C)))
    res = (rng.integers(-2048, 2048, (C, size, size)) / 1024).astype(
        np.float32)
    rms = (rng.integers(4, 17, (size, size)) / 8).astype(np.float32)
    mask = rng.uniform(size=(size, size)) > 0.3 if use_mask else None
    loops = []
    for device in (torch.device("cpu"), cuda):
        loop = SubMinorLoop(size, size, 2 * size, 2 * size)
        loop.set_threshold(1.5, 1.5)
        loop.set_clean_borders(*borders)
        loop.mask = mask
        loop.rms_factor_image = torch.as_tensor(rms, device=device)
        calls, copies = select_candidates.calls, select_candidates.host_masks
        count = loop.find_peak_positions(torch.as_tensor(res, device=device),
                                         meta)
        assert select_candidates.calls - calls == 1
        assert select_candidates.host_masks - copies == int(use_mask)
        loops.append((count, loop))
    (n_cpu, cpu), (n_card, card) = loops
    assert n_card == n_cpu > 10_000
    hb, vb = borders
    assert hb <= int(card._xs.min()) and int(card._xs.max()) < size - hb
    assert vb <= int(card._ys.min()) and int(card._ys.max()) < size - vb
    for name in ("_flat", "_xs", "_ys", "_residual_k", "_rms_k"):
        assert getattr(card, name).device.type == "cuda"
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))


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
    hs.hogbom_step.launches = 0
    assert r.perform(0) is False
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


# ---------------------------------------------------------------------------
# Multiscale: the dense subminor loop (B1 in linear mode) and perform
# ---------------------------------------------------------------------------

from radler_tpu_torch.models import multiscale as ms  # noqa: E402
from radler_tpu_torch.models.multiscale_fused import (  # noqa: E402
    _coefficient_basis,
    dense_subminor_loop,
)


@pytest.mark.parametrize("options", [
    {},
    {"fit": True, "rms": True},
    {"stop_on_negative": True},
    {"allow_negative": False, "divergence_limit": 1.5},
], ids=["plain", "fit_rms", "stop_on_negative", "positive_diverging"])
def test_dense_subminor_loop_bit_equal_to_plain(cuda, options):
    """Multiscale's dense subminor loop on the kernels (B1 in linear mode
    with the weight plane, its select folded in) against its plain run, from the
    same start: the same result, component cube and residual, bit for
    bit."""
    c = make_case(("linear", 4, 1, False), cuda, seed=5)
    rng = np.random.default_rng(6)
    rms = torch.as_tensor(rng.uniform(0.5, 1.5, (HEIGHT, WIDTH)),
                          dtype=torch.float32, device=cuda)
    use_rms = bool(options.get("rms"))
    weight = c["weight"] * rms if use_rms else c["weight"]
    fitter = (SpectralFitter(rd.SpectralFittingMode.POLYNOMIAL, 2,
                             c["meta"].frequencies, c["meta"].weights)
              if options.get("fit") else None)
    allow_negative = options.get("allow_negative", True)
    flat = int(torch.argmax(c["res"][0].abs()))
    y, x = divmod(flat, WIDTH)
    outs = []
    for plain in (False, True):
        hs.hogbom_step.launches = 0
        res = c["res"].clone()
        _, comp, it, value, found, div = dense_subminor_loop(
            res, c["psfs"], weight, rms if use_rms else None, 0.02, 0.1, 3,
            400, options.get("divergence_limit", 0.0),
            (float(res[0, y, x]), x, y, True), meta=c["meta"],
            allow_negative=allow_negative,
            stop_on_negative=bool(options.get("stop_on_negative")),
            fitter=fitter, plain=plain,
        )
        outs.append(((it, value, found, div), comp, res,
                     hs.hogbom_step.launches))
    (rk, ck, resk, lk), (rp, cp, resp, lp) = outs
    assert rk == rp and rk[0] > 4
    assert torch.equal(ck, cp) and torch.equal(resk, resp)
    assert lp == 0 and lk >= rk[0] - 3


def multiscale_problem(size, n_channels, seed=5):
    """Extended sources of both brightnesses convolved with per-channel
    Gaussian PSFs with a sidelobe ring (``chip_smoke.py``'s diffuse problem
    at a small size)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2.0 + (xx - size // 2) ** 2.0
    psfs = np.stack([
        np.exp(-r2 / (2 * (2.5 * (1 + 0.04 * c)) ** 2))
        + 0.06 * np.exp(-((np.sqrt(r2) - 14 * (1 + 0.03 * c)) ** 2) / 6)
        for c in range(n_channels)
    ]).astype(np.float32)
    sky = np.zeros((size, size))
    for _ in range(12):
        cy, cx = rng.integers(size // 8, 7 * size // 8, 2)
        s = rng.uniform(1.5, 12)
        sky += rng.uniform(0.2, 1.0) * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    res = np.stack([
        np.fft.irfft2(np.fft.rfft2(sky * (1 + 0.1 * c))
                      * np.fft.rfft2(np.fft.ifftshift(psfs[c])), s=sky.shape)
        for c in range(n_channels)
    ]).astype(np.float32)
    return psfs, res


@pytest.mark.parametrize("route", ["dense", "clark", "fused"])
def test_perform_multiscale_on_card_matches_cpu(cuda, route, monkeypatch):
    """Multiscale (2-term fit, 2 channels) through Radler.perform on the
    card against the port's CPU run of the same arrays: equal iteration
    counts and components per scale, the cubes within 1e-5 of
    max(1, |res|max); the host path's dense route and the fused route
    launch B1, the host path's Clark route B2."""
    if route != "fused":
        monkeypatch.setenv("RADLER_TPU_NO_FUSED_MS", "1")
    if route == "clark":
        monkeypatch.setattr(ms, "DENSE_SUBMINOR_MAX_PIXELS", 0)
    psfs, res = multiscale_problem(128, 2)
    s = rd.Settings()
    s.algorithm_type = rd.AlgorithmType.MULTISCALE
    s.trimmed_image_width = s.trimmed_image_height = 128
    s.minor_iteration_count = 150
    s.minor_loop_gain = 0.1
    s.major_loop_gain = 0.85
    s.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    freqs = np.array([[1.0e8, 1.1e8], [1.1e8, 1.2e8]])
    runs = []
    for device in ("cpu", cuda):
        cube, model = res.copy(), np.zeros_like(res)
        hs.hogbom_step.launches = sl.subminor_loop.launches = 0
        r = rd.Radler(s, psfs, cube, model, 0.0, frequencies=freqs,
                      device=device)
        r.perform(0)
        alg = r._parallel.first_algorithm
        runs.append((r.iteration_number,
                     [e.n_components_cleaned for e in alg.scale_infos],
                     cube, model,
                     (hs.hogbom_step.launches, sl.subminor_loop.launches)))
    (n_c, comp_c, res_c, mod_c, _), (n_g, comp_g, res_g, mod_g, launches) = runs
    assert n_g == n_c > 0 and comp_g == comp_c
    scale = max(1.0, float(np.abs(res_c).max()))
    assert np.abs(res_g - res_c).max() <= 1e-5 * scale
    assert np.abs(mod_g - mod_c).max() <= 1e-5 * scale
    if route == "clark":
        assert launches[0] == 0 and launches[1] > 0
    else:
        assert launches[0] >= n_g and launches[1] == 0


def coefficient_case(C, P, device, seed=7):
    """A linear-mode cube of C channels x P polarizations, its polynomial
    fit's (fit matrix, expansion) pair on ``device``, and its start."""
    c = make_case(("linear", C, P, False), device, seed=seed)
    meta = c["meta"]
    fitter = SpectralFitter(rd.SpectralFittingMode.POLYNOMIAL, 2,
                            meta.frequencies, meta.weights)
    expand = _coefficient_basis(fitter, meta)
    pair = (torch.as_tensor(fitter._fit_matrix, dtype=torch.float32,
                            device=device),
            torch.as_tensor(expand, device=device))
    flat = int(torch.argmax(c["res"][0].abs()))
    return c, pair, divmod(flat, WIDTH)


@pytest.mark.parametrize("P", [1, 2])
def test_loop_coefficient_mode_bit_equal_to_plain(cuda, P):
    """The fused multiscale loop's dense subminor form of the Högbom loop
    (B1 in linear mode with the weight plane, components tracked in the
    polynomial fit's coefficient space) against its plain run: the same
    result, coefficient cube and residual, bit for bit."""
    c, pair, (y, x) = coefficient_case(4, P, cuda)
    lin = ("linear", linear_integration_coefficients(c["meta"]))
    outs = []
    for plain in (False, True):
        res = c["res"].clone()
        comp = torch.zeros((pair[1].shape[1], HEIGHT, WIDTH), device=cuda)
        params = hs.LoopParams.make(0.1, 0.05, 5.0, 4.0, 300, False)
        hs.hogbom_step.launches = 0
        out = hs.hogbom_loop(
            res, comp, c["psfs"], c["weight"], None,
            (float(res[0, y, x]), x, y, True), params, 0, meta=c["meta"],
            allow_negative=True, plain=plain, integration=lin,
            coefficients=pair)
        torch.cuda.synchronize()
        outs.append((out, res, comp, hs.hogbom_step.launches))
    (ok, rk, ck, lk), (op, rp, cp, lp) = outs
    assert ok == op and ok.iteration > 10
    assert torch.equal(rk, rp) and torch.equal(ck, cp)
    assert bool(ck.abs().sum() > 0)
    assert lp == 0 and lk >= ok.iteration


@pytest.mark.parametrize("mesh_shape, P", [((1, 4), 1), ((2, 2), 1),
                                           ((4, 2), 2)],
                         ids=["chan1-B1", "chan2-B4", "chan4-B4-per-plane"])
def test_mesh_dense_subminor_bit_equal_to_plain(cuda, mesh_shape, P):
    """The fused loop's mesh subminor (B4 on the shards of a channel
    split, one PSF per plane where a shard holds part of a polarization
    group; B1 on row shards) against its plain run, bit for bit."""
    c, pair, _ = coefficient_case(4 // P, P, cuda, seed=8)
    rows = 256
    res0 = c["res"][:, :rows].contiguous()
    psfs = c["psfs"][:, :rows].contiguous()
    weight = c["weight"][:rows].contiguous()
    flat = int(torch.argmax(res0[0].abs()))
    y, x = divmod(flat, WIDTH)
    mesh = pm.Mesh(*mesh_shape, cuda)
    lin = ("linear", linear_integration_coefficients(c["meta"]))
    outs = []
    for plain in (False, True):
        res = res0.clone()
        comp = torch.zeros((pair[1].shape[1], rows, WIDTH), device=cuda)
        params = hs.LoopParams.make(0.1, 0.05, 5.0, 4.0, 150, False)
        launches = (si.subtract_integrate.launches, hs.hogbom_step.launches)
        out = pm.mesh_hogbom_loop(
            mesh, res, comp, psfs, weight, None,
            (float(res[0, y, x]), x, y, True), params, 0, meta=c["meta"],
            allow_negative=True, plain=plain, integration=lin,
            coefficients=pair)
        torch.cuda.synchronize()
        counted = (si.subtract_integrate.launches - launches[0],
                   hs.hogbom_step.launches - launches[1])
        outs.append((out, res, comp, counted))
    (ok, rk, ck, nk), (op, rp, cp, np_) = outs
    assert ok == op and ok.iteration > 10
    assert torch.equal(rk, rp) and torch.equal(ck, cp)
    assert np_ == (0, 0)
    kernel = 1 if mesh.chan == 1 else 0
    assert nk[kernel] >= ok.iteration * mesh.size and nk[1 - kernel] == 0


# ---------------------------------------------------------------------------
# B1's facet mode (the batched facet route)
# ---------------------------------------------------------------------------


# Ragged true boxes (rows, columns) in the common box: full width (383, not
# a multiple of 4), the inactive facet's, one pixel wide, and narrower than
# a block's threads.
TRUE_BOXES = [(200, 383), (250, 372), (131, 1), (257, 203)]
# The facet step takes the planes in chunks of 8, the last one partial:
# CASES, 2, 3 and 6 planes, and 12 in two chunks (with 3 polarizations, a
# channel across the chunks' border).
FACET_CASES = CASES + [
    ("squared", 1, 2, True),
    ("normal", 3, 1, False),
    ("linear", 6, 1, False),
    ("normal", 4, 3, False),
    ("squared", 3, 4, True),
]
# What the padding around a true box holds: a value the search would pick
# if the kernel read it.
PADDING = 12345.0


def make_facet_case(case, n_facets, shared, device, seed=0, boxed=False):
    """F facets' cubes at the ragged shape, each searchable only in its own
    top-left box (the padded common box), with their own loop states; facet
    1 is inactive from the start.  ``boxed`` takes the boxes from
    ``TRUE_BOXES`` (``c["boxes"]``) and fills the padding with
    ``PADDING``."""
    cases = [make_case(case, device, seed + f) for f in range(n_facets)]
    c = dict(cases[0])
    c["res"] = torch.stack([k["res"] for k in cases])
    c["psfs"] = (cases[0]["psfs"] if shared
                 else torch.stack([k["psfs"] for k in cases]))
    weight = torch.stack([k["weight"] for k in cases])
    boxes = [TRUE_BOXES[f % len(TRUE_BOXES)] if boxed
             else (HEIGHT - 7 * f, WIDTH - 11 * f) for f in range(n_facets)]
    for f, (rows, cols) in enumerate(boxes):
        weight[f, rows:, :] = 0.0
        weight[f, :, cols:] = 0.0
        if boxed:
            c["res"][f, :, rows:, :] = PADDING
            c["res"][f, :, :, cols:] = PADDING
    c["weight"] = weight
    c["boxes"] = (torch.tensor(boxes, dtype=torch.int32) if boxed
                  else None)
    states, raws = [], []
    for f, (rows, cols) in enumerate(boxes):
        box = c["res"][f, 0, :rows, :cols].abs() * weight[f, :rows, :cols]
        y, x = divmod(int(torch.argmax(box)), cols)
        active = 0 if f == 1 else 1
        states.append([y, x, 1, 0, 0, active, y * WIDTH + x, 0])
        raws.append(c["res"][f, :, y, x])
    raw = torch.stack(raws)
    c["state"] = torch.tensor(states, dtype=torch.int32, device=device)
    c["raw"] = raw
    return c


def assert_padding_untouched(res, c):
    """Every pixel outside each facet's true box still holds PADDING."""
    for f, (rows, cols) in enumerate(c["boxes"].tolist()):
        pad = torch.ones_like(res[f, 0], dtype=torch.bool)
        pad[:rows, :cols] = False
        assert bool((res[f][:, pad] == PADDING).all()), f


@pytest.mark.parametrize("boxed", [False, True], ids=["common", "true-boxes"])
@pytest.mark.parametrize("use_weight", [False, True])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-facet"])
@pytest.mark.parametrize("n_facets", [1, 4])
@pytest.mark.parametrize("case", FACET_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_facet_step_and_select_bit_equal_to_plain(cuda, case, n_facets,
                                                  shared, use_weight, boxed):
    """The facet-mode launch (the step, each facet's select folded in)
    against its plain version (the per-facet loop of the single-cube plain
    step and select); one facet over the whole box reproduces the
    single-cube launch bit for bit, with the facet's limits (the other
    facets stop at their iteration limit of 2).  With true boxes the step
    reads and writes nothing outside them, and a facet's partials past its
    own runs hold no peak.  Every facet's counter reads 0 after each
    launch."""
    c = make_facet_case(case, n_facets, shared, cuda, boxed=boxed)
    params = hs.FacetLoopParams.make(
        0.1, [0.0] * n_facets, [10.0] * n_facets, 4.0,
        [100] + [2] * (n_facets - 1), False, cuda)
    outs = []
    for plain in (False, True):
        res = c["res"].clone()
        model = torch.zeros_like(res)
        buffers = hs.LoopBuffers(c["state"].clone(),
                                 torch.zeros(n_facets, device=cuda),
                                 c["raw"].clone(), c["raw"] * params.gain)
        step = hs.hogbom_step_facets_reference if plain else (
            hs.hogbom_step_facets)
        for _ in range(3):
            partials = step(res, model, c["psfs"], buffers.values,
                            buffers.state, c["coefs"],
                            c["weight"] if use_weight else None,
                            mode=c["mode"], n_polarizations=c["P"],
                            allow_negative=True, boxes=c["boxes"],
                            buffers=buffers, params=params,
                            rms=c["weight"] if use_weight else None)
            if not plain:
                counters = buffers.workspace.counters.tolist()
                assert counters == [0] * n_facets
        torch.cuda.synchronize()
        outs.append((res, model, partials, buffers))
    (rk, mk, pk, bk), (rp, mp, pp, bp) = outs
    assert torch.equal(rk, rp) and torch.equal(mk, mp)
    # An inactive facet's partials are left unwritten by the kernel.
    active = [f for f in range(n_facets) if f != 1]
    for a, b in zip(pk, pp):
        assert torch.equal(a[active], b[active])
    for name in ("state", "value", "peak", "values"):
        assert torch.equal(getattr(bk, name), getattr(bp, name)), name
    if boxed:
        assert_padding_untouched(rk, c)
        runs = [-(-r * w // hs.PIXELS_PER_BLOCK)
                for r, w in c["boxes"].tolist()]
        for f in active:
            assert bool((pk[0][f, runs[f]:] == -float("inf")).all())
            assert bool((pk[1][f, runs[f]:] == 2**31 - 1).all())
    if n_facets > 1:
        assert torch.equal(rk[1], c["res"][1])  # the inactive facet
    elif not boxed:
        res = c["res"][0].clone()
        model = torch.zeros_like(res)
        one = hs.LoopBuffers(c["state"][0].clone(),
                             torch.zeros(1, device=cuda), c["raw"][0].clone(),
                             c["raw"][0] * params.gain)
        for _ in range(3):
            hs.hogbom_step(
                res, model, c["psfs"] if shared else c["psfs"][0],
                one.values, one.state, c["coefs"],
                c["weight"][0] if use_weight else None, mode=c["mode"],
                n_polarizations=c["P"], allow_negative=True, buffers=one,
                params=params.facet(0),
                rms=c["weight"][0] if use_weight else None)
        assert torch.equal(res, rk[0]) and torch.equal(model, mk[0])
        assert torch.equal(one.state, bk.state[0])


@pytest.mark.parametrize("boxed", [False, True], ids=["common", "true-boxes"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-facet"])
def test_facet_loop_bit_equal_to_plain(cuda, shared, boxed):
    """The lockstep loop with the 2-term fit between launches, an rms
    factor and facets that stop at different iterations: kernel and plain
    loop end in the same state, with and without true boxes."""
    n_facets = 4
    c = make_facet_case(("squared", 2, 4, True), n_facets, shared, cuda,
                        seed=5, boxed=boxed)
    fitter = SpectralFitter(rd.SpectralFittingMode.POLYNOMIAL, 2,
                            [1e8, 1.1e8], [1.0, 2.0])
    rms = torch.as_tensor(
        np.random.default_rng(4).uniform(0.5, 1.5, (n_facets, HEIGHT, WIDTH)),
        dtype=torch.float32, device=cuda)
    host = c["state"].tolist()
    peaks = [(float(c["res"][f, 0, h[0], h[1]]), h[1], h[0], f != 1)
             for f, h in enumerate(host)]
    starts = [0, 0, 0, 7]
    outs = []
    for plain in (False, True):
        res = c["res"].clone()
        model = torch.zeros_like(res)
        params = hs.FacetLoopParams.make(
            0.2, [0.05, 0.05, 0.2, 0.5], [5.0] * n_facets, 4.0,
            [300, 300, 40, 300], False, cuda)
        out = hs.facet_hogbom_loop(
            res, model, c["psfs"], c["weight"] * rms, rms, peaks, params,
            starts, meta=c["meta"], allow_negative=True, fitter=fitter,
            plain=plain, boxes=c["boxes"])
        outs.append((out, res, model))
    (ok, rk, mk), (op, rp, mp) = outs
    assert ok == op
    done = [r.iteration - s for r, s in zip(ok.results, starts)]
    assert done[1] == 0 and len(set(done)) > 2
    assert ok.lockstep >= max(done)
    assert torch.equal(rk, rp) and torch.equal(mk, mp)
    if boxed:
        assert_padding_untouched(rk, c)


def test_facet_step_over_more_facets_than_a_launch_takes(cuda):
    """More facets than one facet-step launch takes (FACETS_PER_LAUNCH):
    300 facets, two launches, each on its own facets' cubes, states,
    partials, counters and limits, bit-equal to the plain version over
    ragged true boxes, three iterations with a stopped facet in each
    launch."""
    n_facets, height, width = 300, 24, 40
    rng = np.random.default_rng(6)
    res = torch.as_tensor(rng.normal(scale=0.01, size=(
        n_facets, 1, height, width)).astype(np.float32), device=cuda)
    boxes = [(1 + f % height, 1 + (7 * f) % width) for f in range(n_facets)]
    weight = torch.zeros((n_facets, height, width), device=cuda)
    states = []
    for f, (rows, cols) in enumerate(boxes):
        weight[f, :rows, :cols] = 1.0
        y, x = divmod(int(torch.argmax(res[f, 0, :rows, :cols].abs())), cols)
        states.append([y, x, 1, 0, 0, 1, y * width + x, 0])
    yy, xx = np.mgrid[0:height, 0:width]
    psf = torch.as_tensor(np.exp(-((yy - height // 2) ** 2 + (
        xx - width // 2) ** 2) / 4.0).astype(np.float32), device=cuda)[None]
    for f in (5, 290):
        states[f][hs.ACTIVE] = 0
    state = torch.tensor(states, dtype=torch.int32, device=cuda)
    raw = res[torch.arange(n_facets), :, state[:, 0].long(),
              state[:, 1].long()]
    coefs = torch.ones(1, device=cuda)
    params = hs.FacetLoopParams.make(
        0.1, [0.0] * n_facets, [10.0] * n_facets, 4.0,
        [2 + f % 3 for f in range(n_facets)], False, cuda)
    outs = []
    for step in (hs.hogbom_step_facets, hs.hogbom_step_facets_reference):
        r, m = res.clone(), torch.zeros_like(res)
        buffers = hs.LoopBuffers(state.clone(),
                                 torch.zeros(n_facets, device=cuda),
                                 raw.clone(), raw * params.gain)
        launches = hs.hogbom_step_facets.launches
        for _ in range(3):
            partials = step(r, m, psf, buffers.values, buffers.state, coefs,
                            weight, mode="signed", n_polarizations=1,
                            allow_negative=True,
                            boxes=torch.tensor(boxes, dtype=torch.int32),
                            buffers=buffers, params=params, rms=weight)
        torch.cuda.synchronize()
        outs.append((r, m, partials, buffers,
                     hs.hogbom_step_facets.launches - launches))
    (rk, mk, pk, bk, nk), (rp, mp, pp, bp, np_) = outs
    assert torch.equal(rk, rp) and torch.equal(mk, mp)
    active = [f for f in range(n_facets) if f not in (5, 290)]
    for a, b in zip(pk, pp):
        assert torch.equal(a[active], b[active])
    for name in ("state", "value", "peak", "values"):
        assert torch.equal(getattr(bk, name), getattr(bp, name)), name
    assert bk.workspace.counters.tolist() == [0] * n_facets
    assert torch.equal(bk.state[5], state[5])
    assert (nk, np_) == (6, 0)


@pytest.mark.parametrize("fit", ["coefficients", "none"])
def test_facet_loop_linear_bit_equal_to_plain(cuda, fit):
    """The batched multiscale route's lockstep loop: B1's facet mode in
    linear mode with a PSF stack a facet, a weight plane, a gain a facet,
    true boxes and (``coefficients``) the components in the polynomial
    fit's coefficient space; kernel and plain loop end in the same state,
    the padding untouched."""
    n_facets = 4
    c = make_facet_case(("linear", 2, 4, False), n_facets, False, cuda,
                        seed=9, boxed=True)
    meta = c["meta"]
    fitter = SpectralFitter(rd.SpectralFittingMode.POLYNOMIAL, 2,
                            meta.frequencies, meta.weights)
    pair = (torch.as_tensor(fitter._fit_matrix, dtype=torch.float32,
                            device=cuda),
            torch.as_tensor(_coefficient_basis(fitter, meta), device=cuda))
    lin = ("linear", linear_integration_coefficients(meta))
    host = c["state"].tolist()
    peaks = [(float(c["res"][f, 0, h[0], h[1]]), h[1], h[0], f != 1)
             for f, h in enumerate(host)]
    starts = [0, 0, 3, 0]
    n_comp = pair[1].shape[1] if fit == "coefficients" else meta.n_images
    outs = []
    for plain in (False, True):
        res = c["res"].clone()
        comp = torch.zeros((n_facets, n_comp, HEIGHT, WIDTH), device=cuda)
        params = hs.FacetLoopParams.make(
            [0.1, 0.2, 0.05, 0.15], [0.05, 0.05, 0.2, 0.1], [5.0] * n_facets,
            4.0, [300, 300, 40, 300], False, cuda)
        launches = hs.hogbom_step_facets.launches
        out = hs.facet_hogbom_loop(
            res, comp, c["psfs"], c["weight"], None, peaks, params, starts,
            meta=meta, allow_negative=True, plain=plain, boxes=c["boxes"],
            integration=lin,
            coefficients=pair if fit == "coefficients" else None)
        torch.cuda.synchronize()
        outs.append((out, res, comp,
                     hs.hogbom_step_facets.launches - launches))
    (ok, rk, ck, lk), (op, rp, cp, lp) = outs
    assert ok == op
    done = [r.iteration - s for r, s in zip(ok.results, starts)]
    assert done[1] == 0 and max(done) > 10
    assert torch.equal(rk, rp) and torch.equal(ck, cp)
    assert lp == 0 and lk == ok.lockstep
    assert_padding_untouched(rk, c)


def test_batched_multiscale_facets_on_card_match_cpu(cuda, monkeypatch):
    """Multiscale on a 2x2 facet grid takes the batched route (every facet's
    fused loop at once, its dense loops in B1's facet mode) on the card as
    on the CPU: the same boxes and per-facet iteration counts, the cubes
    within 1e-5 of max(1, |res|max) (cuFFT against pocketfft)."""
    monkeypatch.delenv("RADLER_TPU_NO_BATCHED_FACETS", raising=False)
    psfs, res = multiscale_problem(128, 2)
    s = rd.Settings()
    s.algorithm_type = rd.AlgorithmType.MULTISCALE
    s.trimmed_image_width = s.trimmed_image_height = 128
    s.minor_iteration_count = 150
    s.minor_loop_gain, s.major_loop_gain = 0.1, 0.85
    s.parallel.grid_width = s.parallel.grid_height = 2
    s.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    freqs = np.array([[1.0e8, 1.1e8], [1.1e8, 1.2e8]])
    runs = []
    for device in ("cpu", cuda):
        cube, model = res.copy(), np.zeros_like(res)
        hs.hogbom_step_facets.launches = 0
        r = rd.Radler(s, psfs, cube, model, 0.0, frequencies=freqs,
                      device=device)
        r.perform(0)
        p = r._parallel
        runs.append(([a.iteration_number for a in p.algorithms],
                     [(b.x, b.y, b.width, b.height) for b in
                      p.last_sub_images], p.last_route, cube, model,
                     hs.hogbom_step_facets.launches))
    (n_c, b_c, route_c, res_c, mod_c, _), (n_g, b_g, route_g, res_g, mod_g,
                                           launches) = runs
    assert route_c == route_g == "batched"
    assert b_g == b_c and n_g == n_c and sum(n_c) > 0
    scale = max(1.0, float(np.abs(res_c).max()))
    assert np.abs(res_g - res_c).max() <= 1e-5 * scale
    assert np.abs(mod_g - mod_c).max() <= 1e-5 * scale
    assert launches > 0


def test_asp_on_card_matches_cpu(cuda):
    """ASP (2-term fit, 2 channels) on a grid of point sources through
    Radler.perform on the card against the port's CPU run: equal iteration
    counts, the cubes within 1e-5 of max(1, |res|max)."""
    size, k = 128, 3
    psfs, _ = multiscale_problem(size, 2)
    rng = np.random.default_rng(7)
    sky = np.zeros((size, size))
    step = size // (k + 1)
    for i in range(k):
        for j in range(k):
            sky[step * (i + 1) + rng.integers(-3, 4),
                step * (j + 1) + rng.integers(-3, 4)] = rng.uniform(0.2, 1.0)
    res = np.stack([
        np.fft.irfft2(np.fft.rfft2(sky * (1 - 0.05 * c)) * np.fft.rfft2(
            np.fft.ifftshift(psfs[c])), s=sky.shape) for c in range(2)
    ]).astype(np.float32)
    s = rd.Settings()
    s.algorithm_type = rd.AlgorithmType.ADAPTIVE_SCALE_PIXEL
    s.trimmed_image_width = s.trimmed_image_height = size
    s.minor_iteration_count = 100
    s.minor_loop_gain, s.major_loop_gain = 0.1, 0.85
    s.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    freqs = np.array([[1.0e8, 1.1e8], [1.1e8, 1.2e8]])
    runs = []
    for device in ("cpu", cuda):
        cube, model = res.copy(), np.zeros_like(res)
        r = rd.Radler(s, psfs, cube, model, 0.0, frequencies=freqs,
                      device=device)
        r.perform(0)
        runs.append((r.iteration_number, cube, model))
    (n_c, res_c, mod_c), (n_g, res_g, mod_g) = runs
    assert n_g == n_c > 0
    scale = max(1.0, float(np.abs(res_c).max()))
    assert np.abs(res_g - res_c).max() <= 1e-5 * scale
    assert np.abs(mod_g - mod_c).max() <= 1e-5 * scale


# ---------------------------------------------------------------------------
# Several cards: the mesh kernels on a card other than the current one, and
# the mesh loops over two cards
# ---------------------------------------------------------------------------


@pytest.fixture
def two_cards():
    """Cards 0 and 1, card 0 the current device; skips with fewer."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0), torch.device("cuda", 1)


def on_each_card(cards, run):
    """``run(card)`` on each card from a process whose current device is
    card 0; the outputs on the host, and the current device after."""
    outs = []
    for card in cards:
        out = run(card)
        torch.cuda.synchronize(card)
        outs.append([t.cpu() for t in out])
        assert torch.cuda.current_device() == 0
    return outs


def assert_cards_bit_equal(outs):
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [CASES[2], CASES[4]],
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_step_with_row_offset_on_card_1_bit_equal_to_card_0(two_cards, case):
    """B1 on a row shard launched on card 1, bit-equal to the same launch on
    card 0, and counted on card 1."""
    r0 = 64

    def run(card):
        c = make_case(case, card)
        values = torch.as_tensor(np.random.default_rng(2).uniform(
            -0.5, 0.8, c["res"].shape[0]).astype(np.float32), device=card)
        weight = c["weight"][r0:r0 + SHARD_ROWS].contiguous()
        res = c["res"][:, r0:r0 + SHARD_ROWS].clone()
        model = torch.zeros_like(res)
        parts = []
        for y, x in shard_peaks(r0):
            state = torch.tensor([y, x, 1, 0, 0, 1, y * WIDTH + x, 0],
                                 dtype=torch.int32, device=card)
            parts += hs.hogbom_step(
                res, model, c["psfs"], values, state, c["coefs"], weight,
                mode=c["mode"], n_polarizations=c["P"], allow_negative=True,
                row_offset=r0)
        return [res, model, *parts]

    before = hs.hogbom_step.launches_by_card[1]
    assert_cards_bit_equal(on_each_card(two_cards, run))
    assert hs.hogbom_step.launches_by_card[1] - before == len(shard_peaks(r0))


@pytest.mark.parametrize("case", [CASES[1], CASES[4]],
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_subtract_integrate_on_card_1_bit_equal_to_card_0(two_cards, case):
    """B4, linear and squared, launched on card 1, bit-equal to card 0."""
    r0 = HEIGHT - SHARD_ROWS

    def run(card):
        c = shard_case(case, card)
        values = torch.as_tensor(np.random.default_rng(1).uniform(
            -0.5, 0.8, c["res"].shape[0]).astype(np.float32), device=card)
        res = c["res"][:, r0:r0 + SHARD_ROWS].clone()
        model = torch.zeros_like(res)
        parts = []
        for y, x in shard_peaks(r0):
            state = torch.tensor([y, x, 1, 0, 0, 1, y * WIDTH + x, 0],
                                 dtype=torch.int32, device=card)
            part = torch.full((SHARD_ROWS, WIDTH), 3.0, device=card)
            si.subtract_integrate(res, model, c["psfs"], values, state,
                                  c["plane_coefs"], c["pol"], part,
                                  mode=c["mode"], n_polarizations=c["P"],
                                  row_offset=r0)
            parts.append(part)
        return [res, model, *parts]

    before = si.subtract_integrate.launches_by_card[1]
    assert_cards_bit_equal(on_each_card(two_cards, run))
    assert si.subtract_integrate.launches_by_card[1] - before == len(
        shard_peaks(r0))


def test_subminor_tiles_on_card_1_bit_equal_to_card_0(two_cards):
    """B2's tile axis over 8 ragged tiles (an empty one) with a fit and an
    rms factor, launched on card 1, bit-equal to card 0."""

    def run(card):
        loop, psfs, coef, fit = subminor_case(2, 2, True, True, card, seed=3)
        k = loop._residual_k.shape[1]
        counts = TILE_SEGMENTS[8] + [k - sum(TILE_SEGMENTS[8])]
        res = loop._residual_k.clone()
        model = torch.zeros_like(res)
        out = sl.subminor_loop_tiles(
            res, model, loop._rms_k, loop._xs, loop._ys, psfs, coef, fit,
            sl.SubminorParams.make(0.005, 0.1, 3, 250, 4.0, True, False),
            tile_offsets(counts, card), counts, n_polarizations=2)
        return [out, res, model]

    before = sl.subminor_loop_tiles.launches_by_card[1]
    outs = on_each_card(two_cards, run)
    assert_cards_bit_equal(outs)
    assert sl.subminor_loop_tiles.launches_by_card[1] - before == 1
    assert max(it for it, _, _ in sl.read_tile_results(outs[0][0])) > 3


@pytest.mark.parametrize("mesh_shape, case", [
    ((1, 4), ("normal", 2, 4, False)),
    ((2, 2), ("normal", 2, 4, False)),
    ((4, 2), ("normal", 4, 1, False)),
], ids=["chan1-B1", "chan2-normal", "chan4-normal"])
def test_mesh_loop_over_two_cards_bit_equal_to_one(two_cards, mesh_shape,
                                                   case):
    """The Högbom mesh loop with its shards over cards 0 and 1, bit-equal to
    the same loop with every shard on card 0; each card launches its
    shards' kernels."""
    card0, card1 = two_cards
    c = make_case(case, card0, seed=4)
    rows = 256
    res0 = c["res"][:, :rows].contiguous()
    psfs = c["psfs"][:, :rows].contiguous()
    weight = c["weight"][:rows].contiguous()
    rms = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, (rows, WIDTH)), dtype=torch.float32, device=card0)
    flat = int(torch.argmax(res0[0].abs()))
    y, x = divmod(flat, WIDTH)
    kernel = hs.hogbom_step if mesh_shape[0] == 1 else si.subtract_integrate
    outs = []
    for devices in ((card0,), (card0, card1)):
        mesh = pm.Mesh(*mesh_shape, card0, devices)
        res = res0.clone()
        model = torch.zeros_like(res)
        params = hs.LoopParams.make(0.2, 0.05, 5.0, 4.0, 150, False)
        before = kernel.launches_by_card[1]
        out = pm.mesh_hogbom_loop(
            mesh, res, model, psfs, weight * rms, rms,
            (float(res[0, y, x]), x, y, True), params, 0, meta=c["meta"],
            allow_negative=True)
        torch.cuda.synchronize(card0)
        torch.cuda.synchronize(card1)
        outs.append((out, res, model, kernel.launches_by_card[1] - before))
    (o1, r1, m1, n1), (o2, r2, m2, n2) = outs
    assert o1 == o2 and o1.iteration > 10
    assert torch.equal(r1, r2) and torch.equal(m1, m2)
    assert n1 == 0 and n2 >= o2.iteration * mesh_shape[0] * mesh_shape[1] // 2


@pytest.mark.parametrize("mesh_shape", [(1, 8), (4, 2)],
                         ids=["chan1-tile8", "chan4-tile2"])
def test_mesh_clark_over_two_cards_bit_equal_to_one(two_cards, mesh_shape):
    """The mesh's Clark loop with its tiles over cards 0 and 1 (one B2
    launch a card), bit-equal to every tile on card 0."""
    card0, card1 = two_cards
    c = make_case(("linear", 4, 1, False), card0, seed=6)
    rows = 256
    res = c["res"][:, :rows].contiguous()
    psfs = c["psfs"][:, :rows].contiguous()
    rms = c["weight"][:rows] + 0.5
    window = torch.ones((rows, WIDTH), dtype=torch.bool, device=card0)
    fitter = SpectralFitter(rd.SpectralFittingMode.LOG_POLYNOMIAL, 2,
                            c["meta"].frequencies, c["meta"].weights)
    outs = []
    for devices in ((card0,), (card0, card1)):
        before = sl.subminor_loop_tiles.launches_by_card.copy()
        out = pm.mesh_subminor_clean(
            pm.Mesh(*mesh_shape, card0, devices), res, psfs, rms, window,
            0.012, sl.SubminorParams.make(0.012, 0.1, 0, 300, 4.0, True,
                                          False),
            meta=c["meta"], fitter=fitter)
        torch.cuda.synchronize(card0)
        torch.cuda.synchronize(card1)
        launched = sl.subminor_loop_tiles.launches_by_card - before
        outs.append((out, launched))
    (o1, l1), (o2, l2) = outs
    assert o1._replace(delta=None) == o2._replace(delta=None)
    assert o1.iteration > 10 and torch.equal(o1.delta, o2.delta)
    assert dict(l1) == {0: 1} and dict(l2) == {0: 1, 1: 1}


# ---------------------------------------------------------------------------
# The spread workloads: B3's row-block mode and the facets over groups
# ---------------------------------------------------------------------------

from radler_tpu_torch.parallel import rows as pr  # noqa: E402


def row_layout(height, parts, device):
    return pr.RowLayout(tuple(height * p // parts for p in range(parts + 1)),
                        (device,) * parts)


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("shape, n_scales", [((600, 300), 9), ((256, 200), 5),
                                             ((2, 96, 130), 3)])
def test_atrous_rows_bit_equal_to_plain(cuda, shape, n_scales, parts):
    """B3's row-block mode on every part's block of every launch (halos
    of up to 4 x 511 rows, taller than a block) against its plain version
    on the same block, and the spread decompose against the whole-image
    plain decompose: bit-equal."""
    img = np.random.default_rng(parts).standard_normal(shape)
    img = torch.as_tensor(img.astype(np.float32), device=cuda)
    layout = row_layout(shape[-2], parts, cuda)
    cur = pr.Rows.scatter(img, layout)
    for step in ia.launch_plan(n_scales, *shape[-2:]):
        reach = ia.launch_reach(step)
        nxt = []
        for p in range(parts):
            block, out0 = cur.block(p, reach)
            rows = cur.parts[p].shape[-2]
            out = [torch.full((step.n_scales, *cur.parts[p].shape), np.nan,
                              device=cuda) for _ in range(2)]
            smooth = [torch.empty_like(cur.parts[p]) for _ in range(2)]
            ia.atrous_rows(block, step, out0, rows, out[0], smooth[0])
            ia.atrous_rows_reference(block, step, out0, rows, out[1],
                                     smooth[1])
            torch.cuda.synchronize()
            assert torch.equal(out[0], out[1])
            assert torch.equal(smooth[0], smooth[1])
            nxt.append(smooth[0])
        cur = pr.Rows(nxt, layout)
    before = ia.atrous_rows.launches
    got = pr.decompose_rows(pr.Rows.scatter(img, layout), n_scales).gather()
    assert ia.atrous_rows.launches - before == parts * len(
        ia.launch_plan(n_scales, *shape[-2:]))
    assert torch.equal(got.cpu(), iuwt_ops.decompose(img.cpu(), n_scales))


@pytest.mark.parametrize("algorithm", ["GENERIC_CLEAN", "MULTISCALE"])
def test_batched_facets_over_four_groups_bit_equal_to_one(cuda, algorithm,
                                                          monkeypatch):
    """A 2 x 2 facet grid on a mesh of 4 shards: over 4 groups of one card
    (one facet a group, each group's lockstep loop its own) the cubes and
    the per-facet counts are those of one group, bit for bit."""
    monkeypatch.delenv("RADLER_TPU_NO_BATCHED_FACETS", raising=False)
    psfs, res = multiscale_problem(128, 2)
    s = rd.Settings()
    s.algorithm_type = getattr(rd.AlgorithmType, algorithm)
    s.trimmed_image_width = s.trimmed_image_height = 128
    s.minor_iteration_count = 150
    s.minor_loop_gain, s.major_loop_gain = 0.1, 0.85
    s.parallel.grid_width = s.parallel.grid_height = 2
    s.parallel.use_device_mesh = True
    s.parallel.n_devices = 4
    s.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    freqs = np.array([[1.0e8, 1.1e8], [1.1e8, 1.2e8]])
    card = torch.device("cuda", torch.cuda.current_device())
    runs = []
    for groups in (1, 4):
        monkeypatch.setattr(pm, "visible_cards",
                            lambda device, g=groups: [card] * g)
        cube, model = res.copy(), np.zeros_like(res)
        r = rd.Radler(s, psfs, cube, model, 0.0, frequencies=freqs,
                      device=card)
        r.perform(0)
        p = r._parallel
        assert p.first_algorithm.device_mesh.groups == groups
        runs.append(([a.iteration_number for a in p.algorithms],
                     p.last_route, cube, model))
    (n1, route1, res1, mod1), (n4, route4, res4, mod4) = runs
    assert route1 == route4 == "batched" and n1 == n4 and sum(n1) > 0
    np.testing.assert_array_equal(res4, res1)
    np.testing.assert_array_equal(mod4, mod1)
