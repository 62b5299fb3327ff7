"""The port's mesh Högbom loop and kernel B4 against the JAX package's.

The JAX side runs as its own mesh tests run it: the Pallas kernels in
interpret mode, on the 8 virtual CPU devices of ``conftest.py``; the port's
CPU path runs the kernels' plain PyTorch versions with every shard on the
CPU.  Inputs are made with NumPy from a seed and handed to both.

Tolerances, each with its reason:

* kernel B4 and B1 with a row offset within 1e-6 absolute: the plain
  versions round each multiply and add separately, while XLA contracts the
  interpreted kernels' multiply-adds into fused multiply-adds on the CPU;
  the values here are below 2, where that is a few float32 ulps;
* the mesh loops those of ``tests/test_mesh_pallas.py`` (equal iteration
  counts, residual and model within 2e-5, value within 2e-4 + 1e-3|v|),
  and ``Radler.perform`` on a mesh those of ``tests/test_mesh_clean.py``
  (equal iteration counts, cubes within 2e-6).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu.image_set import CubeMeta as JaxCubeMeta
from radler_tpu.ops.pallas.hogbom_step import (
    fused_clean_step,
    fused_subtract_integrate,
    integration_coefficients as jax_integration_coefficients,
    pad_psfs,
)
from radler_tpu.parallel.mesh import make_mesh as jax_make_mesh
from radler_tpu.parallel.mesh import mesh_hogbom_loop as jax_mesh_hogbom_loop
from radler_tpu_torch.interop import (
    cube_meta_from_reference,
    mesh_from_jax,
    settings_from_reference,
)
from radler_tpu_torch.kernels import hogbom_step as hs
from radler_tpu_torch.kernels import subtract_integrate as si
from radler_tpu_torch.parallel import mesh as pm

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

KERNEL_ATOL = 1e-6
HEIGHT, WIDTH, TILES = 64, 48, 4
H_LOC = HEIGHT // TILES

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


def make_meta(n_channels, n_polarizations, squared, seed=0):
    rng = np.random.default_rng(seed)
    return JaxCubeMeta(
        n_channels=n_channels,
        n_polarizations=n_polarizations,
        weights=tuple(float(w) for w in rng.uniform(0.5, 2.0, n_channels)),
        linked=(True,) * n_polarizations,
        polarization_norm_factor=1.0,
        squared_joins=squared,
        frequencies=tuple(1e8 + 1e7 * c for c in range(n_channels)),
    )


def make_shard_inputs(n_images, n_channels, seed):
    """A residual with sources of 0.2 to 0.9 on noise, Gaussian PSFs that
    differ per channel, and component values, as NumPy arrays."""
    rng = np.random.default_rng(seed)
    res = rng.normal(scale=0.01, size=(n_images, HEIGHT, WIDTH))
    for _ in range(10):
        y, x = rng.integers(0, HEIGHT), rng.integers(0, WIDTH)
        res[:, y, x] += rng.uniform(0.2, 0.9, n_images)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
    r2 = (yy - HEIGHT // 2) ** 2.0 + (xx - WIDTH // 2) ** 2.0
    psfs = np.stack([np.exp(-r2 / (2.0 * (1.5 + 0.4 * c) ** 2))
                     for c in range(n_channels)])
    values = rng.uniform(-0.6, 0.6, n_images)
    return res.astype(np.float32), psfs.astype(np.float32), values.astype(
        np.float32)


def peaks(r0):
    """Peaks inside the shard starting at row r0, in a shard above and one
    below, and at the image's four corners."""
    return [(r0 + 5, 17), (r0 - 9, 40), (r0 + H_LOC + 6, 3), (0, 0),
            (0, WIDTH - 1), (HEIGHT - 1, 0), (HEIGHT - 1, WIDTH - 1)]


def port_state(y, x, active=1):
    return torch.tensor([y, x, 1, 0, 0, active, y * WIDTH + x, 0],
                        dtype=torch.int32)


# (mode, n_channels, n_polarizations, squared_joins) of B4's four modes.
B4_CASES = [
    ("signed", 1, 1, False),
    ("linear", 3, 1, False),
    ("normal", 2, 1, False),
    ("normal", 2, 2, False),
    ("squared", 2, 2, True),
]


@pytest.mark.parametrize("shard", [1, 2])
@pytest.mark.parametrize("case", B4_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_subtract_integrate_matches_pallas_interpret(case, shard):
    mode, C, P, squared = case
    n = C * P
    meta = make_meta(C, P, squared, seed=C + P)
    if mode == "linear":
        chan = np.random.default_rng(1).uniform(0.2, 1.0, n).astype(np.float32)
        pol = np.ones(1, np.float32)
    else:
        got, chan, pol = jax_integration_coefficients(meta)
        assert got == mode
    coefs = si.plane_coefficients(mode, chan, P)
    res, psfs, values = make_shard_inputs(n, C, seed=10 * C + P)
    r0 = shard * H_LOC
    local = res[:, r0:r0 + H_LOC]
    psf_pad = pad_psfs(jnp.asarray(psfs[np.arange(n) // P]))
    for y, x in peaks(r0):
        new_res, part = fused_subtract_integrate(
            jnp.asarray(local), psf_pad, jnp.asarray(values),
            jnp.asarray(coefs), jnp.int32(y - r0 - HEIGHT + H_LOC),
            jnp.int32(x), block_rows=8, integration_mode=mode,
            pol_coefs=tuple(float(v) for v in pol), n_polarizations=P,
            interpret=True,
        )
        residual = torch.as_tensor(local.copy())
        model = torch.zeros_like(residual)
        out = torch.zeros(H_LOC, WIDTH)
        si.subtract_integrate(
            residual, model, torch.as_tensor(psfs), torch.as_tensor(values),
            port_state(y, x), torch.as_tensor(coefs), torch.as_tensor(pol),
            out, mode=mode, n_polarizations=P, row_offset=r0,
        )
        np.testing.assert_allclose(residual.numpy(), np.asarray(new_res),
                                   atol=KERNEL_ATOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(part),
                                   atol=KERNEL_ATOL)
        # The model gains the values at the peak on the shard holding it.
        expected = np.zeros_like(local)
        if r0 <= y < r0 + H_LOC:
            expected[:, y - r0, x] = values
        np.testing.assert_array_equal(model.numpy(), expected)


def test_subtract_integrate_is_a_no_op_when_inactive():
    res, psfs, values = make_shard_inputs(2, 2, seed=3)
    residual = torch.as_tensor(res[:, :H_LOC].copy())
    model = torch.zeros_like(residual)
    out = torch.full((H_LOC, WIDTH), 7.0)
    launches = si.subtract_integrate.launches
    si.subtract_integrate(
        residual, model, torch.as_tensor(psfs), torch.as_tensor(values),
        port_state(3, 4, active=0), torch.ones(2), torch.ones(1), out,
        mode="normal", n_polarizations=1,
    )
    assert torch.equal(residual, torch.as_tensor(res[:, :H_LOC]))
    assert not model.any() and bool((out == 7.0).all())
    assert si.subtract_integrate.launches == launches  # CPU: no launch


@pytest.mark.parametrize("case", [("signed", 1, 1, False),
                                  ("normal", 2, 1, False),
                                  ("normal", 2, 2, False),
                                  ("squared", 2, 2, True)],
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_step_with_row_offset_matches_pallas_interpret(case):
    """B1 on a shard of a taller image: the PSFs at the full height and the
    peak in image rows, against the TPU kernel given the shard's
    local-frame peak row (``mesh.py:283-305``)."""
    mode, C, P, squared = case
    n = C * P
    meta = make_meta(C, P, squared, seed=4)
    got, chan, pol = jax_integration_coefficients(meta)
    assert got == mode
    res, psfs, values = make_shard_inputs(n, C, seed=20 + n)
    weight = np.random.default_rng(5).uniform(0, 1, (H_LOC, WIDTH)).astype(
        np.float32)
    r0 = 2 * H_LOC
    local = res[:, r0:r0 + H_LOC]
    psf_pad = pad_psfs(jnp.asarray(psfs[np.arange(n) // P]))
    for y, x in peaks(r0):
        new_res, idx, cmp = fused_clean_step(
            jnp.asarray(local), psf_pad, jnp.asarray(values),
            jnp.asarray(weight), jnp.int32(y - r0 - HEIGHT + H_LOC),
            jnp.int32(x), block_rows=8, allow_negative=True,
            integration_mode=mode, chan_coefs=tuple(float(v) for v in chan),
            pol_coefs=tuple(float(v) for v in pol), use_weight=True,
            interpret=True,
        )
        residual = torch.as_tensor(local.copy())
        model = torch.zeros_like(residual)
        part_cmp, part_idx, _ = hs.hogbom_step(
            residual, model, torch.as_tensor(psfs), torch.as_tensor(values),
            port_state(y, x), torch.as_tensor(
                hs.kernel_coefficients(mode, chan, pol)),
            torch.as_tensor(weight), mode=mode, n_polarizations=P,
            allow_negative=True, row_offset=r0,
        )
        np.testing.assert_allclose(residual.numpy(), np.asarray(new_res),
                                   atol=KERNEL_ATOL)
        best = int(torch.argmax(part_cmp))
        assert int(part_idx[best]) == int(idx)
        assert abs(float(part_cmp[best]) - float(cmp)) <= KERNEL_ATOL
        expected = np.zeros_like(local)
        if r0 <= y < r0 + H_LOC:
            expected[:, y - r0, x] = values
        np.testing.assert_array_equal(model.numpy(), expected)


def test_step_row_offset_zero_is_the_single_device_step():
    res, psfs, values = make_shard_inputs(2, 2, seed=6)
    outs = []
    for kw in ({}, {"row_offset": 0}):
        residual = torch.as_tensor(res.copy())
        model = torch.zeros_like(residual)
        parts = hs.hogbom_step(
            residual, model, torch.as_tensor(psfs), torch.as_tensor(values),
            port_state(30, 20), torch.as_tensor(
                hs.kernel_coefficients("normal", np.ones(2), np.ones(1))),
            mode="normal", n_polarizations=1, allow_negative=True, **kw)
        outs.append((residual, model, *parts))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [("signed", 1, 1, False),
                                  ("linear", 3, 1, False),
                                  ("normal", 3, 1, False),
                                  ("normal", 2, 2, False),
                                  ("squared", 2, 2, True)],
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_integrate_values_matches_jax(case):
    from radler_tpu.ops.pallas.hogbom_step import integrate_values as jax_iv

    mode, C, P, squared = case
    meta = make_meta(C, P, squared, seed=7)
    if mode == "linear":
        chan, pol = np.asarray([0.3, 0.5, 0.2], np.float32), np.ones(1)
    else:
        _, chan, pol = jax_integration_coefficients(meta)
    vals = np.random.default_rng(8).normal(size=C * P).astype(np.float32)
    want = jax_iv(jnp.asarray(vals), mode, jnp.asarray(chan),
                  jnp.asarray(pol, jnp.float32), C, P)
    got = hs.integrate_values(torch.as_tensor(vals), mode,
                              torch.as_tensor(chan),
                              torch.as_tensor(pol, dtype=torch.float32), P)
    assert got.shape == ()
    assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))


# ---------------------------------------------------------------------------
# The mesh loop against the JAX mesh loop (tests/test_mesh_pallas.py)
# ---------------------------------------------------------------------------


def pallas_problem(n_chan, n_pol, size, seed=3):
    """``tests/test_mesh_pallas.py``'s problem: point sources convolved
    with a Gaussian PSF, one plane per image, scaled per plane."""
    rng = np.random.default_rng(seed)
    n = n_chan * n_pol
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psf = np.exp(-r2 / 18.0).astype(np.float32)
    sky = np.zeros((size, size), np.float32)
    for _ in range(8):
        cy, cx = rng.integers(10, size - 10, 2)
        sky[cy, cx] = rng.uniform(0.5, 2.0)
    res = np.stack([
        np.fft.irfft2(np.fft.rfft2(sky * (1 + 0.1 * i))
                      * np.fft.rfft2(np.fft.ifftshift(psf)), s=(size, size))
        for i in range(n)
    ]).astype(np.float32)
    return np.stack([psf] * n_chan), res


def initial_peak(meta, res):
    mode, chan, pol = jax_integration_coefficients(meta)
    n, height, width = res.shape
    if mode == "signed":
        integ = res[0] * chan[0]
    elif mode == "normal" and meta.n_polarizations == 1:
        integ = np.einsum("c,chw->hw", chan, res)
    else:
        cube = res.reshape(meta.n_channels, meta.n_polarizations, height,
                           width)
        integ = np.sqrt(np.maximum(
            np.einsum("cphw,cphw,c,p->hw", cube, cube, chan, pol), 0.0))
    y0, x0 = divmod(int(np.argmax(np.abs(integ))), width)
    return float(integ[y0, x0]), x0, y0


def run_both_mesh_loops(meta, psfs, res, n_iter, gain, weight=None,
                        first_threshold=1e-6):
    """The JAX mesh loop (interpret mode, 8 virtual devices) and the port's
    on the same mesh shape; returns (JAX outputs, port outputs)."""
    n, height, width = res.shape
    P = meta.n_polarizations
    v0, x0, y0 = initial_peak(meta, res)
    w = np.ones((height, width), np.float32) if weight is None else weight
    ones = jnp.ones((height, width), jnp.float32)
    mesh = jax_make_mesh(n_channels=meta.n_channels)
    assert mesh.size == 8
    ref = jax_mesh_hogbom_loop(
        mesh, jnp.asarray(res), jnp.zeros_like(jnp.asarray(res)),
        pad_psfs(jnp.asarray(psfs[np.arange(n) // P])), jnp.asarray(w), ones,
        jnp.float32(v0), jnp.int32(x0), jnp.int32(y0), jnp.asarray(True),
        jnp.float32(first_threshold), jnp.float32(gain),
        jnp.float32(abs(v0)), jnp.float32(4.0), jnp.int32(0),
        jnp.int32(n_iter), meta=meta, allow_negative=True,
        stop_on_negative=False, fitter=None, interpret=True,
    )
    residual = torch.as_tensor(res.copy())
    model = torch.zeros_like(residual)
    out = pm.mesh_hogbom_loop(
        mesh_from_jax(mesh, "cpu"), residual, model, torch.as_tensor(psfs),
        torch.as_tensor(w), torch.ones(height, width), (v0, x0, y0, True),
        hs.LoopParams.make(gain, first_threshold, abs(v0), 4.0, n_iter,
                           False),
        0, meta=cube_meta_from_reference(meta), allow_negative=True,
    )
    return ref, (residual.numpy(), model.numpy(), out)


MESH_CASES = [
    # (n_channels, n_polarizations, norm, squared, mesh shape): one channel
    # runs B1 on chan 1 x tile 8, four joined channels B4 in normal mode on
    # chan 4 x tile 2, 2 ch x 2 pol squared B4 in squared mode on 2 x 4.
    (1, 1, 1.0, False, {"chan": 1, "tile": 8}),
    (4, 1, 1.0, False, {"chan": 4, "tile": 2}),
    (2, 2, 2.0, True, {"chan": 2, "tile": 4}),
]


@needs_8
@pytest.mark.parametrize("case", MESH_CASES,
                         ids=["single-channel", "joined-channels",
                              "joined-polarizations-squared"])
def test_mesh_loop_matches_jax_mesh_loop(case):
    C, P, norm, squared, shape = case
    meta = JaxCubeMeta(C, P, (1.0,) * C, (True,) * P, norm, squared,
                       tuple(1e8 + 1e7 * c for c in range(C)))
    psfs, res = pallas_problem(C, P, 64)
    ref, got = run_both_mesh_loops(meta, psfs, res, n_iter=40, gain=0.2)
    res_r, mod_r, it_r, val_r, found_r, _ = ref
    res_g, mod_g, out = got
    assert dict(jax_make_mesh(n_channels=C).shape) == shape
    assert out.iteration == int(it_r) == 40
    np.testing.assert_allclose(res_g, np.asarray(res_r), atol=2e-5)
    np.testing.assert_allclose(mod_g, np.asarray(mod_r), atol=2e-5)
    assert out.found == bool(found_r)
    assert abs(out.value - float(val_r)) < 2e-4 + 1e-3 * abs(float(val_r))


@needs_8
def test_mesh_loop_with_a_weight_plane_matches_jax():
    """Four joined channels under a border window and a random weight,
    with negatives allowed: the weighted comparison of the summed parts."""
    meta = JaxCubeMeta(4, 1, (1.0, 0.8, 1.2, 0.5), (True,), 1.0, False,
                       tuple(1e8 + 1e7 * c for c in range(4)))
    psfs, res = pallas_problem(4, 1, 64, seed=9)
    rng = np.random.default_rng(2)
    weight = rng.uniform(0.5, 1.0, (64, 64)).astype(np.float32)
    weight[:3] = weight[-3:] = weight[:, :3] = weight[:, -3:] = 0.0
    ref, got = run_both_mesh_loops(meta, psfs, res, n_iter=60, gain=0.1,
                                   weight=weight)
    assert got[2].iteration == int(ref[2]) == 60
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), atol=2e-5)
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), atol=2e-5)


@needs_8
@pytest.mark.parametrize("n_channels", [1, 2],
                         ids=["chan1-tile8-B1", "chan2-tile4-B4"])
def test_cross_tile_tie_takes_the_largest_index(n_channels):
    """Two tiles hold the same maximum: the mesh takes the larger global
    flat index (``mesh.py:334-336``), as the JAX mesh does, where the
    single-device loop takes the smaller."""
    size = 64
    psf = np.zeros((size, size), np.float32)
    psf[size // 2, size // 2] = 1.0  # a delta: subtraction touches one pixel
    res = np.zeros((n_channels, size, size), np.float32)
    first, low, high = (3, 10), (12, 20), (50, 7)  # tiles 0/1/6 or 0/0/3
    res[:, first[0], first[1]] = 3.0
    res[:, low[0], low[1]] = 2.0
    res[:, high[0], high[1]] = 2.0
    meta = JaxCubeMeta(n_channels, 1, (1.0,) * n_channels, (True,), 1.0,
                       False, tuple(1e8 + 1e7 * c for c in range(n_channels)))
    psfs = np.stack([psf] * n_channels)
    # Gain 1: iteration 1 removes the first source and picks one of the
    # tied two, iteration 2 removes it.
    ref, got = run_both_mesh_loops(meta, psfs, res, n_iter=2, gain=1.0)
    mod_r, mod_g = np.asarray(ref[1]), got[1]
    np.testing.assert_array_equal(mod_g, mod_r)
    assert (mod_g[:, high[0], high[1]] == 2.0).all()
    assert not mod_g[:, low[0], low[1]].any()
    # The single-device loop breaks the same tie the other way.
    residual = torch.as_tensor(res.copy())
    model = torch.zeros_like(residual)
    hs.hogbom_loop(residual, model, torch.as_tensor(psfs), None, None,
                   (3.0, first[1], first[0], True),
                   hs.LoopParams.make(1.0, 1e-6, 3.0, 4.0, 2, False), 0,
                   meta=cube_meta_from_reference(meta), allow_negative=True)
    assert (model.numpy()[:, low[0], low[1]] == 2.0).all()


def test_mesh_loop_chunking_equals_exact_stop(monkeypatch):
    """Iterations enqueued after the stop are no-ops on every shard: reading
    the state every iteration or every few chunks ends in the same bits."""
    meta = cube_meta_from_reference(
        JaxCubeMeta(2, 2, (1.0, 0.7), (True, True), 2.0, True, (1e8, 1.1e8)))
    psfs, res = pallas_problem(2, 2, 64, seed=4)
    v0, x0, y0 = initial_peak(meta, res)
    params = hs.LoopParams.make(0.3, 0.4, abs(v0), 0.0, 500, False)
    runs = []
    for chunk in (1, 2 * hs.CHUNK + 1):
        monkeypatch.setattr(hs, "CHUNK", chunk)
        residual = torch.as_tensor(res.copy())
        model = torch.zeros_like(residual)
        out = pm.mesh_hogbom_loop(
            pm.make_mesh(8, 2, "cpu"), residual, model,
            torch.as_tensor(psfs), None, None, (v0, x0, y0, True), params, 0,
            meta=meta, allow_negative=True)
        runs.append((out, residual, model))
    (out_a, res_a, mod_a), (out_b, res_b, mod_b) = runs
    assert out_a == out_b and 0 < out_a.iteration < 500
    assert torch.equal(res_a, res_b) and torch.equal(mod_a, mod_b)


def test_mesh_of_one_plane_per_shard_is_the_single_device_loop():
    """Four channels, one plane per chan shard: the parts add in B1's own
    order, so the mesh loop and the single-device loop end in the same
    bits when no two tiles tie."""
    meta = cube_meta_from_reference(
        JaxCubeMeta(4, 1, (1.0, 0.8, 1.2, 0.5), (True,), 1.0, False,
                    tuple(1e8 + 1e7 * c for c in range(4))))
    psfs, res = pallas_problem(4, 1, 64, seed=6)
    v0, x0, y0 = initial_peak(meta, res)
    params = hs.LoopParams.make(0.1, 1e-3, abs(v0), 4.0, 300, False)
    outs = []
    for mesh in (None, pm.make_mesh(8, 4, "cpu")):
        residual = torch.as_tensor(res.copy())
        model = torch.zeros_like(residual)
        args = (residual, model, torch.as_tensor(psfs), None, None,
                (v0, x0, y0, True), params, 0)
        kw = dict(meta=meta, allow_negative=True)
        out = (hs.hogbom_loop(*args, **kw) if mesh is None
               else pm.mesh_hogbom_loop(mesh, *args, **kw))
        outs.append((out, residual, model))
    (out_1, res_1, mod_1), (out_8, res_8, mod_8) = outs
    assert out_1 == out_8 and out_1.iteration > 100
    assert torch.equal(res_1, res_8) and torch.equal(mod_1, mod_8)


# ---------------------------------------------------------------------------
# Through Radler.perform (tests/test_mesh_clean.py)
# ---------------------------------------------------------------------------


def cross_psf(size):
    psf = np.zeros((size, size), np.float32)
    c = size // 2
    psf[c, c] = 1.0
    psf[c - 1, c] = 0.4
    psf[c + 1, c] = 0.6
    psf[c, c - 1] = 0.25
    psf[c, c + 1] = 0.5
    return psf


def mesh_settings(package, size, iterations, threshold, use_mesh):
    s = package.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.minor_iteration_count = iterations
    s.absolute_threshold = threshold
    s.generic.use_sub_minor_optimization = False
    s.parallel.use_device_mesh = use_mesh
    s.parallel.n_devices = 8 if use_mesh else 0
    return s


def perform(package, settings, psf, residual, **kwargs):
    res = residual.copy()
    mdl = np.zeros_like(res)
    device = {"device": "cpu"} if package is rd else {}
    r = package.Radler(settings, psf, res, mdl, 0.0, **device, **kwargs)
    more = r.perform(0)
    return more, res, mdl, r.iteration_number


def assert_same_run(a, b, atol=2e-6):
    assert a[0] == b[0] and a[3] == b[3]
    np.testing.assert_allclose(a[1], b[1], atol=atol)
    np.testing.assert_allclose(a[2], b[2], atol=atol)


@needs_8
def test_mesh_point_source_parity():
    size = 64
    psf = cross_psf(size)
    residual = np.zeros((size, size), np.float32)
    sy, sx, scale = 21, 37, 2.5
    for dy, dx, v in [(0, 0, 1.0), (-1, 0, 0.4), (1, 0, 0.6), (0, -1, 0.25),
                      (0, 1, 0.5)]:
        residual[sy + dy, sx + dx] = scale * v
    settings = mesh_settings(rd, size, 1000, 1e-8, True)
    got = perform(rd, settings, psf, residual)
    more, res, model, _ = got
    assert not more
    assert np.abs(res).max() < 2e-6
    assert abs(model[sy, sx] - scale) < 1e-4 * scale
    rest = model.copy()
    rest[sy, sx] = 0.0
    assert np.abs(rest).max() < 4e-6
    jax_settings = mesh_settings(jrd, size, 1000, 1e-8, True)
    assert_same_run(got, perform(jrd, jax_settings, psf, residual))


def multichannel_problem(n_channels, seed):
    size = 64
    rng = np.random.default_rng(seed)
    psf = np.stack([cross_psf(size)] * n_channels)
    residual = np.zeros((n_channels, size, size), np.float32)
    for c in range(n_channels):
        residual[c, 20, 30] = 1.0 + (0.2 if n_channels == 2 else 0.1) * c
        residual[c, 40, 45] = 0.7
    residual += np.float32(1e-4) * rng.standard_normal(
        residual.shape).astype(np.float32)
    freqs = np.array([[1.0e8 + c * 1e7, 1.1e8 + c * 1e7]
                      for c in range(n_channels)])
    return psf, residual, freqs


@needs_8
@pytest.mark.parametrize("n_channels, seed, shape",
                         [(2, 11, (2, 4)), (8, 12, (8, 1))],
                         ids=["two-channels", "pure-channel-sharding"])
def test_mesh_multichannel_matches_single_device_and_jax(n_channels, seed,
                                                         shape):
    psf, residual, freqs = multichannel_problem(n_channels, seed)
    mesh = pm.make_mesh(8, n_channels, "cpu")
    assert (mesh.chan, mesh.tile) == shape
    runs = {}
    for package in (rd, jrd):
        for use_mesh in (False, True):
            s = mesh_settings(package, 64, 100, 1e-3, use_mesh)
            runs[package, use_mesh] = perform(package, s, psf, residual,
                                              frequencies=freqs)
    assert runs[rd, True][3] > 0
    assert_same_run(runs[rd, True], runs[rd, False])
    assert_same_run(runs[rd, True], runs[jrd, True])


def test_radler_mesh_launches_no_kernel_on_the_cpu():
    """The CPU mesh runs the plain versions: no launch is counted."""
    psf, residual, freqs = multichannel_problem(2, 3)
    before = (si.subtract_integrate.launches, hs.hogbom_step.launches)
    _, res, _, n = perform(rd, mesh_settings(rd, 64, 20, 1e-3, True), psf,
                           residual, frequencies=freqs)
    assert n == 20 and np.abs(res).max() < np.abs(residual).max()
    assert (si.subtract_integrate.launches, hs.hogbom_step.launches) == before


# ---------------------------------------------------------------------------
# make_mesh and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_devices, n_channels, shape", [
    (8, 64, (8, 1)),
    (8, 2, (2, 4)),
    (8, 3, (1, 8)),
    (8, 4, (4, 2)),
    (8, None, (4, 2)),
    (1, 64, (1, 1)),
])
def test_make_mesh_channel_major(n_devices, n_channels, shape):
    """``tests/test_mesh_clean.py::test_make_mesh_channel_major``'s table,
    for the port's mesh and, through ``mesh_from_jax``, the JAX one."""
    mesh = pm.make_mesh(n_devices, n_channels, "cpu")
    assert (mesh.chan, mesh.tile) == shape and mesh.size == n_devices
    assert mesh.device == torch.device("cpu")
    if len(jax.devices()) >= 8:
        jmesh = mesh_from_jax(jax_make_mesh(n_devices, n_channels), "cpu")
        assert jmesh == mesh


def test_mesh_eligibility():
    meta = cube_meta_from_reference(make_meta(2, 2, False))
    mesh = pm.make_mesh(8, 2, "cpu")  # chan 2 x tile 4
    assert pm.mesh_pallas_eligible(mesh, meta, 64)
    assert pm.mesh_pallas_eligible(mesh, meta, 4)  # no 8-row gate
    assert not pm.mesh_pallas_eligible(mesh, meta, 62)
    # chan 4 would split the 2-polarization groups of 4 planes.
    assert not pm.mesh_pallas_eligible(pm.Mesh(4, 2, torch.device("cpu")),
                                       meta, 64)


def test_place_round_trip():
    cube = torch.arange(4 * 8 * 3, dtype=torch.float32).view(4, 8, 3)
    for chan, tile in ((1, 8), (2, 4), (4, 2), (4, 1)):
        mesh = pm.Mesh(chan, tile, torch.device("cpu"))
        shards = pm.place(cube, mesh)
        assert shards.shape == (chan, tile, 4 // chan, 8 // tile, 3)
        assert torch.equal(shards[chan - 1, tile - 1],
                           cube[-(4 // chan):, -(8 // tile):])
        target = torch.zeros_like(cube)
        pm.unplace(shards, target, mesh)
        assert torch.equal(target, cube)


def refusal_settings(package, **changes):
    s = mesh_settings(package, 64, 10, 1e-3, True)
    for name, value in changes.items():
        obj = s
        *path, last = name.split(".")
        for part in path:
            obj = getattr(obj, part)
        if hasattr(value, "name"):  # an enum: the package's own member
            value = getattr(type(getattr(obj, last)), value.name)
        setattr(obj, last, value)
    return s


@needs_8
@pytest.mark.parametrize("changes, height", [
    ({"generic.use_sub_minor_optimization": True}, 64),
    ({"algorithm_type": rd.AlgorithmType.IUWT}, 64),
    ({}, 60),
], ids=["clark", "iuwt", "height-not-divisible"])
def test_unported_mesh_routes_raise(changes, height):
    """The mesh routes that the port once refused run, and match the JAX
    package (``assert_same_run``): the mesh's Clark subminor loop (chan 1 x
    tile 8) and IUWT on the mesh (row placement only in the JAX package,
    the single-device run in the port) against its mesh run; 60 rows,
    which do not divide over 8 tiles, take the single-device Högbom loop,
    against the JAX package's run without a mesh, since its own mesh run
    raises there (``jax.device_put`` of uneven shards)."""
    yy, xx = np.mgrid[0:height, 0:64]
    psf = np.exp(-((yy - height // 2) ** 2 + (xx - 32) ** 2) / 6.0)
    res = np.zeros((height, 64))
    for y, x, v in ((10, 10, 1.0), (37, 50, 0.7), (height - 9, 22, -0.45),
                    (29, 33, 0.55)):
        res += v * np.roll(psf, (y - height // 2, x - 32), (0, 1))
    psf, res = psf.astype(np.float32), res.astype(np.float32)
    runs = []
    for package in (rd, jrd):
        s = refusal_settings(package, **changes)
        s.trimmed_image_height = height
        if package is jrd and height % 8:
            with pytest.raises(ValueError, match="divisible"):
                perform(package, s, psf, res)
            s.parallel.use_device_mesh = False
        runs.append(perform(package, s, psf, res))
    assert runs[0][3] > 0 and np.abs(runs[0][2]).max() > 0
    assert_same_run(*runs)


def test_mesh_of_one_shard_runs_the_single_device_loop():
    """``n_devices`` 1, or 0 on the CPU (one device), makes no mesh: the
    Clark default runs as without one."""
    psf, residual, _ = multichannel_problem(1, 5)
    outs = []
    for use_mesh, n_devices in ((False, 0), (True, 0), (True, 1)):
        s = mesh_settings(rd, 64, 50, 1e-3, use_mesh)
        s.parallel.n_devices = n_devices
        s.generic.use_sub_minor_optimization = True
        outs.append(perform(rd, s, psf[0], residual[0]))
    for out in outs[1:]:
        assert out[3] == outs[0][3]
        assert np.array_equal(out[1], outs[0][1])


def test_settings_carry_the_mesh_fields():
    s = jrd.Settings()
    s.parallel.use_device_mesh = True
    s.parallel.n_devices = 8
    port = settings_from_reference(s)
    assert port.parallel.use_device_mesh and port.parallel.n_devices == 8
