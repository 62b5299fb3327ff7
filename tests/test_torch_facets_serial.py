"""Faceted deconvolution on the serial route, in the port against the JAX
package, on the CPU: multiscale (each facet on the fused loop or the host
path) and IUWT, whose facets run one after another in both packages' rules
(the JAX package batches multiscale; the port does so after ROADMAP queue
A, item 6b), the per-scale masks and the component list across facets,
faceted checkpoints and the clones' caches.  Helpers, fields and the
tolerances, with their reasons, are ``test_torch_facets.py``'s.
"""

import numpy as np
import pytest
import torch

import radler_tpu as jrd

import radler_tpu_torch as rd
from radler_tpu_torch.interop import settings_from_reference

from test_torch_facets import (
    NO_BATCH,
    assert_parity,
    assert_same_split,
    convolve,
    gaussian_psf,
    point_field,
    run,
    settings,
)

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)


def iuwt_field(size, seed=11):
    """``test_faceted_iuwt.py``'s diffuse problem."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    psf = np.exp(-((yy - size // 2) ** 2 + (xx - size // 2) ** 2)
                 / (2 * 2.0**2)).astype(np.float32)
    sky = np.zeros((size, size), np.float32)
    for _ in range(10):
        cy, cx = rng.integers(size // 6, 5 * size // 6, 2)
        s_ = rng.uniform(1.5, 6.0)
        a = rng.uniform(0.4, 1.2)
        sky += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s_ * s_))
    return psf, convolve(sky, psf)


@pytest.mark.parametrize("route", ["fused", "host", "fused-3x3"])
def test_multiscale_facets_match_jax(route, monkeypatch):
    """Serial multiscale, each facet on the fused loop or the host path,
    on a 2x2 grid (and 3x3), against the JAX serial route, and within the
    JAX package's own 3e-5 of its batched route."""
    psf = gaussian_psf(128)
    residual = point_field(128, psf, blob=1.5)
    s = settings("MULTISCALE", 128, grid=3 if route.endswith("3x3") else 2,
                 iterations=300)
    if route == "host":
        monkeypatch.setenv("RADLER_TPU_NO_FUSED_MS", "1")
    j = run(jrd, s, psf, residual, monkeypatch, True)
    if route == "host":
        monkeypatch.setenv("RADLER_TPU_NO_FUSED_MS", "1")
    t = run(rd, s, psf, residual, monkeypatch, False)
    assert t[4]._parallel.last_route == "serial"
    scale = max(1.0, float(np.abs(j[2]).max()))
    assert_parity(j, t, atol=2e-6 * scale)
    if route != "host":
        jb = run(jrd, s, psf, residual, monkeypatch, False)
        assert jb[:2] == t[:2]
        np.testing.assert_allclose(t[2], jb[2], atol=3e-5)
        np.testing.assert_allclose(t[3], jb[3], atol=3e-5)


def test_faceted_multiscale_automask_matches_jax(monkeypatch):
    """``test_faceted_multiscale.py``'s run (2x2, auto-masking over several
    major iterations, the source list): the per-scale masks merged over the
    facets, the component list gathered from them, equal counts."""
    size = 96
    rng = np.random.default_rng(2)
    psf = gaussian_psf(size, 1.5)
    sky = np.zeros((size, size), np.float32)
    for y, x in [(22, 22), (22, 72), (72, 22), (72, 72)]:
        sky[y, x] = 1.0
    residual = convolve(sky, psf) + rng.normal(
        scale=5e-3, size=(size, size)).astype(np.float32)
    pixel_scale = 1.0 / 60.0 * (np.pi / 180.0)
    s = settings("MULTISCALE", size, iterations=600, absolute_threshold=0.0,
                 major_loop_gain=1.0, auto_mask_sigma=5.0,
                 auto_threshold_sigma=1.0, save_source_list=True,
                 pixel_scale__x=pixel_scale, pixel_scale__y=pixel_scale)
    kw = {"beam_size": 1.5 * pixel_scale}
    j = run(jrd, s, psf, residual, monkeypatch, True, majors=3, **kw)
    t = run(rd, s, psf, residual, monkeypatch, True, majors=3, **kw)
    assert_parity(j, t, atol=2e-6)
    masks_j, masks_t = j[4]._parallel._scale_masks, t[4]._parallel._scale_masks
    assert len(masks_t) == len(masks_j) > 1
    assert any(m.any() for m in masks_t)
    for a, b in zip(masks_j, masks_t):
        np.testing.assert_array_equal(b, a)
    cj, ct = j[4].get_component_list(), t[4].get_component_list()
    assert [ct.component_count(i) for i in range(ct.n_scales)] == [
        cj.component_count(i) for i in range(cj.n_scales)]
    assert sum(ct.component_count(i) for i in range(ct.n_scales)) >= 4


@pytest.mark.parametrize("grid", [2, 3])
def test_faceted_iuwt_matches_jax(grid, monkeypatch):
    """``test_faceted_iuwt.py``'s field on a 2x2 (and 3x3) grid, 12
    structure iterations: serial IUWT, equal splits, counts and results,
    the residual within 2e-6 of max(1, |res|max), as multiscale is held.
    On the 2x2 grid, from the fifth structure iteration on, rounding
    decides the second facet's residual between two outcomes 1e-3 apart:
    the JAX package's own run lands on either, from process to process and
    when its input is multiplied by float32(1 + 1e-7).  The port holds the
    contract against the nearer of those two JAX runs, and against the
    JAX run itself the tolerances ``test_torch_iuwt.py`` holds IUWT's
    perform to (5e-3 absolute, 1e-3 in rms and in model flux)."""
    psf, residual = iuwt_field(128)
    s = settings("IUWT", 128, grid, iterations=12, major_loop_gain=0.6,
                 absolute_threshold=0.0)
    j = run(jrd, s, psf, residual, monkeypatch, False)
    t = run(rd, s, psf, residual, monkeypatch, False)
    assert t[4]._parallel.last_route == "serial"
    assert t[:2] == j[:2]
    assert_same_split(j[5], t[5])
    scale = max(1.0, float(np.abs(residual).max()))
    if grid == 2:
        nudged = run(jrd, s, psf, residual * NUDGE, monkeypatch, False)
        assert_parity(nearest(t, j, nudged), t, atol=2e-6 * scale)
    else:
        assert_parity(j, t, atol=2e-6 * scale)
    rms = lambda a: float(np.sqrt(np.mean(a.astype(np.float64) ** 2)))  # noqa
    assert np.abs(t[2] - j[2]).max() <= 5e-3
    assert rms(t[2]) == pytest.approx(rms(j[2]), rel=1e-3)
    assert t[3].sum() == pytest.approx(j[3].sum(), rel=1e-3)
    # The JAX test's own gates: finite, cleaned, flux kept.
    assert np.isfinite(t[2]).all() and t[3].max() > 0
    assert rms(t[2]) < 0.75 * rms(residual)


# A one-ulp nudge of a cube's values, to show where rounding decides a run.
NUDGE = np.float32(1.0 + 1e-7)


def nearest(t, *jax_runs):
    """Of the JAX runs, the one whose residual lies nearest the port's."""
    return min(jax_runs, key=lambda j: float(np.abs(t[2] - j[2]).max()))


def check_field(size, n_channels, seed):
    """``chip_smoke.py``'s faceted card-against-CPU field
    (``make_ms_check_problem``): 20 point sources on config 3's diffuse
    emission at 1/500 of its brightness, under its PSFs (a Gaussian with a
    sidelobe ring), as I, Q, U, V (x 1, 0.3, -0.2, 0.1) of each channel;
    returns (PSFs [C, H, W], planes [4 C, H, W])."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psfs = []
    for c in range(n_channels):
        w = 2.5 * (1.0 + 0.04 * c)
        p = np.exp(-r2 / (2 * w * w))
        p += 0.06 * np.exp(-((np.sqrt(r2) - 14 * (1 + 0.03 * c)) ** 2) / 6)
        psfs.append(p.astype(np.float32))
    psfs = np.stack(psfs)
    sky = np.zeros((size, size), np.float32)
    for _ in range(60):
        cy, cx = rng.integers(size // 8, 7 * size // 8, 2)
        s_ = rng.uniform(1.5, 25)
        a = rng.uniform(0.2, 1.0)
        m = max(1, int(4 * s_))
        y0, y1 = max(0, cy - m), min(size, cy + m)
        x0, x1 = max(0, cx - m), min(size, cx + m)
        sky[y0:y1, x0:x1] += a * np.exp(
            -((yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2)
            / (2 * s_ * s_))
    rng = np.random.default_rng(seed)
    points = np.zeros((size, size))
    ys = rng.integers(size // 8, 7 * size // 8, 20)
    xs = rng.integers(size // 8, 7 * size // 8, 20)
    np.add.at(points, (ys, xs), rng.uniform(0.2, 1.0, 20))
    planes = []
    for c in range(n_channels):
        fp = np.fft.rfft2(np.fft.ifftshift(psfs[c]))
        diffuse = np.fft.irfft2(np.fft.rfft2(sky * (1 + 0.1 * c)) * fp,
                                s=(size, size)).astype(np.float32)
        image = (0.002 * diffuse + np.fft.irfft2(
            np.fft.rfft2(points * (1 - 0.05 * c)) * fp, s=(size, size))
                 ).astype(np.float32)
        planes += [image * flux for flux in (1.0, 0.3, -0.2, 0.1)]
    return psfs, np.stack(planes).astype(np.float32)


def iquv_table(psfs):
    """A work table of I, Q, U, V for each channel, the PSF on I."""
    n_channels = len(psfs)

    def make(package, res, model):
        mod = __import__(package.__name__ + ".work_table",
                         fromlist=["WorkTable"])
        tab = mod.WorkTable([], n_channels, n_channels)
        i = 0
        for c in range(n_channels):
            for pol in ("STOKES_I", "STOKES_Q", "STOKES_U", "STOKES_V"):
                e = mod.WorkTableEntry()
                e.polarization = getattr(package.Polarization, pol)
                e.original_channel_index = c
                e.image_weight = 1.0
                e.band_start_frequency = 1.0e8 + c * 1e7
                e.band_end_frequency = 1.1e8 + c * 1e7
                if pol == "STOKES_I":
                    e.psf_accessors = [mod.LoadOnlyImageAccessor(psfs[c])]
                e.residual_accessor = mod.LoadAndStoreImageAccessor(res[i])
                e.model_accessor = mod.LoadAndStoreImageAccessor(model[i])
                tab.add_entry(e)
                i += 1
        return tab

    return make


def components(radler):
    """The merged component list: {scale: {(x, y): values}}."""
    cl = radler.get_component_list()
    return {si: {tuple(int(v) for v in cl.get_component(si, k)[:2]):
                 np.asarray(cl.get_component(si, k)[2])
                 for k in range(cl.component_count(si))}
            for si in range(cl.n_scales)}


def all_scales_case(seed):
    """(settings, table maker, planes) of the all-scales multiscale case."""
    psfs, planes = check_field(256, 2, seed)
    s = jrd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = 256
    s.algorithm_type = jrd.AlgorithmType.MULTISCALE
    s.minor_iteration_count = 300
    s.minor_loop_gain, s.major_loop_gain = 0.1, 0.85
    s.squared_joins = True
    s.save_source_list = True
    s.parallel.grid_width = s.parallel.grid_height = 2
    s.spectral_fitting.mode = jrd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    return s, iquv_table(psfs), planes


@pytest.mark.parametrize("seed", [8, 7])
def test_faceted_multiscale_all_scales_matches_jax(seed, monkeypatch):
    """The smoke's card-against-CPU field at 256^2 x 2 channels x IQUV,
    config 5's settings (squared joins, 2-term fit, gain 0.1, major gain
    0.85, 2x2 facets, 300 iterations) with every scale (0 to 64 pixels),
    against the JAX serial route.  At seed 8 within the contract.  At
    seed 7 two pixels nearly tie for one of the 64-pixel scale's 201
    components, in the third facet, so that rounding decides which it
    takes (the residuals part by 3.5e-4): the JAX package's run on its
    input multiplied by float32(1 + 1e-7) takes the other.  The port holds
    the contract against the nearer of the two JAX runs, and against the
    JAX run itself the same counts with at most that one component a
    pixel over."""
    s, table, planes = all_scales_case(seed)

    def jax_run(inputs):
        j = run(jrd, s, None, inputs, monkeypatch, True, table=table)
        return j[:4] + (components(j[4]), j[5])

    j = jax_run(planes)
    t = run(rd, s, None, planes, monkeypatch, True, table=table)
    assert t[4]._parallel.last_route == "serial"
    assert max(a.scale_count for a in t[4]._parallel.algorithms) == 6
    scale = max(1.0, float(np.abs(j[2]).max()))
    if seed == 8:
        assert_parity(j, t, atol=2e-6 * scale)
        return
    ct = components(t[4])
    best = nearest(t, j, jax_run(planes * NUDGE))
    assert {k: set(v) for k, v in best[4].items()} == {
        k: set(v) for k, v in ct.items()}
    assert_parity(best, t, atol=2e-6 * scale)
    assert t[:2] == j[:2]
    cj = j[4]
    assert [len(ct[k]) for k in ct] == [len(cj[k]) for k in cj]
    moved = [(k, p, q) for k in cj for p in cj[k] if p not in ct[k]
             for q in ct[k] if q not in cj[k]]
    assert len(moved) <= 1
    for k, p, q in moved:
        assert k == max(cj) and max(abs(p[0] - q[0]), abs(p[1] - q[1])) == 1


# ---------------------------------------------------------------------------
# Checkpoints and clones
# ---------------------------------------------------------------------------


def test_faceted_checkpoint_round_trip_and_jax_checkpoint(tmp_path,
                                                          monkeypatch):
    """After the mask-tracking perform of a faceted multiscale run, the
    facet layer's per-scale masks survive the port's checkpoint; a
    checkpoint written by the JAX package after the same perform continues
    in the port as it does in the JAX package."""
    size = 96
    psf = gaussian_psf(size)
    residual = point_field(size, psf, blob=1.5)
    s = settings("MULTISCALE", size, iterations=150, auto_mask_sigma=4.0,
                 absolute_threshold=0.0, major_loop_gain=0.85)
    monkeypatch.setenv(NO_BATCH, "1")
    res_j, mod_j = residual.copy(), np.zeros_like(residual)
    rj = jrd.Radler(s, psf, res_j, mod_j, 0.0)
    assert rj.perform(0) is True
    assert rj._parallel._scale_masks
    jax_path = str(tmp_path / "jax.ckpt")
    rj.save_state(jax_path)
    res_t, mod_t = res_j.copy(), mod_j.copy()
    rj.perform(1)

    ts = settings_from_reference(s)
    rt = rd.Radler(ts, psf, res_t, mod_t, 0.0, device="cpu")
    rt.load_state(jax_path)
    for a, b in zip(rj._parallel._scale_masks, rt._parallel._scale_masks):
        assert b.shape == a.shape
    port_path = str(tmp_path / "port.ckpt")
    rt.save_state(port_path)
    again = rd.Radler(ts, psf, res_t.copy(), mod_t.copy(), 0.0, device="cpu")
    again.load_state(port_path)
    assert len(again._parallel._scale_masks) == len(rt._parallel._scale_masks)
    for a, b in zip(rt._parallel._scale_masks, again._parallel._scale_masks):
        np.testing.assert_array_equal(b, a)
    assert ([a.iteration_number for a in again._parallel.algorithms]
            == [a.iteration_number for a in rt._parallel.algorithms])
    rt.perform(1)
    assert ([a.iteration_number for a in rt._parallel.algorithms]
            == [a.iteration_number for a in rj._parallel.algorithms])
    scale = max(1.0, float(np.abs(res_j).max()))
    np.testing.assert_allclose(res_t, res_j, atol=2e-6 * scale)
    np.testing.assert_allclose(mod_t, mod_j, atol=1e-4)
    for a, b in zip(rj._parallel._scale_masks, rt._parallel._scale_masks):
        np.testing.assert_array_equal(b, a)


def test_clones_share_no_cache(monkeypatch):
    """Each facet's multiscale clone keeps its own scales, masks and fused
    banks, made for its own box."""
    psf = gaussian_psf(96)
    residual = point_field(96, psf, blob=1.5)
    s = settings_from_reference(settings("MULTISCALE", 96, iterations=100))
    r = rd.Radler(s, psf, residual, np.zeros_like(residual), 0.0,
                  device="cpu")
    algorithms = r._parallel.algorithms
    assert len(algorithms) == 4
    for name in ("scale_infos", "scale_masks", "_kernel_cache", "_comp_acc"):
        assert len({id(getattr(a, name)) for a in algorithms}) == 4, name
    r.perform(0)
    boxes = [(sub.height, sub.width) for sub in r._parallel.last_sub_images]
    banks = [a._fused_banks for a in algorithms]
    assert all(b is not None for b in banks)
    for box, bank in zip(boxes, banks):
        assert tuple(bank[1].shape[-2:]) == box  # the PSFs the banks hold
    tensors = [id(t) for b in banks for t in b[4] if torch.is_tensor(t)]
    assert len(tensors) == len(set(tensors))


def print_readings():
    """The readings the faceted IUWT and all-scales multiscale cases rest
    on: for each structure-iteration count (IUWT) and seed (multiscale),
    the per-facet counts and the residual's largest difference between
    the port and the JAX package, and between the port and the JAX
    package's run on its input times float32(1 + 1e-7); for multiscale
    also the JAX package's batched route against its serial one."""
    mp = pytest.MonkeyPatch()
    nudge = NUDGE
    psf, residual = iuwt_field(128)
    for grid in (2, 3):
        for k in range(1, 13):
            s = settings("IUWT", 128, grid, iterations=k,
                         major_loop_gain=0.6, absolute_threshold=0.0)
            j = run(jrd, s, psf, residual, mp, False)
            n = run(jrd, s, psf, residual * nudge, mp, False)
            t = run(rd, s, psf, residual, mp, False)
            print(f"IUWT {grid}x{grid}, {k:2d} structure iterations: counts "
                  f"{t[1]} (JAX {j[1]}); max|dres| against JAX "
                  f"{np.abs(t[2] - j[2]).max():.3g}, against JAX nudged "
                  f"{np.abs(t[2] - n[2]).max():.3g}; JAX against JAX nudged "
                  f"{np.abs(j[2] - n[2]).max():.3g}", flush=True)
    for seed in (7, 8):
        s, table, planes = all_scales_case(seed)
        j, n, t = (run(pkg, s, None, p, mp, True, table=table)
                   for pkg, p in ((jrd, planes), (jrd, planes * nudge),
                                  (rd, planes)))
        cj, ct = components(j[4]), components(t[4])
        moved = [(k, p, q) for k in cj for p in cj[k] if p not in ct[k]
                 for q in ct[k] if q not in cj[k]]
        scale = max(1.0, float(np.abs(j[2]).max()))
        print(f"multiscale, all scales, seed {seed}: counts {t[1]} (JAX "
              f"{j[1]}); max|dres| / max(1, |res|max) against JAX "
              f"{np.abs(t[2] - j[2]).max() / scale:.3g}, against JAX nudged "
              f"{np.abs(t[2] - n[2]).max() / scale:.3g}; components moved "
              f"(scale, JAX's (x, y), the port's) {moved}", flush=True)
        b = run(jrd, s, None, planes, mp, False, table=table)
        print(f"  the JAX package's batched route: counts {b[1]}, max|dres| "
              f"/ max(1, |res|max) against its serial route "
              f"{np.abs(b[2] - j[2]).max() / scale:.3g}", flush=True)


def _margins(coeffs, mask, blob, window, min_scale, sigma_level, tolerance):
    """The structure selection's decisions and their margins, from one
    ``structure_stats_select`` call's outputs: the per-scale thresholds
    (recomputed in float32 as both packages form them, and checked against
    the mask), the member nearest the threshold and the non-member nearest
    it (in units of the threshold), and for each scale the margin of its
    significance test ``vals > rms * sigma_level``."""
    f32 = np.float32
    n_scales = mask.shape[0]
    stats = blob[:5 * n_scales].reshape(5, n_scales)
    rmses, vals = stats[0].astype(f32), stats[1].astype(f32)
    signed_max = f32(blob[-1])
    factor = f32(f32(sigma_level) * f32(4.0)) / f32(5.0)
    thr = np.maximum(rmses * factor, f32(tolerance) * abs(signed_max))
    thr = np.where(signed_max < 0.0, -thr, thr).astype(f32)
    c = coeffs[:n_scales]
    t = thr[:, None, None]
    exceeds = np.where(t >= 0.0, c > t, (c < t) | (c > -t))
    live = window[None] & (np.arange(n_scales)[:, None, None] >= min_scale)
    # Distance past the threshold, in units of it (> 0: a member).
    past = ((np.abs(c) if signed_max < 0.0 else c) - np.abs(t)) / np.abs(t)

    def nearest(which):
        """(distance in units of the threshold, scale, y, x, value) of the
        pixel of ``which`` nearest the threshold."""
        at = np.argwhere(live & which)
        if not at.size:
            return None
        k = np.argmin(np.abs(past[tuple(at.T)]))
        sc, y, x = (int(v) for v in at[k])
        return float(past[sc, y, x]), sc, y, x, float(c[sc, y, x])

    return dict(
        mask_matches=bool(np.array_equal(exceeds & live, mask)),
        thresholds=thr,
        nearest_member=nearest(exceeds),
        nearest_other=nearest(~exceeds),
        significance=(vals - rmses * f32(sigma_level)) / (
            rmses * f32(sigma_level)),
    )


def print_iuwt_decisions(grid=2, iterations=12, facet=1):
    """Every comparison of facet ``facet``'s structure iterations on
    ``test_faceted_iuwt.py``'s field (a ``grid`` x ``grid`` grid,
    ``iterations`` structure iterations), in the JAX package and in the
    port, and in the JAX package on its input times float32(1 + 1e-7):
    the significant scale and each scale's significance margin, the
    structure thresholds and the members nearest them on either side, the
    member count and box, the CG's SNR after each of its iterations (its
    stop test: SNR > 100 after the third, or a falling SNR after the sixth
    above 3) and the RMS guard.  Run it in two processes to see which
    decision the JAX package resolves both ways."""
    import radler_tpu.ops.iuwt as jax_ops

    import radler_tpu_torch.ops.iuwt as port_ops

    mp = pytest.MonkeyPatch()
    psf, residual = iuwt_field(128)
    s = settings("IUWT", 128, grid, iterations=iterations,
                 major_loop_gain=0.6, absolute_threshold=0.0)
    for name, pkg, ops, field in (
            ("JAX", jrd, jax_ops, residual),
            ("JAX, input times float32(1 + 1e-7)", jrd, jax_ops,
             residual * NUDGE),
            ("port", rd, port_ops, residual)):
        calls = []
        select0 = ops.structure_stats_select
        cg0 = ops.conjugate_gradient_guarded

        def select(image, window, select_window, psf_rms, scale0, sigma,
                   absolute, tol, min_scale, n_scales, allow_negative,
                   select0=select0, calls=calls):
            out = select0(image, window, select_window, psf_rms, scale0,
                          sigma, absolute, tol, min_scale, n_scales,
                          allow_negative)
            host = [np.asarray(o.cpu() if torch.is_tensor(o) else o)
                    for o in out[:3]]
            calls.append(("select", tuple(image.shape), host,
                          np.asarray(window.cpu() if torch.is_tensor(window)
                                     else window),
                          np.asarray(select_window.cpu()
                                     if torch.is_tensor(select_window)
                                     else select_window),
                          int(min_scale), float(sigma), float(tol)))
            return out

        def cg(scales, mask, masked_dirty, dirty, psf_k, gain, n_scales,
               max_iterations=20, cg0=cg0, calls=calls, ops=ops):
            out = cg0(scales, mask, masked_dirty, dirty, psf_k, gain,
                      n_scales, max_iterations)
            snrs = []
            for k in range(1, max_iterations + 1):
                _, status = ops.conjugate_gradient(
                    scales, mask, masked_dirty, psf_k, n_scales, k)
                snrs.append(float(np.asarray(status)[1]))
                if k > 1 and snrs[-1] == snrs[-2]:
                    snrs.pop()
                    break
            calls.append(("cg", tuple(dirty.shape),
                          np.asarray(out[1]).tolist(), snrs))
            return out

        mp.setattr(ops, "structure_stats_select", select)
        mp.setattr(ops, "conjugate_gradient_guarded", cg)
        out = run(pkg, s, psf, field, mp, False)
        mp.undo()
        print(f"== {name}: counts {out[1]} ==", flush=True)
        shapes = []
        for call in calls:
            if call[0] == "select" and call[1] not in shapes:
                shapes.append(call[1])
        n_select = 0
        for call in calls:
            if call[0] == "select":
                at = shapes.index(call[1])
                if at != facet:
                    continue
                n_select += 1
                coeffs, mask, blob = call[2]
                m = _margins(coeffs, mask, blob, call[4], call[5], call[6],
                             call[7])
                n = mask.shape[0]
                print(f"  structure iteration {n_select} {call[1]}: scale "
                      f"{int(blob[-2])} signed max {blob[-1]:.9g}; count "
                      f"{int(blob[5 * n])} box {blob[5 * n + 1:5 * n + 5]}"
                      f"; thresholds {m['thresholds']}; mask as "
                      f"recomputed {m['mask_matches']}; nearest member "
                      f"and non-member (distance past the threshold in "
                      f"units of it, scale, y, x, value) "
                      f"{m['nearest_member']}, {m['nearest_other']}; "
                      f"significance margins {np.round(m['significance'], 4)}",
                      flush=True)
            elif at == facet:
                success, snr, before, after = call[2]
                print(f"    CG {call[1]}: {len(call[3])} iterations, SNR "
                      f"{[f'{v:.6g}' for v in call[3]]}, success "
                      f"{bool(success)}; RMS {before:.9g} -> {after:.9g}",
                      flush=True)


if __name__ == "__main__":
    # From the repo's root, on the CPU (a few minutes):
    #   PYTHONPATH=. python tests/test_torch_facets_serial.py
    # and, for the faceted IUWT case's decisions alone:
    #   PYTHONPATH=. python tests/test_torch_facets_serial.py decisions
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["decisions"]:
        print_iuwt_decisions()
    else:
        print_readings()
