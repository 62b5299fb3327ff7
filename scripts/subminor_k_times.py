#!/usr/bin/env python3
"""Time the Clark subminor kernel (B2) through its wrapper: launches of 200
iterations, microseconds per iteration, two readings each.

First as a perform launches it (the plan the wrapper takes by itself), at
several candidate counts of config 2's 2048^2 problem.  Then the launch
plan's choices, at 1, 4 and 8 planes (the candidate sets of
``chip_smoke.py``'s 1-channel, 4-channel and 4-channel x 2-polarization
cases) and about 1000, 10,000 and 60,000 candidates, and at 80 planes and
about 100 and 1000: every cluster size at 128 to 1024 threads a block, with
the raw values in the first exchange and without.  The readings beside
``cluster_plan`` in ``kernels/subminor_loop.py`` come from here.

``routes`` compares B2's two routes, one cluster and the grid of one block
a multiprocessor, on candidate sets of the 8192^2 x 4 spectral field
(``chip_smoke.make_spectral_problem``: the PSFs do not stay in L2) at
about 30,000, 60,218, 100,000, 168,945, 300,000 and 1,000,000 candidates
and 1, 4 and 8 planes (the 4 channels; 4 channels x 2 polarizations): the
cluster plan, the grid at 256, 512 and 1024 threads a block and at its
plan's, and two blocks a multiprocessor; then, at config 2's field (its
2048^2 PSF stays in L2), the cluster and the grid at the counts of the
first part.  ``GRID_VALUES`` and ``GRID_MIN_THREADS`` come from here.
Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 scripts/subminor_k_times.py            # the first two parts
    python3 scripts/subminor_k_times.py perform    # the first part alone
    python3 scripts/subminor_k_times.py routes     # the routes alone
    python3 scripts/subminor_k_times.py compare    # B2's cells, any commit
    python3 scripts/subminor_k_times.py config3    # config 3's Clark route

``compare`` reads the cells a change to B2 may move, each with the
wrapper's own plan: B2 at config 2's candidate set and config 2's perform,
B2's tile axis, and the 8192^2 x 4 spectral performs with B2 at their
recorded state.  It uses only what every commit since the spectral fits
has, so copied into an older checkout it times that commit: run parent,
change, change, parent in one call.  ``config3`` does the same for config
3's Clark route (17 B2 launches of 8 planes a perform).

The first part alone times any commit of the port.  It imports nothing of
JAX.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

COUNTS = (1000, 2000, 4000, 10_000, 30_000, None)  # None: config 2's own set
ITERATIONS = 200
# The plan's choices: ((channels, polarizations), candidate counts), threads.
PLAN_CASES = (((1, 1), (1000, 10_000, 60_000)),
              ((4, 1), (1000, 10_000, 60_000)),
              ((4, 2), (1000, 10_000, 60_000)),
              ((20, 4), (100, 1000)))
THREADS = (128, 256, 512, 1024)
# The routes' candidate counts and plane counts, and the grid's threads.
ROUTE_COUNTS = (30_000, 60_218, 100_000, 168_945, 300_000, 1_000_000)
ROUTE_PLANES = (1, 4, 8)
GRID_THREADS = (256, 512, 1024)


def _us_per_iteration(fn):
    """One warm-up launch, then three between two events.  A launch takes
    hundreds of microseconds on the card and tens to enqueue, so the events
    time the card."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (3 * ITERATIONS)


def as_a_perform_launches_it(sl, params):
    from radler_tpu_torch.image_set import (
        CubeMeta,
        linear_integration_coefficients,
    )

    psf, residual = cs.make_problem(cs.CLARK_SIZE, cs.N_SOURCES)
    dev = torch.device("cuda")
    res_d = torch.as_tensor(residual, device=dev)[None]
    psfs = torch.as_tensor(psf, device=dev)[None]
    meta = CubeMeta(1, 1, (1.0,), (True,), 1.0, False, (0.0,))
    coef = torch.as_tensor(linear_integration_coefficients(meta), device=dev)
    ordered = res_d[0].abs().flatten().sort().values
    for count in COUNTS:
        loop = cs._clark_loop(
            res_d[0], meta, cs._settings(cs.CLARK_SIZE, cs.ITERATIONS,
                                         clark=True))
        if count is not None:
            loop.set_threshold(float(ordered[-count]), 0.0)
        k = loop.find_peak_positions(res_d, meta)
        res_k = loop._residual_k.clone()
        model_k = torch.zeros_like(res_k)
        readings = []
        for _ in range(2):
            ms, _ = cs._time_ms(
                lambda: sl.subminor_loop(res_k, model_k, None, loop._xs,
                                         loop._ys, psfs, coef, None, params,
                                         n_polarizations=1), 5)
            readings.append(ms * 1e3 / ITERATIONS)
        cs.say(f"K = {k}: {readings[0]:.3f}, {readings[1]:.3f} us per "
               f"iteration")


def the_plans_choices(sl, params):
    for (C, P), target in ((cp, k) for cp, ks in PLAN_CASES for k in ks):
        state = cs._subminor_state(C, P, False, True, seed=40 + C * P,
                                   k_target=target)
        n, k = C * P, state["k"]
        loop = state["loop"]
        res = loop._residual_k.clone()
        model = torch.zeros_like(res)
        chosen = sl.cluster_plan(n, k)
        exchanges = (True, False) if n <= sl.SHIP_RAW_MAX_IMAGES else (False,)
        plans = [
            sl.cluster_plan(n, k, cluster_size=r,
                            ship_raw=raw)._replace(threads=t)
            for raw in exchanges for r in cs.CLUSTER_SIZES for t in THREADS
        ]
        plans.append(chosen)
        readings = [[] for _ in plans]
        for i in (*range(len(plans)), *reversed(range(len(plans)))):
            readings[i].append(_us_per_iteration(
                lambda: sl.subminor_loop(
                    res, model, None, loop._xs, loop._ys, state["psfs"],
                    state["coef"], None, params, n_polarizations=P,
                    _plan=plans[i])))
        cs.say(f"N = {n}, K = {k}: the plan takes {cs._plan_name(chosen)}, "
               f"{readings[-1][0]:.2f}, {readings[-1][1]:.2f} us per "
               f"iteration")
        for raw in exchanges:
            for r in cs.CLUSTER_SIZES:
                row = [(p.threads, a, b)
                       for p, (a, b) in zip(plans[:-1], readings)
                       if (p.ship_raw, p.cluster_size) == (raw, r)]
                cs.say(f"  R={r}{' raw' if raw else ''}: " + "; ".join(
                    f"x{t} {a:.2f}, {b:.2f}" for t, a, b in row))
        del state


def _spectral_states():
    """The 8192^2 x 4 spectral field's candidate sets: for each count of
    ROUTE_COUNTS the brightest pixels of the summed |residual| in raster
    order, and for each plane count of ROUTE_PLANES the state, positions,
    PSFs, polarizations and linear coefficients (1/N each)."""
    psfs, res, _, _ = cs.make_spectral_problem(cs.SPECTRAL_SIZE,
                                               cs.SPECTRAL_SOURCES)
    width = res.shape[-1]
    order = res.abs().sum(0).flatten().argsort(descending=True)
    for k in ROUTE_COUNTS:
        idx = order[:k].sort().values
        xs = (idx % width).to(torch.int32)
        ys = (idx // width).to(torch.int32)
        for n in ROUTE_PLANES:
            if n == 1:
                planes, psf_n, pols = res[:1], psfs[:1], 1
            elif n == 4:
                planes, psf_n, pols = res, psfs, 1
            else:
                planes = torch.stack([res[i // 2] * (1.0 - 0.2 * (i % 2))
                                      for i in range(8)])
                psf_n, pols = psfs, 2
            state = planes.reshape(n, -1)[:, idx].contiguous()
            coef = torch.full((n,), 1.0 / n, dtype=torch.float32,
                              device=res.device)
            yield k, n, state, xs, ys, psf_n, pols, coef
            del planes, state


def _timed_plans(sl, plans, state, xs, ys, psfs, coef, params, pols):
    """Microseconds per iteration of each (name, plan), two readings, in
    turns forward and backward; a plan the card refuses (a grid whose
    clusters it cannot place all at once) reads nan."""
    res = state.clone()
    model = torch.zeros_like(res)
    readings = [[] for _ in plans]
    for i in (*range(len(plans)), *reversed(range(len(plans)))):
        try:
            us = _us_per_iteration(
                lambda: sl.subminor_loop(res, model, None, xs, ys, psfs, coef,
                                         None, params, n_polarizations=pols,
                                         _plan=plans[i][1]))
        except RuntimeError as refused:
            cs.say(f"  {plans[i][0]}: {refused}")
            us = float("nan")
        readings[i].append(us)
    return readings


def routes(sl, params):
    sms = sl.sm_count(torch.device("cuda"))
    faster = {}
    for k, n, state, xs, ys, psfs, pols, coef in _spectral_states():
        grid = sl.cluster_plan(n, k, grid_blocks=sms)
        threads = sorted({*GRID_THREADS, grid.threads})
        plans = [("cluster", sl.cluster_plan(n, k))]
        plans += [(f"grid x{t}{' (plan)' if t == grid.threads else ''}",
                   grid._replace(threads=t)) for t in threads]
        plans.append(("grid 2 a multiprocessor",
                      sl.cluster_plan(n, k, grid_blocks=2 * sms)))
        readings = _timed_plans(sl, plans, state, xs, ys, psfs, coef, params,
                                pols)
        cs.say(f"8192^2 field, N = {n}, K = {k} (grid: {grid.slice_len} a "
               f"block, x{grid.threads}, "
               f"{'shared' if grid.on_chip else 'global'} memory; cluster "
               f"{cs._plan_name(plans[0][1])}): "
               + "; ".join(f"{name} {a:.2f}, {b:.2f}" for (name, _), (a, b)
                           in zip(plans, readings)) + " us per iteration")
        cluster_us = sum(readings[0]) / 2
        grid_us = sum(readings[1 + threads.index(grid.threads)]) / 2
        faster.setdefault(n, []).append((k, grid_us < cluster_us))
    for n, rows in faster.items():
        cs.say(f"N = {n}: the grid (its plan) is faster at K = "
               + ", ".join(str(k) for k, won in rows if won)
               + "; the cluster at K = "
               + ", ".join(str(k) for k, won in rows if not won))

    # Config 2's field, its PSF in L2.
    from radler_tpu_torch.image_set import (
        CubeMeta,
        linear_integration_coefficients,
    )

    psf, residual = cs.make_problem(cs.CLARK_SIZE, cs.N_SOURCES)
    dev = torch.device("cuda")
    res_d = torch.as_tensor(residual, device=dev)[None]
    psfs = torch.as_tensor(psf, device=dev)[None]
    meta = CubeMeta(1, 1, (1.0,), (True,), 1.0, False, (0.0,))
    coef = torch.as_tensor(linear_integration_coefficients(meta), device=dev)
    ordered = res_d[0].abs().flatten().sort().values
    for count in COUNTS:
        loop = cs._clark_loop(
            res_d[0], meta, cs._settings(cs.CLARK_SIZE, cs.ITERATIONS,
                                         clark=True))
        if count is not None:
            loop.set_threshold(float(ordered[-count]), 0.0)
        k = loop.find_peak_positions(res_d, meta)
        grid = sl.cluster_plan(1, k, grid_blocks=sms)
        plans = [("cluster", sl.cluster_plan(1, k))]
        plans += [(f"grid x{t}", grid._replace(threads=t))
                  for t in sorted({grid.threads, 1024})]
        readings = _timed_plans(sl, plans, loop._residual_k, loop._xs,
                                loop._ys, psfs, coef, params, 1)
        cs.say(f"config 2's field, K = {k}: " + "; ".join(
            f"{name} {a:.2f}, {b:.2f}" for (name, _), (a, b)
            in zip(plans, readings)) + " us per iteration; the plan takes "
            + cs._plan_name(sl.cluster_plan(1, k, sm_count=sms)))


def compare(sl, params):
    """The cells this script compares across commits, each read with the
    wrapper's own plan: B2 at config 2's candidate set (us per iteration),
    config 2's perform (minor iterations/s), B2's tile axis at config 2 on
    chan 1 x tile 8 (ms for 200 iterations on each tile), and each 8192^2
    x 4 spectral perform (seconds, best of 2 after a recorded warm-up) with
    B2 at its recorded state (FIT_TIMED_ITERATIONS iterations from
    threshold 0, us per iteration, and the result's bits).  Uses only
    functions of ``chip_smoke.py`` that every commit since the fits has,
    so the script copied into an older checkout times that commit."""
    from radler_tpu_torch.image_set import (
        CubeMeta,
        linear_integration_coefficients,
    )

    psf, residual = cs.make_problem(cs.CLARK_SIZE, cs.N_SOURCES)
    dev = torch.device("cuda")
    res_d = torch.as_tensor(residual, device=dev)[None]
    psfs = torch.as_tensor(psf, device=dev)[None]
    meta = CubeMeta(1, 1, (1.0,), (True,), 1.0, False, (0.0,))
    coef = torch.as_tensor(linear_integration_coefficients(meta), device=dev)
    loop = cs._clark_loop(res_d[0], meta, cs._settings(
        cs.CLARK_SIZE, cs.ITERATIONS, clark=True))
    k = loop.find_peak_positions(res_d, meta)
    res_k = loop._residual_k.clone()
    model_k = torch.zeros_like(res_k)
    us = [_us_per_iteration(lambda: sl.subminor_loop(
        res_k, model_k, None, loop._xs, loop._ys, psfs, coef, None, params,
        n_polarizations=1)) for _ in range(2)]
    cs.say(f"compare: config 2's B2 at K = {k}: {us[0]:.3f}, {us[1]:.3f} us "
           "per iteration")
    _, rate = cs.phase_config2(psf, residual)
    cs.say(f"compare: config 2's perform {rate:.1f} minor iterations/s")
    mesh = cs.phase_mesh_clark(
        "config 2", torch.as_tensor(psf, device=dev),
        torch.as_tensor(residual, device=dev), {}, cs.CLARK_SIZE,
        cs.ITERATIONS, tile_times=True)
    cs.say(f"compare: B2's tile axis {mesh['times']['ms']:.4f} ms for "
           f"{cs.SUBMINOR_TIMED_ITERATIONS} iterations on each tile")
    del psf, residual, res_d, psfs, loop

    spectral, res, index_map, freqs = cs.make_spectral_problem(
        cs.SPECTRAL_SIZE, cs.SPECTRAL_SOURCES)
    import os
    import tempfile

    from radler_tpu_torch.utils.fits import write_fits_image

    timed = sl.SubminorParams.make(0.0, cs.GAIN, 0, cs.FIT_TIMED_ITERATIONS,
                                   0.0, True, False)
    with tempfile.TemporaryDirectory() as tmp:
        forced = os.path.join(tmp, "forced.fits")
        write_fits_image(forced, index_map)
        for mode in cs.FIT_MODES:
            settings = cs._spectral_settings(cs.SPECTRAL_SIZE, cs.ITERATIONS,
                                             mode, forced)

            def make():
                return cs._spectral_radler(settings, spectral, res, freqs)

            calls = []
            with cs._recording_b2(calls):
                first = cs._run_perform(make)
            seconds = [cs._run_perform(make)[1] for _ in range(2)]
            args, kwargs = calls[0]
            state = args[0]
            runs = []
            for _ in range(2):
                res_s, model_s = state.clone(), torch.zeros_like(state)
                run = (res_s, model_s) + tuple(args[2:8]) + (timed,)
                ms, _ = cs._time_ms(lambda: sl.subminor_loop(*run, **kwargs),
                                    5)
                runs.append(ms * 1e3 / cs.FIT_TIMED_ITERATIONS)
            res_s, model_s = state.clone(), torch.zeros_like(state)
            out = sl.subminor_loop(res_s, model_s, *args[2:8], timed,
                                   **kwargs)
            cs.say(f"compare: {mode}: {first[0]} iterations, K = "
                   f"{state.shape[1]}; perform s "
                   f"{', '.join(f'{v:.4f}' for v in seconds)}; B2 at the "
                   f"recorded state {runs[0]:.2f}, {runs[1]:.2f} us per "
                   f"iteration, result {sl.read_result(out)}, residual sum "
                   f"{float(res_s.double().sum()):.10g}")
            del calls, first, args
            torch.cuda.empty_cache()


def config3_clark():
    """Config 3's Clark route (multiscale 2048^2 x 8 channels, the 2-term
    fit, 600 iterations: 17 B2 launches of 8 planes) through
    Radler.perform, a fresh and a kept Radler, each a warm-up and the best
    of 4 performs, and the plans its B2 calls take.  Uses what every commit
    since the fits has, as ``compare`` does."""
    psfs, residual = cs.make_diffuse_problem(cs.MS_SIZE, cs.MS_CHANNELS)
    psf_d = torch.as_tensor(psfs, device=cs.DEVICE)
    res_d = torch.as_tensor(residual, device=cs.DEVICE)
    settings = cs._ms_settings(cs.MS_SIZE, cs.MS_ITERATIONS)
    for kept in (None, cs._ms_radler(psf_d, res_d, settings)):
        best, run, seconds = cs._ms_best(psf_d, res_d, settings, "clark",
                                         kept=kept, count=4)
        cs.say(f"compare: config 3's Clark route, "
               f"{'fresh' if kept is None else 'kept'} Radler: {run[0]} "
               f"iterations, seconds {', '.join(f'{s:.4f}' for s in seconds)}"
               f"; best {run[0] / best:.1f} minor iterations/s")


def main(argv):
    if not torch.cuda.is_available():
        print("subminor_k_times.py needs a CUDA device", file=sys.stderr)
        return 1
    from radler_tpu_torch.kernels import subminor_loop as sl

    cs.say(cs.phase_card())
    params = sl.SubminorParams.make(0.0, cs.GAIN, 0, ITERATIONS, 0.0, True,
                                    False)
    if "routes" in argv:
        routes(sl, params)
        return 0
    if "compare" in argv:
        compare(sl, params)
        return 0
    if "config3" in argv:
        config3_clark()
        return 0
    as_a_perform_launches_it(sl, params)
    if "perform" not in argv:
        the_plans_choices(sl, params)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
