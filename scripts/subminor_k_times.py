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
``cluster_plan`` in ``kernels/subminor_loop.py`` come from here.  Run from
the root of a checkout on a machine with one NVIDIA GPU:

    python3 scripts/subminor_k_times.py            # both parts
    python3 scripts/subminor_k_times.py perform    # the first part alone

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


def main(argv):
    if not torch.cuda.is_available():
        print("subminor_k_times.py needs a CUDA device", file=sys.stderr)
        return 1
    from radler_tpu_torch.kernels import subminor_loop as sl

    cs.say(cs.phase_card())
    params = sl.SubminorParams.make(0.0, cs.GAIN, 0, ITERATIONS, 0.0, True,
                                    False)
    as_a_perform_launches_it(sl, params)
    if "perform" not in argv:
        the_plans_choices(sl, params)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
