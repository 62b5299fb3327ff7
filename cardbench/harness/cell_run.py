"""One run of one cell: set-up, the measured window or the traced stretch,
the correctness check, and the result's numbers.

:func:`run_cell` holds everything but the look for a card, so a test can
drive it on the CPU; ``run.py`` adds the look, the import guard and the
printing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import random
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from . import check, fields as fields_module, program, spec, stats
from . import trace as trace_module
from .syncs import count_syncs


@dataclasses.dataclass
class Run:
    field: int
    start: float
    end: float
    iterations: int
    performs: int


@dataclasses.dataclass
class CellResult:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    device: dict
    checks: Dict[str, dict]
    breakdown: Optional[dict] = None
    info: dict = dataclasses.field(default_factory=dict)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_order(n_fields: int, n_checked: int, seed: int) -> List[int]:
    """The pool's run order: the fields whose runs are checked (drawn from
    the seed) first, then the others in index order."""
    checked = random.Random(seed).sample(range(n_fields), n_checked)
    return checked + [f for f in range(n_fields) if f not in checked]


def _launches() -> Dict[str, int]:
    """The port's launch counters (a kernel entry's ``launches``) in the
    kernel modules loaded so far."""
    found = {}
    for name, module in list(sys.modules.items()):
        if not name.startswith("radler_tpu_torch.kernels."):
            continue
        for attr, obj in vars(module).items():
            count = getattr(obj, "launches", None)
            if callable(obj) and isinstance(count, int):
                found[f"{name.rsplit('.', 1)[1]}.{attr}"] = count
    return found


def _end_to_end(name: str, runs: List[Run], window_s: float,
                setup_s: float) -> float:
    if name == "minor_iterations_per_s":
        return stats.rate(sum(r.iterations for r in runs), window_s)
    if name == "run_p90_s":
        return stats.percentile([r.end - r.start for r in runs], 90)
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r} in the harness")


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, started: float,
             deconvolve: Callable = program.deconvolve) -> CellResult:
    """Run ``cell`` once on ``device``: its pool from ``seed``, one warm
    run, then ``seconds`` of back-to-back runs (or, ``traced``, the
    profiled stretch and the sync-counted runs), then the check.
    ``started`` is the process's start on ``time.perf_counter``'s clock."""
    device = torch.device(device)
    config, traffic = cell.config, cell.traffic
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    t_pool = time.perf_counter()
    pool = fields_module.make_fields(config, traffic, seed, device)
    _sync(device)
    t_pool = time.perf_counter() - t_pool
    F = pool.pool.shape[0]
    n_checked = int(config.get("checked_runs", 1))
    order = check_order(F, n_checked, seed)
    checked = set(order[:n_checked])

    def one(f: int):
        return deconvolve(config, pool.psfs, pool.pool[f], pool.frequencies,
                          pool.weights)

    t_warm = time.perf_counter()
    one(order[0])  # warm-up: the library, the kernels, cuFFT's plans
    _sync(device)
    t_warm = time.perf_counter() - t_warm
    kept: Dict[int, program.RunOutput] = {}
    runs: List[Run] = []
    failed = 0
    launches0 = _launches()
    info: Dict[str, object] = {"sources_a_field": pool.sources,
                               "pool_s": t_pool, "warm_run_s": t_warm}

    def timed(i: int) -> None:
        nonlocal failed
        f = order[i % F]
        start = time.perf_counter()
        try:
            out = one(f)
            _sync(device)
        except Exception as exc:  # a failed request: counted, not fatal
            failed += 1
            info.setdefault("errors", []).append(repr(exc)[:300])
            return
        runs.append(Run(f, start, time.perf_counter(), out.iterations,
                        out.performs))
        if f in checked:
            kept[f] = out

    # What set-up made stays: the cyclic collector's full passes walk only
    # what the runs make.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - started
    result_metrics: Dict[str, dict] = {}
    device_info: Dict[str, object] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": cell.chips,
    }
    breakdown = None
    if not traced:
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() < t0 + seconds or not runs:
            timed(i)
            i += 1
            if failed and not runs and i >= F:
                break
        window_s = (runs[-1].end - t0) if runs else seconds
        attempted = i
        for m in cell.end_to_end:
            if runs:
                result_metrics[m.name] = {
                    "value": _end_to_end(m.name, runs, window_s, setup_s),
                    "unit": m.unit}
        info["window_s"] = window_s
        info["runs"] = len(runs)
        info["performs_a_run"] = ([r.performs for r in runs[:F]])
        info["iterations_by_field"] = {
            r.field: r.iterations for r in runs[:F]}
        info["first_runs_s"] = [r.end - r.start for r in runs[:3]]
        if len(runs) > 1:
            took = [r.end - r.start for r in runs]
            info["run_s_quartiles"] = statistics.quantiles(took, n=4)
            info["run_s_max"] = max(took)
    else:
        modules = {m.name: spec.metric_module(m.name) for m in cell.per_layer}
        probes = {name: module.probe() for name, module in modules.items()
                  if hasattr(module, "probe")}
        n_traced = int(config.get("traced_runs", 2))
        traced_runs: List[int] = []

        def stretch():
            for j in range(n_traced):
                for p in probes.values():
                    p.run = j
                n_before = len(runs)
                timed(j)
                traced_runs.append(runs[-1].iterations
                                   if len(runs) > n_before else 0)

        with contextlib.ExitStack() as stack:
            for p in probes.values():
                stack.enter_context(p.installed())
            dev_events, host_events, window = trace_module.profile(stretch)
        # Host syncs over whole runs, the run's closing synchronize left
        # out of the count.
        syncs = []
        for j in range(n_traced, n_traced + int(config.get("sync_runs", 1))):
            f = order[j % F]
            outs = []
            syncs.append(count_syncs(lambda: outs.append(one(f))))
            _sync(device)
            if f in checked:
                kept[f] = outs[0]
        attempted = n_traced + len(syncs)
        ctx = trace_module.TraceContext(
            config=config, device_name=str(device_info["kind"]),
            runs=n_traced, iterations=traced_runs, window=window,
            device=dev_events, host=host_events,
            probes={name: p.settle(dict(enumerate(traced_runs)))
                    for name, p in probes.items()},
            syncs=syncs)
        for m in cell.per_layer:
            value = modules[m.name].read(ctx)
            if value is not None:
                result_metrics[m.name] = {"value": value, "unit": m.unit}
        device_info["busy_s"] = ctx.busy_s()
        device_info["window_s"] = ctx.window_s
        breakdown = {"device_ops": trace_module.top_device_ops(ctx),
                     "idle_gaps": trace_module.idle_gaps(ctx)}
        info["traced_iterations"] = traced_runs
        info["probes"] = {name: [dataclasses.asdict(r) for r in records]
                          for name, records in ctx.probes.items()}

    gc.unfreeze()
    n_runs = max(attempted, 1)
    info["launches_a_run"] = {k: (v - launches0.get(k, 0)) / n_runs
                              for k, v in _launches().items()}
    device_info["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(device))
        if device.type == "cuda" else 0)
    info["memory_peak_bytes"] = device_info["memory_peak_bytes"]

    # The check, once the window is closed and the peak read: the
    # program's state and the pool's unchecked fields are freed first.
    limits = {k: float(v) for k, v in config["limits"].items()}
    outputs = {f: kept[f].cubes() + (kept[f].iterations,) for f in kept}
    inputs = {f: pool.pool[f].clone() for f in kept}
    psfs, freqs, weights = pool.psfs, pool.frequencies, pool.weights
    del kept, pool, one
    if device.type == "cuda":
        torch.cuda.empty_cache()
    worst = {k: 0.0 for k in check.NUMBERS}
    started_check = time.perf_counter()
    for f, out in sorted(outputs.items()):
        ref = check.run_reference(config, psfs, inputs[f], freqs, weights)
        numbers = check.compare(inputs[f], out, ref)
        for k, v in numbers.items():
            worst[k] = v if not v <= worst[k] else worst[k]
    correct = bool(outputs) and failed == 0 and check.judge(worst, limits)
    checks = {k: {"value": worst[k], "limit": limits[k]}
              for k in check.NUMBERS}
    info["checked_fields"] = sorted(outputs)
    info["check_s"] = time.perf_counter() - started_check
    return CellResult(correct=correct, attempted=attempted, failed=failed,
                      metrics=result_metrics, device=device_info,
                      checks=checks, breakdown=breakdown, info=info)
