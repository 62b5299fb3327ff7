#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 cardbench/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

From the root of a checkout that holds ``radler_tpu_torch``.  It makes the
cell's pool of fields on the card from ``--seed``, warms up with one run,
then either runs whole deconvolutions back to back for ``--seconds``
(``--trace 0``: the cell's end-to-end metrics) or profiles a stretch of
whole runs and counts host syncs over others (``--trace 1``: its per-layer
metrics), checks the checked runs against the cell's plain reference, and
prints one JSON object as its last line of standard output; the compared
numbers and their limits are also the last lines of standard error.

It exits with a code other than 0, and prints no result, without a CUDA
device (or with fewer than the cell asks for), when ``radler_tpu_torch``
is not the checkout's, and when JAX or the ``radler_tpu`` package is
loaded in the process once the window has closed.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "radler_tpu")


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name (before the first dot) is,
    whole, one of :data:`FORBIDDEN`."""
    return sorted({name.split(".")[0] for name in modules
                   if name.split(".")[0] in FORBIDDEN})


def _card_state() -> str:
    """The card's name, power limit, clocks, temperature and draw, as
    ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from cardbench.harness import spec

    try:
        cell = spec.resolve(args.workload)
    except (KeyError, FileNotFoundError) as exc:
        print(f"cardbench: {exc}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cardbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}: no run, no result",
              file=sys.stderr)
        return 3
    import radler_tpu_torch

    if not Path(radler_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"cardbench: radler_tpu_torch comes from "
              f"{radler_tpu_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 5

    from cardbench.harness.cell_run import run_cell

    imported_s = time.perf_counter() - _STARTED
    device = torch.device("cuda", 0)
    print(json.dumps({"card": _card_state(),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, _STARTED)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"cardbench: loaded in this process: {found}; no result",
              file=sys.stderr)
        return 4
    result.info["card_after"] = _card_state()
    result.info["imports_s"] = imported_s
    print(json.dumps({"info": result.info}), flush=True)
    line = {"correct": result.correct, "attempted": result.attempted,
            "failed": result.failed, "metrics": result.metrics,
            "device": result.device}
    if result.breakdown is not None:
        line["breakdown"] = result.breakdown
    line["checks"] = result.checks
    print(f"correct: {result.correct}", file=sys.stderr)
    for name, c in result.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
