#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from.

    python3 cardbench/calibrate.py --workload <config>.<traffic> \\
        --seeds <n>,<n>,... --control-seeds <n>,<n>,...

On the card, at the cell's own size, in one process: for each of
``--seeds`` the cell's pool from that seed, the checked fields run through
the timed path (``harness.program.deconvolve``) and compared with the plain
reference, the numbers that ``harness.check`` compares; for each of
``--control-seeds`` the control, the reference computed in bfloat16 put in
the program's place, compared the same way.  A limit lies above the largest
program reading and below the smallest control reading.  Prints one JSON
line a reading and a summary last.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from cardbench.harness import cell_run, check, fields, program, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.resolve(args.workload)
    config, traffic = cell.config, cell.traffic
    dev = torch.device("cuda", 0)
    n_checked = int(config.get("checked_runs", 1))
    readings = {"program": [], "control": []}

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    for kind, chosen in (("program", seeds(args.seeds)),
                         ("control", seeds(args.control_seeds))):
        for seed in chosen:
            pool = fields.make_fields(config, traffic, seed, dev)
            order = cell_run.check_order(pool.pool.shape[0], n_checked, seed)
            for f in order[:n_checked]:
                field = pool.pool[f]
                args_ = (pool.psfs, field, pool.frequencies, pool.weights)
                t = time.perf_counter()
                if kind == "program":
                    out = program.deconvolve(config, *args_)
                    res, mod = out.cubes()
                    judged = (res, mod, out.iterations)
                else:
                    judged = check.run_reference(config, *args_,
                                                 dtype=torch.bfloat16)
                ref = check.run_reference(config, *args_)
                numbers = check.compare(field, judged, ref)
                row = {"kind": kind, "seed": seed, "field": f,
                       "seconds": time.perf_counter() - t, **numbers}
                readings[kind].append(row)
                print(json.dumps(row), flush=True)
                del judged, ref
            del pool
            torch.cuda.empty_cache()
    summary = {
        "lower": {k: max(r[k] for r in readings["program"])
                  for k in check.NUMBERS},
        "upper": {k: min(r[k] for r in readings["control"])
                  for k in check.NUMBERS},
        "limits": config["limits"],
    }
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
