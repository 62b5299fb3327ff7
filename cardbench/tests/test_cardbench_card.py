"""One short run of each cell on the card (skips without one)."""

import json
import subprocess
import sys

import pytest

from cardbench.harness import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, traced):
    p = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 17), "--seconds", "3", "--trace", str(traced)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
