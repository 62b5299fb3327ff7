"""``radler_tpu_torch.utils.profiling``: twin of
``tests/test_algorithms.py::test_profiling_phase_timer``, and the port's
own cases for ``trace``, ``annotate``, ``force_sync`` and the module's
imports."""

import json
import subprocess
import sys
from pathlib import Path

import torch

from radler_tpu_torch.utils import profiling


def test_profiling_phase_timer():
    timer = profiling.PhaseTimer()
    with timer.phase("work"):
        _ = torch.ones((8, 8)).sum()
    assert "work" in timer.report()


def test_phase_timer_counts_and_syncs_on_cpu_tensors():
    timer = profiling.PhaseTimer()
    x = torch.ones(4)
    for _ in range(3):
        with timer.phase("step", sync={"x": [x, (x,)]}):
            x = x * 2
    assert timer.counts == {"step": 3}
    assert timer.totals["step"] >= 0.0
    assert timer.report().startswith("step: ")


def test_trace_writes_a_chrome_trace_with_nested_annotations(tmp_path):
    """On the CPU ``trace`` writes ``trace.json``, and an ``annotate``
    range inside another shows up inside it in the trace."""
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    path = tmp_path / "trace" / "trace.json"
    assert path.exists()
    events = {e["name"]: e for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("ph") == "X"}
    outer, inner = events["outer"], events["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    names = {e.key for e in prof.key_averages()}
    assert {"outer", "inner"} <= names


def test_force_sync_ignores_cpu_tensors_and_other_leaves():
    profiling.force_sync([torch.zeros(2), {"a": 1, "b": (torch.ones(1),)}])
    profiling.force_sync(None)


def test_importing_the_module_loads_no_jax():
    code = ("import sys, radler_tpu_torch.utils.profiling; "
            "print(any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "False"
