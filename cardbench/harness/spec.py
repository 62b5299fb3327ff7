"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json`` and
``traffic/<traffic>.json`` under this benchmark's folder; a per-layer
metric ``<name>`` is the module ``metrics/<name>.py``: its function
``read``, and its optional ``probe``.  Adding a configuration, a traffic mix or a metric
is adding such a file and its entry: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: Optional[str] = None
    moves: Optional[str] = None
    bound: Optional[float] = None


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def read_data(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def data_file(folder: str, name: str) -> Path:
    """``<folder>/<name>.json``; raises when there is none."""
    path = BENCH_DIR / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{folder}/{name}.json: no such file")
    return path


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _metric(entry: dict) -> Metric:
    keys = {f.name for f in dataclasses.fields(Metric)}
    return Metric(**{k: v for k, v in entry.items() if k in keys})


def resolve(cell_name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``cell_name`` of ``BENCHMARK.json`` with its configuration
    and traffic read from their files."""
    bench = load_benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == cell_name]
    if len(entries) != 1:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    w = entries[0]
    return Cell(
        name=w["name"],
        config_name=w["config"],
        traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=read_data(data_file("configs", w["config"])),
        traffic=read_data(data_file("traffic", w["traffic"])),
        end_to_end=[_metric(m) for m in bench["end_to_end"]
                    if _applies(m, cell_name)],
        per_layer=[_metric(m) for m in bench["per_layer"]
                   if _applies(m, cell_name)],
    )


def metric_module(name: str):
    """``metrics/<name>.py``.  Its ``read`` takes the traced run's
    :class:`~cardbench.harness.trace.TraceContext` and returns the metric's
    value, or None where the run has nothing for it to read.  Its optional
    ``probe()`` returns an object that the traced runs install: a context
    manager ``installed()``, an attribute ``run`` set to each traced run's
    index, and ``settle(run_iterations)``, whose list of dataclass records
    ``read`` finds under ``ctx.probes[name]``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> Callable:
    return metric_module(name).read
