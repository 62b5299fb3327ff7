"""BENCHMARK.json against the contract the harness relies on: every cell
finds its files, every metric its reader, names and units their
characters."""

import json
import re

import pytest

from cardbench.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.resolve(cell, BENCH)
    assert c.name == f"{c.config_name}.{c.traffic_name}"
    assert c.config["name"] == c.config_name
    assert c.traffic["name"] == c.traffic_name
    assert c.chips in (1, 4)
    assert {m.name for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.config["limits"]) == {"iterations", "residual", "model"}


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for group in ("end_to_end", "per_layer", "configs", "workloads"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen)), group


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert spec.metric_reader(m["name"]) is not None
        layers.setdefault(m["layer"], []).append(m["name"])
    assert BENCH["run_seconds"] in range(1, 52)


def test_configs_files_lie_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        data = spec.read_data(spec.ROOT / c["file"])
        assert data["reduced"] == c["reduced"]
        assert 1 <= len(data["source"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024
